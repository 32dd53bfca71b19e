"""Spatial and data sharding of the port (style_transfer2_tpu_torch/
parallel/) on the CPU, against the JAX package's sharding on the 8 virtual
CPU devices tests/conftest.py gives it and against the port's own
unsharded engines: tests/test_parallel.py's cases, with the port's mesh
entries all torch.device('cpu') (one process standing in for each
device), and the pieces the port writes by hand: the halo conv, the
two-phase style branch, the gather of an unevenly pooling level, the
cross-shard TV roll, the sharded checkpoint and the bf16 history gate."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.engine.batched import (
    BatchedStyleTransfer as JaxBatchedStyleTransfer)
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.parallel import (
    DataPlacement as JaxDataPlacement,
    SpatialPlacement as JaxSpatialPlacement,
    make_mesh as jax_make_mesh)
from style_transfer2_tpu_torch.engine import (StyleTransfer, load_checkpoint,
                                              save_checkpoint)
from style_transfer2_tpu_torch.engine.batched import (
    BatchedStyleTransfer, PlacedBatchedStyleTransfer, batched_engine)
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.ops import conv, style
from style_transfer2_tpu_torch.ops.losses import tv_norm
from style_transfer2_tpu_torch.parallel import (DataPlacement, Sharded,
                                                SpatialPlacement, make_mesh)

WEIGHTS = {
    'content': {'conv2_2': 0.1},
    'style': {'conv1_1': 1.0, 'conv2_1': 1.0},
    'deepdream': {},
}
# Taps down to conv5_1: a 32px grid on 4 shards pools evenly to 4x32
# rows, then is gathered (module docstring of models/vgg19.py).
DEEP_WEIGHTS = {
    'content': {'conv4_2': 1.0},
    'style': {'conv1_1': 1.0, 'conv3_1': 1.0, 'conv5_1': 1.0},
    'deepdream': {'conv4_1': 0.5},
}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
# tests/test_parallel.py's tolerances.
TRACE_RTOL, TRACE_ATOL = 5e-4, 1e-6
IMAGE_RTOL, IMAGE_ATOL = 1e-3, 0.1
BF16_LOSS_RTOL = 2e-2
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the grids are tiny, and the test runner runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(spec='2x4'):
    """The port's SpatialPlacement over `spec` CPU entries ('space' axis
    of a 2-D mesh, or the one axis of a 1-D one)."""
    if 'x' in str(spec):
        return SpatialPlacement(make_mesh(spec, device='cpu'))
    return SpatialPlacement(make_mesh(spec, axis_names=('space',),
                                      device='cpu'))


def _jax_space(spec='2x4'):
    if 'x' in str(spec):
        return JaxSpatialPlacement(jax_make_mesh(spec))
    return JaxSpatialPlacement(jax_make_mesh(spec, axis_names=('space',)))


def _images(hw, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
            for _ in range(3)]


def _start(engine, optimizer, weights, hw, seed=3):
    content, style_img, inp = _images(hw, seed)
    engine.set_weights(weights, SCALARS)
    engine.set_optimizer(optimizer)
    engine.set_step_size(10.0 if optimizer == 'adam' else 1.0)
    engine.set_content(content)
    engine.set_style(style_img)
    engine.set_input(inp)
    assert engine.start()
    return engine


def _port(placement, optimizer='adam', weights=WEIGHTS, hw=(32, 32),
          precision='float32', remat=False):
    return _start(StyleTransfer(random_params(2), precision=precision,
                                device='cpu', placement=placement,
                                remat=remat), optimizer, weights, hw)


def _steps(engine, n=3):
    traces, img = [], None
    for _ in range(n):
        img, trace = engine.step()
        traces.append(trace)
    return np.asarray(img), traces


_JAX_RUNS = {}


def _jax_run(optimizer, hw=(32, 32), spec='2x4', n=3):
    """The JAX engine's sharded run, once per configuration."""
    key = (optimizer, hw, spec, n)
    if key not in _JAX_RUNS:
        st = _start(JaxStyleTransfer(random_params(2),
                                     placement=_jax_space(spec)),
                    optimizer, WEIGHTS, hw)
        _JAX_RUNS[key] = _steps(st, n)
    return _JAX_RUNS[key]


def _assert_traces(got, want, what, rtol=TRACE_RTOL, atol=TRACE_ATOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        keys = [k for k in w if k != 'time']
        assert [k for k in g if k != 'time'] == keys
        for key in keys:
            np.testing.assert_allclose(
                g[key], w[key], rtol=rtol, atol=atol,
                err_msg='%s: step %d, trace key %r' % (what, i, key))


# -- meshes and placements -------------------------------------------------------

def test_make_mesh_shapes():
    """tests/test_parallel.py test_make_mesh_shapes on the port: the same
    shapes and axis names as the JAX mesh over the same count of devices;
    too few devices raise make_mesh's message. On the CPU a spec of n is n
    entries of the CPU, and 'auto' is one."""
    assert len(jax.devices()) == 8
    eight = [CPU] * 8
    for spec, want in (('auto', (8,)), ('2x4', (2, 4)), (4, (4,)),
                       ('4', (4,)), ((2, 2), (2, 2))):
        m = make_mesh(spec, devices=eight)
        jm = jax_make_mesh(spec)
        assert m.devices.shape == jm.devices.shape == want
        assert m.axis_names == jm.axis_names
        assert m.shape == dict(jm.shape)
    assert make_mesh('2x4', device='cpu').axis_names == ('data', 'space')
    assert make_mesh('2x4', device='cpu').devices.shape == (2, 4)
    assert make_mesh(4, device='cpu').devices.shape == (4,)
    assert make_mesh('auto', device='cpu').devices.shape == (1,)
    assert all(d == CPU for d in make_mesh(3, device='cpu').devices.flat)
    with pytest.raises(ValueError, match="Mesh '4x4' needs 16 devices, "
                                         "have 8"):
        make_mesh('4x4', devices=eight)
    with pytest.raises(ValueError):
        jax_make_mesh('4x4')
    # A device may repeat: several shards on one card.
    assert make_mesh(4, devices=['cpu'] * 4).devices.size == 4


def test_make_mesh_on_cuda_needs_the_cards():
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_mesh(2)


def _shapes(x):
    return {tuple(s.shape) for s in x.shards}


def _jax_shapes(x):
    return {s.data.shape for s in x.addressable_shards}


def test_spatial_sharding_actually_shards():
    """The image and the (n_corr, 1, H, W, C) L-BFGS history shard on H
    over the 4 'space' devices of a 2x4 mesh, as the JAX placement's do."""
    p, jp = _space(), _jax_space()
    x = p.image(torch.zeros(1, 64, 64, 3))
    assert isinstance(x, Sharded) and x.axis == 1
    assert _shapes(x) == _jax_shapes(jp.image(jnp.zeros((1, 64, 64, 3)))) \
        == {(1, 16, 64, 3)}
    assert len(x.shards) == 4 and tuple(x.shape) == (1, 64, 64, 3)
    hist = p.state({'sk': torch.zeros(10, 1, 64, 64, 3)})['sk']
    jhist = jp.state({'sk': jnp.zeros((10, 1, 64, 64, 3))})['sk']
    assert _shapes(hist) == _jax_shapes(jhist) == {(10, 1, 16, 64, 3)}


def test_spatial_sharding_uneven_h_falls_back_to_w():
    p, jp = _space(4), _jax_space(4)
    x = p.image(torch.zeros(1, 66, 64, 3))
    assert x.axis == 2
    assert _shapes(x) == _jax_shapes(jp.image(jnp.zeros((1, 66, 64, 3)))) \
        == {(1, 66, 16, 3)}
    h = p.state(torch.zeros(5, 1, 66, 64, 3))
    assert _shapes(h) == _jax_shapes(jp.state(jnp.zeros((5, 1, 66, 64, 3)))) \
        == {(5, 1, 66, 16, 3)}


def test_snap_hw():
    p = _space(8)
    assert p.snap_hw((1030, 771)) == (1032, 776)
    assert p.snap_hw((1024, 768)) == (1024, 768)
    assert p.snap_hw((3, 5)) == (8, 8)   # never below one row per shard
    jp = _jax_space(8)
    for hw in ((1030, 771), (1024, 768), (3, 5)):
        assert p.snap_hw(hw) == jp.snap_hw(hw)


def test_spatial_replication_fallback_is_loud(caplog):
    """Large arrays that replicate (neither axis divides) warn once; small
    deep-pyramid features replicate silently by design."""
    p = _space(4)
    big = torch.zeros(1, 2049, 2049, 4)  # 67 MB, both axes indivisible
    with caplog.at_level(logging.WARNING, logger='parallel'):
        out = p.image(big)
        p.image(big)  # warned once per shape
    assert torch.is_tensor(out)
    warned = [r for r in caplog.records if 'REPLICATION' in r.message]
    assert len(warned) == 1

    caplog.clear()
    with caplog.at_level(logging.WARNING, logger='parallel'):
        p.image(torch.zeros(1, 3, 3, 512))
    assert not caplog.records


def test_placed_shards_are_copies_of_their_own():
    """Shards never alias the placed tensor or each other: an in-place
    write to one touches nothing else."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(1, 2, 8, 3)
    xs = _space(4).image(x)
    assert xs.axis == 2
    xs.shards[0].fill_(-1.0)
    assert (x >= 0).all()
    assert all((s >= 0).all() for s in xs.shards[1:])


# -- the collectives and the kernels' sharded wrappers ----------------------------

@pytest.mark.parametrize('hw,n', [((16, 12), 4), ((10, 16), 4)])
def test_halo_conv_matches_the_unsharded_conv(hw, n):
    """conv3x3_bias_relu_sharded (H-sharded at 16x12, W-sharded at 10x16)
    against the plain conv of the whole map, forward and backward: the
    halo rows' gradients reach the neighbouring shards."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, *hw, 8), dtype=torch.float32)
    w = torch.tensor(rng.randn(3, 3, 8, 16) * 0.2, dtype=torch.float32)
    b = torch.tensor(rng.randn(16) * 0.1, dtype=torch.float32)
    g = torch.tensor(rng.randn(1, *hw, 16), dtype=torch.float32)
    wt = conv.backward_weights(w)

    xr = x.clone().requires_grad_(True)
    y = conv.conv3x3_bias_relu_plain(xr, w, b)
    (dx,) = torch.autograd.grad(y, xr, g)

    xs = _space(n).image(x)
    assert xs.axis == (1 if hw[0] % n == 0 else 2)
    xs.requires_grad_(True)
    ys = conv.conv3x3_bias_relu_sharded(xs, lambda device: (w, b, wt))
    gs = _space(n).image(g)
    dxs = torch.autograd.grad(ys.shards, xs.shards, gs.shards)
    np.testing.assert_allclose(ys.gather().detach().numpy(),
                               y.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.cat(dxs, xs.axis).numpy(), dx.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('c', [64, 6])
def test_two_phase_style_branch_matches_the_fused_one(c):
    """style_branch_sharded (partial Grams, a sum over the shards, G_style
    subtracted once, the gradient product against the broadcast G_diff)
    against the unsharded plain branch."""
    rng = np.random.RandomState(1)
    feat = torch.tensor(rng.rand(1, 16, 12, c), dtype=torch.float32)
    gram_style = torch.tensor(rng.rand(c, c) * 0.1, dtype=torch.float32)
    s_grad, gram_diff = style.fused_style_branch_plain(feat, gram_style)
    s_sh, gd_sh = style.fused_style_branch(_space(4).image(feat), gram_style)
    assert isinstance(s_sh, Sharded) and _shapes(s_sh) == {(1, 4, 12, c)}
    np.testing.assert_allclose(gd_sh.numpy(), gram_diff.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(s_sh.gather().numpy(), s_grad.numpy(),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize('hw,n', [((16, 12), 4), ((10, 16), 4)])
def test_tv_rolls_across_the_shards(hw, n):
    """TV's circular rolls on a Sharded map (the first and last rows
    exchanged across the shards) give the unsharded norm and gradient."""
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.rand(1, *hw, 3), dtype=torch.float32)
    norm, grad = tv_norm(x, 2.0)
    norm_s, grad_s = tv_norm(_space(n).image(x), 2.0)
    np.testing.assert_allclose(norm_s.item(), norm.item(), rtol=1e-6)
    np.testing.assert_allclose(grad_s.gather().numpy(), grad.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_sharded_arrays_refuse_what_must_see_the_whole_array():
    """A Sharded runs elementwise math shard by shard and nothing else:
    a reduction along a dim, or a full-size plain tensor beside it,
    raises rather than compute per shard."""
    xs = _space(4).image(torch.ones(1, 8, 8, 3))
    with pytest.raises(TypeError, match='not defined'):
        torch.sum(xs, dim=1)
    with pytest.raises(TypeError, match='ambiguous'):
        xs + torch.ones(1, 8, 8, 3)
    assert torch.sum(xs).item() == 8 * 8 * 3
    assert torch.mean(torch.square(xs * 2.0)).item() == 4.0


def test_trunk_gathers_the_first_unevenly_pooling_level():
    """At 40x40 on 4 shards each shard holds 10 rows, 5 after pool1: pool2
    gathers, so the taps are Sharded down to conv2_2 and whole below it,
    each equal to the unsharded trunk's."""
    model = vgg19.VGG19Features(
        {k: {n: torch.tensor(v) for n, v in p.items()}
         for k, p in random_params(2).items()})
    x = torch.tensor(np.random.RandomState(4).rand(1, 40, 40, 3) * 255 - 120,
                     dtype=torch.float32)
    layers = ('conv1_1', 'pool1', 'conv2_2', 'pool2', 'conv3_1')
    want = model(x, layers)
    got = model(_space(4).image(x), layers)
    for name in layers:
        sharded = name in ('conv1_1', 'pool1', 'conv2_2')
        assert isinstance(got[name], Sharded) == sharded, name
        value = got[name].gather() if sharded else got[name]
        # float32 convs of other shapes sum in another order: 1e-5 of the
        # map's largest value.
        np.testing.assert_allclose(
            value.numpy(), want[name].numpy(), rtol=1e-5,
            atol=1e-5 * want[name].abs().max().item(), err_msg=name)


# -- the engine ---------------------------------------------------------------------

@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_spatial_sharding_matches_jax_and_single_device(optimizer):
    """tests/test_parallel.py test_spatial_sharding_matches_single_device
    on the port: 3 steps at 32x32, H over the 4 'space' devices of a 2x4
    mesh, every trace key against the JAX engine's sharded run and the
    port's unsharded one."""
    img_s, traces_s = _steps(_port(_space(), optimizer))
    img_u, traces_u = _steps(_port(None, optimizer))
    img_j, traces_j = _jax_run(optimizer)
    _assert_traces(traces_s, traces_u, 'port sharded vs unsharded')
    _assert_traces(traces_s, traces_j, 'port vs JAX, sharded')
    np.testing.assert_allclose(img_s, img_u, rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(img_s, img_j, rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL)


def test_spatial_sharding_uneven_h_matches_single_device():
    """A W-sharded 34x32 grid (H indivisible by 4): 2 Adam steps against
    the port's unsharded engine and the JAX engine's W-sharded run."""
    hw = (34, 32)
    st = _port(_space(4), 'adam', hw=hw)
    assert st.input_hw == hw and st._input.axis == 2
    img_s, traces_s = _steps(st, 2)
    img_u, traces_u = _steps(_port(None, 'adam', hw=hw), 2)
    img_j, traces_j = _jax_run('adam', hw, 4, 2)
    _assert_traces(traces_s, traces_u, 'W-sharded vs unsharded')
    _assert_traces(traces_s, traces_j, 'port vs JAX, W-sharded')
    np.testing.assert_allclose(img_s, img_u, rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL)


def test_spatial_sharding_with_k_step_chunks():
    """run_steps and begin/collect chunks under a placement: one trace a
    step, the chunk's image gathered, against the unsharded engine and
    the JAX engine's sharded scan."""
    def run(engine):
        img, trace = engine.run_steps(3)
        return np.asarray(img), trace

    img_s, trace_s = run(_port(_space(), 'adam'))
    img_u, trace_u = run(_port(None, 'adam'))
    jst = _start(JaxStyleTransfer(random_params(2), placement=_jax_space()),
                 'adam', WEIGHTS, (32, 32))
    img_j, trace_j = run(jst)
    _assert_traces([trace_s], [trace_u], 'chunk, port')
    _assert_traces([trace_s], [trace_j], 'chunk, port vs JAX')
    np.testing.assert_allclose(img_s, img_u, rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL)

    # Two chunks in flight, L-BFGS, primed at the first.
    st, su = _port(_space(), 'lbfgs'), _port(None, 'lbfgs')
    got = [st.begin_steps(2), st.begin_steps(3)]
    want = [su.begin_steps(2), su.begin_steps(3)]
    for (gi, gt), (wi, wt) in zip(st.collect_steps_many(got),
                                  su.collect_steps_many(want)):
        np.testing.assert_allclose(gi, wi, rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
        _assert_traces([t.data for t in gt], [t.data for t in wt],
                       'chunks in flight')
    assert len(st.traces) == len(su.traces) == 6


@pytest.mark.parametrize('remat', [False, 'conv', 'block'])
def test_spatial_sharding_bf16_under_each_remat_policy(remat):
    """bf16 with each remat policy under sharding, through the taps down
    to conv5_1 (sharded, then gathered): the loss tracks the unsharded
    bf16 run at the JAX test's rtol 2e-2."""
    img_s, traces_s = _steps(_port(_space(4), 'lbfgs', DEEP_WEIGHTS,
                                   precision='bfloat16', remat=remat))
    img_u, traces_u = _steps(_port(None, 'lbfgs', DEEP_WEIGHTS,
                                   precision='bfloat16'))
    for ts, tu in zip(traces_s, traces_u):
        assert np.isfinite(ts['loss'])
        np.testing.assert_allclose(ts['loss'], tu['loss'],
                                   rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(img_s, img_u, rtol=0.1, atol=3.0)


@pytest.mark.parametrize('remat', ['conv', 'block'])
def test_spatial_sharding_float32_remat_matches(remat):
    """float32 remat under sharding, deep taps and the gathered levels:
    every trace key against the unsharded float32 run."""
    _, traces_s = _steps(_port(_space(4), 'adam', DEEP_WEIGHTS,
                               remat=remat), 2)
    _, traces_u = _steps(_port(None, 'adam', DEEP_WEIGHTS), 2)
    _assert_traces(traces_s, traces_u, 'float32 remat %s' % remat)


def test_gathered_deep_levels_match_single_device():
    """40x40 on 4 shards: the trunk gathers at pool2 and runs the rest on
    the first device; the deep content, style and deep-dream terms and
    every other trace key match the unsharded engine's."""
    _, traces_s = _steps(_port(_space(4), 'lbfgs', DEEP_WEIGHTS,
                               hw=(40, 40)), 2)
    _, traces_u = _steps(_port(None, 'lbfgs', DEEP_WEIGHTS, hw=(40, 40)), 2)
    _assert_traces(traces_s, traces_u, 'gathered levels')


def test_sharded_engine_resamples_and_places_again():
    """resample_input and resample_content warm-start the sharded state on
    a new grid, placed again: the traces follow the unsharded engine's."""
    engines = [_port(_space(4), 'adam'), _port(None, 'adam')]
    traces = []
    for st in engines:
        st.step()
        st.resample_input((24, 32))
        st.resample_content((24, 32))
        assert st.input_hw == (24, 32)
        traces.append(_steps(st, 2)[1])
    assert isinstance(engines[0]._input, Sharded)
    assert isinstance(engines[0].opt_state['g1_mean'], Sharded)
    assert torch.is_tensor(engines[0].input)
    _assert_traces(traces[0], traces[1], 'after a resample')


def test_sharded_checkpoint_round_trip(tmp_path):
    """A sharded engine's checkpoint holds whole arrays (gathered on save)
    and a sharded engine loads it placed again: the next chunk equals the
    uninterrupted engine's, bit for bit on the CPU. An unsharded engine
    loads it too."""
    ref = _port(_space(4), 'lbfgs')
    ref.run_steps(2)
    want = ref.run_steps(3)

    st = _port(_space(4), 'lbfgs')
    st.run_steps(2)
    save_checkpoint(st, tmp_path / 'ck')
    loaded = torch.load(tmp_path / 'ck' / 'arrays.pt', weights_only=True)
    assert loaded['opt_state']['sk'].shape == (10, 1, 32, 32, 3)
    resumed = StyleTransfer(random_params(2), device='cpu',
                            placement=_space(4))
    load_checkpoint(resumed, tmp_path / 'ck')
    assert isinstance(resumed.opt_state['sk'], Sharded)
    assert resumed.opt_state['x'] is resumed._input
    got = resumed.run_steps(3)
    np.testing.assert_array_equal(got[0], want[0])
    assert ({k: v for k, v in got[1].items() if k != 'time'}
            == {k: v for k, v in want[1].items() if k != 'time'})

    plain = StyleTransfer(random_params(2), device='cpu')
    load_checkpoint(plain, tmp_path / 'ck')
    assert torch.is_tensor(plain.opt_state['sk'])
    _, trace = plain.run_steps(3)
    _assert_traces([trace], [want[1]], 'unsharded resume')


def test_bf16_history_gate_sees_the_global_grid():
    """The bf16 L-BFGS history gate (160k px) reads the whole grid: 400x400
    on 4 shards (40k px each) keeps bf16 pairs, and a warm start down to
    200x200 restarts them in float32, as the unsharded engine does."""
    for placement in (_space(4), None):
        st = StyleTransfer(random_params(2), precision='bfloat16',
                           device='cpu', placement=placement)
        st.set_weights({'content': {'conv1_1': 1.0}, 'style': {},
                        'deepdream': {}}, SCALARS)
        rng = np.random.RandomState(0)
        st.set_style(rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
        img = rng.randint(0, 256, (400, 400, 3)).astype(np.uint8)
        st.set_content(img)
        st.set_input(img)
        assert st.start()
        assert st.opt_state['sk'].dtype == torch.bfloat16
        st.resample_input((200, 200))
        assert st.opt_state['sk'].dtype == torch.float32
        if placement is not None:
            assert isinstance(st.opt_state['sk'], Sharded)
            assert _shapes(st.opt_state['sk']) == {(10, 1, 50, 200, 3)}


def test_placement_must_match_the_engine_device():
    with pytest.raises(ValueError, match='placement over cpu'):
        StyleTransfer(random_params(2), device='cuda', placement=_space(2))


# -- data placement ----------------------------------------------------------------

def _lane_jobs(hw=(16, 16), n=2):
    rng = np.random.RandomState(20)
    return [[rng.randint(0, 256, hw + (3,)).astype(np.uint8)
             for _ in range(3)] for _ in range(n)]


def test_data_placement_lanes_match_the_unsharded_batched_engine():
    """Two lanes over a 2-way 'data' mesh: each device group steps its own
    lane; every lane's traces against the unsharded batched engine's and
    the JAX batched engine's over its DataPlacement (a 2x4 mesh's data
    axis), L-BFGS, 2 steps and a 2-step chunk."""
    params = random_params(2)
    jobs = _lane_jobs()
    placed = batched_engine(params, WEIGHTS, SCALARS, (16, 16), 2,
                            placement=DataPlacement(make_mesh(
                                2, axis_names=('data',), device='cpu')),
                            optimizer='lbfgs', device='cpu')
    assert isinstance(placed, PlacedBatchedStyleTransfer)
    assert [g.max_lanes for g in placed.groups] == [1, 1]
    plain = BatchedStyleTransfer(params, WEIGHTS, SCALARS, (16, 16), 2,
                                 optimizer='lbfgs', device='cpu')
    theirs = JaxBatchedStyleTransfer(
        params, WEIGHTS, SCALARS, (16, 16), max_lanes=2, optimizer='lbfgs',
        placement=JaxDataPlacement(jax_make_mesh('2x4')))
    runs = []
    for engine in (placed, plain, theirs):
        lanes = [engine.add_job(*job) for job in jobs]
        assert lanes == [0, 1]
        steps = [engine.step_all() for _ in range(2)]
        chunk = engine.run_steps_all(2)
        runs.append(([{lane: [s[lane]] for lane in s} for s in steps]
                     + [chunk], [np.asarray(engine.lane_image(i))
                                 for i in lanes]))
    for other, what in ((runs[1], 'unsharded'), (runs[2], 'JAX')):
        for got, want in zip(runs[0][0], other[0]):
            for lane in want:
                _assert_traces(got[lane], want[lane], '%s lane %d'
                               % (what, lane))
        for got, want in zip(runs[0][1], other[1]):
            np.testing.assert_allclose(got, want, rtol=IMAGE_RTOL,
                                       atol=IMAGE_ATOL)
    assert placed.t == [4, 4]
    keys, vals, set_ = placed.norms_host()
    assert vals.shape == (len(keys), 2) and set_.all()


def test_data_placement_needs_lanes_that_divide():
    placement = DataPlacement(make_mesh(2, axis_names=('data',),
                                        device='cpu'))
    with pytest.raises(ValueError, match='3 lanes do not divide'):
        PlacedBatchedStyleTransfer(random_params(2), WEIGHTS, SCALARS,
                                   (16, 16), 3, placement, device='cpu')


def test_data_placement_lane_lifecycle_addresses_its_group():
    """add_job, set_running, lane_state, remove_job and a migration's
    add_job(lane_state=, norms=) reach the right group's lane."""
    placement = DataPlacement(make_mesh(2, axis_names=('data',),
                                        device='cpu'))
    eng = PlacedBatchedStyleTransfer(random_params(2), WEIGHTS, SCALARS,
                                     (16, 16), 4, placement, 'adam',
                                     device='cpu')
    jobs = _lane_jobs(n=4)
    for lane in (3, 1):
        assert eng.add_job(*jobs[lane], lane=lane) == lane
    assert eng.active == [False, True, False, True]
    assert eng.groups[0].active == [False, True]
    assert eng.groups[1].active == [False, True]
    eng.set_running(1, False)
    traces = eng.step_all()
    assert sorted(traces) == [3] and eng.t == [0, 0, 0, 1]
    state, norms = eng.lane_state(3), eng.lane_norms(3)
    lane = eng.add_job(*jobs[0], lane_state={k: (v.clone() if
                                                 torch.is_tensor(v) else v)
                                             for k, v in state.items()},
                       norms=norms, lane=0)
    assert lane == 0
    np.testing.assert_array_equal(eng.lane_image(0), eng.lane_image(3))
    eng.remove_job(3)
    assert eng.active == [True, True, False, False]
    assert not eng.groups[1].active[1]
