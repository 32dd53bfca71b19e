"""The port's bfloat16 loss feed (engine/objective.py _feed_layer) against
the JAX package's default bf16 objective (BF16_FEED, STYLE_EINSUM,
STYLE_FOLD 'auto'), on the CPU with the kernels' plain versions, and the
feed's plain kernels (ops/reduce.py sumsq; ops/style.py style_gram_plain,
style_product_plain) against float64.

Every case holds the first evaluation of one objective at one iterate:
Adam's first step, whose trace is the objective at the start image, so
that nothing of an optimizer's path enters. Both sides run the same
numpy inputs and random_params weights.

Tolerances (stated per case below): the two trunks run bf16 convs of
different libraries, whose taps part by a bf16 rounding here and there, so
each trace key is held to a relative bound a little above the largest
distance measured on a CPU. Unfolded, a float32 feed over the bf16 trunk
(float32 taps and cotangents) misses these cases by 1.3e-3 to 2.4e-3 on
scd_grad, ten times the feed's distance: a float32 cotangent never takes
the bf16 rounding of each branch's scale, which moves a whole layer's
gradient by up to 2^-9.
Folded, the JAX branch rounds the style term once, as a float32 feed does,
so there a float32 feed meets the bound too; those cases hold the port's
fold to JAX's, and that the fold reduces no style tap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.engine import objective as jax_objective
from style_transfer2_tpu.engine.batched import (
    BatchedStyleTransfer as JaxBatchedStyleTransfer)
from style_transfer2_tpu.engine import steps as jax_steps
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.models import vgg19 as jax_vgg19
from style_transfer2_tpu.parallel import (
    SpatialPlacement as JaxSpatialPlacement, make_mesh as jax_make_mesh)
from style_transfer2_tpu.parallel import batch as jax_batch
from style_transfer2_tpu_torch.engine import StyleTransfer, objective
from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.ops import reduce, style
from style_transfer2_tpu_torch.parallel import (Sharded, SpatialPlacement,
                                                make_mesh)

# tests/test_bf16.py's feed spec: content, style and deepdream branches.
WEIGHTS = {'content': {'conv2_2': 0.1},
           'style': {'conv1_1': 1.0, 'conv2_1': 1.0},
           'deepdream': {'conv3_1': 0.05}}
# The same with the float32 'data' tap in each loss.
DATA_WEIGHTS = {'content': {'data': 0.01, 'conv2_2': 0.1},
                'style': {'data': 1.0, 'conv1_1': 1.0, 'conv2_1': 1.0},
                'deepdream': {'data': 0.01, 'conv3_1': 0.05}}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
# Every trace key of the first evaluation, relative. Largest measured:
# unfolded 7.0e-5 (single, 24x24), 3.9e-5 (27x32), 6.8e-5 ('data'),
# 1.2e-4 (lanes), 4.7e-5 (sharded); folded 5.4e-5, 7.7e-5, 1.7e-4. A
# float32 feed, unfolded: 1.3e-3, 1.5e-3, 1.3e-3, 2.4e-3, 1.3e-3.
FEED_RTOL = 3e-4
# The port's cotangents against JAX's, elementwise, relative to each
# cotangent's largest magnitude: largest measured 1.5e-3 (conv1_1, whose
# taps part by a bf16 rounding in 0.1% of their values); at least
# COTANGENT_SAME of each bf16 cotangent's values are JAX's bits (measured:
# all of conv2_1's and conv3_1's, 99.9% of conv1_1's).
COTANGENT_RTOL = 4e-3
COTANGENT_SAME = 0.99


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the grids are tiny, and the test runner runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(hw, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
            for _ in range(3)]


def _start(engine, hw, weights=WEIGHTS, seed=7):
    content, style_img, inp = _images(hw, seed)
    engine.set_weights(weights, SCALARS)
    engine.set_optimizer('adam')
    engine.set_step_size(10.0)
    engine.set_content(content)
    engine.set_style(style_img)
    engine.set_input(inp)
    assert engine.start()
    return engine


def _first(engine):
    """The trace of Adam's first step: the objective at the start image."""
    return engine.step()[1]


def _assert_keys(got, want, rtol, what):
    assert list(got) == list(want)
    for key, value in want.items():
        if key in ('time', 'fevals'):
            continue
        np.testing.assert_allclose(got[key], value, rtol=rtol,
                                   err_msg='%s: %s' % (what, key))


def _clear_jax_steps():
    """Drops the JAX package's cached step builders, whose programs read
    STYLE_FOLD when they are traced."""
    for fn in (jax_steps.build_step_core, jax_steps.build_step_fns,
               jax_steps.build_scan_fn, jax_batch.build_batched_step_fns,
               jax_batch.build_masked_batched_step_fns,
               jax_batch.build_masked_batched_scan_fn):
        fn.cache_clear()


@pytest.fixture
def jax_fold(monkeypatch):
    """The JAX objective with STYLE_FOLD forced on (its compiled steps
    cleared before and after), and the port's fold floor at 0."""
    _clear_jax_steps()
    monkeypatch.setattr(jax_objective, 'STYLE_FOLD', True)
    monkeypatch.setattr(objective, 'STYLE_FOLD_MIN_PIXELS', 0)
    yield
    _clear_jax_steps()


@pytest.mark.parametrize('hw,weights', [
    ((24, 24), WEIGHTS), ((27, 32), WEIGHTS), ((24, 24), DATA_WEIGHTS)],
    ids=['24x24', '27x32', 'data'])
def test_first_evaluation_per_trace_key(hw, weights):
    """The port's bf16 objective, single engine, against the JAX
    package's default bf16 objective at the first evaluation: every trace
    key within FEED_RTOL. 24x24 takes JAX's block-1 space-to-depth trunk,
    27x32 its plain one; 'data' adds the float32 'data' tap to each
    loss."""
    got = _first(_start(StyleTransfer(random_params(5), 'bfloat16',
                                      device='cpu'), hw, weights))
    want = _first(_start(JaxStyleTransfer(random_params(5),
                                          precision='bfloat16'), hw,
                         weights))
    _assert_keys(got, want, FEED_RTOL, 'single %s' % (hw,))


def test_style_fold_first_evaluation(jax_fold, monkeypatch):
    """The folded style branch (JAX STYLE_FOLD = True; the port's floor at
    0): every key within FEED_RTOL of JAX's fold, and the port's fold takes
    rms(s_raw) from the Gram, so that only the content and deepdream
    branches reduce a tap."""
    calls = []
    real = objective.sumsq

    def counting(t, lanes=False):
        calls.append(tuple(t.shape))
        return real(t, lanes)

    monkeypatch.setattr(objective, 'sumsq', counting)
    hw = (24, 24)
    got = _first(_start(StyleTransfer(random_params(5), 'bfloat16',
                                      device='cpu'), hw))
    assert len(calls) == 2      # conv2_2's content, conv3_1's deepdream
    want = _first(_start(JaxStyleTransfer(random_params(5),
                                          precision='bfloat16'), hw))
    _assert_keys(got, want, FEED_RTOL, 'folded')


def test_fold_follows_the_pixel_floor(monkeypatch):
    """Unfolded below STYLE_FOLD_MIN_PIXELS (a sum of squares a style
    layer), folded at it; the floor reads the whole grid."""
    calls = []
    real = objective.sumsq
    monkeypatch.setattr(objective, 'sumsq',
                        lambda t, lanes=False: calls.append(1) or real(
                            t, lanes))
    hw = (24, 24)
    for floor, want in ((24 * 24 + 1, 4), (24 * 24, 2)):
        monkeypatch.setattr(objective, 'STYLE_FOLD_MIN_PIXELS', floor)
        calls.clear()
        _first(_start(StyleTransfer(random_params(5), 'bfloat16',
                                    device='cpu'), hw))
        assert len(calls) == want, floor
    monkeypatch.undo()
    assert (objective.STYLE_FOLD_MIN_PIXELS
            == jax_objective.STYLE_FOLD_MIN_PIXELS == 500_000)


def _lane_jobs(hw):
    return [dict(zip(('content', 'style', 'input'), _images(hw, seed)))
            for seed in (7, 8)]


def _lanes_first(engine, hw):
    for job in _lane_jobs(hw):
        engine.add_job(job['content'], job['style'], job['input'])
    return engine.step_all()


@pytest.mark.parametrize('fold', [False, True], ids=['unfolded', 'folded'])
def test_lanes_first_evaluation(fold, request):
    """Two lanes of the port's batched bf16 engine against the JAX batched
    engine's (jax.vmap of the feed): every key of each lane within
    FEED_RTOL, unfolded and folded."""
    if fold:
        request.getfixturevalue('jax_fold')
    hw = (24, 24)
    got = _lanes_first(BatchedStyleTransfer(
        random_params(6), WEIGHTS, SCALARS, hw, max_lanes=2,
        optimizer='adam', precision='bfloat16', device='cpu'), hw)
    want = _lanes_first(JaxBatchedStyleTransfer(
        random_params(6), WEIGHTS, SCALARS, hw, max_lanes=2,
        optimizer='adam', precision='bfloat16'), hw)
    for lane in (0, 1):
        _assert_keys(got[lane], want[lane], FEED_RTOL, 'lane %d' % lane)


@pytest.mark.parametrize('fold', [False, True], ids=['unfolded', 'folded'])
def test_sharded_first_evaluation(fold, request):
    """The port's engine over 2 CPU shards against the JAX engine's
    SpatialPlacement over 2 of tests/conftest.py's virtual devices: every
    key within FEED_RTOL, unfolded and folded; the fold reads the whole
    grid."""
    if fold:
        request.getfixturevalue('jax_fold')
    hw = (32, 32)
    mesh = make_mesh(2, axis_names=('space',), device='cpu')
    got = _first(_start(StyleTransfer(
        random_params(2), 'bfloat16', device='cpu',
        placement=SpatialPlacement(mesh)), hw))
    want = _first(_start(JaxStyleTransfer(
        random_params(2), precision='bfloat16',
        placement=JaxSpatialPlacement(jax_make_mesh(
            2, axis_names=('space',)))), hw))
    _assert_keys(got, want, FEED_RTOL, 'sharded')


def test_content_features_stored_in_bf16():
    """Both engines store content features in bf16 in bfloat16 mode and
    in float32 otherwise; the port's lanes too, and the two engines'
    stored values agree within a bf16 rounding."""
    hw = (24, 24)
    port = _start(StyleTransfer(random_params(5), 'bfloat16', device='cpu'),
                  hw, DATA_WEIGHTS)
    jax_st = _start(JaxStyleTransfer(random_params(5), precision='bfloat16'),
                    hw, DATA_WEIGHTS)
    assert set(port.features) == set(jax_st.features) == {'data', 'conv2_2'}
    for layer, feat in port.features.items():
        assert feat.dtype == torch.bfloat16
        assert jax_st.features[layer].dtype == jnp.bfloat16
        want = np.asarray(jax_st.features[layer], np.float32)
        np.testing.assert_allclose(feat.float().numpy(), want,
                                   rtol=COTANGENT_RTOL,
                                   atol=COTANGENT_RTOL * np.abs(want).max())
    f32 = _start(StyleTransfer(random_params(5), 'float32', device='cpu'),
                 hw)
    assert all(f.dtype == torch.float32 for f in f32.features.values())
    bt = BatchedStyleTransfer(random_params(6), WEIGHTS, SCALARS, hw,
                              max_lanes=2, optimizer='adam',
                              precision='bfloat16', device='cpu')
    assert bt.inputs['content_feats']['conv2_2'].dtype == torch.bfloat16


def _record_vjp(cls, monkeypatch, store):
    """Wraps cls.features_and_vjp so that each vjp call records its
    cotangents (as float32 numpy, with their dtype) into store."""
    real = cls.features_and_vjp

    def wrapped(self, x, layers):
        feats, vjp = real(self, x, layers)

        def recording(diffs):
            store.update({k: (str(v.dtype), np.asarray(
                v.float() if torch.is_tensor(v) else v.astype(jnp.float32)))
                for k, v in diffs.items()})
            return vjp(diffs)
        return feats, recording

    monkeypatch.setattr(cls, 'features_and_vjp', wrapped)


def test_bf16_cotangents(monkeypatch):
    """Each conv tap's cotangent enters the port's vjp in bf16 and the
    'data' tap's in float32, as in the JAX feed (run eagerly, its block-1
    layout off so that the taps are laid out alike), each within
    COTANGENT_RTOL of JAX's, elementwise, and a bf16 one bit for bit JAX's
    in at least COTANGENT_SAME of its values."""
    hw = (24, 24)
    got, want = {}, {}
    _record_vjp(vgg19.VGG19Features, monkeypatch, got)
    _first(_start(StyleTransfer(random_params(5), 'bfloat16', device='cpu'),
                  hw, DATA_WEIGHTS))
    _record_vjp(jax_vgg19.VGG19Features, monkeypatch, want)
    with jax.disable_jit():
        st = JaxStyleTransfer(random_params(5), precision='bfloat16',
                              block1_s2d=False)
        _first(_start(st, hw, DATA_WEIGHTS))
    assert set(got) == set(want) == {'data', 'conv1_1', 'conv2_1',
                                     'conv2_2', 'conv3_1'}
    for layer, (dtype, value) in got.items():
        assert dtype == ('torch.float32' if layer == 'data'
                         else 'torch.bfloat16'), layer
        assert want[layer][0] == ('float32' if layer == 'data'
                                  else 'bfloat16'), layer
        ref = want[layer][1]
        assert value.shape == ref.shape, layer
        np.testing.assert_allclose(value, ref, rtol=0,
                                   atol=COTANGENT_RTOL * np.abs(ref).max(),
                                   err_msg=layer)
        if layer != 'data':
            assert (value == ref).mean() >= COTANGENT_SAME, layer


# -- the plain versions of the feed's kernels ---------------------------------

def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(np.float32(rng.randn(*shape) * scale)).to(
        torch.bfloat16)


@pytest.mark.parametrize('shape', [(1, 24, 24, 64), (3, 7, 5, 128)])
def test_sumsq_plain_against_float64(shape):
    """sumsq on the CPU: float32 sums of the bf16 values' squares within
    1e-6 of float64's, whole and per lane; a float32 tensor alike."""
    rng = np.random.RandomState(0)
    t = _bf16(rng, shape)
    ref = t.double().square()
    got = reduce.sumsq(t)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), ref.sum().item(), rtol=1e-6)
    lanes = reduce.sumsq(t, lanes=True)
    assert lanes.shape == (shape[0],) and lanes.dtype == torch.float32
    np.testing.assert_allclose(lanes.numpy(),
                               ref.sum(dim=(1, 2, 3)).numpy(), rtol=1e-6)
    f32 = t.float() * 1.5
    np.testing.assert_allclose(reduce.sumsq(f32).item(),
                               f32.double().square().sum().item(),
                               rtol=1e-6)


def test_sumsq_of_shards_adds_in_shard_order():
    rng = np.random.RandomState(1)
    t = _bf16(rng, (1, 12, 8, 64))
    parts = [t[:, :6], t[:, 6:]]
    sharded = Sharded([p.contiguous() for p in parts], 1)
    want = reduce.sumsq_plain(parts[0]) + reduce.sumsq_plain(parts[1])
    assert torch.equal(reduce.sumsq(sharded), want)
    with pytest.raises(ValueError):
        reduce.sumsq(sharded, lanes=True)


@pytest.mark.parametrize('n,sms,lanes', [
    (1, 132, 1), (4096, 132, 1), (24 * 24 * 64, 132, 1),
    (2880 * 3840 * 64, 132, 1), (384 * 512 * 64, 132, 4),
    (12345, 132, 3), (10 ** 6, 1, 1)])
def test_sumsq_plan(n, sms, lanes):
    """Chunks of a multiple of 8 covering each row once, in order; about 8
    blocks an SM over the lanes where the rows are long enough, and no
    more blocks than 4096-element pieces of a row."""
    chunk, blocks = reduce.sumsq_plan(n, sms, lanes)
    assert chunk % 8 == 0 and chunk > 0 and 1 <= blocks <= 65535
    assert chunk * blocks >= n > chunk * (blocks - 1)
    assert blocks <= max(1, -(-8 * sms // lanes), -(-n // 4096))
    assert blocks <= max(1, -(-n // 4096))


@pytest.mark.parametrize('lanes', [1, 3])
def test_bf16_style_phases_plain_against_float64(lanes):
    """style_gram_plain of a bf16 map: float32 sums of exact products,
    within 1e-6 of float64 (relative to the Gram's largest entry);
    style_product_plain rounds D to bf16 first, sums in float32 and rounds
    the result once, so it is float64's product of the rounded operands
    rounded to bf16, up to the float32 sums' own error near a rounding
    boundary."""
    rng = np.random.RandomState(2)
    h, w, c = 9, 7, 64
    feat = torch.relu(_bf16(rng, (lanes, h, w, c)))
    size = h * w * c
    gram = style.style_gram_plain(feat if lanes > 1 else feat[:1], size,
                                  lanes=lanes > 1)
    x64 = feat.double().reshape(lanes, h * w, c)
    g64 = torch.bmm(x64.transpose(1, 2), x64) / size
    assert gram.dtype == torch.float32
    got = gram if lanes > 1 else gram[None]
    np.testing.assert_allclose(got.numpy(), g64.numpy(), rtol=0,
                               atol=1e-6 * g64.abs().max().item())
    d = torch.from_numpy(np.float32(rng.randn(lanes, c, c) * 1e-3))
    out = style.style_product_plain(feat if lanes > 1 else feat[:1],
                                    d if lanes > 1 else d[0])
    assert out.dtype == torch.bfloat16 and out.shape == feat.shape
    want = torch.bmm(x64, d.to(torch.bfloat16).double()).reshape(
        feat.shape)
    # Within one bf16 rounding of the exact product, and equal to its
    # rounding nearly everywhere.
    np.testing.assert_allclose(out.double().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-12)
    same = (out == want.to(torch.bfloat16)).double().mean().item()
    assert same > 0.99, same


def test_style_phases_take_the_lane_axis_and_shards():
    """style_gram and style_product on the CPU: lanes lane by lane, a
    Sharded map shard by shard (the partial Grams added in shard order
    on the first device, D rounded once and broadcast), each equal bit for
    bit to the plain phases on the same rows."""
    rng = np.random.RandomState(3)
    feat = torch.relu(_bf16(rng, (2, 8, 6, 64)))
    size = 8 * 6 * 64
    gram = style.style_gram(feat, size, lanes=True)
    assert torch.equal(gram[1], style.style_gram_plain(feat[1:], size))
    d = torch.from_numpy(np.float32(rng.randn(2, 64, 64) * 1e-3))
    assert torch.equal(style.style_product(feat, d)[1:],
                       style.style_product_plain(feat[1:], d[1]))
    one = feat[:1]
    sharded = Sharded([one[:, :4].contiguous(), one[:, 4:].contiguous()], 1)
    want = (style.style_gram_plain(sharded.shards[0], size)
            + style.style_gram_plain(sharded.shards[1], size))
    assert torch.equal(style.style_gram(sharded, size), want)
    prod = style.style_product(sharded, d[0])
    assert isinstance(prod, Sharded) and prod.dtype == torch.bfloat16
    for s, p in zip(sharded.shards, prod.shards):
        assert torch.equal(p, style.style_product_plain(s, d[0]))


@pytest.mark.parametrize('m,c,lanes', [
    (384 * 512, 64, 1), (96 * 128, 512, 1), (192 * 256, 128, 4),
    (17, 64, 1), (720 * 960, 64, 1)])
def test_bf16_gram_plan(m, c, lanes):
    """The bf16 Gram's split: chunks of whole stages of the kernel's ring
    (256 rows where C <= 64, else 64) covering each map once, the grid
    (chunks x items x lanes) within one block an SM where one chunk an
    item leaves room, the partials sized for the float32 reduction's
    layout, the shared memory within an H100 block's 227 KB."""
    cp, chunk, n_chunks, n_partials, smem = style._bf16_plan(m, c, 132,
                                                             lanes)
    assert cp == c and chunk % (256 if c <= 64 else 64) == 0
    assert chunk * n_chunks >= m > chunk * (n_chunks - 1)
    items = len(style.gram_bf16_items(c))
    assert n_chunks == 1 or n_chunks * items * lanes <= 132
    tiles = len(style.gram_tiles(c))
    assert n_partials == lanes * n_chunks * tiles * 64 * 64
    assert smem <= 232448
    assert style._bf16_plan(m, 60, 132, lanes)[0] == 64


def test_store_dtype():
    assert objective.content_store_dtype(torch.bfloat16) == torch.bfloat16
    assert objective.content_store_dtype(torch.float32) == torch.float32


def test_graph_replays_credit_the_feed_counters():
    """A step graph credits every wrapper counter its capture moved
    (engine/graphs.py): the feed's bf16 style phases and sumsq among
    them."""
    from style_transfer2_tpu_torch.engine import graphs
    counts = graphs._launch_counts()
    for key in (('style_gram_bf16',), ('style_grad_bf16',), ('sumsq',)):
        assert key in counts
    before = (style.gram_bf16_launches, style.grad_bf16_launches,
              reduce.launches)
    delta = {('style_gram_bf16',): 2, ('style_grad_bf16',): 3,
             ('sumsq',): 5}
    graphs._credit(delta)
    assert (style.gram_bf16_launches, style.grad_bf16_launches,
            reduce.launches) == (before[0] + 2, before[1] + 3,
                                 before[2] + 5)
    graphs._credit(delta, -1)
    assert (style.gram_bf16_launches, style.grad_bf16_launches,
            reduce.launches) == before
