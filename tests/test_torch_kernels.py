"""The kernel modules of the port (ops/conv.py, ops/style.py, _build.py;
ops/image.py is in test_torch_image.py).

On the CPU: each wrapper's plain version against the JAX package's Pallas
kernel in interpret mode, at the shapes of tests/test_pallas_conv.py and
tests/test_pallas.py (float32 atol 1e-4), and the dispatch rules. The
kernels themselves are tested on the card in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.ops.pallas.conv import (
    conv3x3_bias_relu as jconv3x3_bias_relu)
from style_transfer2_tpu.ops.pallas.style_kernel import (
    fused_style_branch as jfused_style_branch)
from style_transfer2_tpu_torch import _build
from style_transfer2_tpu_torch.ops import conv, style

CONV_CASES = [
    ((1, 16, 32, 64), 128),
    ((1, 24, 16, 128), 128),
    ((2, 8, 16, 64), 256),
]


def _conv_case(seed, shape, cout):
    rng = np.random.RandomState(seed)
    x = np.float32(rng.randn(*shape))
    w = np.float32(rng.randn(3, 3, shape[-1], cout) * 0.1)
    b = np.float32(rng.randn(cout) * 0.1)
    g = np.float32(rng.randn(*shape[:3], cout))
    return x, w, b, g


def _plain_fwd_bwd(x, w, b, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype)
    y = conv.conv3x3_bias_relu(xt, wt, torch.from_numpy(b).to(dtype),
                               conv.backward_weights(wt))
    dx = torch.autograd.grad(y, xt, torch.from_numpy(g).to(dtype))[0]
    return y.detach().float().numpy(), dx.float().numpy()


@pytest.mark.parametrize('shape,cout', CONV_CASES)
def test_plain_conv_matches_pallas_interpret(shape, cout):
    x, w, b, g = _conv_case(0, shape, cout)
    y, dx = _plain_fwd_bwd(x, w, b, g)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    jy = jconv3x3_bias_relu(jx, jw, jb)
    jdx = jax.grad(lambda a: jnp.vdot(jconv3x3_bias_relu(a, jw, jb),
                                      jnp.asarray(g)))(jx)
    assert y.shape == jy.shape and dx.shape == jdx.shape
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(jdx), atol=1e-4, rtol=1e-5)


def test_plain_conv_bf16_matches_pallas_interpret():
    x, w, b, g = _conv_case(2, (1, 16, 16, 128), 128)
    y, _ = _plain_fwd_bwd(x, w, b, g, torch.bfloat16)
    jy = np.float32(jconv3x3_bias_relu(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))))
    scale = max(1.0, float(np.abs(jy).max()))
    assert np.abs(y - jy).max() / scale < 0.03


def test_plain_conv_masks_the_cotangent():
    x, w, b, g = _conv_case(3, (1, 8, 8, 64), 128)
    _, dx = _plain_fwd_bwd(x, w, b, np.ones_like(g))
    _, dx0 = _plain_fwd_bwd(x, w, b - 1e3, np.ones_like(g))
    assert np.abs(dx).max() > 0 and np.abs(dx0).max() == 0


@pytest.mark.parametrize('shape', [(1, 24, 24, 64), (1, 7, 9, 128)])
def test_plain_style_matches_pallas_interpret(shape):
    rng = np.random.RandomState(4)
    feat = np.float32(np.maximum(rng.randn(*shape), 0))
    other = np.float32(np.maximum(rng.randn(*shape), 0)).reshape(-1,
                                                                 shape[-1])
    gram_style = np.float32(other.T @ other / other.size)
    s, gd = style.fused_style_branch(torch.from_numpy(feat),
                                     torch.from_numpy(gram_style))
    js, jgd = jfused_style_branch(jnp.asarray(feat), jnp.asarray(gram_style))
    assert s.shape == js.shape and gd.shape == jgd.shape
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-4,
                               atol=1e-4 * float(np.abs(gram_style).max()))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(js)).max()))


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = (conv.fwd_launches, conv.bwd_launches, style.launches)
    x, w, b, g = _conv_case(5, (1, 5, 7, 3), 64)
    _plain_fwd_bwd(x, w, b, g)
    style.fused_style_branch(torch.ones(1, 3, 5, 8), torch.zeros(8, 8))
    assert (conv.fwd_launches, conv.bwd_launches, style.launches) == before


def test_other_devices_raise():
    x = torch.empty(1, 4, 4, 3, device='meta')
    w = torch.empty(3, 3, 3, 8, device='meta')
    with pytest.raises(RuntimeError):
        conv.conv3x3_bias_relu(x, w, torch.empty(8, device='meta'),
                               conv.backward_weights(w))
    with pytest.raises(RuntimeError):
        style.fused_style_branch(torch.empty(1, 4, 4, 8, device='meta'),
                                 torch.empty(8, 8, device='meta'))


@pytest.mark.parametrize('m,c', [(63, 64), (196608, 64), (3072, 512),
                                 (1, 3), (6, 128)])
@pytest.mark.parametrize('sms', [132, 1])
def test_style_chunking_covers_every_row(m, c, sms):
    chunk, n_chunks = style.gram_plan(m, c, sms)
    assert chunk % 16 == 0 and n_chunks >= 1
    assert chunk * n_chunks >= m > chunk * (n_chunks - 1)


@pytest.mark.parametrize('c', [3, 64, 128, 192, 256, 512, 520])
def test_gram_tiles_cover_the_gram_once_up_to_mirroring(c):
    tiles = style.gram_tiles(c)
    nt = -(-c // 64)
    assert len(tiles) == nt * (nt + 1) // 2
    assert len(set(tiles)) == len(tiles) and all(i <= j for i, j in tiles)
    covered = np.zeros((c, c), np.int32)
    for i, j in tiles:
        covered[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64] += 1
        if i != j:
            covered[j * 64:(j + 1) * 64, i * 64:(i + 1) * 64] += 1
    assert (covered == 1).all()


def test_gram_tiles_follow_the_kernels_launch_order():
    """csrc/style.cu decodes block t by walking rows of the triangle; the
    same walk here must give the planner's list."""
    for c in (64, 256, 512):
        nt = -(-c // 64)
        decoded = []
        for t in range(nt * (nt + 1) // 2):
            i = 0
            while t >= nt - i:
                t -= nt - i
                i += 1
            decoded.append((i, i + t))
        assert decoded == style.gram_tiles(c)


@pytest.mark.parametrize('sms', [132, 114, 78])
def test_gram_plan_sizes_the_split_from_the_sm_count(sms):
    m, c = 384 * 512, 64
    chunk, n_chunks = style.gram_plan(m, c, sms)
    blocks = n_chunks * len(style.gram_tiles(c))
    target = style._BLOCKS_PER_SM * sms
    assert 0.9 * target <= blocks <= 1.1 * target


def test_model_keeps_the_backward_weights_once():
    from style_transfer2_tpu_torch.models import VGG19Features
    rng = np.random.RandomState(11)
    params = {'conv1_1': {'w': torch.from_numpy(np.float32(rng.randn(
        3, 3, 3, 8))), 'b': torch.zeros(8)}}
    for dtype in (torch.float32, torch.bfloat16):
        p = VGG19Features(params, dtype).params['conv1_1']
        assert p['wt'].dtype == dtype
        assert torch.equal(p['wt'], conv.backward_weights(p['w']))


F32 = torch.float32

# (N, H, W, K = cotangent channels, Cout = dx channels) of the backward
# shapes whose tile grid leaves a 132-SM card idle for much of its last
# wave: at 512px (96,128) conv3_1 and (48,64) conv4_1, conv4_2; at 543x724
# (136,181) conv3_1, (68,91) conv4_1, conv4_2. Each split count is the
# fastest of 1, 2, 3, 4, 6 and 8 timed on an H100, or within 2% of it
# (PERF.md; style_transfer2_tpu_torch/split_sweep.py times them).
UNDERFILLED = [((1, 96, 128, 256, 128), 2), ((1, 48, 64, 512, 256), 4),
               ((1, 48, 64, 512, 512), 2), ((1, 136, 181, 256, 128), 2),
               ((1, 68, 91, 512, 256), 3), ((1, 68, 91, 512, 512), 2)]
# Grids of about three full waves, where a split's partial outputs cost
# more than the idle tail it fills (timed likewise): (96,128) conv3_2 at
# 512px and conv4_1 at 768x1024.
FULL_ENOUGH = [(1, 96, 128, 256, 256), (1, 96, 128, 512, 256)]


@pytest.mark.parametrize('h,w', [(384, 512), (543, 724), (768, 1024),
                                 (17, 181), (1, 1)])
def test_bwd_plan_takes_narrow_for_conv1_1(h, w):
    assert conv.bwd_plan(1, h, w, 64, 3, F32, 132) == (conv.NARROW, 1, 64)
    assert conv.bwd_plan(1, h, w, 64, 8, F32, 132)[0] == conv.NARROW
    assert conv.bwd_plan(1, h, w, 64, 9, F32, 132)[0] != conv.NARROW
    assert conv.bwd_plan(1, h, w, 6, 3, F32, 132)[0] == conv.TILE


@pytest.mark.parametrize('shape,splits', UNDERFILLED)
def test_bwd_plan_splits_the_underfilled_grids(shape, splits):
    path, got, kspan = conv.bwd_plan(*shape, F32, 132)
    assert (path, got) == (conv.SPLIT, splits) and kspan % 8 == 0


@pytest.mark.parametrize('shape', FULL_ENOUGH + [
    (1, 384, 512, 64, 64), (1, 192, 256, 128, 128), (1, 136, 181, 256, 256),
    (1, 96, 128, 512, 512), (1, 768, 1024, 64, 64), (1, 9, 33, 3, 130)])
def test_bwd_plan_keeps_the_tile_for_full_grids(shape):
    assert conv.bwd_plan(*shape, F32, 132) == (conv.TILE, 1, shape[3])


def test_bwd_plan_bfloat16_splits_nothing_but_takes_narrow():
    for shape, _ in UNDERFILLED:
        assert conv.bwd_plan(*shape, torch.bfloat16, 132) == (
            conv.TILE, 1, shape[3])
    assert conv.bwd_plan(1, 384, 512, 64, 3, torch.bfloat16, 132) == (
        conv.NARROW, 1, 64)


@pytest.mark.parametrize('shape', [s for s, _ in UNDERFILLED] + FULL_ENOUGH
                         + [(1, 48, 64, 72, 256), (2, 8, 8, 520, 64)])
@pytest.mark.parametrize('sms', [132, 66, 16])
def test_split_plan_covers_every_channel_once(shape, sms):
    path, splits, kspan = conv.bwd_plan(*shape, F32, sms)
    k = shape[3]
    owner = np.zeros(k, np.int32)
    for s in range(splits):
        owner[s * kspan:min(k, (s + 1) * kspan)] += 1
    assert (owner == 1).all()
    if path == conv.SPLIT:
        assert kspan % 8 == 0 and kspan >= 32 and (splits - 1) * kspan < k
    else:
        assert (splits, kspan) == (1, k)


def test_bwd_plan_follows_the_sm_count():
    """The same grid fills a card with fewer SMs in more whole waves: a
    96-block grid splits 4 ways on 132 SMs and not on 24 (four whole
    waves of 24)."""
    shape = (1, 48, 64, 512, 256)
    assert conv.bwd_plan(*shape, F32, 132)[:2] == (conv.SPLIT, 4)
    assert conv.bwd_plan(*shape, F32, 24) == (conv.TILE, 1, 512)


def test_split_sweep_covers_the_trunk_and_turns_splits_off():
    from style_transfer2_tpu_torch import split_sweep
    shapes = split_sweep.trunk_backward_shapes(384, 512)
    assert len(shapes) == 10 and shapes[0] == (384, 512, 64, 3)
    assert shapes[-1] == (48, 64, 512, 512)
    plan = split_sweep.without_splits(conv.bwd_plan)
    for shape, _ in UNDERFILLED:
        assert plan(*shape, F32, 132) == (conv.TILE, 1, shape[3])
    assert plan(1, 384, 512, 64, 3, F32, 132) == (conv.NARROW, 1, 64)
    assert plan(1, 96, 128, 256, 256, F32, 132) == conv.bwd_plan(
        1, 96, 128, 256, 256, F32, 132)


def test_backward_weights_flip_and_transpose():
    w = torch.from_numpy(np.float32(np.random.RandomState(0).randn(
        3, 3, 5, 7)))
    wt = conv.backward_weights(w)
    assert wt.shape == (3, 3, 7, 5) and wt.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(wt[dy, dx], w[2 - dy, 2 - dx].T)


def test_cpu_conv_ignores_the_backward_weights():
    x, w, b, g = _conv_case(10, (1, 6, 9, 16), 24)
    want = _plain_fwd_bwd(x, w, b, g)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    y = conv.conv3x3_bias_relu(xt, wt, torch.from_numpy(b),
                               conv.backward_weights(wt))
    dx = torch.autograd.grad(y, xt, torch.from_numpy(g))[0]
    np.testing.assert_array_equal(y.detach().numpy(), want[0])
    np.testing.assert_array_equal(dx.numpy(), want[1])


def test_build_dir_is_keyed_by_sources():
    d = _build.build_dir()
    assert d == _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert {p.name for p in _build._sources()} == {'conv3x3.cu', 'image.cu',
                                                  'style.cu'}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()
