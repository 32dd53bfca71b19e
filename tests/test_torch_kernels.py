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
from style_transfer2_tpu_torch import _build, split_sweep
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
    def counts():
        return conv.launches('fwd'), conv.launches('bwd'), style.launches

    before = counts()
    x, w, b, g = _conv_case(5, (1, 5, 7, 3), 64)
    _plain_fwd_bwd(x, w, b, g)
    style.fused_style_branch(torch.ones(1, 3, 5, 8), torch.zeros(8, 8))
    assert counts() == before


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


BF16 = torch.bfloat16


@pytest.mark.parametrize('shape', [
    (1, 384, 512, 64, 64), (1, 192, 256, 128, 128), (1, 136, 181, 256, 256),
    (1, 768, 1024, 64, 64), (1, 192, 256, 256, 256), (1, 68, 91, 512, 512),
    (1, 384, 512, 64, 3), (1, 768, 1024, 64, 3)])
def test_bwd_plan_bfloat16_splits_nothing_but_takes_narrow(shape):
    """At grids of most of a wave or more the bf16 backward takes the
    wgmma kernel unsplit; conv1_1's dx (3 channels) takes the narrow
    kernel."""
    path = conv.bwd_plan(*shape, BF16, 132)
    if shape[4] <= 8:
        assert path == (conv.NARROW, 1, shape[3])
    else:
        assert path == (conv.WGMMA, 1, shape[3])


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


# Every float32 forward shape of the 512px path (the 384x512 iterate and
# the 410x512 style image to conv5_1) and of the 1024px ladder's 543x724
# and 768x1024 rungs.
STYLE_FORWARDS = split_sweep.trunk_convs(410, 512) + [(26, 32, 512, 512)]
FORWARDS = sorted({s for hw in ((384, 512), (543, 724), (768, 1024))
                   for s in split_sweep.trunk_convs(*hw)}
                  | set(STYLE_FORWARDS))


@pytest.mark.parametrize('shape', FORWARDS)
@pytest.mark.parametrize('sms', [132, 66, 16])
def test_fwd_plan_covers_every_input_channel_once(shape, sms):
    path, splits, kspan = conv.fwd_plan(1, *shape, F32, sms)
    cin = shape[2]
    owner = np.zeros(cin, np.int32)
    for s in range(splits):
        owner[s * kspan:min(cin, (s + 1) * kspan)] += 1
    assert (owner == 1).all()
    assert (splits - 1) * kspan < cin <= splits * kspan
    if path == conv.SPLIT:
        assert splits >= 2 and kspan % conv._KC == 0 and kspan >= 32
    else:
        assert (splits, kspan) == (1, cin)
    if cin % 4:
        assert path == conv.SCALAR


# The 512px conv4 forwards and the style image's conv5_1: grids of 96 and
# 16 blocks of 16 x 16 pixels by 64 channels on a 132-SM card.
FWD_UNDERFILLED = [(48, 64, 256, 512), (48, 64, 512, 512), (26, 32, 512, 512)]
# The 768x1024 iterate's shallow forwards: thousands of blocks.
FWD_SHALLOW_1024 = [s for s in split_sweep.trunk_convs(768, 1024)
                    if s[3] <= 256 and s[2] % 4 == 0]


@pytest.mark.parametrize('shape', FWD_UNDERFILLED)
def test_fwd_plan_splits_the_underfilled_grids(shape):
    path, splits, kspan = conv.fwd_plan(1, *shape, F32, 132)
    assert path == conv.SPLIT and splits >= 2 and kspan % 8 == 0


@pytest.mark.parametrize('shape', FWD_SHALLOW_1024)
def test_fwd_plan_keeps_the_tile_for_full_grids(shape):
    assert conv.fwd_plan(1, *shape, F32, 132) == (conv.TILE, 1, shape[2])


@pytest.mark.parametrize('shape', [(384, 512, 3, 64), (768, 1024, 3, 64),
                                   (9, 33, 130, 3), (11, 20, 42, 24)])
def test_fwd_plan_takes_the_scalar_path_unless_channels_come_in_fours(shape):
    assert conv.fwd_plan(1, *shape, F32, 132) == (conv.SCALAR, 1, shape[2])


@pytest.mark.parametrize('shape', FWD_SHALLOW_1024 + [
    (543, 724, 64, 64), (272, 362, 128, 128), (136, 181, 256, 256),
    (68, 91, 512, 512), (192, 256, 256, 256)])
def test_fwd_plan_bfloat16_never_splits(shape):
    """At grids of most of a wave or more the bf16 forward never splits:
    the wgmma kernel, unsplit."""
    assert conv.fwd_plan(1, *shape, BF16, 132) == (conv.WGMMA, 1, shape[2])


def _ladder_forwards():
    """(H, W, Cin, Cout) of every forward of the 1024px ladder's 7 rungs."""
    rungs = [(96, 128), (136, 181), (192, 256), (272, 362), (384, 512),
             (543, 724), (768, 1024)]
    return sorted({s for hw in rungs for s in split_sweep.trunk_convs(*hw)})


BF16_FORWARDS = sorted(set(FORWARDS) | set(_ladder_forwards()))


def _wgmma_blocks(h, w, cout):
    return (-(-h // conv._WG_TH) * -(-w // conv._WG_TW)
            * -(-cout // conv.wgmma_bn(cout)))


@pytest.mark.parametrize('shape', BF16_FORWARDS)
@pytest.mark.parametrize('direction', ['fwd', 'bwd'])
def test_bf16_plans_at_every_main_path_ladder_and_style_shape(shape,
                                                              direction):
    """Every bf16 conv of the 512px path, the style image and the 1024px
    ladder: conv1_1 (3 channels) on the mma.sync forward and the narrow
    backward, every other shape on the wgmma kernel, split only where its
    grid fills less than one wave of the 132-SM card or ends in a wave
    that leaves half of it idle, each split's ranges a multiple of 16
    channels covering the summed channels once."""
    h, w, cin, cout = shape
    if direction == 'fwd':
        path, splits, kspan = conv.fwd_plan(1, h, w, cin, cout, BF16, 132)
        k, out = cin, cout
    else:
        path, splits, kspan = conv.bwd_plan(1, h, w, cout, cin, BF16, 132)
        k, out = cout, cin
    if out <= 8 and direction == 'bwd':
        assert (path, splits, kspan) == (conv.NARROW, 1, k)
    elif k % 8:
        assert (path, splits, kspan) == (conv.TILE, 1, k)
    elif (_wgmma_blocks(h, w, out) >= 132
          and not 0 < _wgmma_blocks(h, w, out) % 132 <= 66):
        assert (path, splits, kspan) == (conv.WGMMA, 1, k)
    else:
        assert path in (conv.WGMMA, conv.WGMMA_SPLIT)
    if path == conv.WGMMA_SPLIT:
        assert splits >= 2 and kspan % 16 == 0 and kspan >= 32
        assert (splits - 1) * kspan < k <= splits * kspan
    else:
        assert (splits, kspan) == (1, k)


# The 512px conv4 forwards and backwards and the style image's conv4_x and
# conv5_1: grids of 16 to 96 blocks of 16 x 16 pixels by 128 channels on a
# 132-SM card, (H, W, summed channels, output channels).
BF16_UNDERFILLED = [(48, 64, 256, 512), (48, 64, 512, 512),
                    (52, 64, 512, 512), (26, 32, 512, 512),
                    (48, 64, 512, 256)]


@pytest.mark.parametrize('shape', BF16_UNDERFILLED)
@pytest.mark.parametrize('plan', ['fwd_plan', 'bwd_plan'])
def test_bf16_plan_splits_the_underfilled_grids(shape, plan):
    path, splits, kspan = getattr(conv, plan)(1, *shape, BF16, 132)
    assert path == conv.WGMMA_SPLIT and splits >= 2 and kspan % 16 == 0


@pytest.mark.parametrize('plan', ['fwd_plan', 'bwd_plan'])
def test_bf16_plan_follows_the_sm_count(plan):
    """The 48-block grid of the 512px conv4_2 splits on 132 SMs and not on
    24, which it fills in two whole waves."""
    shape = (1, 48, 64, 512, 512)
    assert getattr(conv, plan)(*shape, BF16, 132)[0] == conv.WGMMA_SPLIT
    assert getattr(conv, plan)(*shape, BF16, 24) == (conv.WGMMA, 1, 512)


@pytest.mark.parametrize('shape', [(384, 512, 3, 64), (410, 512, 3, 64),
                                   (37, 45, 20, 64), (19, 21, 64, 12),
                                   (9, 33, 130, 24)])
def test_bf16_plan_takes_mma_sync_unless_channels_come_in_eights(shape):
    """conv1_1 (Cin = 3), Cin or Cout not a multiple of 8: the mma.sync
    tile kernel, which takes any shape."""
    assert conv.fwd_plan(1, *shape, BF16, 132) == (conv.TILE, 1, shape[2])
    h, w, cin, cout = shape
    if cin > 8:
        assert conv.bwd_plan(1, h, w, cout, cin, BF16, 132) == (
            conv.TILE, 1, cout)


@pytest.mark.parametrize('cin,cout', [(64, 64), (40, 24), (512, 256),
                                      (3, 128), (128, 136)])
def test_wgmma_weights_block_each_slice_in_stage_order(cin, cout):
    """wgmma_weights(w)[cb, ks, dy, dx, kb, nb, r, c] is w[dy, dx, 16 ks +
    8 kb + r, BN cb + 8 nb + c], zero past Cin and Cout."""
    w = torch.from_numpy(np.float32(np.random.RandomState(cin).randn(
        3, 3, cin, cout)))
    bn = conv.wgmma_bn(cout)
    wb = conv.wgmma_weights(w)
    assert wb.shape == (-(-cout // bn), -(-cin // 16), 3, 3, 2, bn // 8, 8,
                        8) and wb.is_contiguous()
    cb, ks, dy, dx, kb, nb, r, c = np.meshgrid(
        *[np.arange(n) for n in wb.shape], indexing='ij')
    k = 16 * ks + 8 * kb + r
    n = bn * cb + 8 * nb + c
    inside = (k < cin) & (n < cout)
    want = np.zeros(wb.shape, np.float32)
    want[inside] = w.numpy()[dy[inside], dx[inside], k[inside], n[inside]]
    np.testing.assert_array_equal(wb.numpy(), want)


def test_wgmma_weights_are_blocked_once_per_tensor():
    w = torch.zeros(3, 3, 16, 64)
    first = conv._wgmma_weights(w)
    assert conv._wgmma_weights(w) is first
    assert conv._wgmma_weights(torch.zeros(3, 3, 16, 64)) is not first
    w.add_(1.0)                 # an in-place update makes the copy stale
    second = conv._wgmma_weights(w)
    assert second is not first and float(second.max()) == 1.0
    assert conv._wgmma_weights(w) is second


def test_fwd_plan_follows_the_sm_count():
    """A 96-block grid (the 512px conv4_2) splits on 132 SMs and not on
    24, which it fills in four whole waves."""
    shape = (1, 48, 64, 512, 512)
    assert conv.fwd_plan(*shape, F32, 132)[0] == conv.SPLIT
    assert conv.fwd_plan(*shape, F32, 24) == (conv.TILE, 1, 512)


def test_split_sweep_covers_the_forwards():
    assert sorted(split_sweep.forward_shapes()) == FORWARDS
    plans = split_sweep.split_plans(512)
    assert sorted(plans) == list(range(1, conv._MAX_SPLITS + 1))
    assert plans[1] == (conv.TILE, 1, 512)
    for splits, (path, got, kspan) in plans.items():
        assert got == splits and (splits - 1) * kspan < 512 <= splits * kspan
    unsplit = split_sweep.without_splits(conv.fwd_plan)
    for shape in FWD_UNDERFILLED:
        assert unsplit(1, *shape, F32, 132) == (conv.TILE, 1, shape[2])


def test_ab_compare_reports_each_group_and_the_step_sums(tmp_path):
    """Two synthetic chip_smoke runs: the tree's forward 10% slower at one
    512px step's shapes, its backward and style rows as the parent's."""
    import json
    from style_transfer2_tpu_torch import ab_compare
    step = split_sweep.trunk_convs(384, 512)

    def run(name, fwd_ms):
        rows = [{'kernel': 'conv3x3', 'dtype': 'float32', 'where': '512',
                 'shape': list(s), 'fwd_ms': fwd_ms, 'bwd_ms': 2.0,
                 'fwd_library_ms': 1.5} for s in dict.fromkeys(step)]
        rows.append({'kernel': 'fused_style_branch', 'dtype': 'float32',
                     'where': '512', 'shape': [384, 512, 64], 'ms': 0.5})
        path = tmp_path / name
        path.write_text(json.dumps(rows))
        return str(path)

    tree = ab_compare.load([run('t1', 1.1), run('t2', 1.1)])
    parent = ab_compare.load([run('p1', 1.0)])
    groups = {g['field']: g for g in ab_compare.compare(tree, parent, 1.03)}
    assert groups['fwd_ms']['rows'] == len(set(step)) == 8
    assert abs(groups['fwd_ms']['worst'] - 1.1) < 1e-12
    assert len(groups['fwd_ms']['above_limit']) == 8
    assert groups['bwd_ms']['above_limit'] == groups['ms']['above_limit'] == []
    sums = ab_compare.step_sums(tree)['float32']['512']
    assert len(step) == 10
    np.testing.assert_allclose(sums['fwd_ms'], [11.0, 11.0])
    np.testing.assert_allclose(sums['bwd_ms'], [20.0, 20.0])
    assert sums['fwd_device_ms'] is None          # not in these runs
    assert abs(groups['fwd_ms']['sum_ratio'] - 1.1) < 1e-12
    assert groups['fwd_ms']['parent_sum'] == 8.0


def test_ab_compare_sums_device_times_and_skips_unmeasured_rows(tmp_path):
    """device_ms rows: one row the parent's profile missed (None) leaves
    its group; the group sums hold the rest."""
    import json
    from style_transfer2_tpu_torch import ab_compare
    shapes = list(dict.fromkeys(split_sweep.trunk_convs(384, 512)))

    def run(name, dev, missing=None):
        rows = [{'kernel': 'conv3x3', 'dtype': 'bfloat16', 'where': '512',
                 'shape': list(s), 'fwd_ms': 1.0, 'bwd_ms': 1.0,
                 'fwd_device_ms': None if s == missing else dev,
                 'bwd_device_ms': dev, 'fwd_host_us': 25.0,
                 'bwd_host_us': 25.0} for s in shapes]
        path = tmp_path / name
        path.write_text(json.dumps(rows))
        return str(path)

    tree = ab_compare.load([run('t', 0.5)])
    parent = ab_compare.load([run('p', 1.0, missing=shapes[0])])
    groups = {g['field']: g for g in ab_compare.compare(tree, parent, 1.03)}
    assert groups['fwd_device_ms']['rows'] == len(shapes) - 1
    assert groups['bwd_device_ms']['rows'] == len(shapes)
    assert abs(groups['bwd_device_ms']['sum_ratio'] - 0.5) < 1e-12
    assert groups['fwd_host_us']['sum_ratio'] == 1.0
    sums = ab_compare.step_sums(tree)['bfloat16']['512']
    np.testing.assert_allclose(sums['bwd_device_ms'], [5.0, 5.0])
    assert ab_compare.step_sums(parent)['bfloat16']['512'][
        'fwd_device_ms'] is None


def test_split_sweep_fit_scores_each_constant_and_restores_them():
    shape = [48, 64, 512, 512]
    before = conv.fwd_plan(1, *shape, F32, 132)
    assert before[:2] == (conv.SPLIT, 4)
    times = {str(s): 1.0 + 0.01 * s for s in split_sweep.split_plans(512)}
    times['4'] = 0.5
    lines = [{'kind': 'fwd (H, W, Cin, Cout)', 'shape': shape, 'sms': 132,
              'ms_by_splits': times}]
    rows = [r for r in split_sweep.fit(lines) if r['kind'] == 'fwd']
    assert len(rows) == 2 * len(split_sweep.FIT_OVERHEADS)
    chosen = [r for r in rows if r['resident'] == conv._FWD_RESIDENT
              and r['overhead'] == conv._FWD_SPLIT_OVERHEAD]
    assert chosen[0]['planned_ms'] == chosen[0]['fastest_ms'] == 0.5
    assert min(r['planned_ms'] for r in rows) == 0.5
    assert conv.fwd_plan(1, *shape, F32, 132) == before


def test_split_sweep_covers_the_trunk_and_turns_splits_off():
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
    assert {p.name for p in _build._sources()} == {
        'conv3x3.cu', 'conv3x3_wgmma.cu', 'epilogue.cu', 'image.cu',
        'pool.cu', 'reduce.cu', 'style.cu'}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()
