"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here carries the `cuda` marker and skips where CUDA is
not available. The file imports neither jax nor the JAX package, so it also
runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from style_transfer2_tpu_torch.ops import conv, image, style
from style_transfer2_tpu_torch.ops.resample import resize_nhwc
from style_transfer2_tpu_torch.utils import tf32

# The 1024px ladder's rungs (utils.scales((768, 1024), min_size=96)).
LADDER_1024 = [(96, 128), (136, 181), (192, 256), (272, 362), (384, 512),
               (543, 724), (768, 1024)]


def _conv_case(seed, shape, cout):
    rng = np.random.RandomState(seed)
    x = np.float32(rng.randn(*shape))
    w = np.float32(rng.randn(3, 3, shape[-1], cout) * 0.1)
    b = np.float32(rng.randn(cout) * 0.1)
    g = np.float32(rng.randn(*shape[:3], cout))
    return x, w, b, g


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA is not available here)')
    with tf32(False):           # the plain versions in full float32
        yield torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize('shape,cout', [((1, 13, 29, 3), 64),
                                        ((2, 7, 17, 64), 96),
                                        ((1, 9, 33, 130), 3),
                                        ((1, 11, 20, 40), 24)])
def test_conv_kernels_match_plain_on_card(cuda, shape, cout, dtype, tol):
    x, w, b, g = _conv_case(6, shape, cout)
    xt, wt, bt, gt = (torch.from_numpy(a).to(cuda, dtype)
                      for a in (x, w, b, g))
    before = (conv.launches('fwd'), conv.launches('bwd'))
    xk = xt.clone().requires_grad_(True)
    y = conv.conv3x3_bias_relu(xk, wt, bt, conv.backward_weights(wt))
    dx = torch.autograd.grad(y, xk, gt)[0]
    assert (conv.launches('fwd'), conv.launches('bwd')) == (
        before[0] + 1, before[1] + 1)
    x32 = xt.float().requires_grad_(True)
    y_ref = conv.conv3x3_bias_relu_plain(x32, wt.float(), bt.float())
    # The backward is held against autograd of the plain pre-ReLU conv with
    # the cotangent masked by the kernel's own forward (an activation within
    # rounding of zero may fall on either side of the ReLU).
    pre = F.conv2d(x32.permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1),
                   bt.float(), padding=1).permute(0, 2, 3, 1)
    dx_ref = torch.autograd.grad(pre, x32, gt.float() * (y > 0).float())[0]
    for got, want in ((y, y_ref), (dx, dx_ref)):
        got, want = got.detach().float(), want.detach()
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_conv_kernels_take_unaligned_views(cuda):
    """A bf16 view that starts one element into its storage is not 16-byte
    aligned; the mma.sync kernel stages it one element at a time rather
    than fault on a 16-byte load."""
    x, w, b, g = _conv_case(8, (1, 6, 10, 16), 16)
    flat = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(
        np.float32)).to(cuda, torch.bfloat16)
    xv = flat[1:].view(x.shape)
    assert xv.data_ptr() % 16 != 0
    wt, bt, gt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (w, b, g))
    xk = xv.detach().requires_grad_(True)
    y = conv.conv3x3_bias_relu(xk, wt, bt, conv.backward_weights(wt))
    dx = torch.autograd.grad(y, xk, gt)[0]
    y_ref = conv.conv3x3_bias_relu_plain(xv.float(), wt.float(), bt.float())
    assert float((y.float() - y_ref).abs().max()) <= 3e-2 * max(
        1.0, float(y_ref.abs().max()))
    assert torch.isfinite(dx.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 7, 9, 128), (1, 40, 33, 64),
                                   (1, 5, 6, 3)])
def test_style_kernel_matches_plain_on_card(cuda, shape):
    rng = np.random.RandomState(7)
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(*shape)))).to(
        cuda)
    gram_style = torch.from_numpy(np.float32(rng.rand(shape[-1],
                                                      shape[-1]))).to(cuda)
    before = style.launches
    s, gd = style.fused_style_branch(feat, gram_style)
    assert style.launches == before + 1
    s_ref, gd_ref = style.fused_style_branch_plain(feat, gram_style)
    torch.testing.assert_close(gd, gd_ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(s, s_ref, rtol=1e-4,
                               atol=1e-4 * float(s_ref.abs().max()))


def _masked_bwd_case(cuda, shape, cout, seed):
    """(g, y, w) for a backward with the cotangent's channels shape[-1] and
    dx's cout: y is a ReLU output with about half its entries zero, so the
    mask matters."""
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(np.float32(rng.randn(*shape))).to(cuda)
    y = torch.relu(torch.from_numpy(np.float32(rng.randn(*shape)))).to(cuda)
    w = torch.from_numpy(np.float32(rng.normal(
        0, np.sqrt(2.0 / (9 * cout)), (3, 3, cout, shape[-1])))).to(cuda)
    return g, y, w


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout,path,dtype,tol', [
    ((1, 17, 181, 64), 3, conv.NARROW, torch.float32, 1e-4),
    ((1, 384, 512, 64), 3, conv.NARROW, torch.float32, 1e-4),
    ((1, 384, 512, 64), 3, conv.NARROW, torch.bfloat16, 3e-2),
    ((1, 48, 64, 512), 256, conv.SPLIT, torch.float32, 1e-4),
    ((1, 68, 91, 512), 256, conv.SPLIT, torch.float32, 1e-4),
])
def test_conv_backward_paths_match_plain_and_repeat(cuda, shape, cout,
                                                    path, dtype, tol):
    """The narrow and split backward kernels against autograd of the plain
    float32 conv (on the same, for bf16 bf16-valued, inputs) with the same
    mask, and bitwise equal from call to call."""
    g, y, w = (t.to(dtype) for t in _masked_bwd_case(cuda, shape, cout, 9))
    n, h, wd, k = shape
    plan = conv.bwd_plan(n, h, wd, k, cout, dtype,
                         torch.cuda.get_device_properties(
                             cuda).multi_processor_count)
    assert plan[0] == path
    before = conv.launches('bwd')
    dx = conv._launch_bwd(g, y, conv.backward_weights(w))
    dx2 = conv._launch_bwd(g, y, conv.backward_weights(w))
    assert conv.launches('bwd') == before + 2 and dx.dtype == dtype
    x = torch.zeros(n, h, wd, cout, device=cuda, requires_grad=True)
    pre = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1)
    want = torch.autograd.grad(pre.permute(0, 2, 3, 1), x,
                               g.float() * (y > 0).float())[0]
    err = float((dx.float() - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max()))
    assert torch.equal(dx, dx2)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 97, 53, 64), (1, 45, 37, 128),
                                   (1, 23, 29, 256), (1, 11, 13, 512)])
def test_style_kernel_ragged_rows_match_plain_and_repeat(cuda, shape):
    """Each tap width at an M that is no multiple of the 16-row stage or
    of the 64-row tile; two calls give the same bits."""
    rng = np.random.RandomState(shape[-1])
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(*shape)))).to(
        cuda)
    other = torch.relu(torch.from_numpy(np.float32(rng.randn(
        shape[1] * shape[2], shape[-1])))).to(cuda)
    gram_style = other.T @ other / other.numel()
    s, gd = style.fused_style_branch(feat, gram_style)
    s2, gd2 = style.fused_style_branch(feat, gram_style)
    s_ref, gd_ref = style.fused_style_branch_plain(feat, gram_style)
    scale = max(float(gd_ref.abs().max()), float(gram_style.abs().max()))
    assert float((gd - gd_ref).abs().max()) <= 1e-4 * scale
    assert float((s - s_ref).abs().max()) <= 1e-4 * float(
        s_ref.abs().max())
    assert torch.equal(s, s2) and torch.equal(gd, gd2)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('hw', LADDER_1024 + [(37, 41), (1, 1)])
def test_image_kernels_equal_plain_bitwise(cuda, hw, dtype):
    rng = np.random.RandomState(hw[0])
    img = (rng.randint(0, 256, hw + (3,)).astype(np.uint8)
           if dtype == np.uint8
           else np.float32(rng.uniform(-20, 275, hw + (3,))))
    before = (image.preprocess_launches, image.deprocess_launches)
    x = image.preprocess(img, cuda)
    assert x.is_cuda and x.shape == (1,) + hw + (3,)
    assert x.dtype == torch.float32
    torch.testing.assert_close(x, image.preprocess_plain(img, cuda),
                               rtol=0, atol=0)
    y = image.deprocess_on_device(x)
    assert y.is_cuda and y.data_ptr() != x.data_ptr()
    torch.testing.assert_close(y, image.deprocess_plain(x), rtol=0, atol=0)
    assert (image.preprocess_launches, image.deprocess_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_image_wrappers_never_take_the_plain_path_on_cuda(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError('plain version called for a CUDA tensor')

    monkeypatch.setattr(image, 'preprocess_plain', refuse)
    monkeypatch.setattr(image, 'deprocess_plain', refuse)
    before = (image.preprocess_launches, image.deprocess_launches)
    img = np.random.RandomState(0).randint(0, 256, (9, 11, 3)).astype(
        np.uint8)
    out = image.deprocess(image.preprocess(img, cuda))
    np.testing.assert_allclose(out, img, atol=1e-4)
    assert (image.preprocess_launches, image.deprocess_launches) == (
        before[0] + 1, before[1] + 1)


def _side_stream_input(cuda, host):
    """(stream, tensor): a side stream on which a long sleep and then the
    copy of `host` into a zeroed tensor are enqueued. A kernel launched on
    that stream after them reads `host`'s values; one launched on another
    stream would run during the sleep and read zeros."""
    src = torch.zeros_like(host)
    s = torch.cuda.Stream(cuda)
    s.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        src.copy_(host)
    return s, src


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_image_kernels_launch_on_the_current_stream(cuda, dtype):
    rng = np.random.RandomState(5)
    img = (rng.randint(0, 256, (543, 724, 3)).astype(np.uint8)
           if dtype == np.uint8
           else np.float32(rng.uniform(-20, 275, (543, 724, 3))))
    s, src = _side_stream_input(cuda, torch.from_numpy(img).to(cuda))
    with torch.cuda.stream(s):
        x = image._launch_preprocess(src)
        y = image._launch_deprocess(x)
    torch.cuda.synchronize()
    want = image.preprocess_plain(img, cuda)
    torch.testing.assert_close(x, want[0], rtol=0, atol=0)
    torch.testing.assert_close(y, image.deprocess_plain(want), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_image_kernels_take_unaligned_views(cuda, dtype):
    """Views that start one element into their storage are not 16-byte
    aligned: the plan gives no vector groups, and the scalar path alone
    gives the same bits."""
    rng = np.random.RandomState(6)
    img = (rng.randint(0, 256, (37, 41, 3)).astype(np.uint8)
           if dtype == np.uint8
           else np.float32(rng.uniform(-20, 275, (37, 41, 3))))
    flat = torch.from_numpy(np.concatenate([np.zeros(1, dtype),
                                            img.ravel()])).to(cuda)
    src = flat[1:].view(img.shape)
    assert src.data_ptr() % 16 != 0
    assert image.image_plan(src.numel(), False)[1] == 0
    x = image._launch_preprocess(src)
    want = image.preprocess_plain(img, cuda)
    torch.testing.assert_close(x, want[0], rtol=0, atol=0)
    xv = torch.cat([torch.zeros(1, device=cuda), want.reshape(-1)])[1:].view(
        want.shape)
    assert xv.data_ptr() % 16 != 0
    torch.testing.assert_close(image._launch_deprocess(xv),
                               image.deprocess_plain(want), rtol=0, atol=0)


@pytest.mark.cuda
def test_conv_forward_launches_on_the_current_stream(cuda):
    x, w, b, _ = _conv_case(12, (1, 24, 40, 64), 64)
    xt, wt, bt = (torch.from_numpy(a).to(cuda) for a in (x, w, b))
    want = conv._launch_fwd(xt, wt, bt)
    s, src = _side_stream_input(cuda, xt)
    with torch.cuda.stream(s):
        got = conv._launch_fwd(src, wt, bt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (x shape, Cout, plan) of the float32 forward on each of its paths, at odd
# H and W that no tile divides: the scalar path (Cin = 3); the tile path
# with 8 x 16 pixels by 128 channels (Cout = 96 fills 3/4 of it) and with
# 16 x 16 by 64, its last pass half-filled (Cin = 44); the split path with
# a ragged last range (76 = 32 + 32 + 12 channels); and fwd_plan's own
# split of the 512px conv4_2.
FWD_PATH_CASES = [((1, 13, 29, 3), 96, (conv.SCALAR, 1, 3)),
                  ((1, 37, 45, 64), 96, (conv.TILE, 1, 64)),
                  ((2, 19, 21, 44), 64, (conv.TILE, 1, 44)),
                  ((1, 37, 45, 76), 96, (conv.SPLIT, 3, 32)),
                  ((1, 48, 64, 512), 512, None)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout,plan', FWD_PATH_CASES)
def test_conv_forward_paths_match_plain_repeat_and_follow_the_stream(
        cuda, shape, cout, plan):
    x, w, b, _ = _conv_case(13, shape, cout)
    xt, wt, bt = (torch.from_numpy(a).to(cuda) for a in (x, w, b))
    if plan is None:
        assert conv.fwd_plan(*shape, cout, torch.float32, torch.cuda.
                             get_device_properties(cuda).multi_processor_count
                             )[0] == conv.SPLIT
    before = conv.launches('fwd')
    y = conv._launch_fwd(xt, wt, bt, plan)
    y2 = conv._launch_fwd(xt, wt, bt, plan)
    assert conv.launches('fwd') == before + 2
    want = conv.conv3x3_bias_relu_plain(xt, wt, bt)
    assert float((y - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(y, y2)
    s, src = _side_stream_input(cuda, xt)
    with torch.cuda.stream(s):
        got = conv._launch_fwd(src, wt, bt, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, y)


@pytest.mark.cuda
def test_conv_forward_unaligned_view_takes_the_scalar_path(cuda,
                                                           monkeypatch):
    """A float32 view that starts one element into its storage is not
    16-byte aligned: the wrapper launches the scalar path for it, which
    matches the plain version."""
    x, w, b, _ = _conv_case(14, (1, 9, 19, 64), 128)
    flat = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(
        np.float32)).to(cuda)
    xv = flat[1:].view(x.shape)
    assert xv.data_ptr() % 16 != 0
    wt, bt = (torch.from_numpy(a).to(cuda) for a in (w, b))
    lib, paths = conv._build.lib(), []

    class Spy:
        def st2_conv3x3_fwd(self, *args):
            paths.append(args[1])
            return lib.st2_conv3x3_fwd(*args)

    monkeypatch.setattr(conv._build, 'lib', Spy)
    y = conv._launch_fwd(xv, wt, bt)
    assert paths == [conv._PATH_CODES[conv.SCALAR]]
    want = conv.conv3x3_bias_relu_plain(xv, wt, bt)
    assert float((y - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('method', ['lanczos3', 'bilinear'])
@pytest.mark.parametrize('src,dst', [((543, 724), (768, 1024)),
                                     ((17, 23), (24, 33)),
                                     ((136, 181), (96, 128))])
def test_resize_on_card_keeps_tf32_off(cuda, src, dst, method):
    """float32_fast turns TF32 on around an engine's work; resize_nhwc must
    still contract in full float32, as jax.image.resize does at
    Precision.HIGHEST. A TF32 contraction misses by ~0.1 on this scale."""
    x = np.float32(np.random.RandomState(1).uniform(0, 255,
                                                    (1,) + src + (3,)))
    want = resize_nhwc(torch.from_numpy(x), dst, method)
    with tf32(True):
        got = resize_nhwc(torch.from_numpy(x).to(cuda), dst, method)
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-3)


def _sms(cuda):
    return torch.cuda.get_device_properties(cuda).multi_processor_count


# (x or g shape, Cout, plan) of the bf16 wgmma kernel on each of its paths
# at ragged shapes: odd H, W = 181 and 91 (no 16-pixel tile divides them),
# Cin 40 (a half-filled last slice) to 512, Cout 24 and 64 (BN = 64, Cout
# 24 filling part of it) and 128 to 512 (BN = 128); a split with a ragged
# last range (512 = 176 + 176 + 160); and the planners' own splits of the
# 512px conv4_2 (plan None).
WGMMA_CASES = [((1, 17, 181, 64), 128, (conv.WGMMA, 1, 64)),
               ((1, 35, 91, 256), 256, (conv.WGMMA, 1, 256)),
               ((2, 13, 45, 512), 64, (conv.WGMMA, 1, 512)),
               ((1, 9, 33, 40), 24, (conv.WGMMA, 1, 40)),
               ((1, 21, 91, 512), 512, (conv.WGMMA_SPLIT, 3, 176)),
               ((1, 48, 64, 512), 512, None)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout,plan', WGMMA_CASES)
def test_bf16_wgmma_forward_matches_plain_repeats_and_follows_the_stream(
        cuda, shape, cout, plan):
    x, w, b, _ = _conv_case(15, shape, cout)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (x, w, b))
    if plan is None:
        assert conv.fwd_plan(*shape, cout, torch.bfloat16, _sms(cuda))[
            0] == conv.WGMMA_SPLIT
    before = conv.path_launches.get(('fwd', (plan or [conv.WGMMA_SPLIT])[0]),
                                    0)
    y = conv._launch_fwd(xt, wt, bt, plan)
    y2 = conv._launch_fwd(xt, wt, bt, plan)
    assert conv.path_launches[('fwd', (plan or [conv.WGMMA_SPLIT])[0])] == (
        before + 2)
    want = conv.conv3x3_bias_relu_plain(xt.float(), wt.float(), bt.float())
    assert y.dtype == torch.bfloat16
    assert float((y.float() - want).abs().max()) <= 3e-2 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(y, y2)
    s, src = _side_stream_input(cuda, xt)
    with torch.cuda.stream(s):
        got = conv._launch_fwd(src, wt, bt, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, y)


# The same for the masked backward: (g shape, dx's Cout, plan).
WGMMA_BWD_CASES = [((1, 17, 181, 128), 64, (conv.WGMMA, 1, 128)),
                   ((1, 35, 91, 512), 256, (conv.WGMMA, 1, 512)),
                   ((1, 9, 33, 40), 24, (conv.WGMMA, 1, 40)),
                   ((1, 21, 91, 512), 512, (conv.WGMMA_SPLIT, 4, 128)),
                   ((1, 48, 64, 512), 512, None)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout,plan', WGMMA_BWD_CASES)
def test_bf16_wgmma_backward_matches_plain_repeats_and_follows_the_stream(
        cuda, shape, cout, plan):
    g, y, w = (t.to(torch.bfloat16)
               for t in _masked_bwd_case(cuda, shape, cout, 16))
    n, h, wd, k = shape
    if plan is None:
        assert conv.bwd_plan(n, h, wd, k, cout, torch.bfloat16,
                             _sms(cuda))[0] == conv.WGMMA_SPLIT
    wt = conv.backward_weights(w)
    dx = conv._launch_bwd(g, y, wt, plan)
    dx2 = conv._launch_bwd(g, y, wt, plan)
    x = torch.zeros(n, h, wd, cout, device=cuda, requires_grad=True)
    pre = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1)
    want = torch.autograd.grad(pre.permute(0, 2, 3, 1), x,
                               g.float() * (y > 0).float())[0]
    assert dx.dtype == torch.bfloat16
    assert float((dx.float() - want).abs().max()) <= 3e-2 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(dx, dx2)
    s, src = _side_stream_input(cuda, g)
    with torch.cuda.stream(s):
        got = conv._launch_bwd(src, y, wt, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, dx)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_split_launches_back_to_back_keep_their_partials_apart(cuda, dtype):
    """Split launches of two sizes queued on one stream with no sync
    between them (the caching allocator hands each the partials block the
    one before freed; stream order keeps them apart) give the bits each
    gives launched alone."""
    split = conv.SPLIT if dtype == torch.float32 else conv.WGMMA_SPLIT
    cases = []
    for seed, (shape, cout, splits, kspan) in enumerate(
            (((1, 21, 91, 512), 256, 4, 128), ((1, 9, 33, 128), 64, 2, 64))):
        x, w, b, _ = _conv_case(20 + seed, shape, cout)
        cases.append(tuple(torch.from_numpy(a).to(cuda, dtype)
                           for a in (x, w, b)) + ((split, splits, kspan),))
    alone = []
    for x, w, b, plan in cases:
        alone.append(conv._launch_fwd(x, w, b, plan))
        torch.cuda.synchronize()
    queued = [conv._launch_fwd(x, w, b, plan)
              for x, w, b, plan in cases + cases[:1]]
    torch.cuda.synchronize()
    for got, want in zip(queued, alone + alone[:1]):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('direction', ['fwd', 'bwd'])
def test_bf16_unaligned_view_takes_the_tile_path(cuda, monkeypatch,
                                                 direction):
    """A bf16 view one element into its storage is not 16-byte aligned: the
    wrapper launches the mma.sync tile path for it instead of the wgmma
    kernel the shape plans, and the result matches the plain version."""
    x, w, b, g = _conv_case(17, (1, 19, 37, 64), 128)
    flat = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(
        np.float32)).to(cuda, torch.bfloat16)
    xv = flat[1:].view(x.shape)
    assert xv.data_ptr() % 16 != 0
    wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (w, b))
    assert conv.fwd_plan(*x.shape, 128, torch.bfloat16, _sms(cuda))[0] in (
        conv.WGMMA, conv.WGMMA_SPLIT)
    lib, paths = conv._build.lib(), []
    name = 'st2_conv3x3_' + direction

    class Spy:
        def __getattr__(self, attr):
            fn = getattr(lib, attr)
            if attr != name:
                return fn

            def spy(*args):
                paths.append(args[1])
                return fn(*args)
            return spy

    monkeypatch.setattr(conv._build, 'lib', Spy)
    if direction == 'fwd':
        got = conv._launch_fwd(xv, wt, bt).float()
        want = conv.conv3x3_bias_relu_plain(xv.float(), wt.float(),
                                            bt.float())
    else:
        # g: 64 cotangent channels, the unaligned view; y: a ReLU output;
        # dx: 128 channels through wt (3, 3, 64, 128).
        y = torch.relu(xv.float() + 0.1).to(torch.bfloat16)
        got = conv._launch_bwd(xv, y, wt).float()
        x0 = torch.zeros(1, 19, 37, 128, device=cuda, requires_grad=True)
        w_fwd = conv.backward_weights(wt).float()     # (3, 3, 128, 64)
        pre = F.conv2d(x0.permute(0, 3, 1, 2), w_fwd.permute(3, 2, 0, 1),
                       padding=1)
        want = torch.autograd.grad(pre.permute(0, 2, 3, 1), x0,
                                   xv.float() * (y > 0).float())[0]
    assert paths == [conv._PATH_CODES[conv.TILE]]
    assert float((got - want).abs().max()) <= 3e-2 * max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_serve_driver_runs_on_card(cuda, precision):
    """The serving driver at 64px on the card, a single step and then
    pipelined chunks: its engine is on CUDA, the iterates are finite and
    every kernel was launched (the style branch: the fused float32 kernel,
    or in bfloat16 the loss feed's bf16 phases)."""
    import asyncio
    from pathlib import Path

    import yaml

    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.serve import messages as m
    from style_transfer2_tpu_torch.serve.driver import Driver

    root = Path(__file__).resolve().parents[1]
    weights, scalars = yaml.safe_load(
        (root / 'initial_weights.yaml').read_text())
    rng = np.random.RandomState(0)
    content, style_img, inp = (rng.randint(0, 256, (64, 64, 3)).astype(
        np.uint8) for _ in range(3))

    def launches():
        return (conv.launches('fwd'), conv.launches('bwd'),
                style.launches + style.gram_bf16_launches,
                image.preprocess_launches, image.deprocess_launches)

    before = launches()

    async def body():
        driver = Driver(random_params(0), precision=precision,
                        device='cuda', adaptive_max_steps=4,
                        pipeline_depth=2)
        task = asyncio.ensure_future(driver.run())
        await driver.in_queue.put(m.SetWeights(weights, scalars))
        await driver.in_queue.put(m.SetImages(None, inp, content, style_img,
                                              True))
        await driver.in_queue.put(m.SetOptimizer('lbfgs'))
        await driver.in_queue.put(m.StartIteration())
        iterates = []
        while len(iterates) < 6:
            msg = await asyncio.wait_for(driver.out_queue.get(), 300)
            if isinstance(msg, m.Iterate):
                iterates.append(msg)
        await driver.in_queue.put(m.Shutdown())
        await task
        return driver, iterates

    driver, iterates = asyncio.run(body())
    assert driver.transfer.device.type == 'cuda'
    assert [it.i for it in iterates] == list(range(1, 7))
    assert all(np.isfinite(it.trace['loss']) for it in iterates)
    assert iterates[-1].image.shape == (64, 64, 3)
    assert all(n > b for n, b in zip(launches(), before)), (before,
                                                            launches())


# The four style taps of the 512px iterate (conv1_1 .. conv4_1).
STYLE_TAPS_512 = [(384, 512, 64), (192, 256, 128), (96, 128, 256),
                  (48, 64, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize('tap', STYLE_TAPS_512)
def test_style_kernel_lanes_match_plain_and_repeat(cuda, tap):
    """The style branch with a lane axis: four lanes in one launch
    sequence against the plain version (two matmuls a lane), the same
    bits on a second call, and each lane within the same tolerance of the
    one-map kernel on that lane alone."""
    h, w, c = tap
    rng = np.random.RandomState(c)
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(4, h, w, c)))
                      ).to(cuda)
    other = torch.relu(torch.from_numpy(np.float32(rng.randn(4, h * w, c)))
                       ).to(cuda)
    grams = torch.bmm(other.transpose(1, 2), other) / (h * w * c)
    before = style.launches
    s, gd = style.fused_style_branch(feat, grams)
    assert style.launches == before + 1
    s2, gd2 = style.fused_style_branch(feat, grams)
    assert torch.equal(s, s2) and torch.equal(gd, gd2)
    s_ref, gd_ref = style.fused_style_branch_plain(feat, grams)
    torch.testing.assert_close(gd, gd_ref, rtol=1e-4,
                               atol=1e-4 * float(grams.abs().max()))
    torch.testing.assert_close(s, s_ref, rtol=1e-4,
                               atol=1e-4 * float(s_ref.abs().max()))
    for lane in range(4):
        s1, gd1 = style.fused_style_branch(feat[lane:lane + 1], grams[lane])
        torch.testing.assert_close(gd[lane], gd1, rtol=1e-4,
                                   atol=1e-4 * float(grams.abs().max()))
        torch.testing.assert_close(s[lane], s1[0], rtol=1e-4,
                                   atol=1e-4 * float(s1.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize('shape,cout', [((4, 384, 512, 3), 64),
                                        ((4, 192, 256, 128), 128),
                                        ((4, 96, 128, 128), 256),
                                        ((4, 48, 64, 512), 512)])
def test_conv_kernels_at_four_lanes_match_cudnn(cuda, shape, cout, dtype,
                                                tol):
    """The conv kernels at N = 4, the batched engine's trunk, against cuDNN
    in float32 with TF32 off: the forward against conv2d with the bias and
    the ReLU, the backward against conv2d's input gradient of the
    cotangent masked by the kernel's own forward."""
    x, w, b, g = _conv_case(11, shape, cout)
    xt, wt, bt, gt = (torch.from_numpy(a).to(cuda, dtype)
                      for a in (x, w, b, g))
    xk = xt.clone().requires_grad_(True)
    y = conv.conv3x3_bias_relu(xk, wt, bt, conv.backward_weights(wt))
    dx = torch.autograd.grad(y, xk, gt)[0]
    x_c = xt.float().permute(0, 3, 1, 2)
    w_c = wt.float().permute(3, 2, 0, 1)
    y_ref = torch.relu(F.conv2d(x_c, w_c, bt.float(), padding=1)).permute(
        0, 2, 3, 1)
    g_c = (gt.float() * (y > 0).float()).permute(0, 3, 1, 2)
    dx_ref = torch.nn.grad.conv2d_input(x_c.shape, w_c, g_c,
                                        padding=1).permute(0, 2, 3, 1)
    for got, want in ((y, y_ref), (dx, dx_ref)):
        err = float((got.float() - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_batched_engine_on_card_matches_cpu(cuda, optimizer):
    """A 2-lane BatchedStyleTransfer on the card against the same on the
    CPU (the plain versions), an inactive lane between them: every trace
    key within the golden rtol over single steps and a chunk, and every
    kernel launched."""
    from style_transfer2_tpu_torch.engine.batched import (
        BatchedStyleTransfer)
    from style_transfer2_tpu_torch.models import random_params
    weights = {'content': {'conv4_2': 0.08},
               'style': {n: 1.0 for n in
                         ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1')}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    rng = np.random.RandomState(0)
    jobs = [[rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
             for _ in range(3)] for _ in range(2)]
    params = random_params(0)
    traces = {}
    before = (conv.launches('fwd'), conv.launches('bwd'), style.launches)
    for device in ('cpu', 'cuda'):
        bt = BatchedStyleTransfer(params, weights, scalars, (48, 64),
                                  max_lanes=3, optimizer=optimizer,
                                  device=device)
        for job, lane in zip(jobs, (0, 2)):
            bt.add_job(*job, lane=lane)
        rows = [bt.step_all() for _ in range(3)]
        rows.append({lane: t[-1] for lane, t in bt.run_steps_all(3).items()})
        traces[device] = rows
    after = (conv.launches('fwd'), conv.launches('bwd'), style.launches)
    assert all(n > b for n, b in zip(after, before)), (before, after)
    for want, got in zip(traces['cpu'], traces['cuda']):
        assert set(want) == set(got) == {0, 2}
        for lane in want:
            for key, value in want[lane].items():
                np.testing.assert_allclose(got[lane][key], value, rtol=5e-3,
                                           err_msg='lane %d %s' % (lane,
                                                                   key))


@pytest.mark.cuda
def test_style_kernel_lanes_do_not_depend_on_each_other(cuda):
    """Each lane's bits depend on its own map and target only: lanes 0-2
    are the same bits whatever lane 3 holds, NaN included."""
    h, w, c = STYLE_TAPS_512[1]
    rng = np.random.RandomState(3)
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(4, h, w, c)))
                      ).to(cuda)
    grams = torch.from_numpy(np.float32(rng.rand(4, c, c))).to(cuda)
    s, gd = style.fused_style_branch(feat, grams)
    other = feat.clone()
    other[3] = float('nan')
    s_o, gd_o = style.fused_style_branch(other, grams)
    assert torch.equal(s[:3], s_o[:3]) and torch.equal(gd[:3], gd_o[:3])
    assert torch.isnan(s_o[3]).all()


@pytest.mark.cuda
def test_batched_engine_on_card_keeps_nans_in_their_lane(cuda):
    """An inactive lane between two active ones, its iterate and norms NaN,
    on the card: its neighbours' traces are the bits they have beside a
    clean inactive lane (the kernels are deterministic, and nothing
    reduces across lanes)."""
    from style_transfer2_tpu_torch.engine.batched import (
        BatchedStyleTransfer)
    from style_transfer2_tpu_torch.models import random_params
    weights = {'content': {'conv2_2': 0.1},
               'style': {'conv1_1': 1.0, 'conv2_1': 1.0}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    rng = np.random.RandomState(2)
    jobs = [[rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
             for _ in range(3)] for _ in range(2)]
    params = random_params(0)
    runs = []
    for poison in (False, True):
        bt = BatchedStyleTransfer(params, weights, scalars, (40, 56),
                                  max_lanes=3, optimizer='lbfgs',
                                  device='cuda')
        for job, lane in zip(jobs, (0, 2)):
            bt.add_job(*job, lane=lane)
        if poison:
            bt.states['x'][1] = float('nan')
            for k in bt.spec.norm_keys:
                bt.inputs['norms_vals'][k][1] = float('nan')
                bt.inputs['norms_set'][k][1] = True
        runs.append([bt.step_all() for _ in range(3)]
                    + [bt.run_steps_all(2)])
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_pool_runs_on_card_with_a_warm_migration(cuda):
    """The pooled tier on the card: 2 float32 Adam lanes at 64px, both
    sessions iterate, one resizes to 48 (a warm migration into a new
    bucket, the iterate counter carried); every bucket is on CUDA, the
    losses are finite and every kernel was launched."""
    import asyncio
    import configparser
    import json

    import aiohttp
    import yaml
    from aiohttp.test_utils import TestClient, TestServer

    from style_transfer2_tpu_torch.serve import pool

    cp = configparser.ConfigParser()
    cp['DEFAULT'] = {
        'initial_content': 'examples/golden_gate.jpg',
        'initial_style': 'examples/starry_night.jpg',
        'initial_size': '64', 'initial_weights': 'initial_weights.yaml',
        'http_host': '127.0.0.1', 'http_port': '8000', 'weights': 'random',
        'precision': 'float32', 'pool_lanes': '2', 'pool_sizes': '48 64',
        'device': 'cuda'}

    def launches():
        return (conv.launches('fwd'), conv.launches('bwd'), style.launches,
                image.preprocess_launches, image.deprocess_launches)

    before = launches()

    async def until(ws, kind, pred=lambda d: True):
        while True:
            data = json.loads((await ws.receive(timeout=300)).data)
            if data['type'] == kind and pred(data):
                return data

    async def body():
        app = pool.init(config=cp['DEFAULT'])
        client = TestClient(TestServer(app),
                            cookie_jar=aiohttp.DummyCookieJar())
        await client.start_server()
        tier = app['tier']
        try:
            sockets = []
            for _ in range(2):
                resp = await client.get('/')
                assert resp.status == 200
                cookie = resp.cookies['pool_session'].value
                ws = await client.ws_connect('/websocket', headers={
                    'Cookie': 'pool_session=' + cookie})
                params = await until(ws, 'newParams')
                await ws.send_str(json.dumps({'type': 'start'}))
                sockets.append((ws, tier.sessions[cookie], params))
            for ws, _, _ in sockets:
                await until(ws, 'iterateInfo', lambda d: d['i'] >= 5)
            ws, sess, params = sockets[1]
            doc = yaml.safe_load(params['params'])
            doc['size'] = 48
            await ws.send_str(json.dumps({'type': 'applyParams',
                                          'params': yaml.safe_dump(doc)}))
            size = await until(ws, 'newSize')
            assert max(size['height'], size['width']) == 48
            i_moved = sess.i
            assert i_moved >= 5
            info = await until(ws, 'iterateInfo',
                               lambda d: d['i'] >= i_moved + 3)
            assert np.isfinite(info['trace']['loss'])
            assert len(tier.engines) == 2
            assert all(e.device.type == 'cuda'
                       for e in tier.engines.values())
            for ws, _, _ in sockets:
                await ws.close()
        finally:
            await client.close()

    asyncio.run(asyncio.wait_for(body(), 600))
    assert all(n > b for n, b in zip(launches(), before)), (before,
                                                            launches())


@pytest.mark.cuda
@pytest.mark.parametrize('shape,offset', [((48, 64, 3), 0),
                                          ((1, 384, 512, 3), 0),
                                          ((1, 33, 17, 3), 0),
                                          ((1, 33, 17, 3), 1)])
def test_preprocess_on_device_matches_plain_bitwise(cuda, shape, offset):
    """The preprocess kernel from a float32 source already on the card (the
    video chain's warm start), an unaligned view too, against the plain
    version bit for bit; one launch; a (1, H, W, 3) result either way."""
    n = int(np.prod(shape))
    rng = np.random.RandomState(3)
    flat = torch.from_numpy(np.float32(rng.uniform(-20, 275, n + 1)))
    x = flat.to(cuda)[offset:offset + n].view(shape)
    before = image.preprocess_launches
    got = image.preprocess_on_device(x)
    assert image.preprocess_launches == before + 1
    want = image.preprocess_plain(x.cpu(), 'cpu')
    assert got.shape == want.shape == (1,) + tuple(shape[-3:])
    assert got.is_cuda and got.data_ptr() != x.data_ptr()
    assert torch.equal(got.cpu(), want)
    with pytest.raises(TypeError, match='float32'):
        image.preprocess_on_device(x.double())


@pytest.mark.cuda
def test_video_stylizer_on_card_matches_cpu(cuda):
    """3 frames at 48x64 through a CUDA VideoStylizer and a CPU one (the
    plain versions), L-BFGS with the temporal term, 6 then 4 iterations:
    every trace key of the whole history within the golden rtol, the
    images within 0.75, each chained frame's prime at temporal_loss 0, and
    every kernel launched."""
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.video import VideoStylizer
    weights = {'content': {'conv4_2': 0.08},
               'style': {n: 1.0 for n in
                         ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1')}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (51, 67, 3)).astype(np.uint8)
    frames = [base[i:i + 48, i:i + 64] for i in range(3)]
    style_img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    out = {}
    before = (conv.launches('fwd'), conv.launches('bwd'), style.launches,
              image.preprocess_launches, image.deprocess_launches)
    for device in ('cpu', 'cuda'):
        v = VideoStylizer(random_params(0), weights, scalars,
                          first_iterations=6, iterations=4,
                          temporal_weight=1e4, seed=1, device=device)
        v.set_style(style_img)
        images = [v.stylize_frame(f)[0] for f in frames]
        out[device] = (images, [t.data for t in v.st.traces])
    after = (conv.launches('fwd'), conv.launches('bwd'), style.launches,
             image.preprocess_launches, image.deprocess_launches)
    assert all(n > b for n, b in zip(after, before)), (before, after)
    (want_imgs, want), (got_imgs, got) = out['cpu'], out['cuda']
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert list(g) == list(w)
        for key, value in w.items():
            if key != 'time':
                np.testing.assert_allclose(g[key], value, rtol=5e-3,
                                           err_msg='row %d %s' % (i, key))
    for a, b in zip(got_imgs, want_imgs):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=0.75)
    primes = [t for t in got if 'fevals' not in t]
    assert len(primes) == 3 and 'temporal_loss' not in primes[0]
    assert all(p['temporal_loss'] == 0.0 for p in primes[1:])


GRAPH_WEIGHTS = {'content': {'conv4_2': 0.08},
                 'style': {n: 1.0 for n in
                           ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1')}}
GRAPH_SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}


def _eager(engine):
    """The engine with its steps run eagerly, as before the graphs: the
    plain version the replays are held against."""
    from style_transfer2_tpu_torch.engine.graphs import StepGraphs
    engine._graphs = StepGraphs()
    return engine


def _single_run(hw, precision, optimizer, graphed, remat=False,
                placement=None):
    """One engine through step, a chunk, an objective change, two chunks in
    flight and step again: its traces, end images, state (a Sharded
    gathered) and norms."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.parallel import Sharded
    rng = np.random.RandomState(4)
    content, style_img, inp = (rng.randint(0, 256, hw + (3,)).astype(
        np.uint8) for _ in range(3))
    st = StyleTransfer(random_params(0), precision, device='cuda',
                       remat=remat, placement=placement)
    if not graphed:
        _eager(st)
    st.set_weights(GRAPH_WEIGHTS, GRAPH_SCALARS)
    st.set_optimizer(optimizer)
    st.set_step_size({'adam': 10.0, 'lbfgs': 1.0}[optimizer])
    st.set_content(content)
    st.set_style(style_img)
    st.set_input(inp)
    assert st.start()
    images = [st.step()[0]]
    images.append(st.run_steps(4)[0])
    st.set_weights(GRAPH_WEIGHTS, dict(GRAPH_SCALARS, tv=4.0))
    a, b = st.begin_steps(3), st.begin_steps(2)
    images += [img for img, _ in st.collect_steps_many([a, b])]
    images.append(st.step()[0])
    state = {k: v.gather() if isinstance(v, Sharded) else
             v.clone() if torch.is_tensor(v) else v
             for k, v in st.opt_state.items()}
    norms = {k: float(v) for k, v in st.norm_vals.items()}
    return st, [t.data for t in st.traces], images, state, norms


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('optimizer', ['lbfgs', 'adam'])
def test_graphed_steps_equal_eager_bitwise(cuda, precision, optimizer):
    """From each key's second step on, step() and begin_steps replay a
    captured graph (and the L-BFGS prime its own): the traces, the end
    images, the iterate, the optimizer state (an L-BFGS history in bf16 at
    this grid) and the norms are the eager engine's bits."""
    from style_transfer2_tpu_torch.engine import graphs
    hw = (400, 408)              # above the bf16 history's pixel gate
    replays = graphs.replays
    st, traces, images, state, norms = _single_run(hw, precision,
                                                   optimizer, True)
    assert graphs.replays - replays == 10 + (optimizer == 'lbfgs')
    assert len(st._graphs) == (2 if optimizer == 'lbfgs' else 1)
    _assert_runs_equal((traces, images, state, norms),
                       _single_run(hw, precision, optimizer, False)[1:])
    if optimizer == 'lbfgs' and precision == 'bfloat16':
        assert state['sk'].dtype == torch.bfloat16


def _assert_runs_equal(got_run, want_run):
    """Two _single_run results (less the engine) bit for bit."""
    traces, images, state, norms = got_run
    traces_e, images_e, state_e, norms_e = want_run
    for got, want in zip(traces, traces_e):
        assert {k: v for k, v in got.items() if k != 'time'} == {
            k: v for k, v in want.items() if k != 'time'}
    assert len(traces) == len(traces_e)
    for got, want in zip(images, images_e):
        np.testing.assert_array_equal(got, want)
    assert state.keys() == state_e.keys()
    for key, value in state.items():
        if torch.is_tensor(value):
            assert torch.equal(value, state_e[key]), key
        else:
            assert value == state_e[key], key
    assert norms == norms_e


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('policy', [True, 'conv', 'block'])
def test_graphed_remat_steps_equal_graphed_plain_bitwise(cuda, precision,
                                                         policy):
    """A remat engine's graphed steps at 384x512 (the recompute captured
    inside the backward) give the plain engine's graphed bits."""
    from style_transfer2_tpu_torch.engine import graphs
    hw = (384, 512)
    replays = graphs.replays
    st, *run = _single_run(hw, precision, 'lbfgs', True, remat=policy)
    assert graphs.replays - replays == 11
    assert st.model.remat == ('block' if policy == 'block' else 'conv')
    _assert_runs_equal(run, _single_run(hw, precision, 'lbfgs', True)[1:])


@pytest.mark.cuda
def test_block_remat_saves_less_and_keeps_the_peak(cuda):
    """One float32 forward and vjp to conv4_2 at 768x1024: with block remat
    the forward leaves less than half as much saved (the taps alone), and
    the evaluation's peak is no higher than the plain one's: it falls in
    conv1_2's backward, where both hold the taps, their cotangents,
    conv1_2's output and two gradients of its size. The gradient is the
    plain one's bits."""
    from style_transfer2_tpu_torch.models import random_params, vgg19
    from style_transfer2_tpu_torch.models.weights import params_from_numpy
    params = params_from_numpy(random_params(0), cuda)
    x = torch.as_tensor(np.float32(np.random.RandomState(0).uniform(
        -120, 130, (1, 768, 1024, 3))), device=cuda)
    layers = ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1', 'conv4_2')
    saved, peaks, grads = {}, {}, {}
    for policy in (False, 'block'):
        model = vgg19.VGG19Features(params, remat=policy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feats, vjp = model.features_and_vjp(x, layers)
        saved[policy] = torch.cuda.memory_allocated() - base
        grads[policy] = vjp({n: torch.ones_like(f)
                             for n, f in feats.items()})
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated() - base
        del feats, vjp
    assert torch.equal(grads['block'], grads[False])
    assert saved['block'] < saved[False] / 2, saved
    assert peaks['block'] <= peaks[False], peaks


def _lanes_run(graphed, precision, optimizer):
    from style_transfer2_tpu_torch.engine.batched import (
        BatchedStyleTransfer)
    from style_transfer2_tpu_torch.models import random_params
    hw = (384, 512)
    rng = np.random.RandomState(6)
    jobs = [[rng.randint(0, 256, hw + (3,)).astype(np.uint8)
             for _ in range(3)] for _ in range(3)]
    bt = BatchedStyleTransfer(random_params(0), GRAPH_WEIGHTS, GRAPH_SCALARS,
                              hw, max_lanes=4, optimizer=optimizer,
                              precision=precision, device='cuda')
    if not graphed:
        _eager(bt)
    for job, lane in zip(jobs, (0, 1, 3)):
        bt.add_job(*job, lane=lane)
    rows = [bt.step_all(), bt.run_steps_all(3)]
    bt.set_running(1, False)
    rows.append(bt.run_steps_all(2))
    bt.set_lane_weights(0, GRAPH_WEIGHTS, dict(GRAPH_SCALARS, tv=4.0))
    bt.set_step_size(3, 0.5)
    bt.set_running(1, True)
    rows.append(bt.run_steps_all(2))
    state = {k: v.clone() for k, v in bt.states.items()}
    keys, vals, set_ = bt.norms_host()
    return bt, rows, state, (keys, vals.tolist(), set_.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('optimizer', ['lbfgs', 'adam'])
def test_graphed_lanes_equal_eager_bitwise(cuda, precision, optimizer):
    """Four lanes at 384x512, one inactive, one paused for a chunk, a lane's
    weights and another's step size changed: the masked step's and the
    masked prime's replays give the eager engine's bits."""
    from style_transfer2_tpu_torch.engine import graphs
    replays = graphs.replays
    bt, rows, state, norms = _lanes_run(True, precision, optimizer)
    assert graphs.replays > replays
    _, rows_e, state_e, norms_e = _lanes_run(False, precision, optimizer)
    assert rows == rows_e
    for key, value in state.items():
        assert torch.equal(value, state_e[key]), key
    assert norms == norms_e


def _ladder_run(graphed):
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    rng = np.random.RandomState(8)
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((96, 128), (136, 181), (192, 256), (96, 128),
                         (96, 128))]
    st = StyleTransfer(random_params(0), 'bfloat16', device='cuda')
    if not graphed:
        _eager(st)
    st.set_weights(GRAPH_WEIGHTS, GRAPH_SCALARS)
    st.set_content(images[0])
    st.set_style(images[3])
    st.set_input(images[4])
    assert st.start()
    rows = []
    for rung, image in enumerate(images[:3]):
        if rung:
            st.resample_input(image.shape[:2])
            st.set_content(image)
        for n in (3, 3, 2):
            rows.append(st.collect_steps(st.begin_steps(n))[1])
    return st, [[{k: v for k, v in t.data.items() if k != 'time'}
                 for t in chunk] for chunk in rows]


@pytest.mark.cuda
def test_graphs_recapture_up_a_ladder(cuda):
    """Each warm start drops the old grid's graphs and their memory pool;
    the next rung captures into a fresh one, and the run is the eager
    engine's bits."""
    st, rows = _ladder_run(True)
    assert len(st._graphs) == 1
    _, rows_e = _ladder_run(False)
    assert rows == rows_e


@pytest.mark.cuda
def test_dropped_engine_returns_its_graph_memory(cuda):
    """A graphed engine holds its graphs' private pool while it lives; when
    it goes, the pool's memory goes back to CUDA (a dead pool would
    otherwise stay reserved, even through an out-of-memory retry)."""
    def private_segments():
        torch.cuda.synchronize()
        return [seg for seg in torch.cuda.memory._snapshot()['segments']
                if tuple(seg.get('segment_pool_id', (0, 0))) != (0, 0)]

    assert not private_segments()
    st, _ = _ladder_run(True)
    assert private_segments()
    del st
    assert not private_segments()


def _shards(cuda, n):
    from style_transfer2_tpu_torch.parallel import Mesh, SpatialPlacement
    return SpatialPlacement(Mesh([cuda] * n, ('space',)))


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('optimizer', ['lbfgs', 'adam'])
@pytest.mark.parametrize('n', [2, 4])
def test_graphed_sharded_engine_equals_eager_bitwise(cuda, n, optimizer,
                                                     precision):
    """A StyleTransfer over n shards of one card replays captured graphs
    of its sharded step (and of its L-BFGS prime) from each key's second
    call on: through step, a chunk, an objective change, two chunks in
    flight and step, the traces, images, state (a bf16 L-BFGS history at
    this grid) and norms are the eager sharded engine's bits."""
    from style_transfer2_tpu_torch.engine import graphs
    from style_transfer2_tpu_torch.parallel import Sharded
    hw = (400, 408)              # above the bf16 history's pixel gate
    replays = graphs.replays
    st, *got = _single_run(hw, precision, optimizer, True,
                           placement=_shards(cuda, n))
    assert graphs.replays - replays == 10 + (optimizer == 'lbfgs')
    assert len(st._graphs) == (2 if optimizer == 'lbfgs' else 1)
    assert isinstance(st._input, Sharded) and len(st._input.shards) == n
    eager = _single_run(hw, precision, optimizer, False,
                        placement=_shards(cuda, n))
    _assert_runs_equal(got, eager[1:])
    if optimizer == 'lbfgs' and precision == 'bfloat16':
        assert got[2]['sk'].dtype == torch.bfloat16


@pytest.mark.cuda
def test_dropped_sharded_engine_returns_its_graph_memory(cuda):
    """A graphed engine over 4 shards of one card holds its graphs' private
    pool while it lives and gives it back when it goes."""
    def private_segments():
        torch.cuda.synchronize()
        return [seg for seg in torch.cuda.memory._snapshot()['segments']
                if tuple(seg.get('segment_pool_id', (0, 0))) != (0, 0)]

    assert not private_segments()
    st = _single_run((96, 128), 'bfloat16', 'lbfgs', True,
                     placement=_shards(cuda, 4))[0]
    assert len(st._graphs) == 2 and private_segments()
    del st
    assert not private_segments()


@pytest.mark.cuda
@pytest.mark.parametrize('c', [64, 6, 512])
def test_style_phases_match_plain_on_card(cuda, c):
    """The two-phase entry points (st2_style_gram with no target,
    st2_style_grad) on one shard of a map cut 4 ways, against their plain
    versions and the fused kernel's halves: phase 1 summed over the 4
    shards minus G_style is the fused G_diff's, phase 2 on each shard its
    rows of the fused s_grad. Each launch counted once, bitwise
    repeatable."""
    from style_transfer2_tpu_torch.parallel import SpatialPlacement, Mesh
    rng = np.random.RandomState(c)
    feat = torch.relu(torch.tensor(np.float32(rng.randn(1, 44, 21, c)),
                                   device=cuda))
    gram_style = torch.tensor(np.float32(rng.rand(c, c) * 1e-3),
                              device=cuda)
    before = (style.gram_launches, style.grad_launches)
    xs = SpatialPlacement(Mesh([cuda] * 4, ('space',))).image(feat)
    s_sh, gd_sh = style.fused_style_branch(xs, gram_style)
    assert (style.gram_launches, style.grad_launches) == (
        before[0] + 4, before[1] + 4)
    s_f, gd_f = style.fused_style_branch(feat, gram_style)
    s_p, gd_p = style.fused_style_branch_plain(feat, gram_style)
    for got in (gd_sh, gd_f):
        assert float((got - gd_p).abs().max()) <= 1e-4 * max(
            float(gd_p.abs().max()), float(gram_style.abs().max()))
    for got in (s_sh.gather(), s_f):
        assert float((got - s_p).abs().max()) <= 1e-4 * float(
            s_p.abs().max())
    size = feat.numel()
    shard = xs.shards[1]
    g_k = style.style_gram(shard, size)
    assert torch.equal(g_k, style.style_gram(shard, size))
    g_p = style.style_gram_plain(shard, size)
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    s_k = style.style_grad(shard, gd_sh, size)
    assert torch.equal(s_k, style.style_grad(shard, gd_sh, size))
    s_q = style.style_grad_plain(shard, gd_sh, size)
    assert float((s_k - s_q).abs().max()) <= 1e-4 * float(s_q.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('hw', [(40, 24), (30, 40)], ids=['H', 'W'])
def test_halo_conv_matches_plain_on_card(cuda, hw):
    """conv3x3_bias_relu_sharded on 4 shards of one card (H-sharded at
    40x24, W at 30x40), forward and backward, against the plain conv of
    the whole map; the kernels launch once a shard each way."""
    from style_transfer2_tpu_torch.parallel import SpatialPlacement, Mesh
    x, w, b, g = _conv_case(7, (1,) + hw + (64,), 64)
    xt, wt, bt, gt = (torch.from_numpy(a).to(cuda) for a in (x, w, b, g))
    placement = SpatialPlacement(Mesh([cuda] * 4, ('space',)))
    xs = placement.image(xt).requires_grad_(True)
    before = (conv.launches('fwd'), conv.launches('bwd'))
    wb = conv.backward_weights(wt)
    ys = conv.conv3x3_bias_relu_sharded(xs, lambda device: (wt, bt, wb))
    dxs = torch.autograd.grad(ys.shards, xs.shards,
                              placement.image(gt).shards)
    assert (conv.launches('fwd'), conv.launches('bwd')) == (
        before[0] + 4, before[1] + 4)
    x32 = xt.clone().requires_grad_(True)
    y_ref = conv.conv3x3_bias_relu_plain(x32, wt, bt)
    pre = F.conv2d(x32.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), bt,
                   padding=1).permute(0, 2, 3, 1)
    y_k = ys.gather()
    dx_ref = torch.autograd.grad(pre, x32, gt * (y_k > 0).float())[0]
    scale = max(1.0, float(y_ref.abs().max()))
    assert float((y_k - y_ref).abs().max()) <= 1e-4 * scale
    dx = torch.cat(dxs, xs.axis)
    assert float((dx - dx_ref).abs().max()) <= 1e-4 * max(
        1.0, float(dx_ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('precision,rtol', [('float32', 5e-3),
                                            ('bfloat16', 2e-2)])
def test_sharded_engine_on_card_matches_unsharded(cuda, precision, rtol):
    """A StyleTransfer over 4 shards of one card against the unsharded
    engine, both graphed: 48x64, 4 L-BFGS steps, every trace key of the
    prime within rtol (float32: of every step); the sharded step is
    captured once and replayed, and the launches counted (replays
    credited) are, in float32, both style phases on the three style
    layers above the gathered level (12 rows a shard: pool3 gathers), the
    fused branch on conv4_1, once an evaluation; in bfloat16 the loss
    feed's bf16 Gram once a shard on those three and once on conv4_1, and
    no float32 style kernel."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.parallel import (Mesh, Sharded,
                                                    SpatialPlacement)
    weights = {'content': {'conv4_2': 0.08},
               'style': {n: 1.0 for n in ('conv1_1', 'conv2_1', 'conv3_1',
                                          'conv4_1')}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
              for _ in range(3)]
    runs = []
    for placement in (None, SpatialPlacement(Mesh([cuda] * 4,
                                                  ('space',)))):
        st = StyleTransfer(random_params(0), precision, placement=placement)
        st.set_weights(weights, scalars)
        st.set_content(images[0])
        st.set_style(images[1])
        st.set_input(images[2])
        assert st.start()
        before = (style.gram_launches, style.launches,
                  style.gram_bf16_launches)
        st.run_steps(4)
        if placement is not None:
            assert isinstance(st._input, Sharded)
            assert len(st._graphs) == 1
            got = (style.gram_launches - before[0],
                   style.launches - before[1],
                   style.gram_bf16_launches - before[2])
            assert got == ((4 * 3 * 5, 5, 0) if precision == 'float32'
                           else (0, 0, (4 * 3 + 1) * 5))
        runs.append([t.data for t in st.traces])
    rows = range(5) if precision == 'float32' else [0]
    for i in rows:
        for key, want in runs[0][i].items():
            if key in ('time', 'fevals'):
                continue
            got = runs[1][i][key]
            assert abs(got - want) <= rtol * abs(want), (i, key, got, want)


# -- the bf16 loss feed's kernels (ops/style.py style_gram, style_product on
# a bf16 tap; ops/reduce.py sumsq) ---------------------------------------------

# The bf16 feed's tolerances against float64 on the same bf16 values
# (chip_smoke.py's FEED_GRAM_TOL, FEED_PRODUCT_TOL): the Gram sums exact
# products in float32; the product rounds its float32 sums to bf16 once.
FEED_GRAM_TOL = 1e-4
FEED_PRODUCT_TOL = 2.0 ** -8 + 1e-5


def _feed_f64_errs(feat, size, d, g, s):
    """(the Gram's, the product's) largest error against float64 on the
    same bf16 values and D rounded to bf16, relative to the reference's
    largest magnitude."""
    x64 = feat.double().reshape(feat.shape[0], -1, feat.shape[-1])
    g64 = torch.bmm(x64.transpose(1, 2), x64) / size
    d64 = d.to(torch.bfloat16).double().reshape(-1, *d.shape[-2:])
    s64 = torch.bmm(x64, d64.expand(x64.shape[0], -1, -1))
    g_err = (g.double().reshape(g64.shape) - g64).abs().max() / (
        g64.abs().max())
    s_err = (s.double().reshape(s64.shape) - s64).abs().max() / (
        s64.abs().max())
    return float(g_err), float(s_err)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 97, 53, 64), (1, 45, 37, 128),
                                   (1, 23, 29, 256), (1, 11, 13, 512),
                                   (3, 17, 19, 64), (2, 9, 7, 72),
                                   (1, 5, 6, 60), (1, 150, 170, 256),
                                   (1, 200, 200, 512), (4, 64, 50, 256)])
def test_feed_style_phases_match_plain_and_repeat(cuda, shape):
    """The bf16 Gram and product at ragged M, at a C that is no multiple
    of the 64-wide tile (72) or of the 8-value copy (60, padded), one map
    and lanes, and at maps whose product blocks walk several slabs (each
    panel of D resident, C = 256 and 512, four lanes crossing from one
    lane's D to the next): the Gram within 1e-4 of the plain version's
    largest entry and of float64, the product within one bf16 ulp of the
    plain version's (2^-7 of the largest value: the two sum in float32 in
    different orders, then round once), within one bf16 rounding of
    float64, and its bits in at least 99% of the values; two calls give
    the same bits, and no float32 kernel launches."""
    rng = np.random.RandomState(shape[-1] + shape[0])
    lanes = shape[0] > 1
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(*shape)))).to(
        cuda, torch.bfloat16)
    size = 4 * shape[1] * shape[2] * shape[3]      # a quarter of a map
    c = shape[-1]
    d = torch.from_numpy(np.float32(rng.randn(*((shape[0],) if lanes
                                                else ()), c, c))).to(cuda)
    before = (style.gram_launches, style.grad_launches,
              style.gram_bf16_launches, style.grad_bf16_launches)
    g = style.style_gram(feat, size, lanes)
    s = style.style_product(feat, d)
    assert (style.gram_launches, style.grad_launches) == before[:2]
    assert (style.gram_bf16_launches, style.grad_bf16_launches) == (
        before[2] + 1, before[3] + 1)
    assert g.dtype == torch.float32 and s.dtype == torch.bfloat16
    assert torch.equal(g, style.style_gram(feat, size, lanes))
    assert torch.equal(s, style.style_product(feat, d))
    g_ref = style.style_gram_plain(feat, size, lanes)
    s_ref = style.style_product_plain(feat, d)
    assert g.shape == g_ref.shape and s.shape == s_ref.shape == feat.shape
    assert float((g - g_ref).abs().max()) <= 1e-4 * float(g_ref.abs().max())
    assert float((s.float() - s_ref.float()).abs().max()) <= 2 ** -7 * float(
        s_ref.float().abs().max())
    assert float((s == s_ref).float().mean()) >= 0.99
    g_err, s_err = _feed_f64_errs(feat, size, d, g, s)
    assert g_err <= FEED_GRAM_TOL and s_err <= FEED_PRODUCT_TOL


@pytest.mark.cuda
def test_feed_style_phases_keep_a_nan_in_its_lane(cuda):
    """Four lanes, a NaN in lane 2's map and another in lane 1's D: the
    Gram and the product of those lanes hold NaNs, every other lane stays
    finite and within tolerance of float64, and each lane's product is
    the bits of that lane run alone (no sum crosses lanes)."""
    rng = np.random.RandomState(11)
    shape = (4, 40, 36, 256)
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(*shape)))).to(
        cuda, torch.bfloat16)
    feat[2, 7, 5, 100] = float('nan')
    d = torch.from_numpy(np.float32(rng.randn(4, 256, 256))).to(cuda)
    d[1, 30, 200] = float('nan')
    size = shape[1] * shape[2] * shape[3]
    g = style.style_gram(feat, size, True)
    s = style.style_product(feat, d)
    for lane in range(4):
        g_nan = bool(torch.isnan(g[lane]).any())
        s_nan = bool(torch.isnan(s[lane].float()).any())
        assert g_nan == (lane == 2) and s_nan == (lane in (1, 2)), lane
        alone = style.style_product(feat[lane:lane + 1], d[lane])
        assert torch.equal(s[lane:lane + 1].view(torch.int16),
                           alone.view(torch.int16)), lane
        if lane in (0, 3):
            g_err, s_err = _feed_f64_errs(feat[lane:lane + 1], size,
                                          d[lane], g[lane], s[lane])
            assert g_err <= FEED_GRAM_TOL and s_err <= FEED_PRODUCT_TOL


@pytest.mark.cuda
def test_feed_product_rounds_d_as_torch_does(cuda):
    """The product rounds a float32 D to bf16 as it stages it: its bits
    are those of the same product of d.to(torch.bfloat16), ties to even
    among the values."""
    rng = np.random.RandomState(12)
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(1, 33, 41,
                                                            128)))).to(
        cuda, torch.bfloat16)
    d = np.float32(rng.randn(128, 128))
    # Exact halfway cases between two bf16 values: 1 + 2^-8 + k 2^-7.
    d[:8, :8] = np.float32(1 + 2.0 ** -8) + np.arange(64).reshape(8, 8) * (
        np.float32(2.0 ** -7))
    d = torch.from_numpy(d).to(cuda)
    assert torch.equal(style.style_product(feat, d),
                       style.style_product(feat, d.to(torch.bfloat16)))


@pytest.mark.cuda
@pytest.mark.parametrize('c', [64, 512])
def test_feed_style_phases_on_a_sharded_map(cuda, c):
    """A bf16 map cut 4 ways on one card: style_gram sums the shards'
    Grams in shard order (bit for bit each shard's own call added up),
    within tolerance of the whole map's plain Gram; style_product rounds
    D once and each shard's product is the bits of that shard's own
    call."""
    from style_transfer2_tpu_torch.parallel import Mesh, SpatialPlacement
    rng = np.random.RandomState(c + 1)
    feat = torch.relu(torch.from_numpy(np.float32(rng.randn(1, 44, 21, c)))
                      ).to(cuda, torch.bfloat16)
    d = torch.from_numpy(np.float32(rng.randn(c, c) * 1e-2)).to(cuda)
    xs = SpatialPlacement(Mesh([cuda] * 4, ('space',))).image(feat)
    size = feat.numel()
    g = style.style_gram(xs, size)
    parts = [style.style_gram(s, size) for s in xs.shards]
    assert torch.equal(g, ((parts[0] + parts[1]) + parts[2]) + parts[3])
    g_ref = style.style_gram_plain(feat, size)
    assert float((g - g_ref).abs().max()) <= 1e-4 * float(g_ref.abs().max())
    prod = style.style_product(xs, d)
    for shard, got in zip(xs.shards, prod.shards):
        assert torch.equal(got, style.style_product(shard, d))
    g_err, s_err = _feed_f64_errs(feat, size, d, g, prod.gather())
    assert g_err <= FEED_GRAM_TOL and s_err <= FEED_PRODUCT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('shape,lanes', [
    ((1, 97, 53, 64), False), ((1, 384, 512, 64), False),
    ((4, 48, 64, 512), True), ((3, 5, 7, 3), True), ((1, 1, 1, 5), False)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_sumsq_matches_float64_and_repeats(cuda, shape, lanes, dtype):
    """sumsq of a bf16 or float32 tensor, whole or per lane, at lengths no
    multiple of the 8-value load: within 1e-5 of float64 on the same
    values, the same bits on a second call, one launch a call."""
    rng = np.random.RandomState(shape[-1])
    t = torch.from_numpy(np.float32(rng.randn(*shape))).to(cuda, dtype)
    from style_transfer2_tpu_torch.ops import reduce
    before = reduce.launches
    got = reduce.sumsq(t, lanes)
    assert reduce.launches == before + 1
    assert torch.equal(got, reduce.sumsq(t, lanes))
    dims = tuple(range(1, len(shape))) if lanes else None
    sq = t.double().square()
    want = sq.sum(dim=dims) if lanes else sq.sum()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_sumsq_takes_an_unaligned_view(cuda):
    """A view one element into a larger bf16 tensor is copied aligned
    (utils.aligned) and summed as the contiguous tensor."""
    from style_transfer2_tpu_torch.ops import reduce
    t = torch.randn(4097, device=cuda).to(torch.bfloat16)
    view = t[1:]
    assert view.data_ptr() % 16 != 0
    assert torch.equal(reduce.sumsq(view), reduce.sumsq(view.clone()))


@pytest.mark.cuda
def test_feed_wrappers_never_take_the_plain_path_on_cuda(cuda, monkeypatch):
    """On CUDA tensors the feed's wrappers launch their kernels: the plain
    versions, made to raise, are never called."""
    from style_transfer2_tpu_torch.ops import reduce

    def refuse(*args, **kwargs):
        raise AssertionError('plain version called on CUDA')

    for module, name in ((style, 'style_gram_plain'),
                         (style, 'style_product_plain'),
                         (reduce, 'sumsq_plain')):
        monkeypatch.setattr(module, name, refuse)
    feat = torch.rand(1, 16, 16, 64, device=cuda).to(torch.bfloat16)
    style.style_gram(feat, feat.numel())
    style.style_product(feat, torch.rand(64, 64, device=cuda))
    reduce.sumsq(feat)


# The step glue's kernels (ops/pool.py, ops/epilogue.py): bit for bit their
# plain versions, at every pool and tap shape the benchmark's cells run.

def _glue_bits(t):
    """t's bits, every NaN made one NaN (csrc/pool.cu keeps no payload)."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float('nan')), t)
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _pool_inputs(shape):
    """The three pool inputs of a VGG trunk at the grid of shape's first
    pool: (n, h, w, 64), then each pool's ceil-mode output with 128 and
    256 channels."""
    n, h, w, _ = shape
    out = []
    for c in (64, 128, 256):
        out.append((n, h, w, c))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


POOL_SHAPES = (
    [('float32', s) for s in _pool_inputs((1, 384, 512, 64))]
    + [('bfloat16', s) for hw in LADDER_1024
       for s in _pool_inputs((1,) + hw + (64,))]
    + [(d, s) for d in ('float32', 'bfloat16')
       for s in ((4, 7, 9, 64), (1, 5, 7, 12), (2, 5, 7, 3),
                 (1, 48, 64, 512))])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,shape', POOL_SHAPES)
def test_pool_kernels_equal_plain_bitwise(cuda, dtype, shape):
    """The pool's forward and backward against the plain torch.amax pool
    and its autograd, bit for bit: ReLU zeros (four-way ties), odd
    extents, 4 images, C off the 16-byte width, NaN and inf in the map and
    the cotangent. Each wrapper call is one launch."""
    from style_transfer2_tpu_torch.ops import pool
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.relu(torch.randn(shape, generator=gen, device=cuda)).to(dt)
    n, h, w, c = shape
    g = torch.randn((n, (h + 1) // 2, (w + 1) // 2, c), generator=gen,
                    device=cuda).to(dt)
    if h * w < 400:
        x[0, 0, 0, 0], x[-1, -1, -1, -1] = float('nan'), float('-inf')
        x[-1, 1, 1, 0] = float('inf')
        g[0, -1, -1, 0], g[-1, 0, 0, -1] = float('inf'), float('nan')
    before = (pool.fwd_launches, pool.bwd_launches)
    xk = x.clone().requires_grad_(True)
    y = pool.max_pool_ceil(xk)
    dx, = torch.autograd.grad(y, xk, g)
    assert (pool.fwd_launches, pool.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    xp = x.clone().requires_grad_(True)
    yp = pool.max_pool_ceil_plain(xp)
    dxp, = torch.autograd.grad(yp, xp, g)
    assert torch.equal(_glue_bits(y.detach()), _glue_bits(yp.detach()))
    assert torch.equal(_glue_bits(dx), _glue_bits(dxp))
    with torch.no_grad():
        assert torch.equal(_glue_bits(pool.max_pool_ceil(x)),
                           _glue_bits(yp.detach()))


@pytest.mark.cuda
def test_pool_kernel_on_the_current_stream_and_under_checkpoint(cuda):
    """The pool launches on the caller's current stream, and under
    torch.utils.checkpoint (the remat policies) its mask is recomputed with
    the forward: the same gradient."""
    from torch.utils.checkpoint import checkpoint

    from style_transfer2_tpu_torch.ops import pool
    x = torch.relu(torch.randn(1, 96, 128, 64, device=cuda))
    g = torch.randn(1, 48, 64, 64, device=cuda)
    xk = x.clone().requires_grad_(True)
    want, = torch.autograd.grad(pool.max_pool_ceil(xk), xk, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xs = x.clone().requires_grad_(True)
        got, = torch.autograd.grad(pool.max_pool_ceil(xs), xs, g)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, want)
    xc = x.clone().requires_grad_(True)
    y = checkpoint(pool.max_pool_ceil, xc, use_reentrant=False,
                   preserve_rng_state=False)
    got, = torch.autograd.grad(y, xc, g)
    assert torch.equal(got, want)


# (layer shape, flags) of the float32 cell's taps: conv1_1 to conv4_1 with
# style, conv4_2 with content, and every term on a ragged 'data' tap.
EPILOGUE_CASES = (
    [((1, 384, 512, 64), 's'), ((1, 192, 256, 128), 's'),
     ((1, 96, 128, 256), 's'), ((1, 48, 64, 512), 's'),
     ((1, 48, 64, 512), 'c'), ((1, 96, 128, 256), 'csd'),
     ((1, 48, 64, 512), 'd'), ((1, 17, 19, 3), 'csd'),
     ((1, 17, 19, 3), 'c')])


@pytest.mark.cuda
@pytest.mark.parametrize('shape,terms', EPILOGUE_CASES)
def test_tap_epilogue_equals_plain(cuda, shape, terms):
    """The tap epilogue's cotangent against the plain version's, bit for
    bit; its sums (float64 inside) within 1e-6 of the plain float32
    reductions and within 2e-7 of float64's; the same bits twice."""
    from style_transfer2_tpu_torch.ops import epilogue
    gen = torch.Generator(device=cuda).manual_seed(len(terms) + shape[-1])
    feat = torch.relu(torch.randn(shape, generator=gen, device=cuda))
    content = torch.relu(torch.randn(shape, generator=gen, device=cuda))
    s_grad = torch.randn(shape, generator=gen, device=cuda) * 1e-4
    w = torch.tensor([0.08, 1.0, -0.3], device=cuda)
    norm = lambda v: torch.tensor(v, device=cuda)   # noqa: E731
    args = dict(content=content if 'c' in terms else None,
                c_norm=norm(3e-3) if 'c' in terms else None,
                s_grad=s_grad if 's' in terms else None,
                s_scale=(w[1] / norm(7e-6)) if 's' in terms else None,
                d_norm=norm(1.3e-2) if 'd' in terms else None)
    before = epilogue.launches
    diff, sums = epilogue.tap_epilogue(feat, w, **args)
    again, sums_again = epilogue.tap_epilogue(feat, w, **args)
    assert epilogue.launches == before + 2
    want, want_sums = epilogue.tap_epilogue_plain(feat, w, **args)
    assert torch.equal(_glue_bits(diff), _glue_bits(want))
    assert torch.equal(diff, again) and torch.equal(sums, sums_again)
    size = float(feat.numel())
    exact = [0.0] * 5
    f64 = lambda t: t.double().square().sum().item()   # noqa: E731
    if 'c' in terms:
        exact[0] = f64(feat - content)
        exact[1] = f64(w[0] * ((2.0 / size) * (feat - content))
                       / args['c_norm'])
    if 's' in terms:
        exact[2] = f64(args['s_scale'] * s_grad)
    if 'd' in terms:
        exact[3] = f64(feat)
        exact[4] = f64(w[2] * ((-2.0 / size) * feat) / args['d_norm'])
    np.testing.assert_allclose(sums.cpu().numpy(), want_sums.cpu().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(sums.cpu().double().numpy(), exact,
                               rtol=2e-7)


@pytest.mark.cuda
def test_glue_wrappers_never_take_the_plain_path_on_cuda(cuda, monkeypatch):
    """On CUDA tensors the pool and the tap epilogue launch their kernels:
    the plain versions, made to raise, are never called."""
    from style_transfer2_tpu_torch.ops import epilogue, pool

    def refuse(*args, **kwargs):
        raise AssertionError('plain version called on CUDA')

    monkeypatch.setattr(pool, 'max_pool_ceil_plain', refuse)
    monkeypatch.setattr(epilogue, 'tap_epilogue_plain', refuse)
    x = torch.rand(1, 16, 16, 64, device=cuda).requires_grad_(True)
    torch.autograd.grad(pool.max_pool_ceil(x).sum(), x)
    epilogue.tap_epilogue(x.detach(), torch.ones(3, device=cuda),
                          s_grad=x.detach(),
                          s_scale=torch.ones((), device=cuda))


def _force_plain_glue(monkeypatch):
    """The trunk's pool and the float32 feed's epilogue as their plain
    versions on the card: the PyTorch kernels the port ran before."""
    from style_transfer2_tpu_torch.engine import objective
    from style_transfer2_tpu_torch.models import vgg19
    from style_transfer2_tpu_torch.ops import epilogue, pool
    monkeypatch.setattr(vgg19, '_max_pool_ceil', pool.max_pool_ceil_plain)
    monkeypatch.setattr(objective, 'tap_epilogue',
                        epilogue.tap_epilogue_plain)


def _glue_f32_run(seed):
    """200 graphed L-BFGS steps at 384x512 in float32 from a uniform
    random start, in chunks of 60, two in flight: (the optimizer state,
    the trace rows)."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    rng = np.random.RandomState(seed)
    content, style_img = (rng.randint(0, 256, (384, 512, 3)).astype(
        np.uint8) for _ in range(2))
    st = StyleTransfer(random_params(0), 'float32', device='cuda')
    st.set_weights(GRAPH_WEIGHTS, GRAPH_SCALARS)
    st.set_content(content)
    st.set_style(style_img)
    st.set_input(np.float32(rng.uniform(0, 255, (384, 512, 3))))
    assert st.start()
    traces = []
    pending = [st.begin_steps(60)]
    for n in (60, 60, 20):
        pending.append(st.begin_steps(n))
        traces += st.collect_steps(pending.pop(0), fetch_image=False)[1]
    traces += st.collect_steps(pending.pop(0), fetch_image=False)[1]
    state = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in st.opt_state.items()}
    return state, [{k: v for k, v in t.data.items() if k != 'time'}
                   for t in traces]


def _glue_ladder_run(seed):
    """One 7-rung bf16 image up the 1024px ladder, 200 L-BFGS iterations a
    rung in chunks of 60 two deep: (the last rung's optimizer state, the
    trace rows)."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    from PIL import Image
    rng = np.random.RandomState(seed)
    big = Image.fromarray(rng.randint(0, 256, (768, 1024, 3)).astype(
        np.uint8))
    style_img = rng.randint(0, 256, (768, 1024, 3)).astype(np.uint8)
    st = StyleTransfer(random_params(0), 'bfloat16', device='cuda')
    st.set_weights(GRAPH_WEIGHTS, GRAPH_SCALARS)
    st.set_style(style_img)
    traces = []
    for rung, hw in enumerate(LADDER_1024):
        content = np.asarray(big.resize(hw[::-1], Image.LANCZOS))
        if rung:
            st.resample_input(hw)
            st.set_content(content)
        else:
            st.set_content(content)
            st.set_input(np.float32(rng.uniform(0, 255, hw + (3,))))
            assert st.start()
        pending = [st.begin_steps(60)]
        for n in (60, 60, 20):
            pending.append(st.begin_steps(n))
            traces += st.collect_steps(pending.pop(0), fetch_image=False)[1]
        traces += st.collect_steps(pending.pop(0), fetch_image=False)[1]
    state = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in st.opt_state.items()}
    return state, [{k: v for k, v in t.data.items() if k != 'time'}
                   for t in traces]


def _assert_same_iterate(got, want):
    """Two runs' optimizer states bit for bit, and their trace scalars
    within 1e-6 (only the glue's loss and trace sums differ in order)."""
    (state, traces), (state_p, traces_p) = got, want
    assert state.keys() == state_p.keys()
    for key, value in state.items():
        if torch.is_tensor(value):
            assert torch.equal(value, state_p[key]), key
        else:
            assert value == state_p[key], key
    assert len(traces) == len(traces_p)
    worst = 0.0
    for row, row_p in zip(traces, traces_p):
        assert row.keys() == row_p.keys()
        for key, value in row.items():
            if np.isfinite(row_p[key]) and row_p[key] != 0:
                worst = max(worst, abs(value / row_p[key] - 1))
            else:
                assert value == row_p[key] or (np.isnan(value)
                                               and np.isnan(row_p[key]))
    assert worst <= 1e-6, worst


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [4000000221, 4000000231])
def test_glue_kernels_keep_the_float32_iterate_bit_for_bit(cuda, seed,
                                                           monkeypatch):
    """200 graphed float32 steps at 384x512 from a random start: the same
    iterate, history and norms with the pool and epilogue kernels as with
    their plain versions forced on the card."""
    got = _glue_f32_run(seed)
    _force_plain_glue(monkeypatch)
    _assert_same_iterate(got, _glue_f32_run(seed))


@pytest.mark.cuda
def test_glue_kernels_keep_the_bf16_ladder_iterate_bit_for_bit(cuda,
                                                              monkeypatch):
    """One 7-rung bf16 image up the 1024px ladder: the same iterate with
    the pool kernel as with the plain pool forced on the card (the bf16
    feed takes no tap epilogue)."""
    from style_transfer2_tpu_torch.ops import epilogue
    before = epilogue.launches
    got = _glue_ladder_run(4000000211)
    assert epilogue.launches == before
    _force_plain_glue(monkeypatch)
    _assert_same_iterate(got, _glue_ladder_run(4000000211))


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_glue_launch_counters_advance_on_replay(cuda, precision):
    """A replayed step credits 3 pool forwards and 3 backwards (pools 1-3
    below the conv4_2 tap) and, in float32, one tap epilogue a tap (5)."""
    from style_transfer2_tpu_torch.engine import graphs
    from style_transfer2_tpu_torch.ops import epilogue, pool
    st = _single_run((96, 128), precision, 'lbfgs', True)[0]
    counts = (pool.fwd_launches, pool.bwd_launches, epilogue.launches,
              graphs.replays)
    st.collect_steps(st.begin_steps(7), fetch_image=False)
    assert graphs.replays - counts[3] == 7
    taps = 5 if precision == 'float32' else 0
    assert (pool.fwd_launches - counts[0], pool.bwd_launches - counts[1],
            epilogue.launches - counts[2]) == (21, 21, 7 * taps)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [2, 4])
def test_tap_epilogue_of_a_sharded_tap_launches_once_a_shard(cuda, n):
    """A Sharded float32 tap on the card (n shards of one card) takes one
    kernel launch a shard, none of the plain version: its diff is the
    whole tap's plain cotangent bit for bit, and its sums are within 1e-6
    of the plain version's shard-order sums."""
    from style_transfer2_tpu_torch.ops import epilogue
    from style_transfer2_tpu_torch.parallel import Sharded
    shape = (1, 96, 128, 256)
    gen = torch.Generator(device=cuda).manual_seed(n)
    feat = torch.relu(torch.randn(shape, generator=gen, device=cuda))
    content = torch.relu(torch.randn(shape, generator=gen, device=cuda))
    s_grad = torch.randn(shape, generator=gen, device=cuda) * 1e-4
    w = torch.tensor([0.08, 1.0, -0.3], device=cuda)
    args = dict(c_norm=torch.tensor(3e-3, device=cuda),
                s_scale=w[1] / torch.tensor(7e-6, device=cuda),
                d_norm=torch.tensor(1.3e-2, device=cuda))
    cut = lambda t: Sharded(list(t.split(96 // n, 1)), 1)   # noqa: E731
    before = epilogue.launches
    diff, sums = epilogue.tap_epilogue(cut(feat), w, cut(content),
                                       s_grad=cut(s_grad), **args)
    assert epilogue.launches == before + n
    assert isinstance(diff, Sharded) and len(diff.shards) == n
    want, _ = epilogue.tap_epilogue_plain(feat, w, content, s_grad=s_grad,
                                          **args)
    assert torch.equal(_glue_bits(diff.gather()), _glue_bits(want))
    _, want_sums = epilogue.tap_epilogue_plain(
        cut(feat), w, cut(content), s_grad=cut(s_grad), **args)
    np.testing.assert_allclose(sums.cpu().numpy(), want_sums.cpu().numpy(),
                               rtol=1e-6)


@pytest.mark.cuda
def test_glue_kernels_keep_the_sharded_float32_iterate_bit_for_bit(
        cuda, monkeypatch):
    """A graphed float32 L-BFGS engine over 4 shards of one card: the
    pool and the tap epilogue launch once a shard of a sharded map, and
    through step, a chunk, an objective change, two chunks in flight and
    step, the images, state and norms are bit for bit those with the plain
    versions forced on the card, the trace scalars within 1e-6."""
    from style_transfer2_tpu_torch.ops import epilogue, pool
    hw = (400, 408)
    counts = (pool.fwd_launches, epilogue.launches)
    st, traces, images, state, norms = _single_run(
        hw, 'float32', 'lbfgs', True, placement=_shards(cuda, 4))
    # More launches than one a pool and one a tap an evaluation (a step
    # is one, the prime one more): the sharded levels launch once a shard.
    steps = len(traces)
    assert pool.fwd_launches - counts[0] > 3 * steps
    assert epilogue.launches - counts[1] > 5 * steps
    _force_plain_glue(monkeypatch)
    counts = (pool.fwd_launches, epilogue.launches)
    _, traces_p, images_p, state_p, norms_p = _single_run(
        hw, 'float32', 'lbfgs', True, placement=_shards(cuda, 4))
    assert (pool.fwd_launches, epilogue.launches) == counts
    for got, want in zip(images, images_p):
        np.testing.assert_array_equal(got, want)
    assert norms == norms_p

    def untimed(rows):
        return [{k: v for k, v in row.items() if k != 'time'}
                for row in rows]

    _assert_same_iterate((state, untimed(traces)),
                         (state_p, untimed(traces_p)))
