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
