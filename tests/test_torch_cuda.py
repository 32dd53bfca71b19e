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
    before = (conv.fwd_launches, conv.bwd_launches)
    xk = xt.clone().requires_grad_(True)
    y = conv.conv3x3_bias_relu(xk, wt, bt)
    dx = torch.autograd.grad(y, xk, gt)[0]
    assert (conv.fwd_launches, conv.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
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
    aligned; the wrapper copies it rather than fault on a 16-byte load."""
    x, w, b, g = _conv_case(8, (1, 6, 10, 16), 16)
    flat = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(
        np.float32)).to(cuda, torch.bfloat16)
    xv = flat[1:].view(x.shape)
    assert xv.data_ptr() % 16 != 0
    wt, bt, gt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (w, b, g))
    xk = xv.detach().requires_grad_(True)
    y = conv.conv3x3_bias_relu(xk, wt, bt)
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
