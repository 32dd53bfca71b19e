"""Fused 3x3 conv + bias + ReLU with a ReLU-masked input-gradient backward.

Counterpart of style_transfer2_tpu/ops/pallas/conv.py:conv3x3_bias_relu.
NHWC activations, HWIO weights, output in x's dtype:

    y  = ReLU(conv3x3_SAME(x, w) + b)
    dx = conv3x3_SAME(g * [y > 0], flip(w)^T)      (no dw, db: the image is
                                                    the only variable)

On a CUDA tensor the wrapper launches the hand-written kernels in
csrc/conv3x3.cu (float32 or bfloat16, f32 accumulation, never TF32). On a
CPU tensor it runs conv3x3_bias_relu_plain, the plain PyTorch version the
tests and chip_smoke.py hold the kernels against. Any other device raises.
"""

import torch
import torch.nn.functional as F

from .. import _build

# Launches of each kernel through the wrappers below, for showing that a
# run went through them (chip_smoke.py resets and reads these).
fwd_launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_bias_relu_plain(x, w, b):
    """ReLU(conv3x3_SAME(x, w) + b) with F.conv2d; autograd gives the
    backward. x (N, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    return torch.relu(y).permute(0, 2, 3, 1).contiguous()


def _check(x, w, b, what):
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError('%s: expected x (N, H, W, C) and w (3, 3, C, Cout), '
                         'got %s and %s' % (what, tuple(x.shape),
                                            tuple(w.shape)))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError('%s: unsupported dtype %s' % (what, x.dtype))
    for t in (w, b):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise TypeError('%s: weights must match x in dtype and device'
                            % what)


def _dense(t):
    """t contiguous and 16-byte aligned: the bf16 kernel stages 16 bytes per
    load, and a view into a larger tensor may start at any element."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(x, w, b):
    global fwd_launches
    _check(x, w, b, 'conv3x3 forward')
    if b.shape != (w.shape[3],):
        raise ValueError('conv3x3 forward: bias shape %s' % (tuple(b.shape),))
    x, w, b = _dense(x), _dense(w), _dense(b)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.lib()
    err = lib.st2_conv3x3_fwd(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        y.data_ptr(), n, h, wd, cin, cout,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'st2_conv3x3_fwd')
    fwd_launches += 1
    return y


def _launch_bwd(g, y, w):
    global bwd_launches
    _check(g, w.transpose(2, 3), None, 'conv3x3 backward')
    if y.shape != g.shape or y.dtype != g.dtype:
        raise ValueError('conv3x3 backward: g and y must match')
    g, y = _dense(g), _dense(y)
    # Flipped in space, transposed in/out: (3, 3, Cout, Cin).
    wt = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()
    n, h, wd, cout = g.shape
    cin = wt.shape[3]
    dx = torch.empty((n, h, wd, cin), dtype=g.dtype, device=g.device)
    lib = _build.lib()
    err = lib.st2_conv3x3_bwd(
        _DTYPE_CODES[g.dtype], g.data_ptr(), y.data_ptr(), wt.data_ptr(),
        dx.data_ptr(), n, h, wd, cout, cin,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, 'st2_conv3x3_bwd')
    bwd_launches += 1
    return dx


class _Conv3x3BiasReLU(torch.autograd.Function):
    """The CUDA path: forward kernel, masked input-gradient kernel."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = _launch_fwd(x, w, b)
        ctx.save_for_backward(y, w)
        return y

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        dx = _launch_bwd(g, y, w) if ctx.needs_input_grad[0] else None
        return dx, None, None


def conv3x3_bias_relu(x, w, b):
    """ReLU(conv3x3_SAME(x, w) + b), NHWC/HWIO, differentiable in x.
    Launches the CUDA kernels for a CUDA x; the plain version for a CPU x."""
    if x.is_cuda:
        return _Conv3x3BiasReLU.apply(x, w, b)
    if x.device.type == 'cpu':
        return conv3x3_bias_relu_plain(x, w, b)
    raise RuntimeError('conv3x3_bias_relu: no kernel for device %s'
                       % x.device)
