"""The trunk's 2x2 stride-2 max pool over NHWC with Caffe's ceil-mode output
size (out = ceil(H/2), ceil(W/2)), differentiable, the gradient split
evenly among a window's ties as the JAX reference's jnp.max splits it
(F.max_pool2d would send it to one).

max_pool_ceil_plain is the plain version: the bottom/right edge padded
with -inf and the 2x2 windows reduced with torch.amax, whose backward
(scale_grad_by_count) gives each tie (g / count) * mask in the tensor's
dtype.

On a CUDA tensor max_pool_ceil launches csrc/pool.cu through an autograd
Function: the forward writes the pooled map and a 4-bit tie mask an
output (a byte each), the ragged edge masked in the kernel rather than
padded; the backward reads the mask and the cotangent and writes the
input gradient. Both give the plain version's values bit for bit (the
csrc/pool.cu header says how). Where no gradient is wanted (grad mode off,
or x not requiring it) the forward writes no mask. On a CPU tensor it
runs the plain version. Any other device raises. float32 and bfloat16, any
N, H, W and C; 16-byte accesses where C is a multiple of 16 bytes' worth
of values.
"""

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import aligned

# Launches of each kernel through max_pool_ceil (chip_smoke.py resets and
# reads these).
fwd_launches = 0
bwd_launches = 0

_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def max_pool_ceil_plain(x):
    """The plain version: F.pad with -inf where H or W is odd, then
    torch.amax over the 2x2 windows."""
    n, h, w, c = x.shape
    pad_h, pad_w = h % 2, w % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h), value=float('-inf'))
    h2, w2 = (h + pad_h) // 2, (w + pad_w) // 2
    return torch.amax(x.reshape(n, h2, 2, w2, 2, c), dim=(2, 4))


def _check(x, what):
    if x.dtype not in _BF16:
        raise TypeError('%s: the kernel takes float32 or bfloat16, got %s'
                        % (what, x.dtype))
    if x.dim() != 4:
        raise ValueError('%s: expected an (n, h, w, c) map, got %s'
                         % (what, tuple(x.shape)))
    if x.get_device() != torch.cuda.current_device():
        raise RuntimeError('%s: tensor on %s, but the current device is '
                           'cuda:%d' % (what, x.device,
                                        torch.cuda.current_device()))


def _vec(c, dtype):
    """Whether a launch over c channels takes 16-byte accesses (every
    operand is a fresh or aligned() tensor, so 16-byte aligned)."""
    return int(c % (16 // (2 if dtype == torch.bfloat16 else 4)) == 0)


def _forward(x, with_mask):
    """(y, the tie mask or None) of the kernel's forward."""
    global fwd_launches
    _check(x, 'max_pool_ceil')
    x = aligned(x)
    n, h, w, c = x.shape
    y = x.new_empty(n, (h + 1) // 2, (w + 1) // 2, c)
    mask = (torch.empty(y.shape, dtype=torch.uint8, device=x.device)
            if with_mask else None)
    err = _build.lib().st2_pool_fwd(
        x.data_ptr(), y.data_ptr(), None if mask is None else mask.data_ptr(),
        n, h, w, c, _BF16[x.dtype], _vec(c, x.dtype), _build.stream(x))
    _build.check(err, 'st2_pool_fwd')
    fwd_launches += 1
    return y, mask


def _backward(g, mask, hw):
    """The input gradient of an (n, h, w, c) map with hw = (h, w) from the
    cotangent g of its pool and the forward's tie mask."""
    global bwd_launches
    _check(g, 'max_pool_ceil backward')
    g = aligned(g)
    n, _, _, c = g.shape
    h, w = hw
    dx = g.new_empty(n, h, w, c)
    err = _build.lib().st2_pool_bwd(
        g.data_ptr(), mask.data_ptr(), dx.data_ptr(), n, h, w, c,
        _BF16[g.dtype], _vec(c, g.dtype), _build.stream(g))
    _build.check(err, 'st2_pool_bwd')
    bwd_launches += 1
    return dx


class _MaxPoolCeil(torch.autograd.Function):
    """The kernels as one differentiable op; the mask is saved for the
    backward (under torch.utils.checkpoint, recomputed with the forward)."""

    @staticmethod
    def forward(ctx, x):
        y, mask = _forward(x, True)
        ctx.save_for_backward(mask)
        ctx.hw = tuple(x.shape[1:3])
        return y

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        return _backward(g, mask, ctx.hw)


def max_pool_ceil(x):
    """2x2 stride-2 max pool of an (n, h, w, c) map with Caffe's ceil-mode
    size: the kernels for a CUDA x (on the current device), the plain
    version for a CPU x."""
    if x.is_cuda:
        if torch.is_grad_enabled() and x.requires_grad:
            return _MaxPoolCeil.apply(x)
        return _forward(x, False)[0]
    if x.device.type == 'cpu':
        return max_pool_ceil_plain(x)
    raise RuntimeError('max_pool_ceil: no kernel for device %s' % x.device)
