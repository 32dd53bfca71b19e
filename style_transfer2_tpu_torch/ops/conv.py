"""Fused 3x3 conv + bias + ReLU with a ReLU-masked input-gradient backward.

Counterpart of style_transfer2_tpu/ops/pallas/conv.py:conv3x3_bias_relu.
NHWC activations, HWIO weights, output in x's dtype:

    y  = ReLU(conv3x3_SAME(x, w) + b)
    dx = conv3x3_SAME(g * [y > 0], flip(w)^T)      (no dw, db: the image is
                                                    the only variable)

On a CUDA tensor the wrapper launches the hand-written kernels in
csrc/conv3x3.cu (float32 or bfloat16, f32 accumulation, never TF32). The
backward takes one of three kernels, chosen by shape alone in bwd_plan, a
pure function of the shape and the card's SM count: narrow (dx with at
most 8 channels, either dtype), split (float32 grids whose last wave
would idle the card, the cotangent channels split across blocks and
summed in a fixed order) or tile. On a CPU tensor it runs conv3x3_bias_relu_plain, the plain PyTorch
version the tests and chip_smoke.py hold the kernels against. Any other
device raises.
"""

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import aligned, sm_count

# Launches of each kernel through the wrappers below, for showing that a
# run went through them (chip_smoke.py resets and reads these).
fwd_launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The backward's paths (csrc/conv3x3.cu, st2_conv3x3_bwd's `path`).
TILE, NARROW, SPLIT = 'tile', 'narrow', 'split'
_PATH_CODES = {TILE: 0, NARROW: 1, SPLIT: 2}
_TH, _TW, _TC = 8, 16, 64   # the tile kernels' pixel rows, columns, channels
_KC = 8                     # channels the float32 tile kernel stages a pass
_NARROW_MAX_COUT = 8
# Blocks of the float32 tile backward resident on one SM: its ~200-220
# registers a thread (ptxas, sm_90a) leave room for one block of 256.
_BWD_RESIDENT = 1
_MAX_SPLITS = 8
_MIN_SPLIT_CHANNELS = 32    # cotangent channels per split, at least
# Each split beyond the first costs about this share more (its partial
# output written and read again, one more block prologue), and a split
# must cut the estimated time by _SPLIT_GAIN or more. Fitted to every
# split count of the 512px, 543x724 and 768x1024 backward shapes timed on
# an H100 (PERF.md; `python -m style_transfer2_tpu_torch.split_sweep`).
_SPLIT_OVERHEAD = 0.05
_SPLIT_GAIN = 0.05


def _split_cost(blocks, splits, kspan, k, slots):
    """Estimated time of the tile grid split `splits` ways, in units of
    one wave of the unsplit kernel: whole waves of `slots` resident blocks,
    each block's work in proportion to its kspan of the k channels, and
    _SPLIT_OVERHEAD for each split beyond the first."""
    waves = -(-blocks * splits // slots)
    return waves * kspan / k * (1 + _SPLIT_OVERHEAD * (splits - 1))


def bwd_plan(n, h, w, k, cout, dtype, sms):
    """(path, splits, kspan) of the masked backward for g and y (n, h, w,
    k) and dx (n, h, w, cout) on a card with `sms` SMs: NARROW for a dx of
    at most 8 channels (k a multiple of 4), in either dtype; SPLIT into
    `splits` ranges of kspan cotangent channels (a multiple of 8, at least
    32) where that cuts the float32 tile grid's estimated time
    (_split_cost) by _SPLIT_GAIN or more, with the splits of least
    estimated time; TILE (splits 1, kspan k) otherwise, and for every other
    bfloat16 shape."""
    if cout <= _NARROW_MAX_COUT and k % 4 == 0:
        return NARROW, 1, k
    if dtype != torch.float32:
        return TILE, 1, k
    blocks = n * -(-h // _TH) * -(-w // _TW) * -(-cout // _TC)
    slots = _BWD_RESIDENT * sms
    base = _split_cost(blocks, 1, k, k, slots)
    best = (base, 1, k)
    for want in range(2, min(_MAX_SPLITS, k // _MIN_SPLIT_CHANNELS) + 1):
        kspan = -(-(-(-k // want)) // _KC) * _KC
        splits = -(-k // kspan)
        cost = _split_cost(blocks, splits, kspan, k, slots)
        if splits > best[1] and cost < best[0]:
            best = (cost, splits, kspan)
    cost, splits, kspan = best
    if splits < 2 or cost > (1 - _SPLIT_GAIN) * base:
        return TILE, 1, k
    return SPLIT, splits, kspan


def backward_weights(w):
    """The backward's weights from the forward's (3, 3, Cin, Cout): flipped
    in space, transposed in/out, (3, 3, Cout, Cin). Computed once per model
    (models/vgg19.py) rather than on every backward."""
    return torch.flip(w, (0, 1)).transpose(2, 3).contiguous()


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


def _launch_fwd(x, w, b):
    global fwd_launches
    _check(x, w, b, 'conv3x3 forward')
    if b.shape != (w.shape[3],):
        raise ValueError('conv3x3 forward: bias shape %s' % (tuple(b.shape),))
    x, w, b = aligned(x), aligned(w), aligned(b)
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


def _launch_bwd(g, y, wt, plan=None):
    """dx for the cotangent g, the forward output y and the backward
    weights wt (3, 3, K, Cout) (backward_weights of the forward's). plan:
    a (path, splits, kspan) to launch instead of bwd_plan's, for timing
    the alternatives (chip_smoke.py, split_sweep.py)."""
    global bwd_launches
    _check(g, wt, None, 'conv3x3 backward')
    if y.shape != g.shape or y.dtype != g.dtype:
        raise ValueError('conv3x3 backward: g and y must match')
    g, y, wt = aligned(g), aligned(y), aligned(wt)
    n, h, wd, k = g.shape
    cout = wt.shape[3]
    path, splits, kspan = plan or bwd_plan(n, h, wd, k, cout, g.dtype,
                                           sm_count(g.device))
    dx = torch.empty((n, h, wd, cout), dtype=g.dtype, device=g.device)
    parts = (torch.empty((splits, n, h, wd, cout), dtype=g.dtype,
                         device=g.device) if path == SPLIT else dx)
    err = _build.lib().st2_conv3x3_bwd(
        _DTYPE_CODES[g.dtype], _PATH_CODES[path], g.data_ptr(), y.data_ptr(),
        wt.data_ptr(), dx.data_ptr(), parts.data_ptr(), n, h, wd, k, cout,
        splits, kspan, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, 'st2_conv3x3_bwd (%s)' % path)
    bwd_launches += 1
    return dx


class _Conv3x3BiasReLU(torch.autograd.Function):
    """The CUDA path: forward kernel, masked input-gradient kernel."""

    @staticmethod
    def forward(ctx, x, w, b, wt):
        y = _launch_fwd(x, w, b)
        ctx.save_for_backward(y, wt)
        return y

    @staticmethod
    def backward(ctx, g):
        y, wt = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _launch_bwd(g, y, wt)
        return dx, None, None, None


def conv3x3_bias_relu(x, w, b, wt):
    """ReLU(conv3x3_SAME(x, w) + b), NHWC/HWIO, differentiable in x.
    Launches the CUDA kernels for a CUDA x; the plain version for a CPU x.
    wt: backward_weights(w), which the caller keeps beside w (the card's
    backward takes it; the plain version ignores it)."""
    if x.is_cuda:
        return _Conv3x3BiasReLU.apply(x, w, b, wt)
    if x.device.type == 'cpu':
        return conv3x3_bias_relu_plain(x, w, b)
    raise RuntimeError('conv3x3_bias_relu: no kernel for device %s'
                       % x.device)
