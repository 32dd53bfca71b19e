"""Fused 3x3 conv + bias + ReLU with a ReLU-masked input-gradient backward.

Counterpart of style_transfer2_tpu/ops/pallas/conv.py:conv3x3_bias_relu.
NHWC activations, HWIO weights, output in x's dtype:

    y  = ReLU(conv3x3_SAME(x, w) + b)
    dx = conv3x3_SAME(g * [y > 0], flip(w)^T)      (no dw, db: the image is
                                                    the only variable)

On a CUDA tensor the wrapper launches the hand-written kernels in
csrc/conv3x3.cu and csrc/conv3x3_wgmma.cu (float32 or bfloat16, f32
accumulation, never TF32). Each direction's kernel is chosen by shape in a
pure function of the shape and the card's SM count. The float32 forward
(fwd_plan): tile, or split (grids whose last wave would idle the card: the
input channels split across blocks into partial sums, added in a fixed
order before the bias and the ReLU), both staging 16 bytes at a time, or
scalar (Cin or Cout not a multiple of 4, as conv1_1's Cin = 3, or an
operand not 16-byte aligned). The bfloat16 forward: wgmma, or wgmma_split
(split likewise, the partials in float32) where Cin and Cout are multiples
of 8 and the operands 16-byte aligned; tile (the mma.sync kernel)
otherwise. The backward (bwd_plan): narrow (dx with at most 8 channels,
either dtype), split (float32, the cotangent channels split likewise) or
tile, and in bfloat16 wgmma or wgmma_split as the forward.
On a CPU tensor it runs conv3x3_bias_relu_plain, the plain PyTorch version
the tests and chip_smoke.py hold the kernels against. Any other device
raises.
"""

import functools

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import aligned, sm_count

# Launches through the wrappers below by (direction, path), 'fwd' or 'bwd'
# and a path name, for showing that a run went through each kernel
# (chip_smoke.py clears and reads this; launches() sums a direction).
path_launches = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernels' paths (csrc/conv3x3.cu, the `path` of st2_conv3x3_fwd and
# st2_conv3x3_bwd).
TILE, NARROW, SPLIT, SCALAR = 'tile', 'narrow', 'split', 'scalar'
WGMMA, WGMMA_SPLIT = 'wgmma', 'wgmma_split'
_PATH_CODES = {TILE: 0, NARROW: 1, SPLIT: 2, SCALAR: 3, WGMMA: 4,
               WGMMA_SPLIT: 5}
_SPLITS = (SPLIT, WGMMA_SPLIT)     # the paths with float32 partial sums
_TH, _TW, _TC = 8, 16, 64   # the backward tiles' pixel rows, columns, channels
_KC = 8                     # channels the float32 tile kernels stage a pass
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


# The float32 forward tile's pixel rows, columns and channels
# (csrc/conv3x3.cu: FTH, FTW, FTC).
_FWD_TH, _FWD_TW, _FWD_TC = 16, 16, 64
# Blocks of the float32 forward tile kernel resident on one SM: its 254-255
# registers a thread (ptxas, sm_90a; no spills) leave room for one block of
# 256. Held to 128 registers for two blocks, it spills and runs 1.3-1.9x
# slower on an H100 (PERF.md).
_FWD_RESIDENT = 1
# Each forward split beyond the first costs about this share more (its
# partial output written and read again, the sum pass). Fitted, with
# _FWD_RESIDENT, to every split count of the 512px, 543x724, 768x1024 and
# style-image forward shapes timed on an H100: the least summed time of
# the planned splits (PERF.md; `python -m style_transfer2_tpu_torch.
# split_sweep`, then its --fit).
_FWD_SPLIT_OVERHEAD = 0.05


# The bfloat16 wgmma kernel (csrc/conv3x3_wgmma.cu): a block's output
# pixel rows and columns, its channels (BN: 128 where Cout is a multiple
# of 128, else 64) and the input channels a stage holds (a split's range
# is a multiple of it).
_WG_TH, _WG_TW, _WG_K = 16, 16, 16
# Blocks of it resident on one SM: its ring (4 stages, 115-230 KB) and up
# to 128 accumulators a thread leave room for one block of 256 threads.
_BF16_FWD_RESIDENT = 1
_BF16_BWD_RESIDENT = 1
# A bf16 split's float32 partial sums cost, in units of one unsplit wave,
# about splits x (output waves) x _BF16_*_PARTIALS / Cin: they are written
# and read again at the memory's rate while the MMAs run at the tensor
# cores', so the cost falls with the channels each output sums. Fitted to
# every split count of the bf16 forward and backward shapes timed on an
# H100 (PERF.md; `python -m style_transfer2_tpu_torch.split_sweep`, then
# its --fit).
_BF16_FWD_PARTIALS = 96.0
_BF16_BWD_PARTIALS = 96.0


def _split_cost(blocks, splits, kspan, k, slots, overhead):
    """Estimated time of the tile grid split `splits` ways, in units of
    one wave of the unsplit kernel: whole waves of `slots` resident blocks,
    each block's work in proportion to its kspan of the k channels, and
    `overhead` for each split beyond the first."""
    waves = -(-blocks * splits // slots)
    return waves * kspan / k * (1 + overhead * (splits - 1))


def _bf16_split_cost(blocks, splits, kspan, k, slots, partials):
    """The same estimate for the bf16 wgmma grid: whole waves as in
    _split_cost, plus, split, the float32 partial sums' traffic:
    splits x blocks / slots x partials / k."""
    waves = -(-blocks * splits // slots)
    cost = waves * kspan / k
    if splits > 1:
        cost += splits * blocks / slots * partials / k
    return cost


def _best_split(blocks, k, slots, overhead, unit=_KC, cost_fn=_split_cost):
    """(splits, kspan) of least estimated time (cost_fn) over 1 ..
    _MAX_SPLITS ranges of kspan channels (a multiple of `unit`, at least
    _MIN_SPLIT_CHANNELS); (1, k) unless a split cuts the unsplit estimate
    by _SPLIT_GAIN or more."""
    base = cost_fn(blocks, 1, k, k, slots, overhead)
    best = (base, 1, k)
    for want in range(2, min(_MAX_SPLITS, k // _MIN_SPLIT_CHANNELS) + 1):
        kspan = -(-(-(-k // want)) // unit) * unit
        splits = -(-k // kspan)
        cost = cost_fn(blocks, splits, kspan, k, slots, overhead)
        if splits > best[1] and cost < best[0]:
            best = (cost, splits, kspan)
    cost, splits, kspan = best
    if splits < 2 or cost > (1 - _SPLIT_GAIN) * base:
        return 1, k
    return splits, kspan


def _bf16_plan(n, h, w, cin, cout, sms, resident, partials):
    """(path, splits, kspan) of a bf16 conv summing cin channels into cout:
    TILE (the mma.sync kernel) unless both are multiples of 8; else WGMMA,
    or WGMMA_SPLIT where a split of cin cuts _bf16_split_cost's estimate by
    _SPLIT_GAIN or more."""
    if cin % 8 or cout % 8:
        return TILE, 1, cin
    blocks = (n * -(-h // _WG_TH) * -(-w // _WG_TW)
              * -(-cout // wgmma_bn(cout)))
    splits, kspan = _best_split(blocks, cin, resident * sms, partials,
                                _WG_K, _bf16_split_cost)
    return (WGMMA if splits == 1 else WGMMA_SPLIT), splits, kspan


@functools.lru_cache(maxsize=None)
def fwd_plan(n, h, w, cin, cout, dtype, sms):
    """(path, splits, kspan) of the forward for x (n, h, w, cin) and y (n,
    h, w, cout) on a card with `sms` SMs: for float32, SCALAR where cin or
    cout is not a multiple of 4; SPLIT into `splits` ranges of kspan input
    channels (a multiple of 8, at least 32) where that cuts the tile
    grid's estimated time (_split_cost, _FWD_RESIDENT blocks an SM,
    _FWD_SPLIT_OVERHEAD) by _SPLIT_GAIN or more; TILE (splits 1, kspan cin)
    otherwise. bfloat16: _bf16_plan (WGMMA, WGMMA_SPLIT of ranges a
    multiple of 16, or TILE for channels not in eights). Cached: the
    wrappers plan every launch, and a plan costs microseconds of host
    time."""
    if dtype != torch.float32:
        return _bf16_plan(n, h, w, cin, cout, sms, _BF16_FWD_RESIDENT,
                          _BF16_FWD_PARTIALS)
    if cin % 4 or cout % 4:
        return SCALAR, 1, cin
    blocks = (n * -(-h // _FWD_TH) * -(-w // _FWD_TW)
              * -(-cout // _FWD_TC))
    splits, kspan = _best_split(blocks, cin, _FWD_RESIDENT * sms,
                                _FWD_SPLIT_OVERHEAD)
    return (TILE if splits == 1 else SPLIT), splits, kspan


@functools.lru_cache(maxsize=None)
def bwd_plan(n, h, w, k, cout, dtype, sms):
    """(path, splits, kspan) of the masked backward for g and y (n, h, w,
    k) and dx (n, h, w, cout) on a card with `sms` SMs: NARROW for a dx of
    at most 8 channels (k a multiple of 4), in either dtype; for float32,
    SPLIT into `splits` ranges of kspan cotangent channels (a multiple of
    8, at least 32) where that cuts the tile grid's estimated time
    (_split_cost) by _SPLIT_GAIN or more, with the splits of least
    estimated time, TILE (splits 1, kspan k) otherwise; for bfloat16,
    _bf16_plan over the k cotangent channels. Cached, as fwd_plan."""
    if cout <= _NARROW_MAX_COUT and k % 4 == 0:
        return NARROW, 1, k
    if dtype != torch.float32:
        return _bf16_plan(n, h, w, k, cout, sms, _BF16_BWD_RESIDENT,
                          _BF16_BWD_PARTIALS)
    blocks = n * -(-h // _TH) * -(-w // _TW) * -(-cout // _TC)
    splits, kspan = _best_split(blocks, k, _BWD_RESIDENT * sms,
                                _SPLIT_OVERHEAD)
    return (TILE if splits == 1 else SPLIT), splits, kspan


def wgmma_bn(cout):
    """Output channels a block of the wgmma kernel owns."""
    return 128 if cout % 128 == 0 else 64


def wgmma_weights(w):
    """The wgmma kernel's weights from w (3, 3, Cin, Cout): zero-padded to
    Cin a multiple of 16 and Cout of BN (wgmma_bn), and blocked (Cout/BN,
    Cin/16, 3, 3, 2, BN/8, 8, 8) as (channel block, 16-channel slice, tap,
    k / 8, n / 8, k % 8, n % 8): one slice of one block's weights is
    contiguous, in the order of the kernel's shared-memory stage (8 x 8
    core matrices), so that one bulk copy stages it."""
    _, _, cin, cout = w.shape
    bn = wgmma_bn(cout)
    w = F.pad(w.detach(), (0, -cout % bn, 0, -cin % 16))
    cin, cout = w.shape[2], w.shape[3]
    w = w.reshape(3, 3, cin // 16, 2, 8, cout // bn, bn // 8, 8)
    return w.permute(5, 2, 0, 1, 3, 6, 4, 7).contiguous()


def _wgmma_weights(w):
    """wgmma_weights(w), kept on w itself beside w's version counter (an
    in-place update makes it stale): a model's weights are blocked once,
    not on every call, and the copy goes when w goes."""
    cached = getattr(w, '_wgmma_blocked', None)
    if cached is None or cached[0] != w._version:
        cached = w._wgmma_blocked = (w._version, wgmma_weights(w))
    return cached[1]


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


def launches(direction):
    """The wrappers' launches in one direction ('fwd' or 'bwd'), over
    every path."""
    return sum(n for (d, _), n in path_launches.items() if d == direction)


def _launch_fwd(x, w, b, plan=None):
    """ReLU(conv3x3_SAME(x, w) + b). plan: a (path, splits, kspan) to
    launch instead of fwd_plan's, for timing the alternatives
    (chip_smoke.py, split_sweep.py). An operand that is not 16-byte aligned
    (a view into a larger tensor) takes the float32 scalar path or the
    bfloat16 tile (mma.sync) path."""
    _check(x, w, b, 'conv3x3 forward')
    if b.shape != (w.shape[3],):
        raise ValueError('conv3x3 forward: bias shape %s' % (tuple(b.shape),))
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    path, splits, kspan = plan or fwd_plan(n, h, wd, cin, cout, x.dtype,
                                           sm_count(x.device))
    xp, wp, bp = x.data_ptr(), w.data_ptr(), b.data_ptr()
    if path in (SPLIT, TILE) and x.dtype == torch.float32 and (
            xp | wp | bp) % 16:
        path, splits, kspan = SCALAR, 1, cin
    elif path in (WGMMA, WGMMA_SPLIT):
        if xp % 16:
            path, splits, kspan = TILE, 1, cin
        else:
            wp = _wgmma_weights(w).data_ptr()
    y = x.new_empty(n, h, wd, cout)
    yp = pp = y.data_ptr()
    if path in _SPLITS:
        parts = x.new_empty(splits, n, h, wd, cout, dtype=torch.float32)
        pp = parts.data_ptr()
    err = _build.lib().st2_conv3x3_fwd(
        _DTYPE_CODES[x.dtype], _PATH_CODES[path], xp, wp, bp, yp, pp, n, h,
        wd, cin, cout, splits, kspan, _build.stream(x))
    if err:      # the message is built only for a failed launch
        _build.check(err, 'st2_conv3x3_fwd (%s)' % path)
    key = ('fwd', path)
    path_launches[key] = path_launches.get(key, 0) + 1
    return y


def _launch_bwd(g, y, wt, plan=None):
    """dx for the cotangent g, the forward output y and the backward
    weights wt (3, 3, K, Cout) (backward_weights of the forward's). plan:
    a (path, splits, kspan) to launch instead of bwd_plan's, for timing
    the alternatives (chip_smoke.py, split_sweep.py)."""
    _check(g, wt, None, 'conv3x3 backward')
    if y.shape != g.shape or y.dtype != g.dtype:
        raise ValueError('conv3x3 backward: g and y must match')
    n, h, wd, k = g.shape
    cout = wt.shape[3]
    path, splits, kspan = plan or bwd_plan(n, h, wd, k, cout, g.dtype,
                                           sm_count(g.device))
    if g.dtype == torch.float32 or path == NARROW:
        g, y, wt = aligned(g), aligned(y), aligned(wt)
    else:
        g, y, wt = g.contiguous(), y.contiguous(), wt.contiguous()
        if path != TILE and (g.data_ptr() | y.data_ptr()) % 16:
            path, splits, kspan = TILE, 1, k
    dx = g.new_empty(n, h, wd, cout)
    parts = (g.new_empty(splits, n, h, wd, cout, dtype=torch.float32)
             if path in _SPLITS else dx)
    wtp = (_wgmma_weights(wt) if path in (WGMMA, WGMMA_SPLIT)
           else wt).data_ptr()
    err = _build.lib().st2_conv3x3_bwd(
        _DTYPE_CODES[g.dtype], _PATH_CODES[path], g.data_ptr(), y.data_ptr(),
        wtp, dx.data_ptr(), parts.data_ptr(), n, h, wd, k, cout,
        splits, kspan, _build.stream(g))
    _build.check(err, 'st2_conv3x3_bwd (%s)' % path)
    key = ('bwd', path)
    path_launches[key] = path_launches.get(key, 0) + 1
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
