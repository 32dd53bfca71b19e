"""Fused style-loss branch: Gram, Gram difference and style half-gradient.

Counterpart of style_transfer2_tpu/ops/pallas/style_kernel.py:
fused_style_branch. For an NHWC feature map X (M = h*w rows of C channels)
and a target Gram G_style:

    G_diff = X^T X / size - G_style                   size = M*C
    s_grad = X G_diff * 2 / (C^2 * size)

It takes one map, (1, h, w, C) with a (C, C) target, or a lane axis:
(B, h, w, C) maps with (B, C, C) targets, B independent jobs of the
batched engine, each lane with its own target and its own results (the
counterpart of jax.vmap over the Pallas call).

On a CUDA tensor the wrapper launches the kernels in csrc/style.cu (a
split-M Gram over the upper-triangle tiles, a fixed-order reduction with
the G_diff epilogue, and the gradient product; float32, never TF32,
deterministic), all lanes in one launch sequence. On a CPU tensor it runs
fused_style_branch_plain, two matmuls a lane. Any other device raises.
The outputs are injected as vjp cotangents and never differentiated
through.

The launch plan (gram_tiles, gram_plan) is a pure function of the shape,
the lane count and the card's SM count, so the CPU tests check it.
"""

import functools

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import aligned, sm_count

# Launches of the kernel through fused_style_branch (chip_smoke.py resets
# and reads this).
launches = 0

_TILE = 64          # output tile edge of the Gram kernel
_ROW_STEP = 16      # M-chunks are multiples of the kernel's staging depth
# Blocks (64 threads each) to aim for per SM: the Gram's split and the
# gradient product's tile rows are sized so that a launch holds about this
# many, the residency the kernels are compiled for (MIN_BLOCKS).
_BLOCKS_PER_SM = 8


def fused_style_branch_plain(feat, gram_style):
    """The plain version: (s_grad (1, h, w, c), gram_diff (c, c)), two
    matmuls; or with a lane axis (s_grad (B, h, w, c), gram_diff
    (B, c, c)) for (B, c, c) targets, the same two matmuls lane by lane.
    Not torch.bmm: over the h*w rows of a 512px tap, cuBLAS's float32 bmm
    strays from a float64 reference by far more than the kernel or
    torch.mm does (chip_smoke.py prints all three beside it)."""
    if gram_style.dim() == 3:
        lanes = [fused_style_branch_plain(feat[i:i + 1], gram_style[i])
                 for i in range(feat.shape[0])]
        return (torch.cat([s for s, _ in lanes]),
                torch.stack([g for _, g in lanes]))
    _, h, w, c = feat.shape
    size = h * w * c
    flat = feat.reshape(h * w, c).float()
    gram_diff = flat.T @ flat / size - gram_style.float()
    s_grad = flat @ gram_diff * (2.0 / (float(c) * float(c) * float(size)))
    return s_grad.reshape(1, h, w, c), gram_diff


def gram_tiles(c):
    """The Gram kernel's tiles (i, j), i <= j, in launch order: the upper
    triangle of the ceil(c/64)-square tile grid, row by row."""
    nt = -(-c // _TILE)
    return [(i, j) for i in range(nt) for j in range(i, nt)]


def gram_plan(m, c, sms, lanes=1):
    """(chunk, n_chunks) for the split-M Gram of `lanes` maps on a card
    with `sms` SMs: about _BLOCKS_PER_SM blocks per SM over (tiles x chunks
    x lanes), each chunk a multiple of 16 rows, the chunks covering rows
    0..m-1 of each map in order."""
    target = _BLOCKS_PER_SM * sms
    n_chunks = max(1, min(-(-target // (len(gram_tiles(c)) * lanes)),
                          -(-m // _ROW_STEP)))
    chunk = -(-m // n_chunks)
    chunk = -(-chunk // _ROW_STEP) * _ROW_STEP
    return chunk, -(-m // chunk)


def grad_tile_rows(m, c, sms, lanes=1):
    """Rows of the gradient product's tile: 64, or 32 where a 64-row grid
    over `lanes` maps would hold fewer than half of _BLOCKS_PER_SM blocks
    per SM."""
    blocks = -(-m // 64) * -(-c // _TILE) * lanes
    return 32 if 2 * blocks < _BLOCKS_PER_SM * sms else 64


@functools.lru_cache(maxsize=256)
def _plan(m, c, sms, lanes=1):
    """(padded c, chunk, n_chunks, partials floats, gradient tile rows) of
    one launch over `lanes` maps. The kernel copies rows in 16-byte pieces,
    so a C that is not a multiple of 4 (never a VGG tap) is padded with
    zero columns, which add nothing to X^T X and come back as zero columns
    of s_grad."""
    cp = -(-c // 4) * 4
    chunk, n_chunks = gram_plan(m, cp, sms, lanes)
    n_partials = lanes * n_chunks * len(gram_tiles(cp)) * _TILE * _TILE
    return cp, chunk, n_chunks, n_partials, grad_tile_rows(m, cp, sms,
                                                           lanes)


def _launch(feat, gram_style):
    """Launches the kernels on (1, h, w, c) with (c, c), or on (B, h, w, c)
    with (B, c, c): every lane in one launch sequence."""
    global launches
    lanes = gram_style.dim() == 3
    if feat.dim() != 4 or (not lanes and feat.shape[0] != 1):
        raise ValueError('fused_style_branch: expected (1, h, w, c) or, '
                         'with (B, c, c) targets, (B, h, w, c); got %s'
                         % (tuple(feat.shape),))
    b, h, w, c = feat.shape
    dev = feat.device
    want = (b, c, c) if lanes else (c, c)
    if gram_style.shape != want or gram_style.device != dev:
        raise ValueError('fused_style_branch: gram_style must be %s on the '
                         'feature map\'s device' % (want,))
    if feat.dtype != torch.float32 or gram_style.dtype != torch.float32:
        raise TypeError('fused_style_branch: the kernel takes float32')
    m = h * w
    size = m * c
    cp, chunk, n_chunks, n_partials, rows = _plan(m, c, sm_count(dev), b)
    x, gs = feat, gram_style
    if cp != c:
        x = F.pad(feat, (0, cp - c))
        gs = F.pad(gram_style, (0, cp - c, 0, cp - c))
    x, gs = aligned(x), gs.contiguous()
    # The host work above runs while the card is idle in a lone call, so it
    # is kept to a few tensor calls: one flat scratch buffer, the outputs in
    # their final shapes.
    partials = x.new_empty(n_partials)
    gdiff = x.new_empty((b, cp, cp) if lanes else (cp, cp))
    sgrad = x.new_empty(b, h, w, cp)
    err = _build.lib().st2_style_branch(
        x.data_ptr(), gs.data_ptr(), partials.data_ptr(), gdiff.data_ptr(),
        sgrad.data_ptr(), m, cp, chunk, n_chunks, rows, b,
        1.0 / float(size), 2.0 / (float(c) * float(c) * float(size)),
        _build.stream(x))
    _build.check(err, 'st2_style_branch')
    launches += 1
    if cp != c:
        sgrad, gdiff = (sgrad[..., :c].contiguous(),
                        gdiff[..., :c, :c].contiguous())
    return sgrad, gdiff


def fused_style_branch(feat, gram_style):
    """(s_grad, gram_diff) for a (1, h, w, c) float32 feature map and its
    (c, c) target Gram, or for (B, h, w, c) lanes and their (B, c, c)
    targets. Launches the CUDA kernels for a CUDA feat; the plain version
    for a CPU feat."""
    if feat.is_cuda:
        return _launch(feat, gram_style)
    if feat.device.type == 'cpu':
        return fused_style_branch_plain(feat, gram_style)
    raise RuntimeError('fused_style_branch: no kernel for device %s'
                       % feat.device)
