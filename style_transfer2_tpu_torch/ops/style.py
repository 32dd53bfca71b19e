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

Under spatial sharding (parallel/spatial.py) the sum over M crosses the
shards, so style_branch_sharded runs the branch as two phases: each
shard's partial Gram X_s^T X_s / size (size the WHOLE map's c*h*w; phase
1, the kernels' Gram half with no target: st2_style_gram), summed over the
shards on the first device, G_style subtracted once; then each shard's
s_grad = X_s G_diff * 2/(C^2 size) against that G_diff broadcast back
(phase 2: st2_style_grad). The plain versions run the same two phases.

The bf16 loss feed (engine/objective.py; the JAX package's BF16_FEED with
STYLE_EINSUM and STYLE_FOLD) takes the branch as its two phases over the
tap in its own dtype, one map, lanes or a Sharded map alike:
style_gram(feat, size), X^T X / size in float32, and style_product(feat,
d), X D in the tap's dtype with D rounded to it first, float32 sums. A
bfloat16 tap launches the tensor-core kernels of csrc/style.cu
(st2_style_gram_bf16, whose partials the float32 branch's fixed-order
reduction sums, and st2_style_grad_bf16); a float32 tap (the 'data' blob)
the float32 phases above, the product with no scale. Their plain versions
are style_gram_plain and style_product_plain.
"""

import functools

import torch
import torch.nn.functional as F

from .. import _build
from ..parallel.spatial import Sharded, broadcast, on_device, reduce_sum
from ..utils import aligned, sm_count

# Launches of the kernel through fused_style_branch (chip_smoke.py resets
# and reads this).
launches = 0
# Launches of the float32 phases (style_branch_sharded, one a shard each;
# style_gram and style_product on a float32 tap).
gram_launches = 0
grad_launches = 0
# Launches of the bfloat16 phases (style_gram, style_product on a bf16 tap).
gram_bf16_launches = 0
grad_bf16_launches = 0

_TILE = 64          # output tile edge of the Gram kernel
_ROW_STEP = 16      # M-chunks are multiples of the kernel's staging depth
# Blocks (64 threads each) to aim for per SM: the Gram's split and the
# gradient product's tile rows are sized so that a launch holds about this
# many, the residency the kernels are compiled for (MIN_BLOCKS).
_BLOCKS_PER_SM = 8
# The bf16 kernels (csrc/style.cu gram_bf16_kernel, style_grad_bf16_kernel):
# one persistent block of two warpgroups an SM, X arriving by TMA in
# boxes of 64 channels, 128 bytes a row, into a ring aligned to 1024
# bytes. The Gram's stage: 256 rows of one box where C <= 64, else 64 rows
# of up to four (two 128-channel blocks), in a ring of 6; its chunks are
# whole stages. The product's slice: 128 rows of one box, in a ring of 8
# (C <= 64), 6 (C <= 256) or 4 beside D's resident panel, so C is at
# most 512.
_BF16_BLOCKS_PER_SM = 1
_BF16_ALIGN = 1024
_BF16_SLAB = 128
_BF16_MAX_C = 512


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
    with `sms` SMs: about _BLOCKS_PER_SM blocks per SM over (tiles x
    chunks x lanes), each chunk a multiple of the kernel's staging depth,
    the chunks covering rows 0..m-1 of each map in order."""
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


def _bf16_bn(c):
    """The bf16 kernels' block width: 64 where C <= 64, else 128."""
    return 64 if c <= 64 else 128


def gram_bf16_items(c):
    """The bf16 Gram kernel's items (I, J) in launch order: the blocks of
    G on or above the diagonal over channel blocks of _bf16_bn(c), row by
    row. Each writes the 64 x 64 tiles of gram_tiles(c) it holds."""
    nb = -(-c // _bf16_bn(c))
    return [(i, j) for i in range(nb) for j in range(i, nb)]


def _bf16_gram_stage(c):
    """(rows, stages, boxes of the largest stage) of the bf16 Gram's ring
    at c (csrc/style.cu GramCfg, gram_boxes): 256 rows of one box where
    C <= 64, else 64 rows of block I's two boxes and, off the diagonal,
    block J's."""
    if c <= 64:
        return 256, 6, 1
    return 64, 6, 4 if c > 128 else 2


@functools.lru_cache(maxsize=256)
def _bf16_plan(m, c, sms, lanes=1):
    """(padded c, chunk, n_chunks, partials floats, dynamic shared memory
    bytes) of the bf16 Gram over `lanes` maps on a card with `sms` SMs: a
    grid of (n_chunks, items, lanes) blocks, n_chunks as large as keeps
    the grid within _BF16_BLOCKS_PER_SM blocks an SM (one wave), each
    chunk whole stages of the kernel's ring, the chunks covering rows
    0..m-1 of each map in order; every block writes the 64 x 64 float32
    partial tiles of its item, which the reduction sums in chunk order.
    Its rows are loaded in boxes of 64 channels, 16-byte aligned, so a C
    that is not a multiple of 8 (never a VGG tap) is padded with zero
    columns. The shared memory is csrc/style.cu gram_smem's: the ring
    and its mbarriers, or the two warpgroups' float32 sums, and the
    alignment."""
    cp = -(-c // 8) * 8
    rows, stages, boxes = _bf16_gram_stage(cp)
    per_chunk = len(gram_bf16_items(cp)) * lanes
    n_chunks = max(1, min(_BF16_BLOCKS_PER_SM * sms // per_chunk,
                          -(-m // rows)))
    chunk = -(-m // n_chunks)
    chunk = -(-chunk // rows) * rows
    n_chunks = -(-m // chunk)
    ring = stages * (boxes * rows * 128 + 8)
    sums = 2 * 64 * (_bf16_bn(cp) + 8) * 4
    return (cp, chunk, n_chunks,
            lanes * n_chunks * len(gram_tiles(cp)) * _TILE * _TILE,
            max(ring, sums) + _BF16_ALIGN)


@functools.lru_cache(maxsize=256)
def _grad_bf16_plan(m, c, sms, lanes=1):
    """(padded c, blocks, dynamic shared memory bytes) of the bf16
    gradient product over `lanes` maps on a card with `sms` SMs: one
    persistent block an SM, at most one a (slab, panel) pair, a multiple
    of the ceil(c / BN) column panels of D (each block keeps one panel
    resident and walks a contiguous range of the lanes' 128-row slabs).
    The shared memory is csrc/style.cu grad_smem's: the ring of 128-row
    slices and its mbarriers, D's panel (c rounded up to 64 rows of BN
    bf16), the bf16 output tile and the alignment."""
    cp = -(-c // 8) * 8
    if cp > _BF16_MAX_C:
        raise ValueError('style_product: the bf16 kernel takes C up to %d, '
                         'got %d' % (_BF16_MAX_C, c))
    bn = _bf16_bn(cp)
    panels = -(-cp // bn)
    slabs = lanes * -(-m // _BF16_SLAB)
    blocks = max(1, min(sms // panels, slabs)) * panels
    kpad = -(-cp // 64) * 64
    stages = 8 if bn == 64 else 4 if kpad > 256 else 6
    smem = (stages * (_BF16_SLAB * 128 + 8) + kpad * bn * 2
            + _BF16_SLAB * bn * 2 + _BF16_ALIGN)
    return cp, blocks, smem


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
    _check_current(feat)
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


def _check_current(feat):
    """Raises unless feat lies on the current CUDA device (the launch runs
    there, with feat's device's stream)."""
    if feat.get_device() != torch.cuda.current_device():
        raise RuntimeError('style branch: tensor on %s, but the current '
                           'device is cuda:%d' % (feat.device,
                                                  torch.cuda.current_device()))


def style_gram_plain(feat, size, lanes=False):
    """Phase 1, plain: X^T X / size in float32 for a (1, h, w, c) map or
    shard, size the whole map's element count; with lanes=True (B, c, c)
    for (B, h, w, c) maps, lane by lane."""
    if lanes:
        return torch.stack([style_gram_plain(f[None], size) for f in feat])
    c = feat.shape[-1]
    flat = feat.reshape(-1, c).float()
    return flat.T @ flat / size


def style_grad_plain(feat, gram_diff, size):
    """Phase 2, plain: X G_diff * 2/(c^2 size) for a (1, h, w, c) shard."""
    _, h, w, c = feat.shape
    flat = feat.reshape(h * w, c).float()
    s_grad = flat @ gram_diff * (2.0 / (float(c) * float(c) * float(size)))
    return s_grad.reshape(1, h, w, c)


def style_product_plain(feat, d):
    """The bf16 feed's gradient product, plain: X D for a (1, h, w, c) map
    and a (c, c) D, or lane by lane for (B, h, w, c) maps and (B, c, c),
    with D rounded to the map's dtype first, the products and sums in
    float32 and one rounding of the result to the map's dtype."""
    if d.dim() == 3:
        return torch.cat([style_product_plain(f[None], di)
                          for f, di in zip(feat, d)])
    c = feat.shape[-1]
    flat = feat.reshape(-1, c).float()
    out = flat @ d.to(feat.dtype).float()
    return out.to(feat.dtype).reshape(feat.shape)


def _operands(feat, what, lanes=False, unit=4):
    """(x padded to a channel multiple of `unit` and aligned, c, lanes) of
    a (1, h, w, c) map, or with lanes of (B, h, w, c) maps, on the current
    device."""
    if feat.dim() != 4 or (not lanes and feat.shape[0] != 1):
        raise ValueError('%s: expected a (1, h, w, c) map%s, got %s' % (
            what, ' or (B, h, w, c) lanes' if lanes else '',
            tuple(feat.shape)))
    _check_current(feat)
    c = feat.shape[-1]
    cp = -(-c // unit) * unit
    x = feat if cp == c else F.pad(feat, (0, cp - c))
    return aligned(x), c, feat.shape[0]


def _shard_operands(feat, what):
    """(x padded to a channel multiple of 4 and aligned, c, padded c, the
    launch plan) of a (1, h, w, c) float32 shard on the current device."""
    if feat.dtype != torch.float32:
        raise TypeError('%s: the kernel takes float32' % what)
    x, c, _ = _operands(feat, what)
    _, h, w, _ = feat.shape
    return x, c, _plan(h * w, c, sm_count(feat.device))


def style_gram(feat, size, lanes=False):
    """Phase 1: X^T X / size in float32 for a (1, h, w, c) map, size the
    whole map's c*h*w, as (c, c) on its device; with lanes=True (B, c, c)
    for (B, h, w, c) maps. A bfloat16 map on the card launches the bf16
    Gram (st2_style_gram_bf16), a float32 one the float32 Gram
    (st2_style_gram), both with no target; a CPU map takes the plain
    version. A Sharded map: each shard's partial Gram under its own
    device, summed in shard order on the first device."""
    global gram_launches, gram_bf16_launches
    if isinstance(feat, Sharded):
        if lanes:
            raise ValueError('style_gram: a Sharded map has no lane axis')
        parts = []
        for s in feat.shards:
            with on_device(s):
                parts.append(style_gram(s, size))
        return reduce_sum(parts, feat.device)
    if not feat.is_cuda:
        if feat.device.type == 'cpu':
            return style_gram_plain(feat, size, lanes)
        raise RuntimeError('style_gram: no kernel for device %s'
                           % feat.device)
    h, w = feat.shape[1:3]
    m = h * w
    sms = sm_count(feat.device)
    if feat.dtype == torch.bfloat16:
        x, c, b = _operands(feat, 'style_gram', lanes, 8)
        cp, chunk, n_chunks, n_partials, _ = _bf16_plan(m, c, sms, b)
        entry, name = _build.lib().st2_style_gram_bf16, 'st2_style_gram_bf16'
    elif feat.dtype == torch.float32:
        x, c, b = _operands(feat, 'style_gram', lanes)
        cp, chunk, n_chunks, n_partials, _ = _plan(m, c, sms, b)
        entry, name = _build.lib().st2_style_gram, 'st2_style_gram'
    else:
        raise TypeError('style_gram: the kernels take bfloat16 or float32, '
                        'got %s' % feat.dtype)
    partials = torch.empty(n_partials, dtype=torch.float32,
                           device=feat.device)
    gram = torch.empty((b, cp, cp) if lanes else (cp, cp),
                       dtype=torch.float32, device=feat.device)
    err = entry(x.data_ptr(), None, partials.data_ptr(), gram.data_ptr(), m,
                cp, chunk, n_chunks, b, 1.0 / float(size), _build.stream(x))
    _build.check(err, name)
    if feat.dtype == torch.bfloat16:
        gram_bf16_launches += 1
    else:
        gram_launches += 1
    return gram if cp == c else gram[..., :c, :c].contiguous()


def style_grad(feat, gram_diff, size):
    """Phase 2: X G_diff * 2/(c^2 size) for a (1, h, w, c) float32 shard
    and the (c, c) G_diff on its device. The kernel on a CUDA shard
    (st2_style_grad), the plain version on a CPU one."""
    global grad_launches
    if not feat.is_cuda:
        return style_grad_plain(feat, gram_diff, size)
    x, c, (cp, _, _, _, rows) = _shard_operands(feat, 'style_grad')
    gd = gram_diff if cp == c else F.pad(gram_diff, (0, cp - c, 0, cp - c))
    gd = aligned(gd)
    _, h, w, _ = x.shape
    sgrad = x.new_empty(1, h, w, cp)
    err = _build.lib().st2_style_grad(
        x.data_ptr(), gd.data_ptr(), sgrad.data_ptr(), h * w, cp, rows, 1,
        2.0 / (float(c) * float(c) * float(size)), _build.stream(x))
    _build.check(err, 'st2_style_grad')
    grad_launches += 1
    return sgrad if cp == c else sgrad[..., :c].contiguous()


def style_product(feat, d):
    """The bf16 feed's gradient product: X D in the map's dtype for a
    (1, h, w, c) map and a (c, c) float32 D on its device, or for
    (B, h, w, c) maps and (B, c, c). D is rounded to the map's dtype
    first. A bfloat16 map on the card launches st2_style_grad_bf16 (float32
    sums, one rounding to bf16), a float32 one st2_style_grad with no
    scale; a CPU map takes the plain version. A Sharded map: D rounded once
    on the first device, broadcast, and each shard's product under its own
    device, Sharded as the map."""
    global grad_launches, grad_bf16_launches
    if isinstance(feat, Sharded):
        out = []
        for s, ds in zip(feat.shards,
                         broadcast(d.to(feat.dtype), feat.devices)):
            with on_device(s):
                out.append(style_product(s, ds))
        return Sharded(out, feat.axis)
    if not feat.is_cuda:
        if feat.device.type == 'cpu':
            return style_product_plain(feat, d)
        raise RuntimeError('style_product: no kernel for device %s'
                           % feat.device)
    lanes = d.dim() == 3
    bf16 = feat.dtype == torch.bfloat16
    if not bf16 and feat.dtype != torch.float32:
        raise TypeError('style_product: the kernels take bfloat16 or '
                        'float32, got %s' % feat.dtype)
    x, c, b = _operands(feat, 'style_product', lanes, 8 if bf16 else 4)
    want = (b, c, c) if lanes else (c, c)
    if tuple(d.shape) != want or d.device != feat.device:
        raise ValueError('style_product: d must be %s on the map\'s device'
                         % (want,))
    cp = x.shape[-1]
    _, h, w, _ = x.shape
    out = x.new_empty(b, h, w, cp)
    if bf16:
        # D goes to the kernel as it is, bf16 (a Sharded map's, rounded on
        # its first device) or float32, which the kernel rounds to bf16 as
        # it stages it: no cast launch.
        gd = d if d.dtype == torch.bfloat16 else d.float()
        if cp != c:
            gd = F.pad(gd, (0, cp - c, 0, cp - c))
        gd = aligned(gd)
        _, blocks, _ = _grad_bf16_plan(h * w, cp, sm_count(feat.device), b)
        err = _build.lib().st2_style_grad_bf16(
            x.data_ptr(), gd.data_ptr(), out.data_ptr(), h * w, cp, b,
            blocks, int(gd.dtype == torch.float32), _build.stream(x))
        _build.check(err, 'st2_style_grad_bf16')
        grad_bf16_launches += 1
    else:
        gd = d.to(feat.dtype)
        if cp != c:
            gd = F.pad(gd, (0, cp - c, 0, cp - c))
        gd = aligned(gd)
        rows = _plan(h * w, c, sm_count(feat.device), b)[4]
        err = _build.lib().st2_style_grad(
            x.data_ptr(), gd.data_ptr(), out.data_ptr(), h * w, cp, rows, b,
            1.0, _build.stream(x))
        _build.check(err, 'st2_style_grad')
        grad_launches += 1
    return out if cp == c else out[..., :c].contiguous()


def style_branch_sharded(feat, gram_style):
    """(s_grad, gram_diff) of fused_style_branch for a Sharded (1, h, w, c)
    float32 map (parallel/spatial.py): phase 1 on each shard (under its
    own device), the partial Grams summed in shard order on the first
    shard's device and G_style (there) subtracted once; phase 2 on each
    shard against G_diff broadcast to its device. s_grad comes back
    Sharded as feat, gram_diff on the first device."""
    size = feat.numel()
    grams = []
    for s in feat.shards:
        with on_device(s):
            grams.append(style_gram(s, size))
    gram_diff = reduce_sum(grams, feat.device) - gram_style
    out = []
    for s, gd in zip(feat.shards, broadcast(gram_diff, feat.devices)):
        with on_device(s):
            out.append(style_grad(s, gd, size))
    return Sharded(out, feat.axis), gram_diff


def fused_style_branch(feat, gram_style):
    """(s_grad, gram_diff) for a (1, h, w, c) float32 feature map and its
    (c, c) target Gram, or for (B, h, w, c) lanes and their (B, c, c)
    targets. Launches the CUDA kernels for a CUDA feat; the plain version
    for a CPU feat. A Sharded feat runs style_branch_sharded."""
    if isinstance(feat, Sharded):
        return style_branch_sharded(feat, gram_style)
    if feat.is_cuda:
        return _launch(feat, gram_style)
    if feat.device.type == 'cpu':
        return fused_style_branch_plain(feat, gram_style)
    raise RuntimeError('fused_style_branch: no kernel for device %s'
                       % feat.device)
