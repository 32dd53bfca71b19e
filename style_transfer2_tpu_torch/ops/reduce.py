"""Sum of squares with float32 products and sums: the bf16 loss feed's
reduction (style_transfer2_tpu/engine/objective.py f32_sumsq).

sumsq(t) is sum(float(t)^2) over every element of a bfloat16 (or float32)
tensor, accumulated in float32, as a 0-d float32 tensor; with lanes=True,
over every element of each lane of a (B, ...) tensor, as (B,). The JAX
package writes it as an einsum of the tensor with itself with a float32
result type, which XLA fuses into one pass over the bf16 values.

On a CUDA tensor the wrapper launches csrc/reduce.cu (a fixed-order
two-stage reduction, no atomics: a graph replay gives the eager call's
bits), which reads the tensor once and writes no float32 copy of it. On a
CPU tensor it runs sumsq_plain. Any other device raises. A Sharded tensor
(parallel/spatial.py) is summed shard by shard, each on its own device,
and the per-shard sums are added in shard order on the first device
(reduce_sum).

The launch plan (sumsq_plan) is a pure function of the element count, the
lane count and the card's SM count, so the CPU tests check it.
"""

import torch

from .. import _build
from ..parallel.spatial import Sharded, on_device, reduce_sum
from ..utils import aligned, sm_count

# Launches of the kernel pair through sumsq (chip_smoke.py resets and
# reads this).
launches = 0

_THREADS = 256
_VEC = 8
# Blocks of _THREADS to aim for per SM over all lanes, and the least
# elements a block takes.
_BLOCKS_PER_SM = 8
_MIN_CHUNK = 4096


def sumsq_plain(t, lanes=False):
    """The plain version: torch.sum(torch.square(t.float())), over each
    lane's elements with lanes=True."""
    squares = torch.square(t.float())
    if lanes:
        return torch.sum(squares, dim=tuple(range(1, t.dim())))
    return torch.sum(squares)


def sumsq_plan(n, sms, lanes=1):
    """(chunk, blocks) of one launch over `lanes` rows of n elements on a
    card with `sms` SMs: about _BLOCKS_PER_SM blocks per SM over all lanes,
    at least _MIN_CHUNK elements a block, each chunk a multiple of 8, the
    blocks covering elements 0..n-1 of each row in order."""
    blocks = max(1, min(-(-_BLOCKS_PER_SM * sms // lanes),
                        -(-n // _MIN_CHUNK), 65535))
    chunk = -(-n // blocks)
    chunk = -(-chunk // _VEC) * _VEC
    return chunk, -(-n // chunk)


def _launch(t, lanes):
    global launches
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError('sumsq: the kernel takes bfloat16 or float32, got %s'
                        % t.dtype)
    if t.get_device() != torch.cuda.current_device():
        raise RuntimeError('sumsq: tensor on %s, but the current device is '
                           'cuda:%d' % (t.device,
                                        torch.cuda.current_device()))
    b = t.shape[0] if lanes else 1
    n = t.numel() // b if b else 0
    if n == 0:
        raise ValueError('sumsq: empty tensor %s' % (tuple(t.shape),))
    x = aligned(t)
    chunk, blocks = sumsq_plan(n, sm_count(t.device), b)
    partials = torch.empty(b * blocks, dtype=torch.float32, device=t.device)
    out = torch.empty(b, dtype=torch.float32, device=t.device)
    err = _build.lib().st2_sumsq(
        x.data_ptr(), partials.data_ptr(), out.data_ptr(), n, chunk, blocks,
        b, int(t.dtype == torch.bfloat16), _build.stream(x))
    _build.check(err, 'st2_sumsq')
    launches += 1
    return out if lanes else out[0]


def sumsq(t, lanes=False):
    """sum(float(t)^2) accumulated in float32: a 0-d float32 tensor, or
    with lanes=True a (B,) float32 tensor of each lane's sum for a
    (B, ...) t. The kernel for a CUDA t, the plain version for a CPU t; a
    Sharded t (lanes=False) is summed shard by shard and the sums added in
    shard order on its first device."""
    if isinstance(t, Sharded):
        if lanes:
            raise ValueError('sumsq: a Sharded tensor has no lane axis')
        parts = []
        for s in t.shards:
            with on_device(s):
                parts.append(sumsq(s))
        return reduce_sum(parts, t.device)
    if t.is_cuda:
        return _launch(t, lanes)
    if t.device.type == 'cpu':
        return sumsq_plain(t, lanes)
    raise RuntimeError('sumsq: no kernel for device %s' % t.device)
