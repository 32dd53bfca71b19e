"""The float32 loss feed's per-tap epilogue: a tapped layer's cotangent and
the sums behind its loss and trace scalars (engine/objective.py).

For a float32 tap `feat` of n elements, its layer weights w = (cw, sw, dw)
and the terms the layer has:

    content:   tc = cw * ((2/n) * (feat - content)) / c_norm
    style:     ts = s_scale * s_grad       (s_scale = sw / s_norm)
    deepdream: td = dw * ((-2/n) * feat) / d_norm

tap_epilogue returns (diff, sums): diff = ((0 + tc) + ts) + td, the terms
present in that order, and sums (5,) float32 = (sum (feat - content)^2,
sum tc^2, sum ts^2, sum feat^2, sum td^2), 0 for an absent term.

tap_epilogue_plain is the plain version, the objective's float32 terms as
PyTorch expressions, and runs on a CPU tap, whole or Sharded
(parallel/spatial.py: the elementwise ops shard by shard, each sum a sum
of per-shard sums in shard order). On a CUDA tap the wrapper launches
csrc/epilogue.cu: one pass writes diff, the plain version's bits (each
term the same IEEE operations in the same order), and the sums come from
a fixed-order float64 reduction of its own, rounded to float32 once,
within float32 rounding of the plain version's; they feed only the loss
and the trace, never the iterate. The launch plan is ops/reduce.py's
sumsq_plan. A Sharded CUDA tap takes one launch a shard, under the
shard's device, with the whole tap's 2/n: diff comes back Sharded, and
each sum is the per-shard sums added in shard order, as the plain
version adds them.
"""

import torch

from .. import _build
from ..parallel.spatial import Sharded, on_device, reduce_sum
from ..utils import aligned, sm_count
from .reduce import sumsq_plan

# Launches of the kernel pair through tap_epilogue (chip_smoke.py resets
# and reads this).
launches = 0

_HAS_C, _HAS_S, _HAS_D = 1, 2, 4


def _sumsq(t):
    return torch.sum(torch.square(t))


def tap_epilogue_plain(feat, weights, content=None, c_norm=None,
                       s_grad=None, s_scale=None, d_norm=None):
    """The plain version (module docstring): PyTorch expressions in the
    objective's order."""
    size = float(feat.numel())
    zero = torch.zeros((), dtype=torch.float32, device=feat.device)
    sums = [zero] * 5
    diff = torch.zeros_like(feat, dtype=torch.float32)
    if content is not None:
        c_diff = feat - content
        term = weights[0] * ((2.0 / size) * c_diff) / c_norm
        diff = diff + term
        sums[0], sums[1] = _sumsq(c_diff), _sumsq(term)
    if s_grad is not None:
        term = s_scale * s_grad
        diff = diff + term
        sums[2] = _sumsq(term)
    if d_norm is not None:
        term = weights[2] * ((-2.0 / size) * feat) / d_norm
        diff = diff + term
        sums[3], sums[4] = _sumsq(feat), _sumsq(term)
    return diff, torch.stack(sums)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(feat, weights, content, c_norm, s_grad, s_scale, d_norm,
            size=None):
    """One launch over a CUDA tap; size: the numel behind the terms' 2/n
    (default the tap's own)."""
    global launches
    if feat.dtype != torch.float32:
        raise TypeError('tap_epilogue: the kernel takes float32, got %s'
                        % feat.dtype)
    if feat.get_device() != torch.cuda.current_device():
        raise RuntimeError('tap_epilogue: tensor on %s, but the current '
                           'device is cuda:%d' % (
                               feat.device, torch.cuda.current_device()))
    for t in (content, s_grad):
        if t is not None and (t.shape != feat.shape
                              or t.dtype != torch.float32):
            raise ValueError('tap_epilogue: content and s_grad must be '
                             'float32 of the tap\'s shape %s'
                             % (tuple(feat.shape),))
    flags = ((_HAS_C if content is not None else 0)
             | (_HAS_S if s_grad is not None else 0)
             | (_HAS_D if d_norm is not None else 0))
    # The maps aligned for 16-byte accesses; the scalars are read one at a
    # time (weights[0] and weights[2]).
    feat, content, s_grad = (None if t is None else aligned(t)
                             for t in (feat, content, s_grad))
    weights = weights.contiguous()
    n = feat.numel()
    size = n if size is None else size
    chunk, blocks = sumsq_plan(n, sm_count(feat.device))
    diff = torch.empty(feat.shape, dtype=torch.float32, device=feat.device)
    partials = torch.empty(5 * blocks, dtype=torch.float64,
                           device=feat.device)
    sums = torch.empty(5, dtype=torch.float32, device=feat.device)
    err = _build.lib().st2_tap_epilogue(
        feat.data_ptr(), _ptr(content), _ptr(s_grad), weights.data_ptr(),
        _ptr(c_norm), _ptr(s_scale), _ptr(d_norm), diff.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), n, chunk, blocks, flags,
        2.0 / size, -2.0 / size, _build.stream(feat))
    _build.check(err, 'st2_tap_epilogue')
    launches += 1
    return diff, sums


def _launch_shards(feat, weights, content, c_norm, s_grad, s_scale,
                   d_norm):
    """A Sharded CUDA tap: one launch a shard under its device, the
    scalars moved there, 2/n of the whole tap; (Sharded diff, the sums
    added in shard order on the first shard's device)."""
    for t in (content, s_grad):
        if t is not None and (not isinstance(t, Sharded)
                              or len(t.shards) != len(feat.shards)):
            raise ValueError('tap_epilogue: content and s_grad of a Sharded '
                             'tap must be Sharded as it is')
    size = feat.numel()
    diffs, sums = [], []
    for i, shard in enumerate(feat.shards):
        def local(t):
            if t is None:
                return None
            if isinstance(t, Sharded):
                return t.shards[i]
            return t.to(shard.device)
        with on_device(shard):
            diff, part = _launch(shard, local(weights), local(content),
                                 local(c_norm), local(s_grad),
                                 local(s_scale), local(d_norm), size)
        diffs.append(diff)
        sums.append(part)
    return Sharded(diffs, feat.axis), reduce_sum(sums, feat.device)


def tap_epilogue(feat, weights, content=None, c_norm=None, s_grad=None,
                 s_scale=None, d_norm=None):
    """(diff, sums) of one float32 tap (module docstring). weights: the
    layer's (3,) float32 weights; content with c_norm, s_grad with s_scale,
    d_norm: the terms the layer has (None: absent), content and s_grad
    laid out as the tap (Sharded where it is), the rest on its (first)
    device. The kernel for a CUDA tap, once a shard of a Sharded one; the
    plain version for a CPU tap."""
    args = (feat, weights, content, c_norm, s_grad, s_scale, d_norm)
    if feat.device.type == 'cpu':
        return tap_epilogue_plain(*args)
    if feat.device.type == 'cuda':
        if isinstance(feat, Sharded):
            return _launch_shards(*args)
        return _launch(*args)
    raise RuntimeError('tap_epilogue: no kernel for device %s' % feat.device)
