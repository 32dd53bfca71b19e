"""The step glue's two kernels' plain versions and arithmetic, on the CPU:
the trunk's 2x2 ceil max pool (ops/pool.py) and the float32 feed's tap
epilogue (ops/epilogue.py, engine/objective.py _f32_layer).

Each kernel must give its plain version's values bit for bit (the card
tests hold them there, tests/test_torch_cuda.py). Here the plain versions
are held bit for bit against the expressions the port ran before them,
and the pool kernel's arithmetic (a tie mask, then (g / count) * bit in
the tensor's dtype), written in PyTorch, against autograd of torch.amax,
with ReLU zeros (four-way ties), odd extents, bf16, four images, and NaN
and inf in the map and in the cotangent."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from style_transfer2_tpu_torch.engine import graphs
from style_transfer2_tpu_torch.engine import objective as obj
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.ops import epilogue, pool
from style_transfer2_tpu_torch.parallel.spatial import Sharded


def _amax_pool(x):
    """The trunk's pool as the port wrote it before ops/pool.py."""
    n, h, w, c = x.shape
    pad_h, pad_w = h % 2, w % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h), value=float('-inf'))
    h2, w2 = (h + pad_h) // 2, (w + pad_w) // 2
    return torch.amax(x.reshape(n, h2, 2, w2, 2, c), dim=(2, 4))


def _windows(x):
    """(n, h2, w2, c, 4) windows of x, -inf past the ragged edge, position
    k = 2 * row + column (csrc/pool.cu)."""
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2), value=float('-inf'))
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    return x.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(
        n, h2, w2, c, 4)


def _kernel_pool(x, g):
    """csrc/pool.cu's arithmetic in PyTorch: (y, dx) from the window
    maximum, the tie bits and (g / count) * bit rounded to x's dtype."""
    win = _windows(x)
    y = torch.amax(win, dim=-1)
    bits = win == y[..., None]
    count = bits.sum(-1).float()
    q = (g.float() / count).to(x.dtype)
    parts = (q.float()[..., None] * bits.float()).to(x.dtype)
    n, h, w, c = x.shape
    h2, w2 = y.shape[1:3]
    dx = parts.reshape(n, h2, w2, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return y, dx.reshape(n, 2 * h2, 2 * w2, c)[:, :h, :w]


def _bits(t):
    """t's bits with every NaN made one NaN (the payload is no result)."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float('nan')), t)
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _case(name, dtype):
    """(x, g) of a named pool case."""
    rng = np.random.RandomState(len(name))
    shape = {'relu_zeros': (1, 4, 6, 8), 'odd': (1, 7, 9, 8),
             'four_images': (4, 6, 5, 16), 'non_finite': (2, 5, 7, 4)}[name]
    x = np.float32(rng.randn(*shape))
    g = np.float32(rng.randn(*shape[:1] + ((shape[1] + 1) // 2,
                                           (shape[2] + 1) // 2)
                             + shape[3:]))
    if name == 'relu_zeros':
        x = np.maximum(x, 0)
        x[:, :2] = 0                   # whole windows of four ties
    if name == 'odd':
        x[:, -1, :3] = x[:, -1, 3:6]   # ties on the ragged row
    if name == 'non_finite':
        x[0, 0, 0, 0] = np.nan
        x[0, 2, 3, 1] = np.inf
        x[1, 4, 6, :] = -np.inf        # a ragged corner: maximum -inf
        x[1, 0, 0:2, 2] = -np.inf
        x[1, 1, 0:2, 2] = -np.inf      # a whole window of -inf
        g[0, 1, 1, 0] = np.nan
        g[1, 0, 0, 1] = np.inf
        g[1, 2, 3, 3] = -np.inf
        g[1, 0, 0, 2] = -2.5
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype))


CASES = ['relu_zeros', 'odd', 'four_images', 'non_finite']
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_plain_pool_is_the_amax_pool_bit_for_bit(name, dtype):
    """The plain pool, and the trunk's pool on the CPU, are the torch.amax
    pool the port ran before: values and gradients bit for bit."""
    x, g = _case(name, dtype)
    want_x = x.clone().requires_grad_(True)
    want = _amax_pool(want_x)
    want_dx, = torch.autograd.grad(want, want_x, g)
    for fn in (pool.max_pool_ceil_plain, vgg19._max_pool_ceil):
        got_x = x.clone().requires_grad_(True)
        got = fn(got_x)
        got_dx, = torch.autograd.grad(got, got_x, g)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(got_dx), _bits(want_dx))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_pool_kernel_arithmetic_is_amax_backward_bit_for_bit(name, dtype):
    """The kernel's arithmetic (a tie mask with the ragged edge's -inf
    counted, (g / count) * bit rounded to the dtype) gives torch.amax's
    forward and its backward's gradient bit for bit, NaN and inf
    included: a NaN window divides by a zero count, inf * 0 is NaN."""
    x, g = _case(name, dtype)
    want_x = x.clone().requires_grad_(True)
    want = _amax_pool(want_x)
    want_dx, = torch.autograd.grad(want, want_x, g)
    y, dx = _kernel_pool(x, g)
    assert torch.equal(_bits(y), _bits(want.detach()))
    assert torch.equal(_bits(dx), _bits(want_dx))
    if name == 'relu_zeros':
        assert torch.equal(dx[:, :2], (g[:, :1].float() / 4).to(dtype)
                           .repeat_interleave(2, 1)
                           .repeat_interleave(2, 2)[:, :, :6])
    if name == 'non_finite':
        assert torch.isnan(dx[0, :2, :2, 0]).all()
        assert torch.equal(dx[1, :2, :2, 2], torch.full(
            (2, 2), -2.5 / 4, dtype=dtype))


def test_pool_without_gradient_takes_the_plain_version_on_the_cpu():
    x, _ = _case('odd', torch.float32)
    with torch.no_grad():
        assert torch.equal(vgg19._max_pool_ceil(x), _amax_pool(x))
    assert torch.equal(pool.max_pool_ceil(x), _amax_pool(x))


def _today_layer(branch, feat, w, content, gram_style, norm_of, trace,
                 loss):
    """The float32 feed's per-layer terms as engine/objective.py wrote them
    before ops/epilogue.py."""
    layer, has_c, has_s, has_d = branch
    size = float(feat.numel())
    diff = torch.zeros_like(feat, dtype=torch.float32)
    rms = obj._rms
    if has_c:
        cw = w[0]
        c_diff = feat - content
        c_grad = (2.0 / size) * c_diff
        cn = norm_of(layer + ':c', rms(c_grad))
        c_loss = cw * torch.mean(torch.square(c_diff)) / cn
        trace.append(c_loss)
        loss = loss + c_loss
        term = cw * c_grad / cn
        trace.append(rms(term))
        diff = diff + term
    if has_s:
        sw = w[1]
        s_grad, gram_diff = obj.fused_style_branch(feat, gram_style)
        sn = norm_of(layer + ':s', rms(s_grad))
        s_loss = sw * torch.mean(torch.square(gram_diff)) / sn
        trace.append(s_loss)
        loss = loss + s_loss
        term = (sw / sn) * s_grad
        trace.append(rms(term))
        diff = diff + term
    if has_d:
        dw = w[2]
        d_grad = (-2.0 / size) * feat
        dn = norm_of(layer + ':d', rms(d_grad))
        d_loss = -dw * torch.mean(torch.square(feat)) / dn
        trace.append(d_loss)
        loss = loss + d_loss
        term = dw * d_grad / dn
        trace.append(rms(term))
        diff = diff + term
    return loss, diff.to(feat.dtype)


def _norm_of(vals, set_, new_vals):
    """make_objective's norm_of over the given norm state."""
    def norm_of(key, fresh):
        value = (vals[key] if fresh is None else
                 torch.where(set_[key], vals[key], fresh))
        new_vals[key] = value
        return value
    return norm_of


def _layer_inputs(seed, shape, has_set):
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(np.float32(np.maximum(rng.randn(*shape), 0)))
    content = torch.from_numpy(np.float32(np.maximum(rng.randn(*shape), 0)))
    style = torch.from_numpy(np.float32(np.maximum(rng.randn(*shape), 0)))
    c = shape[-1]
    flat = style.reshape(-1, c)
    gram = flat.T @ flat / style.numel()
    w = torch.from_numpy(np.float32([0.3, 1.7, -0.4]))
    vals = {k: torch.tensor(np.float32(v)) for k, v in
            (('l:c', 0.02), ('l:s', 3e-5), ('l:d', 0.011))}
    set_ = {k: torch.tensor(has_set) for k in vals}
    return feat, content, gram, w, vals, set_


BRANCHES = [('l', True, False, False), ('l', False, True, False),
            ('l', False, False, True), ('l', True, True, False),
            ('l', True, True, True)]


@pytest.mark.parametrize('shape', [(1, 6, 10, 64), (1, 5, 7, 3)])
@pytest.mark.parametrize('branch', BRANCHES)
@pytest.mark.parametrize('norms', ['unset', 'set', 'set_not_fresh'])
def test_tap_epilogue_layer_is_the_float32_branch_bit_for_bit(branch, shape,
                                                              norms):
    """objective._f32_layer with the plain epilogue gives the float32
    branch's cotangent, trace, loss and norms bit for bit: with unset norms
    (Adam's first step, a prime: the fresh norms), with set ones, and with
    set ones not recomputed (an L-BFGS step)."""
    feat, content, gram, w, vals, set_ = _layer_inputs(
        len(shape) + sum(branch[1:]), shape, norms != 'unset')
    loss0 = torch.tensor(np.float32(0.125))
    want_vals, want_trace = {}, []
    want_loss, want_diff = _today_layer(
        branch, feat, w, content, gram, _norm_of(vals, set_, want_vals),
        want_trace, loss0)
    got_vals, got_trace = {}, []
    got_loss, got_diff = obj._f32_layer(
        'l', branch, feat, w, content, gram, _norm_of(vals, set_, got_vals),
        got_trace, loss0, norms != 'set_not_fresh')
    assert torch.equal(_bits(got_diff), _bits(want_diff))
    assert torch.equal(got_loss, want_loss)
    assert len(got_trace) == len(want_trace)
    for got, want in zip(got_trace, want_trace):
        assert torch.equal(got, want)
    assert got_vals.keys() == want_vals.keys()
    for key, value in want_vals.items():
        assert torch.equal(got_vals[key], value)


def test_tap_epilogue_plain_sums_and_absent_terms():
    """The plain epilogue's five sums, 0 for an absent term, and a diff of
    +0 where every term is -0 (0 + -0, as the branch adds)."""
    feat, content, _, w, vals, _ = _layer_inputs(3, (1, 4, 4, 8), True)
    s_grad = -torch.zeros_like(feat)
    diff, sums = epilogue.tap_epilogue(feat, w, s_grad=s_grad,
                                       s_scale=vals['l:s'])
    assert torch.equal(_bits(diff), _bits(torch.zeros_like(feat)))
    assert torch.equal(sums, torch.zeros(5))
    diff, sums = epilogue.tap_epilogue(feat, w, content, vals['l:c'],
                                       d_norm=vals['l:d'])
    size = float(feat.numel())
    tc = w[0] * ((2.0 / size) * (feat - content)) / vals['l:c']
    td = w[2] * ((-2.0 / size) * feat) / vals['l:d']
    assert torch.equal(diff, torch.zeros_like(feat) + tc + td)
    for got, want in zip(sums, [(feat - content).square().sum(),
                                tc.square().sum(), 0.0,
                                feat.square().sum(), td.square().sum()]):
        assert float(got) == float(want)


def test_tap_epilogue_of_a_sharded_tap_is_the_tap_shard_by_shard():
    """A Sharded tap takes the plain epilogue shard by shard: its diff is
    the unsharded one's, its sums the per-shard sums added in shard
    order."""
    feat, content, _, w, vals, _ = _layer_inputs(5, (1, 8, 6, 16), True)
    args = dict(c_norm=vals['l:c'], d_norm=vals['l:d'])
    diff, sums = epilogue.tap_epilogue(feat, w, content, **args)
    cut = lambda t: Sharded([t[:, :4], t[:, 4:]], 1)   # noqa: E731
    s_diff, s_sums = epilogue.tap_epilogue(cut(feat), w, cut(content),
                                           **args)
    assert isinstance(s_diff, Sharded)
    assert torch.equal(s_diff.gather(), diff)
    # The sums of the map itself (not of the terms, whose scale is the
    # whole tap's): each shard's, added in shard order.
    halves = [epilogue.tap_epilogue(feat[:, a:b], w, content[:, a:b],
                                    **args)[1] for a, b in ((0, 4), (4, 8))]
    assert torch.equal(s_sums[[0, 3]], (halves[0] + halves[1])[[0, 3]])
    np.testing.assert_allclose(s_sums.numpy(), sums.numpy(), rtol=1e-6)


@pytest.mark.parametrize('n', [2, 4])
def test_sharded_card_tap_takes_one_launch_a_shard(monkeypatch, n):
    """A Sharded tap on the card takes one launch a shard (here a stand-in
    that runs the plain version on the shard), each with its own shard of
    content and s_grad, the scalars on the shard's device and the whole
    tap's size; diff comes back Sharded as the tap is, and each sum is the
    shards' added in shard order. A style-only tap, whose term has no
    size in it, gives the whole tap's diff bit for bit."""
    feat, content, _, w, vals, _ = _layer_inputs(9, (1, 8, 6, 16), True)
    s_grad = torch.from_numpy(np.float32(
        np.random.RandomState(10).randn(*feat.shape) * 1e-4))
    s_scale = w[1] / vals['l:s']
    calls = []

    def launch(f, weights, ct, cn, sg, ss, dn, size=None):
        calls.append((tuple(f.shape), size, ct is None, tuple(sg.shape)))
        assert weights.device == f.device and ss.device == f.device
        return epilogue.tap_epilogue_plain(f, weights, ct, cn, sg, ss, dn)

    monkeypatch.setattr(epilogue, '_launch', launch)
    cut = lambda t: Sharded(list(t.split(8 // n, 1)), 1)   # noqa: E731
    diff, sums = epilogue._launch_shards(cut(feat), w, None, None,
                                         cut(s_grad), s_scale, None)
    assert calls == [((1, 8 // n, 6, 16), feat.numel(), True,
                      (1, 8 // n, 6, 16))] * n
    want, want_sums = epilogue.tap_epilogue_plain(feat, w, s_grad=s_grad,
                                                  s_scale=s_scale)
    assert isinstance(diff, Sharded) and diff.axis == 1
    assert len(diff.shards) == n
    assert torch.equal(diff.gather(), want)
    parts = [epilogue.tap_epilogue_plain(f, w, s_grad=g, s_scale=s_scale)[1]
             for f, g in zip(feat.split(8 // n, 1), s_grad.split(8 // n, 1))]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    assert torch.equal(sums, total)
    np.testing.assert_allclose(sums.numpy(), want_sums.numpy(), rtol=1e-6)
    calls.clear()
    epilogue._launch_shards(cut(feat), w, cut(content), vals['l:c'],
                            cut(s_grad), s_scale, vals['l:d'])
    assert [(size, no_content) for _, size, no_content, _ in calls] == [
        (feat.numel(), False)] * n
    with pytest.raises(ValueError, match='Sharded as it is'):
        epilogue._launch_shards(cut(feat), w, content, vals['l:c'], None,
                                None, None)


def test_objective_without_fresh_norms_equals_it_with_them_once_set():
    """fresh_norms=False (an L-BFGS step) gives the objective's loss,
    gradient, trace and norms bit for bit once every norm is set."""
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.models.vgg19 import VGG19Features
    spec = obj.ObjectiveSpec.from_weights(
        {'content': {'conv4_2': 0.1},
         'style': {l: 1.0 for l in ('conv1_1', 'conv2_1', 'conv3_1')},
         'deepdream': {'conv3_1': 0.01}}, {})
    model = VGG19Features({k: {'w': torch.from_numpy(v['w']),
                               'b': torch.from_numpy(v['b'])}
                           for k, v in random_params(0).items()})
    rng = np.random.RandomState(9)
    x = torch.from_numpy(np.float32(rng.randn(1, 24, 20, 3) * 40))
    feats = model(torch.from_numpy(np.float32(rng.randn(1, 24, 20, 3) * 40)))
    content = {l: feats[l] for l in spec.content_layers}
    grams = {l: feats[l].reshape(-1, feats[l].shape[-1]).T
             @ feats[l].reshape(-1, feats[l].shape[-1]) / feats[l].numel()
             for l in spec.style_layers}
    weights = {l: torch.from_numpy(v) for l, v in obj.weights_to_arrays(
        {'content': {'conv4_2': 0.1}, 'style': {l: 1.0 for l in (
            'conv1_1', 'conv2_1', 'conv3_1')},
         'deepdream': {'conv3_1': 0.01}}, spec).items()}
    scalars = {k: torch.tensor(v) for k, v in
               obj.scalars_to_arrays({'tv': 2.0, 'p': 1.0}).items()}
    vals, set_ = obj.empty_norms(spec)
    vals = {k: torch.tensor(v) for k, v in vals.items()}
    set_ = {k: torch.tensor(v) for k, v in set_.items()}
    f = obj.make_objective(spec)
    _, _, (vals, set_), _ = f(model, x, content, grams, weights, scalars,
                              vals, set_)
    assert all(bool(v) for v in set_.values())
    x2 = x + 3.0
    want = f(model, x2, content, grams, weights, scalars, vals, set_)
    got = f(model, x2, content, grams, weights, scalars, vals, set_,
            fresh_norms=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[3], want[3]))
    for key in spec.norm_keys:
        assert torch.equal(got[2][0][key], want[2][0][key])
        assert torch.equal(got[2][1][key], want[2][1][key])


def test_step_graphs_credit_the_glue_kernels():
    """A replay credits the pool's and the epilogue's launches like every
    other kernel's (engine/graphs.py _COUNTERS)."""
    counts = graphs._launch_counts()
    assert counts[('pool_fwd',)] == pool.fwd_launches
    assert counts[('pool_bwd',)] == pool.bwd_launches
    assert counts[('tap_epilogue',)] == epilogue.launches
    before = (pool.fwd_launches, pool.bwd_launches, epilogue.launches)
    plan = graphs._credit_plan({('pool_fwd',): 3, ('pool_bwd',): 3,
                                ('tap_epilogue',): 5})
    graphs._apply(plan)
    try:
        assert (pool.fwd_launches, pool.bwd_launches, epilogue.launches) == (
            before[0] + 3, before[1] + 3, before[2] + 5)
    finally:
        graphs._apply(plan, -1)
