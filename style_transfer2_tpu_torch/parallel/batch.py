"""Batched serving: concurrent user jobs as lanes of one batched step
(style_transfer2_tpu/parallel/batch.py).

The JAX package vmaps the single-image step over a leading lane axis. The
port's kernels are bound through ctypes, which no vmap goes through, so
the batched step is written with the lane axis explicit instead: the
trunk runs once at N = lanes, the style branch takes every lane in one
call, and every per-image reduction, weight, scalar, step size, norm and
optimizer counter is a (B,) value (engine/objective.py make_lane_objective,
optim/*.py step_lanes). Nothing reduces across lanes, so each lane is
exactly the single-image step up to the order of its own sums.

Lanes in one batch share the objective STRUCTURE (ObjectiveSpec) and the
optimizer; weight VALUES, step sizes, images, norms and optimizer state
vary per lane. A (B,) bool run mask leaves paused and inactive lanes
frozen: they still compute (the batch is one chain of launches), but
their optimizer state and norm cache keep their values (torch.where).

Stacked state: per-lane trees are the single engine's (optim/*.py init,
engine/transfer.py inputs); stack_lanes puts a lane axis in front of each
leaf, and an image-bearing leaf (4 or more dims, its batch of 1 at dim
-4) gives its batch dim to the lanes: x (1, H, W, 3) per lane becomes
(B, H, W, 3), an L-BFGS history (n_corr, 1, H, W, 3) becomes
(B, n_corr, H, W, 3). unstack_lane undoes it with views.
"""

import functools

import torch

from ..engine.objective import make_lane_objective
from ..optim import adam, lbfgs


def _make_opfunc(objective, model, inputs):
    def opfunc(x):
        loss, grad, norms, trace = objective(
            model, x, inputs['content_feats'], inputs['grams'],
            inputs['layer_weights'], inputs['scalars'],
            inputs['norms_vals'], inputs['norms_set'])
        return loss, grad, (norms, trace)
    return opfunc


def _keep_norms(norms, inputs, run):
    """The new (vals, set) norm dicts where the lane runs, else the old."""
    vals, set_ = norms
    if run is None:
        return vals, set_
    return ({k: torch.where(run, v, inputs['norms_vals'][k])
             for k, v in vals.items()},
            {k: torch.where(run, v, inputs['norms_set'][k])
             for k, v in set_.items()})


@functools.lru_cache(maxsize=64)
def build_masked_batched_step_fns(spec, optimizer, b1=adam.B1_DEFAULT,
                                  b2=adam.B2_DEFAULT):
    """Returns (masked_step, masked_eval) over stacked lanes:

      masked_step(model, states, inputs, step_sizes, mask)
        -> (states', norms', traces)
      masked_eval(model, states, inputs, mask) -> (states', norms', traces)

    with step_sizes (B,), mask a (B,) bool tensor or None (every lane
    runs), traces one (n_keys, B) tensor in spec.trace_keys order.
    masked_eval primes the L-BFGS caches; it is None for Adam."""
    objective = make_lane_objective(spec)

    if optimizer == 'adam':
        def masked_step(model, states, inputs, step_sizes, mask):
            state_new, _, (norms, trace) = adam.step_lanes(
                states, _make_opfunc(objective, model, inputs), step_sizes,
                mask, b1, b2)
            return (state_new, _keep_norms(norms, inputs, mask),
                    torch.stack(trace))

        return masked_step, None

    if optimizer == 'lbfgs':
        def masked_step(model, states, inputs, step_sizes, mask):
            state_new, _, (norms, trace) = lbfgs.step_lanes(
                states, _make_opfunc(objective, model, inputs), step_sizes,
                mask)
            return (state_new, _keep_norms(norms, inputs, mask),
                    torch.stack(trace))

        def masked_eval(model, states, inputs, mask):
            state_new, _, (norms, trace) = lbfgs.initial_eval_lanes(
                states, _make_opfunc(objective, model, inputs), mask)
            return (state_new, _keep_norms(norms, inputs, mask),
                    torch.stack(trace))

        return masked_step, masked_eval

    raise ValueError('Unknown optimizer: %r' % (optimizer,))


@functools.lru_cache(maxsize=64)
def build_batched_step_fns(spec, optimizer, b1=adam.B1_DEFAULT,
                           b2=adam.B2_DEFAULT):
    """Returns (batched_step, batched_eval), every lane running:

      batched_step(model, states, inputs, step_sizes)
        -> (states', norms', traces)
      batched_eval(model, states, inputs) -> (states', norms', traces)

    batched_eval is None for Adam."""
    masked_step, masked_eval = build_masked_batched_step_fns(
        spec, optimizer, b1, b2)

    def batched_step(model, states, inputs, step_sizes):
        return masked_step(model, states, inputs, step_sizes, None)

    batched_eval = None
    if masked_eval is not None:
        def batched_eval(model, states, inputs):
            return masked_eval(model, states, inputs, None)
    return batched_step, batched_eval


@functools.lru_cache(maxsize=64)
def build_masked_batched_scan_fn(spec, optimizer, n_steps=10,
                                 b1=adam.B1_DEFAULT, b2=adam.B2_DEFAULT):
    """K masked steps for every lane, enqueued one after another with no
    host read: the norm state threads through the steps, and masked lanes
    stay frozen for all K.

      scan_fn(model, states, inputs, step_sizes, mask)
        -> (states', norms', traces)   # traces: (n_keys, B, K)
    """
    masked_step, _ = build_masked_batched_step_fns(spec, optimizer, b1, b2)

    def scan_fn(model, states, inputs, step_sizes, mask):
        inputs = dict(inputs)
        rows = []
        for _ in range(n_steps):
            states, (nv, ns), trace = masked_step(model, states, inputs,
                                                  step_sizes, mask)
            inputs['norms_vals'], inputs['norms_set'] = nv, ns
            rows.append(trace)
        return (states, (inputs['norms_vals'], inputs['norms_set']),
                torch.stack(rows, dim=-1))

    return scan_fn


def _is_image(leaf):
    """An image-bearing leaf, per lane or stacked: 4 or more dims, the
    images' batch (per lane) or the lanes (stacked) at dim -4."""
    return torch.is_tensor(leaf) and leaf.dim() >= 4


def stack_lanes(trees, device=None):
    """Stacks a list of per-lane trees (dicts of tensors, dicts and Python
    numbers) along a new leading lane axis. Image-bearing leaves give
    their batch of 1 to the lane axis; numbers become tensors on
    `device`."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_lanes([t[k] for t in trees], device) for k in first}
    if torch.is_tensor(first):
        if _is_image(first):
            return torch.stack([t.squeeze(-4) for t in trees])
        return torch.stack(list(trees))
    return torch.as_tensor(list(trees), device=device)


def unstack_lane(tree, i):
    """Lane i of a stacked tree, in the per-lane layout, as views."""
    if isinstance(tree, dict):
        return {k: unstack_lane(v, i) for k, v in tree.items()}
    if _is_image(tree):
        return tree[i].unsqueeze(-4)
    return tree[i]
