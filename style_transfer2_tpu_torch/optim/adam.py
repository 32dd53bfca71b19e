"""The reference's Adam variant (style_transfer2_tpu/optim/adam.py;
reference optimizers.py:7-47).

Differences from textbook Adam, kept exactly:
  * both moments are bias-corrected decaying means with their own item
    counters, and objective_changed resets the step count and the FIRST
    moment only, keeping the second moment and its counter;
  * the update is x -= step_size * m_hat / (sqrt(v_hat) + 1e-8).

The counters are host integers: they never depend on device values.

step_lanes steps B independent states stacked on a leading lane axis (the
batched engine; JAX: jax.vmap of step): x and both moments (B, H, W, 3),
the counters (B,) integer tensors on the device, so that lanes that join
at different times or change objective each keep their own bias
corrections, the step size (B,). An optional (B,) bool run mask freezes
the lanes it leaves out: their moments and counters do not advance.
"""

import numpy as np
import torch

from ..ops.resample import resize_nhwc

B1_DEFAULT = 0.9
B2_DEFAULT = 0.999


def init(x):
    """Fresh Adam state around the iterate x."""
    x = x.float()
    return {
        'x': x,
        'g1_mean': torch.zeros_like(x),
        'g1_items': 0,
        'g2_mean': torch.zeros_like(x),
        'g2_items': 0,
        't': 0,
    }


def _correction(b, items):
    """1 - b**items, in float32 like the JAX package."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(items))


def step(state, opfunc, step_size, b1=B1_DEFAULT, b2=B2_DEFAULT):
    """One Adam step (optimizers.py:20-27). opfunc(x) -> (loss, grad, aux).
    Returns (state', loss, aux)."""
    x = state['x']
    loss, grad, aux = opfunc(x)
    g1_mean = b1 * state['g1_mean'] + (1 - b1) * grad
    g1_items = state['g1_items'] + 1
    g2_mean = b2 * state['g2_mean'] + (1 - b2) * torch.square(grad)
    g2_items = state['g2_items'] + 1
    g1 = g1_mean / _correction(b1, g1_items)
    g2 = g2_mean / _correction(b2, g2_items)
    x_new = x - step_size * g1 / (torch.sqrt(g2) + 1e-8)
    state_new = {
        'x': x_new,
        'g1_mean': g1_mean,
        'g1_items': g1_items,
        'g2_mean': g2_mean,
        'g2_items': g2_items,
        't': state['t'] + 1,
    }
    return state_new, loss, aux


def _correction_lanes(b, items):
    """1 - b**items for (B,) integer counters, in float32 on the device."""
    return 1.0 - torch.pow(float(np.float32(b)), items.to(torch.float32))


def step_lanes(state, opfunc, step_sizes, run=None, b1=B1_DEFAULT,
               b2=B2_DEFAULT):
    """step for every lane of a stacked state with (B,) step sizes; lanes
    outside the (B,) run mask still compute but keep their state."""
    x = state['x']
    loss, grad, aux = opfunc(x)
    g1_mean = b1 * state['g1_mean'] + (1 - b1) * grad
    g1_items = state['g1_items'] + 1
    g2_mean = b2 * state['g2_mean'] + (1 - b2) * torch.square(grad)
    g2_items = state['g2_items'] + 1
    g1 = g1_mean / _correction_lanes(b1, g1_items)[:, None, None, None]
    g2 = g2_mean / _correction_lanes(b2, g2_items)[:, None, None, None]
    x_new = x - (step_sizes[:, None, None, None] * g1
                 / (torch.sqrt(g2) + 1e-8))
    state_new = {
        'x': x_new,
        'g1_mean': g1_mean,
        'g1_items': g1_items,
        'g2_mean': g2_mean,
        'g2_items': g2_items,
        't': state['t'] + 1,
    }
    if run is not None:
        state_new = {k: torch.where(
            run.reshape((-1,) + (1,) * (v.dim() - 1)), v, state[k])
            for k, v in state_new.items()}
    return state_new, loss, aux


def objective_changed(state):
    """Resets the step count and the first moment; keeps the second moment
    and its counter (optimizers.py:42-47)."""
    return {
        'x': state['x'],
        'g1_mean': torch.zeros_like(state['g1_mean']),
        'g1_items': 0,
        'g2_mean': state['g2_mean'],
        'g2_items': state['g2_items'],
        't': 0,
    }


def resample(state, hw, new_x=None):
    """Warm-starts the state at a new resolution (optimizers.py:29-40):
    lanczos3 for x (unless new_x is given) and the first moment, bilinear
    clamped at 0 for the second moment; the counters are kept."""
    if new_x is not None:
        x = new_x.float()
        hw = tuple(x.shape[1:3])
    else:
        x = resize_nhwc(state['x'], tuple(hw), 'lanczos3')
    return {
        'x': x,
        'g1_mean': resize_nhwc(state['g1_mean'], tuple(hw), 'lanczos3'),
        'g1_items': state['g1_items'],
        'g2_mean': torch.clamp(
            resize_nhwc(state['g2_mean'], tuple(hw), 'bilinear'), min=0.0),
        'g2_items': state['g2_items'],
        't': state['t'],
    }
