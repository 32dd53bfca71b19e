"""Fixed-step L-BFGS without line search (style_transfer2_tpu/optim/lbfgs.py;
reference optimizers.py:49-125).

  * The curvature history (up to n_corr (s, y, s.y) triples) lives in
    circular buffers of shape (n_corr,) + x.shape: a write cursor `pos` and
    a valid count `count` replace the reference's list append/pop, so
    storing a pair writes one slot. store_curvature_pair writes that slot
    in place.
  * A candidate pair is rejected when s.y <= SY_MIN (optimizers.py:82-83).
  * With an empty history the direction is RMS-normalized; otherwise it is
    scaled by sy_last / y_last.y_last.
  * objective_changed clears the history and the cached (loss, grad); the
    next step must re-prime through initial_eval.

Every step is branch-free on the device: count, pos and the accept
decision are tensors, slots are gathered with index_select, and nothing is
read back to the host inside a step.

In bfloat16 mode on grids of at least BF16_HISTORY_MIN_PIXELS the pairs
are stored in bfloat16, and s.y is the dot of the pair as stored: taken
before rounding it admitted pairs of negative stored curvature, which
diverged (JAX package, optim/lbfgs.py:40-69,154-187).

The *_lanes functions step B independent states stacked on a leading lane
axis (the batched engine; JAX: jax.vmap of these functions): x and grad
(B, H, W, 3), sk and yk (B, n_corr, H, W, 3), syk (B, n_corr), loss,
count and pos (B,), the step size (B,). Every dot is taken per lane, each
lane reads and writes its own history slot, and an optional (B,) bool run
mask freezes the lanes it leaves out: their pair is rejected, so their
slot is rewritten with its own contents, and x, grad and loss keep their
old values.
"""

import torch

from ..ops.resample import resize_nhwc

N_CORR_DEFAULT = 10
SY_MIN = 1e-10
BF16_HISTORY_MIN_PIXELS = 160_000


def history_dtype_for(compute_dtype, hw):
    """Storage dtype of fresh curvature buffers: bfloat16 in bf16 mode on
    grids of at least BF16_HISTORY_MIN_PIXELS, else None (float32)."""
    if (compute_dtype == torch.bfloat16
            and int(hw[0]) * int(hw[1]) >= BF16_HISTORY_MIN_PIXELS):
        return torch.bfloat16
    return None


def _vdot(a, b):
    """Float32 dot of two same-shaped tensors (bf16 operands are widened;
    each bf16 product is exact in float32)."""
    return torch.dot(a.reshape(-1).float(), b.reshape(-1).float())


def _vdot_lanes(a, b):
    """(B,) float32 dots of the lanes of two same-shaped (B, ...) tensors."""
    n = a.shape[0]
    return torch.sum(a.reshape(n, -1).float() * b.reshape(n, -1).float(),
                     dim=1)


def _col(v):
    """A (B,) tensor as (B, 1, 1, 1), to scale (B, H, W, C) lanes."""
    return v[:, None, None, None]


def _slot(buf, index):
    """buf[index] for a 0-d index tensor, without a host sync."""
    return torch.index_select(buf, 0, index.reshape(1))[0]


def init(x, n_corr=N_CORR_DEFAULT, history_dtype=None):
    """Fresh L-BFGS state around the iterate x; run initial_eval before the
    first step."""
    x = x.float()
    hist = torch.float32 if history_dtype is None else history_dtype
    zero_i = torch.zeros((), dtype=torch.int64, device=x.device)
    return {
        'x': x,
        'loss': torch.zeros((), dtype=torch.float32, device=x.device),
        'grad': torch.zeros_like(x),
        'sk': torch.zeros((n_corr,) + tuple(x.shape), dtype=hist,
                          device=x.device),
        'yk': torch.zeros((n_corr,) + tuple(x.shape), dtype=hist,
                          device=x.device),
        'syk': torch.zeros((n_corr,), dtype=torch.float32, device=x.device),
        'count': zero_i,
        'pos': zero_i.clone(),   # next write slot (circular)
    }


def initial_eval(state, opfunc):
    """Primes the (loss, grad) cache (optimizers.py:64-65)."""
    loss, grad, aux = opfunc(state['x'])
    state = dict(state)
    state['loss'] = loss
    state['grad'] = grad
    return state, loss, aux


def inv_hv(state, p):
    """Two-loop recursion over the masked circular history
    (optimizers.py:89-108)."""
    sk, yk, syk = state['sk'], state['yk'], state['syk']
    count, pos = state['count'], state['pos']
    n_corr = sk.shape[0]
    one = torch.ones((), dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)

    alphas = []
    for k in range(n_corr):
        # k-th newest pair: physical slot (pos - 1 - k) mod n_corr.
        valid = count > k
        slot = torch.remainder(pos - 1 - k, n_corr)
        s, y, sy = _slot(sk, slot), _slot(yk, slot), _slot(syk, slot)
        alpha = torch.where(valid, _vdot(s, p) / torch.where(valid, sy, one),
                            zero)
        p = p - alpha * y.float()
        alphas.append(alpha)
    alphas = torch.stack(alphas)

    # Initial Hessian scaling from the newest pair, or RMS normalization
    # when the history is empty (optimizers.py:97-102).
    newest = torch.remainder(pos - 1, n_corr)
    y_last, sy_last = _slot(yk, newest), _slot(syk, newest)
    yy = _vdot(y_last, y_last)
    scale_hist = sy_last / torch.where(yy > 0, yy, one)
    rms = torch.sqrt(_vdot(p, p) / p.numel())
    scale_rms = 1.0 / torch.where(rms > 0, rms, one)
    p = p * torch.where(count > 0, scale_hist, scale_rms)

    for j in range(n_corr):
        # j-th oldest pair: slot (pos - count + j) mod n_corr; its
        # first-loop alpha sits at index count - 1 - j.
        valid = count > j
        slot = torch.remainder(pos - count + j, n_corr)
        s, y, sy = _slot(sk, slot), _slot(yk, slot), _slot(syk, slot)
        beta = _vdot(y, p) / torch.where(valid, sy, one)
        alpha = _slot(alphas, torch.clamp(count - 1 - j, min=0))
        p = p + torch.where(valid, alpha - beta, zero) * s.float()
    return p


def store_curvature_pair(state, s, y):
    """Writes (s, y, s.y) at the cursor if s.y > SY_MIN (optimizers.py:
    79-87), in place. Returns (sk, yk, syk, count, pos)."""
    sk, yk, syk = state['sk'], state['yk'], state['syk']
    n_corr = sk.shape[0]
    pos = state['pos']
    hist = sk.dtype
    # A low-precision history takes s.y from the pair AS STORED.
    s, y = s.to(hist), y.to(hist)
    sy = _vdot(s, y)
    accept = sy > SY_MIN
    idx = pos.reshape(1)
    # On reject the slot is rewritten with its own contents.
    sk.index_copy_(0, idx, torch.where(accept, s, _slot(sk, pos))[None])
    yk.index_copy_(0, idx, torch.where(accept, y, _slot(yk, pos))[None])
    syk.index_copy_(0, idx, torch.where(accept, sy, _slot(syk, pos))[None])
    count = torch.where(accept, torch.clamp(state['count'] + 1, max=n_corr),
                        state['count'])
    pos = torch.where(accept, torch.remainder(pos + 1, n_corr), pos)
    return sk, yk, syk, count, pos


def step(state, opfunc, step_size):
    """One L-BFGS step (optimizers.py:62-77): move along the approximate
    Newton direction, evaluate, store the new curvature pair. The (loss,
    grad) cache must be primed (initial_eval) first."""
    s = -step_size * inv_hv(state, state['grad'])
    x_new = state['x'] + s
    loss, grad, aux = opfunc(x_new)
    sk, yk, syk, count, pos = store_curvature_pair(state, s,
                                                   grad - state['grad'])
    state_new = {
        'x': x_new,
        'loss': loss,
        'grad': grad,
        'sk': sk,
        'yk': yk,
        'syk': syk,
        'count': count,
        'pos': pos,
    }
    return state_new, loss, aux


def objective_changed(state, n_corr=None):
    """Clears the curvature history and the cached evaluation
    (optimizers.py:121-125). The caller must re-prime via initial_eval."""
    return init(state['x'],
                state['sk'].shape[0] if n_corr is None else n_corr,
                history_dtype=state['sk'].dtype)


def resample(state, hw, new_x=None):
    """Warm-starts x at a new resolution (new_x, or the iterate resized to
    hw with lanczos3) and clears the optimizer state (optimizers.py:110-119).
    The fresh history keeps the old one's dtype, so a ladder started below
    BF16_HISTORY_MIN_PIXELS keeps float32 pairs all the way up, as in the
    JAX package."""
    if new_x is not None:
        x = new_x.float()
    else:
        x = resize_nhwc(state['x'], tuple(hw), 'lanczos3')
    return init(x, state['sk'].shape[0], history_dtype=state['sk'].dtype)


def _keep(run, new, old):
    """new where the lane runs, else old (run None: every lane runs)."""
    if run is None:
        return new
    return torch.where(run.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def initial_eval_lanes(state, opfunc, run=None):
    """initial_eval of every lane of a stacked state; lanes outside the
    (B,) run mask keep their cache."""
    loss, grad, aux = opfunc(state['x'])
    state = dict(state)
    state['loss'] = _keep(run, loss, state['loss'])
    state['grad'] = _keep(run, grad, state['grad'])
    return state, loss, aux


def inv_hv_lanes(state, p):
    """inv_hv of each lane of a stacked state on the (B, H, W, 3) p: the
    two-loop recursion over each lane's own circular history."""
    sk, yk, syk = state['sk'], state['yk'], state['syk']
    count, pos = state['count'], state['pos']
    n_lanes, n_corr = syk.shape
    lanes = torch.arange(n_lanes, device=p.device)
    one = torch.ones((), dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)

    alphas = []
    for k in range(n_corr):
        valid = count > k
        slot = torch.remainder(pos - 1 - k, n_corr)
        s, y, sy = sk[lanes, slot], yk[lanes, slot], syk[lanes, slot]
        alpha = torch.where(
            valid, _vdot_lanes(s, p) / torch.where(valid, sy, one), zero)
        p = p - _col(alpha) * y.float()
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)

    newest = torch.remainder(pos - 1, n_corr)
    y_last, sy_last = yk[lanes, newest], syk[lanes, newest]
    yy = _vdot_lanes(y_last, y_last)
    scale_hist = sy_last / torch.where(yy > 0, yy, one)
    rms = torch.sqrt(_vdot_lanes(p, p) / p[0].numel())
    scale_rms = 1.0 / torch.where(rms > 0, rms, one)
    p = p * _col(torch.where(count > 0, scale_hist, scale_rms))

    for j in range(n_corr):
        valid = count > j
        slot = torch.remainder(pos - count + j, n_corr)
        s, y, sy = sk[lanes, slot], yk[lanes, slot], syk[lanes, slot]
        beta = _vdot_lanes(y, p) / torch.where(valid, sy, one)
        alpha = alphas[lanes, torch.clamp(count - 1 - j, min=0)]
        p = p + _col(torch.where(valid, alpha - beta, zero)) * s.float()
    return p


def store_curvature_pair_lanes(state, s, y, run=None):
    """store_curvature_pair for each lane at its own cursor, in place: a
    lane's pair is accepted where its s.y > SY_MIN and it runs. Returns
    (sk, yk, syk, count, pos)."""
    sk, yk, syk = state['sk'], state['yk'], state['syk']
    n_corr = syk.shape[1]
    pos = state['pos']
    hist = sk.dtype
    s, y = s.to(hist), y.to(hist)
    sy = _vdot_lanes(s, y)
    accept = sy > SY_MIN
    if run is not None:
        accept = accept & run
    lanes = torch.arange(syk.shape[0], device=syk.device)
    # A rejected pair, or a lane that does not run, rewrites its slot with
    # its own contents.
    sk[lanes, pos] = torch.where(_col(accept), s, sk[lanes, pos])
    yk[lanes, pos] = torch.where(_col(accept), y, yk[lanes, pos])
    syk[lanes, pos] = torch.where(accept, sy, syk[lanes, pos])
    count = torch.where(accept, torch.clamp(state['count'] + 1, max=n_corr),
                        state['count'])
    pos = torch.where(accept, torch.remainder(pos + 1, n_corr), pos)
    return sk, yk, syk, count, pos


def step_lanes(state, opfunc, step_sizes, run=None):
    """step for every lane of a stacked state with (B,) step sizes; lanes
    outside the (B,) run mask still compute but keep their state. The
    (loss, grad) caches must be primed (initial_eval_lanes) first."""
    s = -_col(step_sizes) * inv_hv_lanes(state, state['grad'])
    x_new = state['x'] + s
    loss, grad, aux = opfunc(x_new)
    sk, yk, syk, count, pos = store_curvature_pair_lanes(
        state, s, grad - state['grad'], run)
    state_new = {
        'x': _keep(run, x_new, state['x']),
        'loss': _keep(run, loss, state['loss']),
        'grad': _keep(run, grad, state['grad']),
        'sk': sk,
        'yk': yk,
        'syk': syk,
        'count': count,
        'pos': pos,
    }
    return state_new, loss, aux
