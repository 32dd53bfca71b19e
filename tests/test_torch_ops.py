"""The port's losses, Gram matrix and optimizers against the JAX package's,
on the CPU: the same numpy inputs through both, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.ops import gram as jgram
from style_transfer2_tpu.ops import losses as jlosses
from style_transfer2_tpu.optim import adam as jadam
from style_transfer2_tpu.optim import lbfgs as jlbfgs
from style_transfer2_tpu_torch.ops import gram, losses
from style_transfer2_tpu_torch.optim import adam, lbfgs

SHAPE = (1, 5, 6, 3)


def _t(a):
    return torch.from_numpy(np.float32(a))


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize('beta', [2.0, 3.5])
def test_tv_norm_matches_jax(rng, beta):
    x = np.float32(rng.randn(1, 7, 9, 3))
    norm, grad = losses.tv_norm(_t(x), beta)
    jnorm, jgrad = jlosses.tv_norm(jnp.asarray(x), beta)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    np.testing.assert_allclose(_np(grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('p', [2.0, 6.0])
def test_p_norm_matches_jax(rng, p):
    x = np.float32(rng.randn(1, 7, 9, 3))
    x[0, 0, 0, 0] = 0.0          # sign(0) = 0 on both sides
    norm, grad = losses.p_norm(_t(x), p)
    jnorm, jgrad = jlosses.p_norm(jnp.asarray(x), p)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    np.testing.assert_allclose(_np(grad), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('shape', [(1, 7, 9, 64), (5, 4, 16)])
def test_gram_matrix_matches_jax(rng, shape):
    x = np.float32(np.maximum(rng.randn(*shape), 0))
    np.testing.assert_allclose(_np(gram.gram_matrix(_t(x))),
                               np.asarray(jgram.gram_matrix(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)


def _pairs(rng, n):
    """n random (s, y) pairs with positive curvature, except the third,
    which is rejected (y = -s, so s.y < 0)."""
    pairs = []
    for i in range(n):
        s = np.float32(rng.randn(*SHAPE))
        y = np.float32(s * 0.5 + 0.3 * rng.randn(*SHAPE))
        if i == 2:
            y = -s
        pairs.append((s, y))
    return pairs


def _assert_states_match(state, jstate):
    for key in ('sk', 'yk', 'syk'):
        np.testing.assert_allclose(_np(state[key]), np.asarray(jstate[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ('count', 'pos'):
        assert int(state[key]) == int(jstate[key]), key


def test_lbfgs_history_two_loop_match_jax(rng):
    """n_corr=3 over 5 pairs: the ring wraps around, one pair is rejected,
    and after every store the two-loop direction matches."""
    x0 = np.float32(rng.randn(*SHAPE))
    state = lbfgs.init(_t(x0), 3)
    jstate = jlbfgs.init(jnp.asarray(x0), 3)
    p = np.float32(rng.randn(*SHAPE))
    np.testing.assert_allclose(_np(lbfgs.inv_hv(state, _t(p))),
                               np.asarray(jlbfgs.inv_hv(jstate,
                                                        jnp.asarray(p))),
                               rtol=1e-5, atol=1e-6)
    for s, y in _pairs(rng, 5):
        keys = ('sk', 'yk', 'syk', 'count', 'pos')
        state = dict(state, **dict(zip(
            keys, lbfgs.store_curvature_pair(state, _t(s), _t(y)))))
        jstate = dict(jstate, **dict(zip(
            keys, jlbfgs.store_curvature_pair(jstate, jnp.asarray(s),
                                              jnp.asarray(y)))))
        _assert_states_match(state, jstate)
        np.testing.assert_allclose(
            _np(lbfgs.inv_hv(state, _t(p))),
            np.asarray(jlbfgs.inv_hv(jstate, jnp.asarray(p))),
            rtol=1e-4, atol=1e-5)
    assert int(state['count']) == 3 and int(state['pos']) == 1


def _quadratic(scale):
    def opfunc(x):
        loss = 0.5 * (scale * x * x).sum()
        return loss, scale * x, None
    return opfunc


def test_lbfgs_steps_match_jax(rng):
    x0 = np.float32(rng.randn(*SHAPE))
    a = np.float32(rng.uniform(0.5, 3.0, SHAPE))
    state, _, _ = lbfgs.initial_eval(lbfgs.init(_t(x0), 3),
                                     _quadratic(_t(a)))
    jstate, _, _ = jlbfgs.initial_eval(jlbfgs.init(jnp.asarray(x0), 3),
                                       _quadratic(jnp.asarray(a)))
    for _ in range(5):
        state, loss, _ = lbfgs.step(state, _quadratic(_t(a)), 1.0)
        jstate, jloss, _ = jlbfgs.step(jstate, _quadratic(jnp.asarray(a)),
                                       1.0)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(_np(state['x']), np.asarray(jstate['x']),
                                   rtol=1e-4, atol=1e-5)
        _assert_states_match(state, jstate)
    fresh = lbfgs.objective_changed(state)
    assert int(fresh['count']) == 0 and float(fresh['syk'].abs().sum()) == 0


def test_lbfgs_bf16_history_takes_sy_from_stored_pair(rng):
    assert lbfgs.history_dtype_for(torch.bfloat16, (512, 384)) is \
        torch.bfloat16
    assert lbfgs.history_dtype_for(torch.bfloat16, (256, 256)) is None
    assert lbfgs.history_dtype_for(torch.float32, (1024, 1024)) is None
    x0 = np.float32(rng.randn(*SHAPE))
    state = lbfgs.init(_t(x0), 3, history_dtype=torch.bfloat16)
    jstate = jlbfgs.init(jnp.asarray(x0), 3, history_dtype=jnp.bfloat16)
    s, y = _pairs(rng, 1)[0]
    sk, _, syk, _, _ = lbfgs.store_curvature_pair(state, _t(s), _t(y))
    _, _, jsyk, _, _ = jlbfgs.store_curvature_pair(jstate, jnp.asarray(s),
                                                   jnp.asarray(y))
    assert sk.dtype == torch.bfloat16
    stored = torch.dot(_t(s).to(torch.bfloat16).float().reshape(-1),
                       _t(y).to(torch.bfloat16).float().reshape(-1))
    np.testing.assert_allclose(float(syk[0]), float(stored), rtol=1e-6)
    np.testing.assert_allclose(float(syk[0]), float(jsyk[0]), rtol=1e-5)


def test_lbfgs_resample_needs_new_x():
    state = lbfgs.init(torch.zeros(SHAPE), 2)
    new = lbfgs.resample(state, None, new_x=torch.ones(1, 3, 4, 3))
    assert new['sk'].shape == (2, 1, 3, 4, 3) and int(new['count']) == 0
    with pytest.raises(NotImplementedError):
        lbfgs.resample(state, (3, 4))


def test_adam_matches_jax(rng):
    x0 = np.float32(rng.randn(*SHAPE))
    a = np.float32(rng.uniform(0.5, 3.0, SHAPE))
    state, jstate = adam.init(_t(x0)), jadam.init(jnp.asarray(x0))
    # Under jit, as the JAX engine runs it (eager jnp.power rounds the
    # bias corrections differently).
    jstep = jax.jit(lambda st: jadam.step(st, _quadratic(jnp.asarray(a)),
                                          0.5))
    for i in range(5):
        if i == 3:
            state = adam.objective_changed(state)
            jstate = jadam.objective_changed(jstate)
            assert state['g2_items'] == int(jstate['g2_items']) == 3
        state, _, _ = adam.step(state, _quadratic(_t(a)), 0.5)
        jstate, _, _ = jstep(jstate)
        for key in ('x', 'g1_mean', 'g2_mean'):
            np.testing.assert_allclose(_np(state[key]),
                                       np.asarray(jstate[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        for key in ('g1_items', 'g2_items', 't'):
            assert state[key] == int(jstate[key]), key
    with pytest.raises(NotImplementedError):
        adam.resample(state, None, new_x=torch.zeros(1, 3, 3, 3))
