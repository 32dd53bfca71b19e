"""Golden end-to-end parity: the port's StyleTransfer (on the CPU, so with
the kernels' plain versions) against the JAX StyleTransfer(use_pallas=True)
from the same images and weights, every trace key at rtol 5e-3 and images
at atol 0.75, as tests/test_golden.py holds the JAX engine to its oracle."""

import numpy as np
import pytest

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu_torch.engine import StyleTransfer

SIZE = (32, 32)
WEIGHTS = {
    'content': {'conv3_2': 0.08},
    'style': {'conv1_1': 1.0, 'conv2_1': 1.0, 'conv3_1': 1.0},
    'deepdream': {'conv2_2': 0.3},
}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
NEW_WEIGHTS = {
    'content': {'conv3_2': 0.2},
    'style': {'conv1_1': 2.0, 'conv2_1': 1.0, 'conv3_1': 1.0,
              'conv4_1': 1.0},
    'deepdream': {'conv2_2': 0.3},
}
RTOL = 5e-3


def _engines(params, optimizer, step_size, images):
    out = []
    for engine in (StyleTransfer(params, device='cpu'),
                   JaxStyleTransfer(params, use_pallas=True)):
        engine.set_weights(WEIGHTS, SCALARS)
        engine.set_optimizer(optimizer)
        engine.set_step_size(step_size)
        content, style, inp = images
        engine.set_content(content)
        engine.set_style(style)
        engine.set_input(inp)
        assert engine.start()
        out.append(engine)
    return out


def _assert_trace_match(got, want, where):
    keys = [k for k in want if k not in ('time', 'fevals')]
    assert [k for k in got if k not in ('time', 'fevals')] == keys, where
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   err_msg='%s: %s' % (where, key))
    assert got.get('fevals') == want.get('fevals'), where


def _images(rng):
    return tuple(rng.randint(0, 256, SIZE + (3,)).astype(np.uint8)
                 for _ in range(3))


@pytest.mark.parametrize('optimizer,step_size', [('adam', 10.0),
                                                 ('lbfgs', 1.0)])
def test_trace_parity_with_jax(rng, optimizer, step_size):
    st, jst = _engines(random_params(7), optimizer, step_size, _images(rng))
    for step in range(5):
        img, trace = st.step()
        jimg, jtrace = jst.step()
        _assert_trace_match(trace, jtrace, 'step %d' % step)
        np.testing.assert_allclose(img, jimg, rtol=1e-2, atol=0.75,
                                   err_msg='image at step %d' % step)
    # The whole history, L-BFGS priming evaluations included.
    assert len(st.traces) == len(jst.traces)
    for i, (got, want) in enumerate(zip(st.traces, jst.traces)):
        _assert_trace_match(got.data, want.data, 'history %d' % i)


def test_midrun_set_weights_parity_with_jax(rng):
    """A mid-run weight change adds a style layer (whose target Gram
    set_style already holds), clears the L-BFGS history and re-primes, and
    keeps the first-evaluation norms of the layers that had them."""
    st, jst = _engines(random_params(9), 'lbfgs', 1.0, _images(rng))
    for _ in range(2):
        st.step()
        jst.step()
    st.set_weights(NEW_WEIGHTS, SCALARS)
    jst.set_weights(NEW_WEIGHTS, SCALARS)
    for step in range(3):
        img, trace = st.step()
        jimg, jtrace = jst.step()
        _assert_trace_match(trace, jtrace, 'step %d after' % step)
        np.testing.assert_allclose(img, jimg, rtol=1e-2, atol=0.75)
    assert set(st.norm_vals) == set(jst.norm_vals)
    for key, value in jst.norm_vals.items():
        np.testing.assert_allclose(float(st.norm_vals[key]), float(value),
                                   rtol=RTOL, err_msg=key)


def test_norms_survive_steps_and_clear_on_reset(rng):
    st = StyleTransfer(random_params(5), device='cpu')
    st.set_weights(WEIGHTS, SCALARS)
    st.set_optimizer('adam')
    content, style, inp = _images(rng)
    st.set_content(content)
    st.set_style(style)
    st.set_input(inp)
    assert st.start()
    st.step()
    first = {k: float(v) for k, v in st.norm_vals.items()}
    st.step()
    assert {k: float(v) for k, v in st.norm_vals.items()} == first
    assert all(v > 0 for v in first.values())
    st.reset()
    assert st.norm_vals == {} and st.t == 0
    st.is_starting = True
    st._start()
    _, trace = st.step()
    assert trace['fevals'] == 1
    assert any(not np.isclose(float(st.norm_vals[k]), first[k])
               for k in first)


def test_start_gating_and_resize(rng):
    st = StyleTransfer(random_params(5), device='cpu')
    st.set_weights(WEIGHTS, SCALARS)
    content, style, inp = _images(rng)
    st.set_content(content)
    st.set_style(style)
    st.set_input(inp[:16])          # a size that does not match the content
    assert not st.start()
    st.set_input(inp)               # L-BFGS warm start at the new size
    assert st.is_running and st.input_hw == SIZE
    _, trace = st.step()
    assert np.isfinite(trace['loss'])
    with pytest.raises(ValueError):
        st.set_optimizer('sgd')
