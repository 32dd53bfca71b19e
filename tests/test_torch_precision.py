"""Precision belongs to each engine, not to the process.

The JAX package binds a precision to each engine's programs
(style_transfer2_tpu/engine/steps.py:56-71). In the port the TF32 switches
are process-wide torch settings, so building a float32_fast engine once
turned TF32 on under every float32 engine alive in the process (the polish
phase builds a float32 engine beside the bfloat16 one). Each engine now
holds its own switches only around the device work it launches. The spies
read the switches where the objective and the Gram matrices run."""

import numpy as np
import pytest
import torch

from style_transfer2_tpu_torch.engine import StyleTransfer, objective
from style_transfer2_tpu_torch.engine import transfer as transfer_mod
from style_transfer2_tpu_torch.models import random_params
from style_transfer2_tpu_torch.utils import tf32

WEIGHTS = {'content': {'conv2_2': 0.1},
           'style': {'conv1_1': 1.0, 'conv2_1': 1.0}, 'deepdream': {}}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}


def _switches():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def seen(monkeypatch):
    """Records the TF32 switches at every style-branch and Gram call."""
    calls = []
    branch = objective.fused_style_branch
    gram = transfer_mod.gram_matrix

    def spy_branch(feat, gram_style):
        calls.append(('objective',) + _switches())
        return branch(feat, gram_style)

    def spy_gram(feat):
        calls.append(('gram',) + _switches())
        return gram(feat)

    monkeypatch.setattr(objective, 'fused_style_branch', spy_branch)
    monkeypatch.setattr(transfer_mod, 'gram_matrix', spy_gram)
    with tf32(True):        # whatever the process had, it comes back
        yield calls


def _engine(precision):
    rng = np.random.RandomState(1)
    st = StyleTransfer(random_params(1), precision=precision, device='cpu')
    st.set_weights(WEIGHTS, SCALARS)
    st.set_content(rng.randint(0, 256, (20, 24, 3)).astype(np.uint8))
    st.set_style(rng.randint(0, 256, (20, 24, 3)).astype(np.uint8))
    st.set_input(rng.randint(0, 256, (20, 24, 3)).astype(np.uint8))
    assert st.start()
    return st


def test_float32_engine_steps_without_tf32_beside_a_fast_one(seen):
    exact = _engine('float32')
    fast = _engine('float32_fast')
    seen.clear()
    exact.step()
    exact.run_steps(2)
    assert seen and all(call == ('objective', False, False) for call in seen)
    seen.clear()
    fast.step()
    assert seen and all(call == ('objective', True, True) for call in seen)
    # Outside the engines' work the caller's switches hold.
    assert _switches() == (True, True)


def test_style_grams_take_the_engine_precision(seen):
    _engine('float32')
    assert [c for c in seen if c[0] == 'gram'] and all(
        c[1:] == (False, False) for c in seen if c[0] == 'gram')
    assert _switches() == (True, True)


def test_tf32_scope_restores_after_an_error():
    before = _switches()
    with pytest.raises(RuntimeError):
        with tf32(not before[0]):
            assert _switches() == (not before[0],) * 2
            raise RuntimeError('inside')
    assert _switches() == before
