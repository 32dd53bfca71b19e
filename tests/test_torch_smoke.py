"""chip_smoke.py's pieces that need no card: how a device time is taken
from several torch.profiler sessions, and the conv paths it requires the
main and ladder runs to take."""

import importlib.util
from pathlib import Path

import pytest

from style_transfer2_tpu_torch.ops import conv

_SPEC = importlib.util.spec_from_file_location(
    'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.mark.parametrize('sessions,want', [
    ([(6, 0.9), (6, 0.9)], 0.3),          # two full sessions agree
    ([(6, 0.9), (6, 1.5)], 0.4),          # their mean, per call
    ([(6, 0.9), (2, 0.03), (6, 1.5)], 0.4),   # the partial one dropped
    ([(2, 0.03), (2, 0.03), (6, 0.9)], None),  # one full session only
    ([(6, 0.9), (3, 0.4)], None),         # the two disagree
    ([(0, 0.0), (0, 0.0), (0, 0.0)], None),   # no kernel seen
])
def test_agreed_ms_keeps_the_sessions_that_saw_every_kernel(sessions, want):
    got = chip_smoke.agreed_ms(sessions, 3)
    if want is None:
        assert got is None
    else:
        assert abs(got - want) < 1e-12


def test_device_ms_runs_a_third_session_only_on_disagreement(monkeypatch):
    seen = iter([(6, 0.9), (2, 0.1), (6, 0.9)])
    calls = []

    def session(fn, torch, n):
        calls.append(n)
        return next(seen)

    monkeypatch.setattr(chip_smoke, 'profile_session', session)
    assert abs(chip_smoke.device_ms(None, None) - 0.3) < 1e-12
    assert len(calls) == 3
    seen = iter([(6, 0.9), (6, 0.9)])
    calls.clear()
    monkeypatch.setattr(chip_smoke, 'profile_session',
                        lambda fn, torch, n: calls.append(n) or next(seen))
    assert abs(chip_smoke.device_ms(None, None) - 0.3) < 1e-12
    assert len(calls) == 2


@pytest.mark.parametrize('precision,missing', [
    ('bfloat16', ('fwd', conv.WGMMA)), ('bfloat16', ('bwd', conv.WGMMA)),
    ('float32', ('bwd', conv.NARROW)), ('float32', ('fwd', conv.SCALAR))])
def test_require_paths_names_a_path_never_taken(monkeypatch, precision,
                                                missing):
    paths = {('fwd', conv.WGMMA): 5, ('bwd', conv.WGMMA): 5,
             ('fwd', conv.TILE): 2, ('bwd', conv.NARROW): 2,
             ('fwd', conv.SCALAR): 1, ('fwd', conv.WGMMA_SPLIT): 1}
    monkeypatch.setattr(conv, 'path_launches', dict(paths))
    chip_smoke.require_paths('main', precision)
    del conv.path_launches[missing]
    with pytest.raises(RuntimeError, match=missing[1]):
        chip_smoke.require_paths('main', precision)
