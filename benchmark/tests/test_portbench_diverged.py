"""A non-finite finished job is `failed` unless the reference, held at the
program's own states on the way to where it went non-finite, steps as the
program did and overflows too (`diverged`): a re-run after the window finds
those states (driver.rerun) and check.classify holds the reference there,
under the cell's held limits (benchmark/held/<cell>.json); a cell without
them counts every such job failed. CPU, the program's plain versions, each
cell's traffic at a small size."""

import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from portbench import check, core, driver, faults  # noqa: E402
from test_portbench_faults import CELLS, _small  # noqa: E402

F32 = 'f32-512-lbfgs'
HELD_SPEC = core.held_spec
# Why a cell's non-finite job is failed under runaway and nan.
WHY = {'runaway': 'the step is not the reference', 'nan': 'the re-run stayed '
       'finite'}


@pytest.fixture(autouse=True)
def _float8_yardstick(monkeypatch):
    """TF32, the float32 cell's yardstick, is float32 itself on the CPU, so
    it resolves no gradient there: these tests measure the program's
    gradient against the float8 reference instead."""
    held_spec = core.held_spec

    def on_the_cpu(name):
        spec = held_spec(name)
        return spec and dict(spec, yardstick='fp8')
    monkeypatch.setattr(core, 'held_spec', on_the_cpu)


def _run(cell, config=None, traffic=None, seconds=3.0, seed=2 ** 31 + 7):
    torch.set_num_threads(2)
    bench, c, cfg, tr, limits = core.cell_parts(cell)
    return core.run_cell(bench, c, config or cfg, traffic or _small(tr),
                         limits, seed, seconds, 0, torch.device('cpu'),
                         core.program_modules(), time.perf_counter())


def _overflowing(config, step_size=1000.0):
    """The configuration with a step size at which fixed-step L-BFGS
    overflows float32 within a few steps, in the reference as in the
    program (a test-only configuration: both sides read it)."""
    return dict(config, optimizer=dict(config['optimizer'],
                                       step_size=step_size))


def _why(cell, fault):
    """What a failed job's stderr line says: the reason classify gives, or
    that a cell without held limits re-ran none."""
    return WHY[fault] if core.held_spec(cell) else 'failed (not re-run)'


@pytest.mark.parametrize('cell', CELLS)
def test_a_runaway_step_is_counted_failed(cell, monkeypatch):
    faults.plant('runaway', monkeypatch.setattr)
    res = _run(cell)
    assert res['failed'] >= 1 and res['diverged'] == 0
    assert res['correct'] is False
    assert any(_why(cell, 'runaway') in line for line in res['held'])


@pytest.mark.parametrize('cell', CELLS)
def test_a_non_finite_answer_whose_rerun_stays_finite_is_failed(
        cell, monkeypatch):
    faults.plant('nan', monkeypatch.setattr)
    res = _run(cell)
    assert res['failed'] >= 1 and res['diverged'] == 0
    assert any(_why(cell, 'nan') in line for line in res['held'])


def test_a_stale_gradient_that_overflows_is_failed(monkeypatch):
    """At a step size of 8 jobs overflow within 20 steps: the sound
    program's are diverged, the stale gradient's failed, as their held
    states read a gradient that is not the reference's."""
    _, _, config, traffic, _ = core.cell_parts(F32)
    traffic = dict(_small(traffic), iterations=20)
    config = _overflowing(config, 8.0)
    sound = _run(F32, config=config, traffic=traffic, seconds=6.0)
    assert sound['failed'] == 0 and sound['diverged'] >= 1
    faults.plant('stale', monkeypatch.setattr)
    res = _run(F32, config=config, traffic=traffic, seconds=6.0)
    assert res['failed'] >= 1 and res['diverged'] == 0
    assert all('the gradient is not the reference' in line
               for line in res['held'][1:])


def test_a_cell_without_held_limits_reruns_nothing(monkeypatch):
    monkeypatch.setattr(core, 'held_spec', lambda name: None)
    _, _, config, _, _ = core.cell_parts(F32)
    res = _run(F32, config=_overflowing(config))
    assert res['failed'] >= 1 and res['diverged'] == 0
    assert res['held'][0].startswith('re-runs: 0 of %d' % res['failed'])
    assert 'no held limits' in res['held'][0]


def test_a_yardstick_that_resolves_no_gradient_leaves_the_job_failed(
        monkeypatch):
    """With the cell's own yardstick, TF32, which on the CPU is float32
    itself, no gradient is read: the sound program's jobs are failed."""
    monkeypatch.setattr(core, 'held_spec', HELD_SPEC)
    _, _, config, _, _ = core.cell_parts(F32)
    res = _run(F32, config=_overflowing(config))
    assert res['failed'] >= 1 and res['diverged'] == 0
    assert all('the yardstick resolves the gradient at no point' in line
               for line in res['held'][1:])


def test_a_sound_program_that_overflows_with_the_reference_is_diverged():
    _, _, config, _, _ = core.cell_parts(F32)
    res = _run(F32, config=_overflowing(config))
    assert res['diverged'] >= 1 and res['failed'] == 0
    # The share of non-finite jobs is read and held as before.
    share = res['check']['failed_share']
    assert share['value'] == 1.0 > share['limit']
    assert all('diverged (the reference overflows too)' in line
               for line in res['held'][1:])


def test_non_finite_jobs_past_the_cap_are_failed():
    _, _, config, traffic, _ = core.cell_parts(F32)
    traffic = dict(traffic, rungs=[[16, 24]], iterations=4, chunk=2,
                   style_size=24)
    res = _run(F32, config=_overflowing(config), traffic=traffic)
    n_bad = res['failed'] + res['diverged']
    assert n_bad > driver.RERUNS
    assert res['diverged'] == driver.RERUNS
    assert res['failed'] == n_bad - driver.RERUNS
    assert res['held'][0].startswith('re-runs: %d of %d'
                                     % (driver.RERUNS, n_bad))


@pytest.mark.parametrize('cell', CELLS)
def test_a_rerun_gives_the_windows_iterate_at_each_chunk_boundary(
        cell, monkeypatch):
    """The window runs a job in chunks; the re-run steps it one iteration a
    begin. At every chunk boundary of every rung the two iterates are the
    same bits, and a job that stayed finite is found to."""
    torch.set_num_threads(2)
    _, _, config, traffic, _ = core.cell_parts(cell)
    d = driver.Driver(_small(traffic), config, 11, torch.device('cpu'),
                      core.program_modules())
    d.build()
    seen = {}          # (hw, iterations into the rung) -> iterate
    begin = driver.Driver._begin

    def recording(self, n, hw):
        handle = begin(self, n, hw)
        at = [k for k in seen.get('at', []) if k[0] == tuple(hw)]
        done = (at[-1][1] if at else 0) + n
        seen.setdefault('at', []).append((tuple(hw), done))
        seen[(tuple(hw), done)] = self.st.input.detach().clone()
        return handle

    monkeypatch.setattr(driver.Driver, '_begin', recording)
    assert d.run_job(0, float('inf'))
    window = {k: v for k, v in seen.items() if k != 'at'}
    assert len(window) == len(d.rungs) * (d.iterations // d.chunk)
    seen.clear()
    held = d.rerun(d.answers[-1])
    assert held['rung'] is None and held['points'] == []
    assert np.array_equal(held['image'], d.answers[-1]['image'])
    assert len(seen['at']) == len(d.rungs) * d.iterations
    for key, x in window.items():
        assert torch.equal(seen[key], x), key


def _skew(monkeypatch, which):
    """check.Check._step's float64 step doubled at the points `which`
    picks (by their index in a job's points), so float32 does not resolve
    the step there."""
    step, classify = check.Check._step, check.Check.classify
    seen = []

    def skewed(self, x, state, dtype=torch.float32):
        s = step(self, x, state, dtype)
        if dtype == torch.float64:
            seen.append(dtype)
            if which(len(seen) - 1, self._n_points):
                return 2 * s
        return s

    def fresh(self, held, spec):
        seen.clear()
        self._n_points = len(held['points'])
        return classify(self, held, spec)

    monkeypatch.setattr(check.Check, '_step', skewed)
    monkeypatch.setattr(check.Check, 'classify', fresh)


def test_a_step_float32_does_not_resolve_is_not_read_the_others_are(
        monkeypatch):
    """The newest point's step made unresolved (its float64 step doubled):
    it is not read, and a runaway step still fails at the older points."""
    _skew(monkeypatch, lambda i, n: i == n - 1)
    faults.plant('runaway', monkeypatch.setattr)
    res = _run(F32)
    assert res['failed'] >= 1 and res['diverged'] == 0
    for line in res['held'][1:]:
        assert re.search(r', 1 steps float32 does not ', line), line
        assert 'the step is not the reference' in line


def test_a_job_with_no_step_float32_resolves_is_failed(monkeypatch):
    _skew(monkeypatch, lambda i, n: True)
    _, _, config, _, _ = core.cell_parts(F32)
    res = _run(F32, config=_overflowing(config))
    assert res['failed'] >= 1 and res['diverged'] == 0
    assert all('float32 resolves the step at no point' in line
               for line in res['held'][1:])
