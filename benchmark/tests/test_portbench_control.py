"""The comparison's control on the card: the reference one precision below
the configuration's (TF32 for float32, float8 for bfloat16) put in the
program's place fails at least one of the cell's limits, where the program
itself passes them. At a small size of each cell's own traffic; the cells'
own sizes are run by benchmark/calibrate.py --control (PERF.md)."""

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import calibrate  # noqa: E402
from portbench import core  # noqa: E402

CELLS = [w['name'] for w in
         json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
         ['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_fails_a_limit_the_program_passes(cell, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: TF32 and the float8 control run on '
                    'the card')
    orig = core.cell_parts

    def small(name, bench=None):
        b, c, config, traffic, limits = orig(name, bench)
        rungs = traffic['rungs'][:3]
        return b, c, config, dict(traffic, rungs=rungs, iterations=30), limits

    monkeypatch.setattr(core, 'cell_parts', small)
    limits = orig(cell)[4]['limits']
    out = calibrate.one_seed(cell, 2 ** 31 + 21, 3.0, torch.device('cuda'),
                             core.program_modules(), True)
    assert out['answers'] > 0
    assert all(v <= limits[k] for k, v in out['program'].items()), out
    assert any(not v <= limits[k] for k, v in out['control'].items()), out


@pytest.mark.cuda
def test_the_control_held_at_overflowing_jobs_is_failed(monkeypatch):
    """At a step size of 8 float32 jobs overflow within 20 steps, in the
    reference as in the program: the program's re-run jobs (the first 8
    non-finite ones; the rest are failed) come out diverged, and the
    control's gradient and step, held at the same states under the cell's
    held limits (benchmark/held), failed."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: TF32 runs on the card')
    from test_portbench_faults import _small
    cell = 'f32-512-lbfgs'
    orig = core.cell_parts

    def overflowing(name, bench=None):
        b, c, config, traffic, limits = orig(name, bench)
        config = dict(config, optimizer=dict(config['optimizer'],
                                             step_size=8.0))
        return b, c, config, dict(_small(traffic), iterations=20), limits

    monkeypatch.setattr(core, 'cell_parts', overflowing)
    out = calibrate.one_seed(cell, 2 ** 31 + 23, 6.0, torch.device('cuda'),
                             core.program_modules(), True)
    program = [v['verdict'] for v in out['verdicts']]
    assert program and set(program) == {'diverged'}, out['verdicts']
    control = [v['verdict'] for v in out['control_verdicts']]
    assert len(control) == len(program), out['control_verdicts']
    assert set(control) == {'failed'}, out['control_verdicts']
