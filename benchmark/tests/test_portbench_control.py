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
