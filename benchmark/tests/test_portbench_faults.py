"""A run with the timed path broken underneath reads `correct` false: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
small size with the cell's own traffic shape, configuration and limits, once
for each fault the cell can have (portbench/faults.py). The sound run's
readings of the same numbers stay under their limits."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from portbench import core, faults  # noqa: E402

SPEC = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in SPEC['workloads']]
# The number each fault moves, and how.
FAULTS = {'frozen': 'start_step_gap', 'answer': 'answer_loss_gap',
          'stale': 'follow_grad_gap', 'nan': 'failed_share',
          'runaway': 'start_step_gap'}


def _small(traffic):
    """The traffic at a CPU size: its rungs scaled to a 64 px top rung, its
    jobs short (but long enough for a stale gradient to show in the step it
    feeds)."""
    top = max(traffic['rungs'][-1])
    rungs = [[max(8, round(h * 64 / top)), max(8, round(w * 64 / top))]
             for h, w in traffic['rungs']][-3:]
    return dict(traffic, rungs=rungs, iterations=8, chunk=4, style_size=64)


def _run(cell, seed=2 ** 31 + 5):
    torch.set_num_threads(2)
    bench, c, config, traffic, limits = core.cell_parts(cell)
    res = core.run_cell(bench, c, config, _small(traffic), limits, seed,
                        3.0, 0, torch.device('cpu'),
                        core.program_modules(), time.perf_counter())
    assert res['attempted'] >= 2      # a job finished, a job followed
    return res


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_planted_fault_reads_not_correct(cell, fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    res = _run(cell)
    assert res['correct'] is False
    number = res['check'][FAULTS[fault]]
    assert not number['value'] <= number['limit'], number


@pytest.mark.parametrize('cell', CELLS)
def test_the_sound_run_passes_the_numbers_the_faults_move(cell):
    res = _run(cell)
    for name in FAULTS.values():
        number = res['check'][name]
        assert number['value'] <= number['limit'], (name, number)


def test_half_the_lanes_left_out_reads_not_correct(monkeypatch):
    """The batched engine's path (a traffic of 'lanes'): its step applied
    to half of the lanes moves the other half's start_step_gap to 1."""
    torch.set_num_threads(2)
    bench, c, config, traffic, limits = core.cell_parts(CELLS[0])
    traffic = dict(traffic, engine='lanes', lanes=4, rungs=[[24, 32]],
                   contents=['golden_gate', 'starry_night'],
                   iterations=4, chunk=2, style_size=32)
    sound = core.run_cell(bench, c, config, traffic, limits, 9, 3.0, 0,
                          torch.device('cpu'), core.program_modules(),
                          time.perf_counter())
    assert sound['check']['start_step_gap']['value'] < 1e-3
    faults.plant('half', monkeypatch.setattr)
    res = core.run_cell(bench, c, config, traffic, limits, 9, 3.0, 0,
                        torch.device('cpu'), core.program_modules(),
                        time.perf_counter())
    assert res['correct'] is False
    assert res['check']['start_step_gap']['value'] > 0.5
