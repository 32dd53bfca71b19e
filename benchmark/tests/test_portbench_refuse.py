"""Runs that must give no result: no card, or a checkout that holds only the
benchmark (CPU). The card's own test decides inside the test."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = json.loads((ROOT / 'BENCHMARK.json').read_text())['workloads'][0]


def _run(cwd):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', CELL['name'],
         '--seed', str(2 ** 31 + 11), '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the refusal cannot show')
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'no CUDA device' in out.stderr


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
