"""The port's CLI on the CPU, and that the port keeps jax out of the
process."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer2_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
CONTENT = str(ROOT / 'examples' / 'golden_gate.jpg')
STYLE = str(ROOT / 'examples' / 'starry_night.jpg')


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_cli_cpu_writes_png_and_trace(tmp_path, precision):
    out = tmp_path / 'out.png'
    trace = tmp_path / 'trace.csv'
    assert cli.main([CONTENT, STYLE, '-o', str(out), '--device', 'cpu',
                     '--size', '32', '--iterations', '3',
                     '--precision', precision,
                     '--trace-csv', str(trace)]) == 0
    with Image.open(out) as img:
        assert img.size == (32, 24)          # 800x600 fitted into 32
    with open(trace, newline='') as f:
        rows = list(csv.DictReader(f))
    # The L-BFGS priming evaluation, then one row per iteration.
    assert len(rows) == 4
    assert [r['fevals'] for r in rows] == ['', '1', '2', '3']
    losses = [float(r['loss']) for r in rows]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'x.png'),
                  '--size', '32', '--iterations', '1'])
    assert not (tmp_path / 'x.png').exists()


def test_port_imports_no_jax(tmp_path):
    """A fresh interpreter that imports the whole port and runs its CLI
    has neither jax nor the JAX package in sys.modules."""
    code = (
        'import json, sys\n'
        'import style_transfer2_tpu_torch.cli as cli\n'
        'import style_transfer2_tpu_torch.engine, '
        'style_transfer2_tpu_torch.ops, style_transfer2_tpu_torch.optim\n'
        'cli.main(sys.argv[1:])\n'
        'print(json.dumps(sorted(m for m in sys.modules\n'
        '    if m.split(".")[0] in\n'
        '    ("jax", "jaxlib", "style_transfer2_tpu"))))\n')
    proc = subprocess.run(
        [sys.executable, '-c', code, CONTENT, STYLE, '-o',
         str(tmp_path / 'o.png'), '--device', 'cpu', '--size', '24',
         '--iterations', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_profile_step_needs_cuda():
    from style_transfer2_tpu_torch import profile_step
    args, cli_args = profile_step.parse_args(['--steps', '3',
                                              '--precision', 'bfloat16'])
    assert args.steps == 3 and cli_args.precision == 'bfloat16'
    assert cli_args.content.endswith('golden_gate.jpg')
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    with pytest.raises(RuntimeError, match='needs CUDA'):
        profile_step.main([])
