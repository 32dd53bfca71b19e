"""What a run loads: never jax, jaxlib, flax or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX package's),
and the plain reference nothing of the port (CPU, fresh interpreters)."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'style_transfer2_tpu'}


def _modules(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\n'
         'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_a_cell_on_the_cpu_loads_no_jax():
    code = (
        'import sys, time\n'
        'sys.path.insert(0, "benchmark")\n'
        'import torch\n'
        'torch.set_num_threads(2)\n'
        'from portbench import core\n'
        'bench, cell, config, traffic, limits = core.cell_parts('
        '"f32-512-lbfgs")\n'
        'traffic = dict(traffic, rungs=[[24, 32]], iterations=4, chunk=2,'
        ' style_size=32)\n'
        'res = core.run_cell(bench, cell, config, traffic, limits, 7, 2.0, 0,'
        ' torch.device("cpu"), core.program_modules(), time.perf_counter())\n'
        'assert "style_transfer2_tpu_torch" in sys.modules\n'
        'assert not core.forbidden_modules(), core.forbidden_modules()\n')
    loaded = _modules(code)
    assert 'style_transfer2_tpu_torch' in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    config = json.loads((BENCH / 'configs' / 'vgg19-gatys-f32.json')
                        .read_text())
    code = (
        'import importlib.util\n'
        'spec = importlib.util.spec_from_file_location("ref", '
        '"benchmark/reference/%s.py")\n'
        'mod = importlib.util.module_from_spec(spec)\n'
        'spec.loader.exec_module(mod)\n' % config['reference'])
    loaded = _modules(code)
    assert not loaded & (FORBIDDEN | {'style_transfer2_tpu_torch',
                                      'portbench'})
