"""BENCHMARK.json against the benchmark's contract, and the harness finding
every part of a cell by its name in data files (CPU)."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from portbench import core  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= len(SPEC['command']) <= 32
    assert all(_line(w) and not w.startswith('/') and '..' not in w
               for w in SPEC['command'])
    assert isinstance(SPEC['run_seconds'], int)
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_units_and_lines(section):
    entries = SPEC[section]
    names = [e['name'] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer', 'source'):
            if key in e and section in ('configs', 'workloads', 'per_layer'):
                assert _line(e[key]), (e['name'], key)


def test_configs_files_and_reduced():
    for c in SPEC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/')
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['name'] == c['name']
        assert c['reduced'] == cfg['reduced'] == []
        assert (BENCH / 'reference' / (cfg['reference'] + '.py')).exists()
        assert any(w['config'] == c['name'] for w in SPEC['workloads'])


def test_cells_find_their_parts():
    pairs = set()
    for w in SPEC['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        _, cell, config, traffic, limits = core.cell_parts(w['name'])
        assert cell is not None and config['name'] == w['config']
        assert traffic['rungs'] and limits['limits']


def test_metrics_sources_and_moves():
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e and 'workloads' not in e2e['setup_s']
    assert e2e['setup_s']['bound'] == 0.25
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert (BENCH / 'end_to_end' / (m['name'] + '.py')).exists()
    cells = {w['name'] for w in SPEC['workloads']}
    layers = {}
    for m in SPEC['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert (BENCH / 'metrics' / (m['name'] + '.py')).exists()
        moved = e2e[m['moves']]
        for cell in m['workloads']:
            assert cell in cells
            # Each cell of a per-layer metric reports the metric it moves.
            assert cell in moved.get('workloads', cells)
        layers.setdefault(m['layer'], set()).add(m['name'])
    for cell in cells:
        reported = [m for m in SPEC['end_to_end']
                    if cell in m.get('workloads', cells)]
        assert len(reported) >= 2
        assert any(cell in m['workloads'] for m in SPEC['per_layer'])


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    """Files added beside the benchmark's, and entries in BENCHMARK.json,
    are all a new cell needs: no file of the harness is edited."""
    root = tmp_path / 'checkout'
    shutil.copytree(BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cfg = json.loads((BENCH / 'configs' / 'vgg19-gatys-f32.json').read_text())
    cfg['name'] = 'vgg19-new'
    (root / 'benchmark/configs/vgg19-new.json').write_text(json.dumps(cfg))
    traffic = json.loads(
        (BENCH / 'traffic' / (spec['workloads'][0]['traffic'] + '.json'))
        .read_text())
    traffic['rungs'] = [[40, 48]]
    (root / 'benchmark/traffic/tiny-new.json').write_text(json.dumps(traffic))
    (root / 'benchmark/workloads/new-cell.json').write_text(json.dumps(
        {'limits': {'start_loss_gap': 1}}))
    (root / 'benchmark/metrics/new_metric.py').write_text(
        'def read(ctx):\n    return 42.0\n')
    spec['configs'].append({'name': 'vgg19-new', 'source': 'x',
                            'file': 'benchmark/configs/vgg19-new.json',
                            'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': 'new-cell', 'config': 'vgg19-new',
                              'traffic': 'tiny-new', 'chips': 1, 'why': 'x'})
    spec['per_layer'].append({'name': 'new_metric', 'unit': 'x',
                              'better': 'lower', 'source': 'program_counter',
                              'layer': 'x', 'moves': 'setup_s',
                              'workloads': ['new-cell']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    code = (
        'import sys; sys.path.insert(0, "benchmark")\n'
        'from portbench import core\n'
        'bench, cell, config, traffic, limits = core.cell_parts("new-cell")\n'
        'assert config["name"] == "vgg19-new" and traffic["rungs"] == '
        '[[40, 48]]\n'
        'names = [m["name"] for m, p in core.reported(bench, cell, 1)]\n'
        'assert names == ["new_metric"], names\n'
        'path = dict((m["name"], p) for m, p in core.reported(bench, cell, 1))'
        '["new_metric"]\n'
        'assert core.load_reader(path)(None) == 42.0\n'
        'print("found")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'found'
