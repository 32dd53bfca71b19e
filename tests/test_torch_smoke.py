"""chip_smoke.py's pieces that need no card: how a device time is taken
from several torch.profiler sessions, the conv paths it requires the
main and ladder runs to take, and its serve phase against the app on the
CPU."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer2_tpu_torch.ops import conv

_SPEC = importlib.util.spec_from_file_location(
    'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.fixture
def one_thread():
    """One intra-op thread: these shapes are tiny, and where the test runner
    runs several workers at once, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize('precision,hw,missing', [
    ('float32', (288, 384), ('fwd', conv.SPLIT)),
    ('float32', (192, 256), ('bwd', conv.SPLIT)),
    ('bfloat16', (192, 256), ('fwd', conv.WGMMA_SPLIT)),
    ('bfloat16', (192, 256), ('bwd', conv.WGMMA_SPLIT))])
def test_require_planned_holds_each_bucket_grid(monkeypatch, precision, hw,
                                                missing):
    """The pool's smaller buckets plan the split paths at N = 4 (on an
    H100's 132 SMs) where the 384x512 grid plans none: launches that
    cover the 384x512 plan alone fail for the smaller bucket, naming the
    path never taken."""
    import types

    fake = types.SimpleNamespace(
        float32=torch.float32, bfloat16=torch.bfloat16,
        cuda=types.SimpleNamespace(get_device_properties=lambda i: (
            types.SimpleNamespace(multi_processor_count=132))))
    big = chip_smoke.planned_paths(fake, precision, (384, 512), 4)
    assert missing not in big
    small = chip_smoke.planned_paths(fake, precision, hw, 4)
    assert missing in small
    monkeypatch.setattr(conv, 'path_launches', dict.fromkeys(big, 1))
    chip_smoke.require_planned(fake, 'pool', [(precision, (384, 512))], 4)
    with pytest.raises(RuntimeError, match=missing[1]):
        chip_smoke.require_planned(fake, 'pool', [(precision, (384, 512)),
                                                  (precision, hw)], 4)
    monkeypatch.setattr(conv, 'path_launches', dict.fromkeys(big + small, 1))
    chip_smoke.require_planned(fake, 'pool', [(precision, (384, 512)),
                                              (precision, hw)], 4)


def test_require_all_launched_needs_graph_replays(monkeypatch):
    """A run whose steps never replayed a graph fails, however many kernels
    it launched; one that replayed records its count."""
    ones = dict.fromkeys(chip_smoke.KERNELS, 1)
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 0)
    with pytest.raises(RuntimeError, match='no step graph replayed'):
        chip_smoke.require_all_launched(ones, 'main float32', ('float32',))
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 19)
    chip_smoke.require_all_launched(ones, 'main float32', ('float32',))
    assert chip_smoke.REPLAYS['main float32'] == 19


@pytest.mark.parametrize('precisions,missing,fails', [
    (('float32',), 'sumsq', False), (('float32',), 'fused_style_branch',
                                     True),
    (('bfloat16',), 'fused_style_branch', False),
    (('bfloat16',), 'sumsq', True), (('bfloat16',), 'style_grad_bf16', True),
    (('bfloat16', 'float32'), 'fused_style_branch', True),
    (('bfloat16', 'float32'), 'style_gram_bf16', True),
    (('float32',), 'tap_epilogue', True), (('bfloat16',), 'tap_epilogue',
                                           False),
    (('float32',), 'pool_fwd', True), (('bfloat16',), 'pool_bwd', True),
    (('bfloat16', 'float32'), 'tap_epilogue', True)])
def test_require_all_launched_follows_the_precision(monkeypatch, precisions,
                                                   missing, fails):
    """A float32 run needs the fused style branch and not the bf16 feed's
    kernels, a bfloat16 run the feed's (its bf16 style phases and sumsq)
    and not the fused branch, a bfloat16 run with a float32 polish
    both."""
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    counts = dict(dict.fromkeys(chip_smoke.KERNELS, 1), **{missing: 0})
    if fails:
        with pytest.raises(RuntimeError, match='%s never launched'
                           % missing):
            chip_smoke.require_all_launched(counts, 'run', precisions)
    else:
        chip_smoke.require_all_launched(counts, 'run', precisions)


@pytest.mark.parametrize('missing,fails', [
    ('tap_epilogue', False), ('pool_fwd', True), ('pool_bwd', True),
    ('fused_style_branch', True)])
def test_require_all_launched_of_a_lanes_run(monkeypatch, missing, fails):
    """A float32 lanes run (the batched engine keeps the float32 feed's
    PyTorch terms) needs no tap epilogue, and every other float32 kernel,
    the pool's two included."""
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    counts = dict(dict.fromkeys(chip_smoke.KERNELS, 1), **{missing: 0})
    if fails:
        with pytest.raises(RuntimeError, match='%s never launched'
                           % missing):
            chip_smoke.require_all_launched(counts, 'batch float32',
                                            ('float32',), lanes=True)
    else:
        chip_smoke.require_all_launched(counts, 'batch float32',
                                        ('float32',), lanes=True)


def test_counters_name_every_kernel_with_a_source():
    """counters() reads every kernel of KERNELS, the step glue's included,
    and each has its sources and the JAX code it replaces."""
    assert set(chip_smoke.counters()) == set(chip_smoke.KERNELS)
    for name in chip_smoke.KERNELS:
        sources, replaces = chip_smoke.SOURCES[name]
        assert all((chip_smoke.ROOT / f).is_file() for f in sources), name
        path, line = replaces.rsplit(':', 1)
        assert (chip_smoke.ROOT / path).is_file() and int(line) > 0, name


def _highres_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's highres runs made small enough for the CPU: --size 32
    (a 24x32 iterate), 6 iterations in chunks of 2, the card-only parts
    stubbed (kernel counts, paths, replays, torch.cuda's memory
    statistics). Returns (the fake torch, the CLI log handler)."""
    import logging
    import types

    monkeypatch.setattr(chip_smoke, 'HIGHRES_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'HIGHRES_SIZE', 32)
    monkeypatch.setattr(chip_smoke, 'HIGHRES_HW', (24, 32))
    monkeypatch.setattr(chip_smoke, 'HIGHRES_ITERATIONS', 6)
    monkeypatch.setattr(chip_smoke, 'HIGHRES_CHUNK', 2)
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    ones = dict.fromkeys(chip_smoke.KERNELS, 1)
    monkeypatch.setattr(chip_smoke, 'counters', lambda: dict(ones))
    monkeypatch.setattr(chip_smoke, 'require_paths', lambda *a: None)
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, empty_cache=lambda: None,
        memory_allocated=lambda: 0, reset_peak_memory_stats=lambda: None,
        max_memory_allocated=lambda: 2 ** 20,
        max_memory_reserved=lambda: 2 ** 21,
        memory_reserved=lambda: 2 ** 21))
    log = chip_smoke.CliLog()
    logger = logging.getLogger('cli')
    monkeypatch.setattr(logger, 'level', logging.INFO)
    logger.addHandler(log)
    return fake, log, logger


@pytest.mark.usefixtures('one_thread')
def test_highres_runs_on_the_cpu(monkeypatch, tmp_path):
    """The highres phase's five CLI runs end to end at 24x32: falling
    losses, the PNG, the rate over the last two chunks, the reserved
    memory read at each chunk, and each remat run's trace equal to its
    precision's run without remat."""
    fake, log, logger = _highres_on_the_cpu(monkeypatch, tmp_path)
    try:
        got = chip_smoke.highres_runs(fake, log, 'a CPU', [])
    finally:
        logger.removeHandler(log)
    assert got == dict.fromkeys(chip_smoke.KERNELS, 5)
    result = json.loads((tmp_path / 'highres.json').read_text())
    assert result['device'] == 'a CPU' and result['kernels'] == []
    assert list(result['runs']) == [
        'float32 no remat', 'float32 block', 'bfloat16 no remat',
        'bfloat16 conv', 'bfloat16 block']
    for name, run in result['runs'].items():
        assert run['it_s'] > 0 and run['wall_s'] > 0
        assert run['losses'][1] < run['losses'][0]
        assert run['memory_reserved_at_chunks'] == [2 ** 21] * 3
        assert run['max_memory_allocated'] == run['peak_bytes'] == 2 ** 20
        assert ('remat_ms_step' in run) == (run['remat'] is not None)
        _assert_roofline(run, run['ms_step'], run['precision'], (24, 32),
                         run['remat'] or False)
    for name in ('float32_remat_block', 'bfloat16_remat_conv'):
        assert (tmp_path / ('highres_%s.csv' % name)).exists()
        assert not (tmp_path / ('highres_%s.png' % name)).exists()


@pytest.mark.usefixtures('one_thread')
def test_highres_refuses_a_remat_trace_that_differs(monkeypatch, tmp_path):
    fake, log, logger = _highres_on_the_cpu(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, 'HIGHRES_RUNS',
                        (('float32', None), ('float32', 'block')))
    read = chip_smoke.read_trace

    def nudged(path):
        rows = read(path)
        if 'remat' in path.name:
            rows[-1]['loss'] = repr(float(rows[-1]['loss']) * (1 + 1e-7))
        return rows

    monkeypatch.setattr(chip_smoke, 'read_trace', nudged)
    try:
        with pytest.raises(RuntimeError, match='trace differs'):
            chip_smoke.highres_runs(fake, log, 'a CPU', [])
    finally:
        logger.removeHandler(log)


def test_serve_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The serve phase's browser script, event log and checks end to end
    against the app on the CPU at 36x48 (its ladder 18x24 -> 36x48), with
    the card-only parts stubbed: the kernel counts (no kernel launches
    here) and torch.cuda's name and sync."""
    import types

    monkeypatch.setattr(chip_smoke, 'SERVE_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'SERVE_SIZE', 48)
    monkeypatch.setattr(chip_smoke, 'SERVE_RESIZE', 64)
    monkeypatch.setattr(chip_smoke, 'SERVE_MIN_SCALE', 24)
    monkeypatch.setattr(chip_smoke, 'SERVE_RUNGS',
                        [(18, 24), (25, 34), (36, 48)])
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    ones = dict.fromkeys(chip_smoke.KERNELS, 1)
    monkeypatch.setattr(chip_smoke, 'counters', lambda: dict(ones))
    monkeypatch.setattr(chip_smoke, 'require_paths', lambda *a: None)
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, get_device_name=lambda i: 'cpu',
        memory_allocated=lambda: 0, reset_peak_memory_stats=lambda: None,
        max_memory_allocated=lambda: 2 ** 20))
    assert chip_smoke.phase_serve(fake, 'a CPU') == dict.fromkeys(
        chip_smoke.KERNELS, 2)
    a = json.loads((tmp_path / 'serve.json').read_text())
    assert a['float32']['grid_512'] == [36, 48]
    assert a['float32']['grid_768'] == [48, 64]
    assert a['float32']['iterates_768'] >= chip_smoke.SERVE_RESIZE_ITERATES
    assert a['float32']['control_s'] > 0
    ladder = a['bfloat16 ladder']
    assert [r['hw'] for r in ladder['rungs']] == [[18, 24], [25, 34],
                                                  [36, 48]]
    assert ladder['polish_iterates'] >= chip_smoke.SERVE_POLISH
    assert ladder['polish_respawn_s'] >= ladder['polish_ready_s'] > 0


@pytest.mark.usefixtures('one_thread')
def test_batch_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The batch phase end to end on the CPU at --size 32: its inputs (the
    four flips of golden_gate in one wave, starry_night alone in another),
    the CLI's --batch, the per-lane losses, the PNG sizes, the wave rates
    read from the CLI's log and the 48x64 batch parity, with the card-only
    parts stubbed (kernel counts, planned paths, memory statistics)."""
    import logging
    import types

    monkeypatch.setattr(chip_smoke, 'BATCH_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'BATCH_SIZE', 32)
    monkeypatch.setattr(chip_smoke, 'ITERATIONS', 3)
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    ones = dict.fromkeys(chip_smoke.KERNELS, 1)
    monkeypatch.setattr(chip_smoke, 'counters', lambda: dict(ones))
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    monkeypatch.setattr(chip_smoke, 'planned_paths', lambda *a: [])
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, memory_allocated=lambda: 0,
        reset_peak_memory_stats=lambda: None,
        max_memory_allocated=lambda: 2 ** 20))
    log = chip_smoke.CliLog()
    logger = logging.getLogger('cli')
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        got, aggregate = chip_smoke.phase_batch(
            fake, log, {'float32': 10.0, 'bfloat16': 20.0}, 'a CPU')
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    assert got == dict.fromkeys(chip_smoke.KERNELS, 2)
    result = json.loads((tmp_path / 'batch.json').read_text())
    for precision in ('float32', 'bfloat16'):
        run = result[precision]
        assert run['lanes'] == chip_smoke.LANES
        assert run['aggregate_it_s'] == pytest.approx(
            chip_smoke.LANES * run['lane_it_s'])
        assert aggregate[precision] == run['aggregate_it_s']
        assert run['single_it_s'] == {'float32': 10.0,
                                      'bfloat16': 20.0}[precision]
        assert len(run['losses']) == 5
        assert sorted(p.name for p in (tmp_path / ('batch_' + precision))
                      .iterdir()) == sorted(
            ['golden_gate%s_styled.png' % v
             for v in ('', '_both', '_lr', '_tb')]
            + ['starry_night_styled.png'])
    assert result['parity_worst_rel_err'] <= chip_smoke.PARITY_RTOL


@pytest.mark.usefixtures('one_thread')
def test_pool_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The pool phase's browser script, logs and checks end to end against
    the port's pool and router on the CPU, its buckets at 18x24, 27x36 and
    36x48, with the card-only parts stubbed: the kernel counts and planned
    paths (no kernel launches here), torch.cuda's name, sync and memory
    statistics."""
    import types

    monkeypatch.setattr(chip_smoke, 'POOL_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'POOL_SIZES', (24, 36, 48))
    monkeypatch.setattr(chip_smoke, 'POOL_SIZE', 48)
    monkeypatch.setattr(chip_smoke, 'POOL_RESIZE', 36)
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    ones = dict.fromkeys(chip_smoke.KERNELS, 1)
    monkeypatch.setattr(chip_smoke, 'counters', lambda: dict(ones))
    monkeypatch.setattr(chip_smoke, 'require_paths', lambda *a: None)
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    planned = []
    monkeypatch.setattr(chip_smoke, 'planned_paths',
                        lambda torch, *a: planned.append(a) or [])
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, get_device_name=lambda i: 'cpu',
        memory_allocated=lambda: 0, reset_peak_memory_stats=lambda: None,
        max_memory_allocated=lambda: 2 ** 20))
    got = chip_smoke.phase_pool(fake, 'a CPU', {'float32': 10.0,
                                                'bfloat16': 20.0})
    assert got == dict.fromkeys(chip_smoke.KERNELS, 2)
    result = json.loads((tmp_path / 'pool.json').read_text())
    a = result['float32']
    assert a['grid'] == [36, 48] and a['resize_grid'] == [27, 36]
    assert a['lanes'] == [0, 1, 2, 3]
    assert len(a['session_it_s']) == 4 and a['aggregate_it_s'] == (
        pytest.approx(sum(a['session_it_s'])))
    assert a['control_s'] > 0 and a['resize_s'] > 0
    assert a['resize_iterates'] >= chip_smoke.POOL_RESIZE_ITERATES
    assert a['outputs'] == {'0': [36, 48], '1': [27, 36], '2': [36, 48],
                            '3': [36, 48]}
    b = result['bfloat16 ladder']
    assert b['rungs'] == [[18, 24], [27, 36], [36, 48]]
    assert len(b['sessions']) == chip_smoke.POOL_BROWSERS_B
    for sess in b['sessions']:
        assert [r['hw'] for r in sess['rungs']] == b['rungs']
        assert all(r['iterates'] >= chip_smoke.POOL_LADDER
                   for r in sess['rungs'])
        assert sess['polish_iterates'] >= chip_smoke.POOL_POLISH
        assert sess['polish_migration_s'] > 0
    assert result['batch_aggregate_it_s'] == {'float32': 10.0,
                                              'bfloat16': 20.0}
    # The conv paths are required for every bucket each tier drove, at
    # the tier's lanes.
    assert planned == [('float32', (36, 48), 4), ('float32', (27, 36), 4),
                       ('bfloat16', (18, 24), 4), ('bfloat16', (27, 36), 4),
                       ('bfloat16', (36, 48), 4), ('float32', (36, 48), 4)]
    assert a['resize_device_thread_s'] > 0
    assert all(sess['polish_device_thread_s'] > 0 for sess in b['sessions'])


@pytest.mark.usefixtures('one_thread')
def test_video_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The video phase end to end on the CPU at --size 32 (the pan's frames
    at 32x24): the three video.main() runs and their checks (the primes'
    temporal_loss of exactly 0, the warm starts, the PNGs, the implied
    preprocess and deprocess launches), the CLI's log line, the flicker,
    the small pipelined check, the parity check (the objective at each of
    a CPU run's evaluations, here CPU against CPU) and the CLI's --profile in a
    subprocess (its trace's CPU ops standing in for the kernels), with the
    card-only parts stubbed: the kernel counts, torch.cuda's events, sync
    and memory statistics."""
    import time
    import types

    monkeypatch.setattr(chip_smoke, 'VIDEO_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'VIDEO_SIZE', 32)
    monkeypatch.setattr(chip_smoke, 'VIDEO_FIRST', 12)
    monkeypatch.setattr(chip_smoke, 'VIDEO_ITERATIONS', 6)
    monkeypatch.setattr(chip_smoke, 'VIDEO_PIPE_HW', (24, 32))
    monkeypatch.setattr(chip_smoke, 'VIDEO_PARITY_HW', (24, 32))
    monkeypatch.setattr(chip_smoke, 'VIDEO_PROFILE_SIZE', 32)
    monkeypatch.setattr(chip_smoke, 'VIDEO_PROFILE_CATEGORY', 'cpu_op')
    monkeypatch.setattr(chip_smoke, 'VIDEO_PROFILE_NAMES', {
        'conv': 'aten::conv2d', 'style': 'aten::mm', 'image': 'aten::sub'})
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    frames = chip_smoke.VIDEO_FRAMES
    counts = dict.fromkeys(chip_smoke.KERNELS, 1)
    counts.update(preprocess=2 * frames + 2, deprocess=frames)
    monkeypatch.setattr(chip_smoke, 'replays', lambda: 1)
    monkeypatch.setattr(chip_smoke, 'counters', lambda: dict(counts))

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, memory_allocated=lambda: 0,
        reset_peak_memory_stats=lambda: None, Event=Event,
        max_memory_allocated=lambda: 2 ** 20))
    got = chip_smoke.phase_video(fake, 'a CPU')
    assert got == {name: 3 * n for name, n in counts.items()}
    result = json.loads((tmp_path / 'video.json').read_text())
    for name in ('float32 temporal 1000', 'bfloat16 temporal 1000',
                 'float32 temporal 0'):
        run = result[name]
        assert run['hw'] == [24, 32]
        assert len(run['chained_it_s']) == frames - 1
        assert run['first_frame_s'] > 0 and run['steady_s_per_frame'] > 0
        assert run['flicker'] > 0
        assert max(run['warm_start_ratio']) < chip_smoke.VIDEO_WARM_MAX
        assert len(list((tmp_path / 'video' / (
            '%s_temporal_%g' % (run['precision'], run['temporal'])))
            .iterdir())) == frames
    assert result['pipelined_max_diff'] <= 1e-3
    parity = result['parity']                          # CPU against CPU
    assert parity['evaluations'] == parity['rows'] == frames * (
        chip_smoke.VIDEO_ITERATIONS + 1) + chip_smoke.VIDEO_FIRST - (
            chip_smoke.VIDEO_ITERATIONS)
    assert parity['worst_rel_err'] == 0.0
    assert parity['worst_grad_diff_over_terms'] == 0.0
    assert 0 < parity['least_grad_over_terms'] <= 1
    assert sorted(parity['cpu_moved_by_noise']) == ['1e-06', '1e-07']
    assert parity['trajectory_parts_at_row'] is None
    assert sorted(result['profile_kernels']) == ['conv', 'image', 'style']


def _assert_roofline(fields, ms, precision, hw, remat=False, lanes=1):
    """A phase record's roofline fields: perfmodel.model_step at hw with
    initial_weights.yaml's taps, lanes times, read at ms a step."""
    from style_transfer2_tpu_torch.utils import perfmodel
    model = perfmodel.model_step(hw, precision, remat,
                                 content_layers=('conv4_2',),
                                 style_layers=('conv1_1', 'conv2_1',
                                               'conv3_1', 'conv4_1'))
    model = model.lanes(lanes) if lanes > 1 else model
    assert fields['model_flops'] == model.flops
    assert fields['floor_ms'] == model.t_floor * 1e3
    assert fields['bound_by'] == model.bound
    assert fields['mfu'] == model.mfu_at(ms / 1e3)
    assert fields['share_of_floor'] == model.sol_at(ms / 1e3)


def test_roofline_line_and_its_limit(monkeypatch, capsys):
    """The roofline line holds a row a measured step beside the card's
    name and power limit; a share of the floor above MAX_SHARE fails."""
    monkeypatch.setattr(chip_smoke, 'ROOFLINE', [])
    slow = chip_smoke.roofline('graph one_image float32 graphed',
                               (384, 512), 'float32', 8.3)
    assert round(slow['share_of_floor'], 3) == 0.417
    assert slow['bound_by'] == 'compute'
    line = chip_smoke.phase_roofline('NVIDIA H100 80GB HBM3, 700.00 W')
    assert line['device'] == 'NVIDIA H100 80GB HBM3, 700.00 W'
    assert line['roofline'] == [{
        'path': 'graph one_image float32 graphed', 'hw': [384, 512],
        'precision': 'float32', 'remat': None, 'lanes': 1,
        'floor_ms': slow['floor_ms'], 'ms': 8.3, 'mfu': slow['mfu'],
        'share_of_floor': slow['share_of_floor'], 'bound_by': 'compute'}]
    assert 'graph one_image float32 graphed' in capsys.readouterr().out
    lanes = chip_smoke.roofline('graph lanes4 bfloat16 graphed', (384, 512),
                                'bfloat16', 10.8, lanes=4)
    assert lanes['floor_ms'] == 4 * chip_smoke.step_model(
        (384, 512), 'bfloat16').t_floor * 1e3
    chip_smoke.roofline('too fast', (384, 512), 'float32', 3.0)
    with pytest.raises(RuntimeError, match='too fast'):
        chip_smoke.phase_roofline('a card')


def test_torchvision_state_dict_is_torchvisions_layout():
    """chip_smoke's torchvision state dict: features.N with N counting a
    ReLU after each conv and a pool after each block, as the JAX
    package's index table has it."""
    from style_transfer2_tpu.models.weights import _TORCHVISION_INDEX
    from style_transfer2_tpu_torch.models import random_params
    params = random_params(0)
    state = chip_smoke.torchvision_state_dict(params)
    assert sorted(state) == sorted(
        'features.%d.%s' % (i, k) for i in _TORCHVISION_INDEX.values()
        for k in ('weight', 'bias'))
    w = state['features.%d.weight' % _TORCHVISION_INDEX['conv3_2']]
    assert tuple(w.shape) == (256, 256, 3, 3)
    assert torch.equal(w.permute(2, 3, 1, 0),
                       torch.from_numpy(params['conv3_2']['w']))


@pytest.mark.usefixtures('one_thread')
def test_weights_round_trip_runs_on_the_cpu(monkeypatch, tmp_path):
    """The parity phase's weights round trip at 24x32 on the CPU, with a
    capture backend that replays without a card: the steps from the
    caffemodel's and the torchvision state dict's params equal those from
    random_params(0) bit for bit, and the caffemodel is not left behind;
    a params dict one bit off is caught."""
    monkeypatch.setattr(chip_smoke, 'GRAPH_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'GRAPH_BACKEND', _FakeGraphs)
    monkeypatch.setattr(chip_smoke, 'GRAPH_HW', (24, 32))
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    chip_smoke.weights_round_trip()
    assert list(tmp_path.iterdir()) == []
    from style_transfer2_tpu_torch.models import weights
    real = weights.params_from_torchvision

    def off_by_a_bit(state, caffe_scale=False):
        params = real(state, caffe_scale)
        w = params['conv1_1']['w']
        w.view(np.uint32)[0, 0, 0, 0] ^= 1
        return params

    monkeypatch.setattr(weights, 'params_from_torchvision', off_by_a_bit)
    import style_transfer2_tpu_torch.models as models
    monkeypatch.setattr(models, 'params_from_torchvision', off_by_a_bit)
    with pytest.raises(RuntimeError, match='torchvision'):
        chip_smoke.weights_round_trip()


class _ReplayGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class _FakeGraphs:
    """A capture backend without a card (tests/test_torch_scan.py)."""

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        return _ReplayGraph(fn)

    def reset(self):
        pass


@pytest.mark.usefixtures('one_thread')
def test_graph_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The graph phase end to end on the CPU at 24x32: graphed against
    eager bit for bit in every combination, the timings in turns, the
    memory readings and graph.json, with a capture backend that replays
    without a card and the card-only parts stubbed (node counts,
    torch.cuda's sync and memory statistics)."""
    import types

    from style_transfer2_tpu_torch.engine import graphs

    monkeypatch.setattr(chip_smoke, 'GRAPH_DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'GRAPH_BACKEND', _FakeGraphs)
    monkeypatch.setattr(chip_smoke, 'GRAPH_HW', (24, 32))
    monkeypatch.setattr(chip_smoke, 'GRAPH_CHUNK', 2)
    monkeypatch.setattr(chip_smoke, 'GRAPH_HOST_CHUNK', 1)
    monkeypatch.setattr(chip_smoke, 'GRAPH_ROUNDS', 1)
    monkeypatch.setattr(chip_smoke, 'OUT_DIR', tmp_path)
    monkeypatch.setattr(chip_smoke, 'graph_nodes', lambda *a: None)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, memory_allocated=lambda: 0,
        memory_reserved=lambda: 0, empty_cache=lambda: None,
        reset_peak_memory_stats=lambda: None,
        max_memory_allocated=lambda: 0))
    replays = graphs.replays
    out = chip_smoke.phase_graph(fake, 'a CPU')
    assert graphs.replays > replays
    result = json.loads((tmp_path / 'graph.json').read_text())
    assert result['bitwise'] and result['hw'] == [24, 32]
    assert {c['kind'] for c in result['capture_s']} == {'step', 'prime'}
    for precision in ('float32', 'bfloat16'):
        for kind in ('one_image', 'lanes4'):
            for name in ('eager', 'graphed'):
                run = out[precision][kind][name]
                assert len(run['ms']) == 2 and run['it_s'] > 0
                _assert_roofline(run['roofline'], run['median_ms'],
                                 precision, (24, 32), False,
                                 1 if kind == 'one_image' else 4)


@pytest.mark.usefixtures('one_thread')
def test_shard_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The shard phase's runs end to end on the CPU (4 CPU entries for the
    shards), with a capture backend that replays without a card: float32
    and bfloat16 at 24x32 against unsharded engines, the sharded steps
    replayed, the style phases once a shard a style layer an evaluation,
    the graphed sharded engine against the eager one bit for bit and the
    two timed in turns, the W-fallback at 30x40 (bit for bit too), the
    24x32 stand-in of the 3840px run, the checkpoint resumed bit for bit,
    4 lanes over a 2-way data mesh, the CLI's --mesh 1; the card's memory
    statistics and node counts stubbed."""
    import logging
    import types

    for name, value in (('SHARD_DEVICE', 'cpu'), ('SHARD_SIZE', 32),
                        ('SHARD_ITERATIONS', 4), ('SHARD_CHUNK', 2),
                        ('SHARD_W_SIZE', 40), ('SHARD_W_ITERATIONS', 2),
                        ('SHARD_BATCH_SIZE', 32),
                        ('SHARD_BATCH_ITERATIONS', 2),
                        ('SHARD_CLI_SIZE', 24), ('OUT_DIR', tmp_path),
                        ('SHARD_BACKEND', _FakeGraphs),
                        ('SHARD_HIGHRES_HW', (24, 32)),
                        ('SHARD_HIGHRES_SIZE', 32),
                        ('SHARD_HIGHRES_STEPS', 2), ('GRAPH_CHUNK', 2),
                        ('GRAPH_HOST_CHUNK', 1), ('GRAPH_ROUNDS', 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, 'shard_nodes', lambda *a: None)
    # The plain versions count no launches: the counts each precision's
    # run needs. Of initial_weights.yaml's 4 style layers, conv1_1 and
    # conv2_1 stay sharded at 6 rows a shard (pool2 gathers): in float32 4
    # shards x 2 layers x 5 evaluations (the prime and 4 steps) a phase,
    # the fused branch 2 x 5; in bfloat16 the feed's bf16 phases (4 x 2 +
    # 2) x 5 and no float32 style kernel.
    counts = dict(dict.fromkeys(chip_smoke.KERNELS, 1), style_gram=40,
                  style_grad=40, fused_style_branch=10, style_gram_bf16=0,
                  style_grad_bf16=0, sumsq=0)
    bf16_counts = dict(counts, style_gram=0, style_grad=0,
                       fused_style_branch=0, style_gram_bf16=50,
                       style_grad_bf16=50, sumsq=1)
    engines = []
    real_engine = chip_smoke.shard_engine

    def shard_engine(inputs, precision, *args, **kwargs):
        engines.append(precision)
        return real_engine(inputs, precision, *args, **kwargs)

    monkeypatch.setattr(chip_smoke, 'shard_engine', shard_engine)
    monkeypatch.setattr(chip_smoke, 'shard_launch_counts', lambda: dict(
        bf16_counts if engines[-1] == 'bfloat16' else counts))
    fake = types.SimpleNamespace(
        device=torch.device, cuda=types.SimpleNamespace(
            synchronize=lambda: None, memory_allocated=lambda: 0,
            memory_reserved=lambda: 0, max_memory_reserved=lambda: 2 ** 21,
            reset_peak_memory_stats=lambda: None, empty_cache=lambda: None,
            max_memory_allocated=lambda: 2 ** 20))
    log = chip_smoke.CliLog()
    logger = logging.getLogger('cli')
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        launches, result = chip_smoke.shard_runs(fake, 'a CPU', log)
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    assert launches == counts
    assert json.loads((tmp_path / 'shard.json').read_text()) == result
    assert result['hw'] == [24, 32] and result['n_shards'] == 4
    for precision in ('float32', 'bfloat16'):
        run = result[precision]
        assert run['worst_rel_err'] <= chip_smoke.SHARD_RTOL[precision]
        assert run['losses'][1] < run['losses'][0]
        assert run['halo_bytes_step'] > 0
        # conv1_1 to conv2_2 sharded (pool2 gathers 3-row shards), TV's
        # two rolls; the roofline's count is what a step's exchanges
        # moved.
        itemsize = 4 if precision == 'float32' else 2
        assert run['halo_bytes_step'] == run['model_halo_bytes_step'] == (
            2 * 2 * 3 * (32 * (3 + 64) + 16 * (64 + 128)) * itemsize
            + 2 * 4 * 32 * 3 * 4)
        _assert_roofline(run['unsharded_roofline'],
                         run['unsharded_ms_step'], precision, (24, 32))
        assert run['one_card_roofline']['floor_ms'] > \
            run['unsharded_roofline']['floor_ms']
        graph = run['graph']
        assert graph['bitwise'] and graph['nodes'] is None
        assert {c['kind'] for c in graph['capture_s']} == {'step', 'prime'}
        for name in ('eager', 'graphed'):
            rates = graph['rates'][name]
            assert len(rates['ms']) == 2 and rates['host_share'] > 0
            assert len(rates['host_us_one_step']) == \
                chip_smoke.SHARD_HOST_TRIALS
            assert rates['roofline']['floor_ms'] == \
                run['one_card_roofline']['floor_ms']
    assert result['w_fallback']['hw'] == [30, 40]
    assert result['w_fallback']['bitwise']
    highres = result['highres']
    assert highres['hw'] == [24, 32] and highres['unsharded_ms_step'] is None
    assert highres['replays'] >= 3 and highres['ms_step'] > 0
    assert highres['losses'][1] < highres['losses'][0]
    assert result['checkpoint']['resumed_equal']
    assert result['batch']['worst_rel_err'] <= chip_smoke.PARITY_RTOL
    assert result['cli'] == {'mesh_1': 'ok'}


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('fold', [False, True])
def test_feed_eval_parity_runs_on_the_cpu(monkeypatch, fold):
    """The parity phase's bf16 feed check end to end on the CPU, both
    engines there (so every evaluation agrees exactly), unfolded and
    folded, with the card-only launch counts stubbed; the fold floor is
    restored after."""
    from style_transfer2_tpu_torch.engine import objective
    from style_transfer2_tpu_torch.models import random_params
    counts = dict(dict.fromkeys(chip_smoke.KERNELS, 1),
                  fused_style_branch=0)
    monkeypatch.setattr(chip_smoke, 'counters', lambda: dict(counts))
    rng = np.random.RandomState(0)
    images = tuple(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
                   for _ in range(3))
    weights = {'content': {'conv4_2': 0.08},
               'style': {n: 1.0 for n in ('conv1_1', 'conv2_1')}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    worst = chip_smoke.feed_eval_parity(torch, random_params(0), weights,
                                        scalars, images, fold, 'cpu')
    assert worst[0] == 0.0
    assert objective.STYLE_FOLD_MIN_PIXELS == 500_000
    counts['fused_style_branch'] = 1
    with pytest.raises(RuntimeError, match='float32 style branch'):
        chip_smoke.feed_eval_parity(torch, random_params(0), weights,
                                    scalars, images, fold, 'cpu')
