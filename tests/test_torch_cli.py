"""The port's CLI on the CPU, and that the port keeps jax out of the
process."""

import csv
import json
import logging
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


@pytest.mark.parametrize('flags', [['--pallas'], ['--platform', 'cpu'],
                                   ['--prewarm-ladder', '--multi-scale',
                                    '--min-scale', '18'],
                                   ['--pallas', '--platform', 'cpu',
                                    '--prewarm-ladder']])
def test_cli_accepts_and_ignores_jax_only_flags(tmp_path, caplog, flags):
    """A JAX command line runs on the port: --pallas, --platform and
    --prewarm-ladder are parsed, logged as ignored, and change nothing in
    the run (the trace is the run's without them)."""
    traces = []
    for extra in (flags, [f for f in flags if f in ('--multi-scale',
                                                    '--min-scale', '18')]):
        trace = tmp_path / ('trace%d.csv' % len(traces))
        caplog.clear()
        with caplog.at_level(logging.INFO, logger='cli'):
            assert cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'o.png'),
                             '--device', 'cpu', '--size', '32',
                             '--iterations', '2', '--trace-csv', str(trace)]
                            + extra) == 0
        ignored = [r.getMessage() for r in caplog.records
                   if 'ignored' in r.getMessage()]
        with open(trace, newline='') as f:
            traces.append([{k: v for k, v in r.items() if k != 'time'}
                           for r in csv.DictReader(f)])
        if extra is flags:
            named = [f for f in flags if f.startswith('--')
                     and f not in ('--multi-scale', '--min-scale')]
            assert len(ignored) == 1
            assert all(f in ignored[0] for f in named)
        else:
            assert not ignored
    assert traces[0] == traces[1]


@pytest.mark.parametrize('argv,want', [([], False), (['--remat'], 'conv'),
                                       (['--remat', 'conv'], 'conv'),
                                       (['--remat', 'block'], 'block')])
def test_cli_remat_parses_as_the_jax_cli(argv, want):
    from style_transfer2_tpu.cli import parse_args as jax_parse_args
    assert cli.parse_args(['c.jpg', 's.jpg'] + argv).remat == want
    assert jax_parse_args(['c.jpg', 's.jpg'] + argv).remat == want


def test_cli_remat_refuses_an_unknown_policy(capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(['c.jpg', 's.jpg', '--remat', 'all'])
    assert 'invalid choice' in capsys.readouterr().err


def _trace_rows(path):
    with open(path, newline='') as f:
        return [{k: v for k, v in r.items() if k != 'time'}
                for r in csv.DictReader(f)]


def test_cli_remat_block_trace_equals_plain_and_tracks_jax(tmp_path):
    """A 32px --remat block run writes the plain run's trace bit for bit,
    and the JAX CLI's --remat block trace within the golden rtol 5e-3."""
    argv = [CONTENT, STYLE, '--size', '32', '--iterations', '3',
            '--model-weights', 'random', '--steps-per-dispatch', '2']
    traces = {}
    for name, extra in (('plain', []), ('block', ['--remat', 'block'])):
        trace = tmp_path / (name + '.csv')
        assert cli.main(argv + ['-o', str(tmp_path / (name + '.png')),
                                '--device', 'cpu', '--trace-csv',
                                str(trace)] + extra) == 0
        traces[name] = _trace_rows(trace)
    assert len(traces['plain']) == 4
    assert traces['block'] == traces['plain']
    from style_transfer2_tpu.cli import main as jax_main
    trace = tmp_path / 'jax.csv'
    assert jax_main(argv + ['-o', str(tmp_path / 'jax.png'), '--platform',
                            'cpu', '--trace-csv', str(trace), '--remat',
                            'block']) == 0
    want = _trace_rows(trace)
    assert len(want) == len(traces['block'])
    for got, ref in zip(traces['block'], want):
        assert list(got) == list(ref)
        for key, value in ref.items():
            if value == '':
                assert got[key] == value, key
            elif key in ('step', 'fevals'):
                assert float(got[key]) == float(value), key
            else:
                np.testing.assert_allclose(float(got[key]), float(value),
                                           rtol=5e-3, err_msg=key)


def test_cli_remat_reaches_the_main_and_the_polish_engine(tmp_path,
                                                          monkeypatch):
    from style_transfer2_tpu_torch.engine import transfer
    made = []
    init = transfer.StyleTransfer.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        made.append((self.precision, self.remat, self.model.remat))

    monkeypatch.setattr(transfer.StyleTransfer, '__init__', spy)
    assert cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'o.png'),
                     '--device', 'cpu', '--size', '24', '--iterations', '1',
                     '--precision', 'float32_fast', '--polish', '1',
                     '--remat']) == 0
    assert made == [('float32_fast', 'conv', 'conv'),
                    ('float32', 'conv', 'conv')]


@pytest.mark.usefixtures('one_thread')
def test_cli_batch_logs_remat_once_and_ignores_it(tmp_path, caplog):
    """The JAX CLI's batch mode never reads --remat; the port's logs that
    it ignores it, once, and builds its batched engine as without it."""
    indir, style = _batch_dir(tmp_path, 4, {'a': (40, 60)})
    with caplog.at_level(logging.INFO, logger='cli'):
        assert cli.main([str(indir), str(style), '--batch', '-o',
                         str(tmp_path / 'out'), '--size', '24',
                         '--iterations', '1', '--lanes', '1', '--device',
                         'cpu', '--model-weights', 'random', '--remat',
                         'block']) == 0
    hits = [r.getMessage() for r in caplog.records
            if '--remat' in r.getMessage()]
    assert len(hits) == 1 and 'ignored' in hits[0]
    assert (tmp_path / 'out' / 'a_styled.png').exists()


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'x.png'),
                  '--size', '32', '--iterations', '1'])
    assert not (tmp_path / 'x.png').exists()


def test_port_imports_no_jax(tmp_path):
    """A fresh interpreter that imports the whole port, its serving tier
    included, and runs its CLI has neither jax nor the JAX package in
    sys.modules. The CLI runs sharded (--mesh 2), so the parallel
    modules' whole path is covered."""
    code = (
        'import json, sys\n'
        'import style_transfer2_tpu_torch.cli as cli\n'
        'import style_transfer2_tpu_torch.engine, '
        'style_transfer2_tpu_torch.ops, style_transfer2_tpu_torch.optim\n'
        'import style_transfer2_tpu_torch.engine.checkpoint, '
        'style_transfer2_tpu_torch.ops.resample, '
        'style_transfer2_tpu_torch.ops.image\n'
        'import style_transfer2_tpu_torch.engine.batched, '
        'style_transfer2_tpu_torch.parallel, '
        'style_transfer2_tpu_torch.parallel.batch, '
        'style_transfer2_tpu_torch.parallel.mesh, '
        'style_transfer2_tpu_torch.parallel.spatial\n'
        'import style_transfer2_tpu_torch.serve.app, '
        'style_transfer2_tpu_torch.serve.driver, '
        'style_transfer2_tpu_torch.serve.persist, '
        'style_transfer2_tpu_torch.serve.phases, '
        'style_transfer2_tpu_torch.utils.logging\n'
        'import style_transfer2_tpu_torch.video, '
        'style_transfer2_tpu_torch.utils.profiling\n'
        'cli.main(sys.argv[1:])\n'
        'print(json.dumps(sorted(m for m in sys.modules\n'
        '    if m.split(".")[0] in\n'
        '    ("jax", "jaxlib", "style_transfer2_tpu"))))\n')
    proc = subprocess.run(
        [sys.executable, '-c', code, CONTENT, STYLE, '-o',
         str(tmp_path / 'o.png'), '--device', 'cpu', '--size', '24',
         '--iterations', '1', '--mesh', '2'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_cli_profile_writes_a_trace(tmp_path, caplog):
    """--profile on the CPU: one Chrome trace of the run in the directory,
    holding the host's ops (the plain conv among them), and its path
    logged."""
    out, prof = tmp_path / 'out.png', tmp_path / 'prof'
    with caplog.at_level(logging.INFO, logger='cli'):
        assert cli.main([CONTENT, STYLE, '-o', str(out), '--device', 'cpu',
                         '--size', '24', '--iterations', '2',
                         '--profile', str(prof)]) == 0
    assert out.exists()
    [trace] = list(prof.iterdir())
    assert trace.name.endswith('.pt.trace.json')
    names = {e.get('name') for e in json.loads(trace.read_text())
             ['traceEvents']}
    assert 'aten::conv2d' in names
    assert any(r.getMessage() == 'profiler trace written to %s' % trace
               for r in caplog.records)


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


@pytest.fixture
def one_thread():
    """One intra-op thread: these shapes are tiny, and where the test runner
    runs several workers at once, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_dir(tmp_path, seed, sizes):
    """A directory of random images named by `sizes` {name: (h, w)} and a
    44x44 style image."""
    rng = np.random.RandomState(seed)
    indir = tmp_path / 'in'
    indir.mkdir()
    for name, size in sizes.items():
        Image.fromarray(rng.randint(0, 256, size + (3,))
                        .astype(np.uint8)).save(indir / (name + '.png'))
    style = tmp_path / 'style.png'
    Image.fromarray(rng.randint(0, 256, (44, 44, 3))
                    .astype(np.uint8)).save(style)
    return indir, style


@pytest.mark.usefixtures('one_thread')
def test_cli_batch_mode(tmp_path):
    """--batch styles a directory as lanes of one batched step: images
    group by fitted grid (no distortion), waves bounded by --lanes, one
    output per input (tests/test_cli.py, less its --data-mesh)."""
    indir, style = _batch_dir(tmp_path, 1, {'a': (40, 60), 'b': (40, 60),
                                            'c': (50, 50)})
    outdir = tmp_path / 'out'
    assert cli.main([str(indir), str(style), '--batch', '-o', str(outdir),
                     '--size', '32', '--iterations', '4', '--lanes', '2',
                     '--optimizer', 'adam', '--model-weights', 'random',
                     '--device', 'cpu', '--steps-per-dispatch', '2']) == 0
    outs = sorted(p.name for p in outdir.iterdir())
    assert outs == ['a_styled.png', 'b_styled.png', 'c_styled.png']
    a = Image.open(outdir / 'a_styled.png')
    c = Image.open(outdir / 'c_styled.png')
    assert (a.size[1], a.size[0]) == (21, 32)   # 40x60 fit into 32
    assert (c.size[1], c.size[0]) == (32, 32)
    # Distinct contents gave distinct stylizations (no lane mixing).
    arr_a = np.asarray(a, np.float32)
    arr_b = np.asarray(Image.open(outdir / 'b_styled.png'), np.float32)
    assert np.abs(arr_a - arr_b).mean() > 1.0


@pytest.mark.usefixtures('one_thread')
def test_cli_batch_skip_existing(tmp_path):
    """--skip-existing restarts an interrupted batch at the first missing
    output: whole PNGs are left untouched, a truncated one is redone."""
    indir, style = _batch_dir(tmp_path, 5, {n: (40, 60) for n in 'abcd'})
    outdir = tmp_path / 'out'
    args = [str(indir), str(style), '--batch', '-o', str(outdir),
            '--size', '32', '--iterations', '4', '--lanes', '2',
            '--optimizer', 'adam', '--model-weights', 'random',
            '--device', 'cpu', '--steps-per-dispatch', '2']

    assert cli.main(args) == 0
    assert len(list(outdir.iterdir())) == 4
    (outdir / 'b_styled.png').unlink()
    (outdir / 'c_styled.png').unlink()
    whole = (outdir / 'd_styled.png').read_bytes()
    (outdir / 'd_styled.png').write_bytes(whole[:len(whole) // 2])
    mtime_a = (outdir / 'a_styled.png').stat().st_mtime_ns
    assert cli.main(args + ['--skip-existing']) == 0
    assert sorted(p.name for p in outdir.iterdir()) == [
        'a_styled.png', 'b_styled.png', 'c_styled.png', 'd_styled.png']
    assert (outdir / 'a_styled.png').stat().st_mtime_ns == mtime_a
    with Image.open(outdir / 'd_styled.png') as img:
        img.verify()
    # Everything present: no-op.
    mtimes = {p.name: p.stat().st_mtime_ns for p in outdir.iterdir()}
    assert cli.main(args + ['--skip-existing']) == 0
    assert {p.name: p.stat().st_mtime_ns
            for p in outdir.iterdir()} == mtimes


@pytest.mark.usefixtures('one_thread')
def test_cli_batch_pipelined_matches_sync(tmp_path):
    """--batch with --pipeline-depth N keeps several chunks in flight per
    wave; the chunk plan is fixed up front, so every output image is
    bit-identical to the synchronous depth-1 run."""
    indir, style = _batch_dir(tmp_path, 7, {'a': (40, 60), 'b': (40, 60)})
    outs = []
    for depth in ('1', '3'):
        outdir = tmp_path / ('out_d' + depth)
        assert cli.main([str(indir), str(style), '--batch', '-o',
                         str(outdir), '--size', '32', '--iterations', '7',
                         '--lanes', '2', '--optimizer', 'lbfgs',
                         '--model-weights', 'random', '--device', 'cpu',
                         '--steps-per-dispatch', '2',
                         '--pipeline-depth', depth]) == 0
        outs.append({p.name: np.asarray(Image.open(p))
                     for p in outdir.iterdir()})
    sync, piped = outs
    assert sorted(sync) == ['a_styled.png', 'b_styled.png'] == sorted(piped)
    for name in sync:
        np.testing.assert_array_equal(sync[name], piped[name], name)


class _LossLog(logging.Handler):
    """Each styled image's final loss, from the CLI's '-> (loss ...)'
    line (the JAX CLI logs the last loss, the port's first and last)."""

    def __init__(self):
        super().__init__()
        self.losses = {}

    def emit(self, record):
        if record.msg.startswith('%s -> %s (loss'):
            self.losses[record.args[0]] = float(record.args[-1])


@pytest.mark.usefixtures('one_thread')
def test_cli_batch_beside_jax_cli(tmp_path):
    """The JAX CLI's --batch and the port's on the same directory, random
    weights, 32px, a wave of two and a wave of one: the same output files,
    images as close as the golden atol 0.75 allows after rounding, final
    losses within rtol 5e-3."""
    from style_transfer2_tpu.cli import main as jax_main
    indir, style = _batch_dir(tmp_path, 3, {'a': (40, 60), 'b': (40, 60),
                                            'c': (40, 60)})
    losses = {}
    images = {}
    for name, run, extra in (('jax', jax_main, ['--platform', 'cpu']),
                             ('torch', cli.main, ['--device', 'cpu'])):
        outdir = tmp_path / name
        log = _LossLog()
        logger = logging.getLogger('cli')
        level = logger.level
        logger.addHandler(log)
        logger.setLevel(logging.INFO)
        try:
            assert run([str(indir), str(style), '--batch', '-o', str(outdir),
                        '--size', '32', '--iterations', '4', '--lanes', '2',
                        '--optimizer', 'lbfgs', '--model-weights', 'random',
                        '--steps-per-dispatch', '2'] + extra) == 0
        finally:
            logger.removeHandler(log)
            logger.setLevel(level)
        losses[name] = log.losses
        images[name] = {p.name: np.asarray(Image.open(p), np.float32)
                        for p in outdir.iterdir()}
    assert sorted(images['torch']) == sorted(images['jax']) == [
        'a_styled.png', 'b_styled.png', 'c_styled.png']
    # The PNGs hold the images rounded to uint8: two float images within
    # the golden atol 0.75 round to pixels at most one step apart. Few do
    # differ: a mean of 0.026 measured on the CPU, bounded at 0.1.
    for name, img in images['jax'].items():
        np.testing.assert_allclose(images['torch'][name], img, atol=1.0,
                                   err_msg=name)
        assert np.abs(images['torch'][name] - img).mean() <= 0.1, name
    assert sorted(losses['torch']) == sorted(losses['jax']) == [
        'a.png', 'b.png', 'c.png']
    for name, loss in losses['jax'].items():
        np.testing.assert_allclose(losses['torch'][name], loss, rtol=5e-3,
                                   err_msg=name)


@pytest.mark.parametrize('flag,match', [
    (['--data-mesh', '2', '--lanes', '3'],
     r'--lanes \(3\) must divide by the data mesh \(2 devices\)'),
    (['--multi-scale'], 'multi-scale'),
    (['--mesh', '2'], 'mesh')])
def test_cli_batch_refuses_what_it_does_not_combine_with(tmp_path, flag,
                                                         match):
    indir, style = _batch_dir(tmp_path, 2, {'a': (40, 60)})
    with pytest.raises(SystemExit, match=match):
        cli.main([str(indir), str(style), '--batch', '-o',
                  str(tmp_path / 'out'), '--size', '32', '--iterations',
                  '1', '--device', 'cpu', '--model-weights', 'random']
                 + flag)
    assert not (tmp_path / 'out').exists()


def test_cli_batch_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    indir, style = _batch_dir(tmp_path, 2, {'a': (40, 60)})
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main([str(indir), str(style), '--batch', '-o',
                  str(tmp_path / 'out'), '--size', '32', '--iterations',
                  '1', '--model-weights', 'random'])


@pytest.mark.usefixtures('one_thread')
def test_profile_step_builds_the_batched_engine():
    """profile_step --batch steps a BatchedStyleTransfer of --lanes jobs
    (its engine built here on the CPU; the profile itself needs CUDA)."""
    from style_transfer2_tpu_torch import profile_step
    args, cli_args = profile_step.parse_args([
        '--batch', '--lanes', '2', '--device', 'cpu', '--size', '24',
        '--model-weights', 'random', '--steps', '2'])
    assert args.steps == 2 and cli_args.batch and cli_args.lanes == 2
    run_steps, hw, spec = profile_step.batched_steps(cli_args)
    assert hw == (18, 24)
    assert spec.style_layers == ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1')
    traces = run_steps(2)
    assert sorted(traces) == [0, 1]
    assert [t['fevals'] for t in traces[1]] == [1, 2]
    assert traces[0][0]['loss'] != traces[1][0]['loss']
    # The roofline of a 2-lane step: twice one image's counts.
    from style_transfer2_tpu_torch.utils import perfmodel
    one = perfmodel.model_step(hw, 'float32', content_layers=('conv4_2',),
                               style_layers=spec.style_layers)
    got = profile_step.roofline(cli_args, hw, spec, 5.0)
    assert got['model_flops'] == 2 * one.flops
    assert got['floor_ms'] == 2 * one.t_floor * 1e3
    assert got['bound_by'] == one.bound
    np.testing.assert_allclose(got['mfu'], 2 * one.flops / 67e12 / 5e-3,
                               rtol=1e-12)
    np.testing.assert_allclose(got['share_of_floor'],
                               2 * one.t_floor / 5e-3, rtol=1e-12)


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('extra,remat', [([], False),
                                         (['--remat', 'block'], 'block')])
def test_profile_step_reads_the_single_engine_against_its_floor(extra,
                                                                remat):
    """profile_step's single-image engine (built here on the CPU) and its
    roofline fields: the engine's taps, grid, precision and remat."""
    from style_transfer2_tpu_torch import profile_step
    from style_transfer2_tpu_torch.utils import perfmodel
    args, cli_args = profile_step.parse_args([
        '--device', 'cpu', '--size', '24', '--model-weights', 'random',
        '--precision', 'bfloat16'] + extra)
    run_steps, hw, spec = profile_step.single_steps(cli_args)
    assert hw == (18, 24) and spec.content_layers == ('conv4_2',)
    run_steps(1)
    want = perfmodel.model_step(hw, 'bfloat16', remat,
                                content_layers=spec.content_layers,
                                style_layers=spec.style_layers)
    got = profile_step.roofline(cli_args, hw, spec, 2.0)
    assert got == {'model_flops': want.flops,
                   'floor_ms': want.t_floor * 1e3, 'bound_by': want.bound,
                   'mfu': want.mfu_at(2e-3),
                   'share_of_floor': want.sol_at(2e-3)}


@pytest.mark.usefixtures('one_thread')
def test_cli_batch_data_mesh_splits_the_lanes(tmp_path, caplog):
    """--batch --data-mesh 2 on the CPU: 4 lanes over 2 device groups (two
    CPU entries), the styled images those of the unsplit batch."""
    indir, style = _batch_dir(tmp_path, 5, {'a': (40, 60), 'b': (40, 60),
                                            'c': (40, 60)})
    images = {}
    for name, extra in (('split', ['--data-mesh', '2']), ('one', [])):
        outdir = tmp_path / name
        with caplog.at_level(logging.INFO, logger='cli'):
            assert cli.main([str(indir), str(style), '--batch', '-o',
                             str(outdir), '--size', '24', '--iterations',
                             '3', '--lanes', '4', '--device', 'cpu',
                             '--model-weights', 'random'] + extra) == 0
        images[name] = {p.name: np.asarray(Image.open(p), np.float32)
                        for p in outdir.iterdir()}
    assert any('lane axis sharded over 2 devices' in r.getMessage()
               for r in caplog.records)
    assert sorted(images['split']) == sorted(images['one']) == [
        'a_styled.png', 'b_styled.png', 'c_styled.png']
    for name, img in images['one'].items():
        np.testing.assert_allclose(images['split'][name], img, atol=1.0,
                                   err_msg=name)


def _cli_trace(tmp_path, name, extra):
    trace = tmp_path / (name + '.csv')
    assert cli.main([CONTENT, STYLE, '-o', str(tmp_path / (name + '.png')),
                     '--device', 'cpu', '--size', '34', '--iterations', '3',
                     '--trace-csv', str(trace), '--model-weights',
                     'random'] + extra) == 0
    with open(trace, newline='') as f:
        return [{k: v for k, v in r.items() if k != 'time'}
                for r in csv.DictReader(f)]


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('ladder', [[], ['--multi-scale', '--min-scale',
                                         '18']],
                         ids=['single_scale', 'ladder'])
def test_cli_mesh_matches_the_unsharded_cli(tmp_path, ladder):
    """--mesh 2 --device cpu, at one scale (26x34) and up the ladder
    (18x24, 26x34: rungs that divide by 2, so nothing snaps): the trace
    of every step, the L-BFGS primes included, matches the unsharded
    CLI's (tests/test_parallel.py's rtol 5e-4, atol 1e-6)."""
    got = _cli_trace(tmp_path, 'mesh', ladder + ['--mesh', '2'])
    want = _cli_trace(tmp_path, 'one', ladder)
    assert len(got) == len(want) == (4 if not ladder else 8)
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w)
        for key in w:
            if key in ('step', 'fevals') or w[key] == '':
                assert g[key] == w[key]
                continue
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=5e-4, atol=1e-6,
                                       err_msg='row %d %s' % (i, key))


@pytest.mark.usefixtures('one_thread')
def test_cli_mesh_snaps_every_rung(tmp_path, caplog):
    """--mesh 2 up a ladder whose first rung is 21x28: it snaps to 22x28
    (logged), and the run ends on the 30x40 target."""
    with caplog.at_level(logging.INFO, logger='cli'):
        assert cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'o.png'),
                         '--device', 'cpu', '--size', '40', '--iterations',
                         '2', '--multi-scale', '--min-scale', '24',
                         '--model-weights', 'random', '--mesh', '2']) == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert 'snapped 21x28 -> 22x28 for the 2-way mesh' in msgs
    assert any(m.startswith('scale 22x28:') for m in msgs)
    with Image.open(tmp_path / 'o.png') as img:
        assert img.size == (40, 30)


def test_cli_mesh_over_too_many_devices_exits(tmp_path, monkeypatch):
    """A mesh of more devices than there are exits with make_mesh's
    message, before anything is loaded (one device available here)."""
    from style_transfer2_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, 'available_devices',
                        lambda device, n: [torch.device('cpu')])
    with pytest.raises(SystemExit, match="Mesh '2' needs 2 devices, "
                                         "have 1"):
        cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'x.png'),
                  '--device', 'cpu', '--size', '32', '--iterations', '1',
                  '--mesh', '2'])
    assert not (tmp_path / 'x.png').exists()


def test_cli_mesh_on_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main([CONTENT, STYLE, '-o', str(tmp_path / 'x.png'),
                  '--size', '32', '--iterations', '1', '--mesh', '2'])
