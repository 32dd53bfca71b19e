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
    sys.modules."""
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
        'style_transfer2_tpu_torch.parallel.batch\n'
        'import style_transfer2_tpu_torch.serve.app, '
        'style_transfer2_tpu_torch.serve.driver, '
        'style_transfer2_tpu_torch.serve.persist, '
        'style_transfer2_tpu_torch.serve.phases, '
        'style_transfer2_tpu_torch.utils.logging\n'
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
    (['--data-mesh', '2'], 'item 7'),
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
    run_steps, hw = profile_step.batched_steps(cli_args)
    assert hw == (18, 24)
    traces = run_steps(2)
    assert sorted(traces) == [0, 1]
    assert [t['fevals'] for t in traces[1]] == [1, 2]
    assert traces[0][0]['loss'] != traces[1][0]['loss']
