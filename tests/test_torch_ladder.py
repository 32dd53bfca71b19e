"""The coarse-to-fine path of the port on the CPU, against the JAX package:
resize_nhwc, the optimizers' resample, the StyleTransfer ladder (warm-started
resample_input, set_content and resample_content), the K-step chunks
(begin_steps/collect_steps), checkpoint/resume, and the CLI's --multi-scale,
--resume and --polish runs against the JAX CLI's. Inputs are made from
numpy seeds; every case is at most 64px."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import ResizeMethod, _kernels, compute_weight_mat
from PIL import Image

from style_transfer2_tpu.cli import main as jax_cli_main
from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.ops.resample import resize_nhwc as jresize_nhwc
from style_transfer2_tpu.optim import adam as jadam
from style_transfer2_tpu.optim import lbfgs as jlbfgs
from style_transfer2_tpu_torch import cli
from style_transfer2_tpu_torch.engine import (StyleTransfer, load_checkpoint,
                                              save_checkpoint)
from style_transfer2_tpu_torch.ops.resample import resize_nhwc, weight_matrix
from style_transfer2_tpu_torch.optim import adam, lbfgs

RTOL = 5e-3                 # tests/test_golden.py's trace tolerance
# The bf16 CLI run's loss against the JAX CLI's over 8 main and 16 polish
# rows: measured at most 0.124 (main row 6) and 0.112 (polish row 2).
BF16_LOSS_RTOL = 0.2
LADDER = [(18, 24), (25, 34), (36, 48)]
WEIGHTS = {
    'content': {'conv3_2': 0.08},
    'style': {'conv1_1': 1.0, 'conv2_1': 1.0, 'conv3_1': 1.0},
    'deepdream': {'conv2_2': 0.3},
}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
STEP_SIZES = {'adam': 10.0, 'lbfgs': 1.0}
RESIZES = [((17, 23), (24, 33)), ((24, 33), (17, 23)), ((17, 23), (17, 23)),
           ((24, 33), (31, 20))]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _without_time(trace):
    return {k: v for k, v in trace.items() if k != 'time'}


def _assert_traces_close(got, want, where, rtol=RTOL):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _without_time(g), _without_time(w)
        assert list(g) == list(w), '%s row %d' % (where, i)
        for key, value in w.items():
            if key == 'fevals':
                assert g[key] == value, '%s row %d' % (where, i)
            else:
                np.testing.assert_allclose(
                    g[key], value, rtol=rtol,
                    err_msg='%s row %d: %s' % (where, i, key))


# -- ops/resample -------------------------------------------------------------

@pytest.mark.parametrize('method', ['lanczos3', 'bilinear'])
@pytest.mark.parametrize('src,dst', RESIZES)
def test_resize_matches_jax(src, dst, method):
    x = np.float32(np.random.RandomState(0).uniform(0, 255,
                                                    (1,) + src + (3,)))
    got = resize_nhwc(_t(x), dst, method).numpy()
    want = np.asarray(jresize_nhwc(jnp.asarray(x), dst, method))
    assert got.shape == want.shape == (1,) + dst + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    if src == dst:
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize('method', ['lanczos3', 'bilinear'])
@pytest.mark.parametrize('n_in,n_out', [(17, 24), (24, 17), (181, 256),
                                        (5, 40)])
def test_weight_matrix_matches_jax(n_in, n_out, method):
    kernel = _kernels[ResizeMethod.from_string(method)]
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         kernel, True)).T
    got = weight_matrix(n_in, n_out, method).numpy()
    assert got.shape == (n_out, n_in)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- optim resample -------------------------------------------------------------

@pytest.mark.parametrize('hist', [None, 'bfloat16'])
def test_lbfgs_resample_matches_jax(hist):
    x = np.float32(np.random.RandomState(1).uniform(-120, 130,
                                                    (1, 17, 23, 3)))
    state = lbfgs.init(_t(x), 4, history_dtype=(None if hist is None
                                                 else torch.bfloat16))
    jstate = jlbfgs.init(jnp.asarray(x), 4, history_dtype=(
        None if hist is None else jnp.bfloat16))
    new = lbfgs.resample(state, (24, 33))
    jnew = jlbfgs.resample(jstate, (24, 33))
    np.testing.assert_allclose(new['x'].numpy(), np.asarray(jnew['x']),
                               rtol=1e-5, atol=1e-3)
    assert new['sk'].shape == tuple(jnew['sk'].shape) == (4, 1, 24, 33, 3)
    assert str(new['sk'].dtype).split('.')[-1] == str(jnew['sk'].dtype)
    assert int(new['count']) == int(jnew['count']) == 0


def test_adam_resample_matches_jax():
    rng = np.random.RandomState(2)
    x, g1 = (np.float32(rng.uniform(-120, 130, (1, 24, 33, 3)))
             for _ in range(2))
    g2 = np.float32(rng.uniform(0, 50, (1, 24, 33, 3)))
    state = dict(adam.init(_t(x)), g1_mean=_t(g1), g2_mean=_t(g2),
                 g1_items=3, g2_items=7, t=3)
    jstate = dict(jadam.init(jnp.asarray(x)), g1_mean=jnp.asarray(g1),
                  g2_mean=jnp.asarray(g2), g1_items=jnp.int32(3),
                  g2_items=jnp.int32(7), t=jnp.int32(3))
    for hw, new_x in (((17, 23), None), (None, np.float32(x[:, :17, :23]))):
        new = adam.resample(state, hw, None if new_x is None else _t(new_x))
        jnew = jadam.resample(jstate, hw, None if new_x is None
                              else jnp.asarray(new_x))
        for key in ('x', 'g1_mean', 'g2_mean'):
            np.testing.assert_allclose(new[key].numpy(),
                                       np.asarray(jnew[key]), rtol=1e-5,
                                       atol=1e-3, err_msg=key)
        assert float(new['g2_mean'].min()) >= 0.0
        for key in ('g1_items', 'g2_items', 't'):
            assert new[key] == int(jnew[key]), key


# -- the engine up the ladder -----------------------------------------------------

def _ladder_images(seed):
    rng = np.random.RandomState(seed)
    contents = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
                for hw in LADDER]
    style = rng.randint(0, 256, (30, 30, 3)).astype(np.uint8)
    init = rng.randint(0, 256, LADDER[0] + (3,)).astype(np.uint8)
    return contents, style, init


def _start(engine, optimizer, images):
    contents, style, init = images
    engine.set_weights(WEIGHTS, SCALARS)
    engine.set_optimizer(optimizer)
    engine.set_step_size(STEP_SIZES[optimizer])
    engine.set_content(contents[0])
    engine.set_style(style)
    engine.set_input(init)
    assert engine.start()
    return engine


def _climb(engine, contents, steps, rungs=(1, 2)):
    """Rung 2 warm-starts with resample_input + set_content, rung 3 with
    resample_input + resample_content; `steps` iterations on each."""
    for rung in rungs:
        engine.resample_input(LADDER[rung])
        if rung == 1:
            engine.set_content(contents[rung])
        else:
            engine.resample_content(LADDER[rung])
        assert engine.start()
        for _ in range(steps):
            engine.step(fetch_image=False)


@pytest.mark.parametrize('optimizer', ['lbfgs', 'adam'])
def test_golden_ladder_matches_jax(optimizer):
    images = _ladder_images(3)
    params = random_params(7)
    st = _start(StyleTransfer(params, device='cpu'), optimizer, images)
    jst = _start(JaxStyleTransfer(params), optimizer, images)
    for engine in (st, jst):
        for _ in range(3):
            engine.step(fetch_image=False)
        _climb(engine, images[0], 3)
    assert st.input_hw == jst.input_hw == LADDER[-1]
    assert st.t == jst.t == 9
    _assert_traces_close([t.data for t in st.traces],
                         [t.data for t in jst.traces], optimizer)
    np.testing.assert_allclose(st.snapshot(), np.asarray(jst.snapshot()),
                               rtol=1e-2, atol=0.75)


def test_chunks_in_flight_match_single_steps():
    """Chunks of 4 kept two deep give the trace history of one step at a
    time, exactly, with each chunk's image its own end iterate and the
    prime trace first."""
    images = _ladder_images(4)
    params = random_params(3)
    single = _start(StyleTransfer(params, device='cpu'), 'lbfgs', images)
    snapshots = {}
    for t in range(1, 11):
        single.step(fetch_image=False)
        snapshots[t] = single.snapshot()

    chunked = _start(StyleTransfer(params, device='cpu'), 'lbfgs', images)
    handles = cli.dispatch_chunks(chunked, 10, 4, 2)
    first = next(handles)
    # Depth 2: the second chunk is already enqueued.
    assert chunked.t == 8 and first.t_end == 4
    ends = []
    for handle in [first] + list(handles):
        image, traces = chunked.collect_steps(handle)
        assert [t.data['fevals'] for t in traces] == list(
            range(handle.t_end - handle.n_steps + 1, handle.t_end + 1))
        np.testing.assert_array_equal(image, snapshots[handle.t_end])
        ends.append(handle.t_end)
    assert ends == [4, 8, 10]
    assert 'fevals' not in chunked.traces[0].data
    assert len(chunked.traces) == len(single.traces) == 11
    for got, want in zip(chunked.traces, single.traces):
        assert _without_time(got.data) == _without_time(want.data)
    np.testing.assert_array_equal(chunked.snapshot(), single.snapshot())


def test_set_input_preprocessed_pause_and_empty_resamples():
    images = _ladder_images(6)
    params = random_params(4)
    plain = _start(StyleTransfer(params, device='cpu'), 'lbfgs', images)
    pre = _start(StyleTransfer(params, device='cpu'), 'lbfgs', images)
    # The polish hand-off: a float32 snapshot back through preprocess is
    # the iterate itself, as a preprocessed tensor is.
    plain.set_input(plain.snapshot())
    pre.set_input(pre._input.clone(), preprocessed=True)
    torch.testing.assert_close(pre._input, plain._input, rtol=0, atol=1e-4)
    got, want = pre.run_steps(2)[1], plain.run_steps(2)[1]
    np.testing.assert_allclose(
        [v for k, v in got.items() if k != 'time'],
        [v for k, v in want.items() if k != 'time'], rtol=1e-5)
    pre.pause()
    assert not pre.is_running and not pre.is_starting

    empty = StyleTransfer(params, device='cpu')
    empty.resample_input((5, 7))
    empty.resample_content((5, 7))
    assert empty.input_hw == (5, 7) and empty.content.shape == (1, 5, 7, 3)
    assert float(empty._input.abs().sum()) == 0.0


@pytest.mark.parametrize('optimizer', ['lbfgs', 'adam'])
def test_checkpoint_resume_mid_ladder(tmp_path, optimizer):
    """Save mid-rung, load into a fresh engine, go on up the ladder: the
    same traces as the run that never stopped."""
    images = _ladder_images(5)
    params = random_params(2)
    whole = _start(StyleTransfer(params, device='cpu'), optimizer, images)
    whole.run_steps(3)
    save_checkpoint(whole, tmp_path / 'ck')
    saved_rows = len(whole.traces)

    resumed = StyleTransfer(params, device='cpu')
    load_checkpoint(resumed, tmp_path / 'ck')
    assert resumed.t == 3 and resumed.input_hw == LADDER[0]
    assert resumed.optimizer_name == optimizer
    assert resumed.start()
    for engine in (whole, resumed):
        engine.run_steps(2)
        _climb(engine, images[0], 2)
    assert resumed.t == whole.t == 9
    tail = [t.data for t in whole.traces[saved_rows:]]
    assert [_without_time(t.data) for t in resumed.traces] == [
        _without_time(t) for t in tail]
    np.testing.assert_array_equal(resumed.snapshot(), whole.snapshot())


# -- the CLI beside the JAX CLI ---------------------------------------------------

def _write_images(tmp_path):
    rng = np.random.RandomState(0)
    content = tmp_path / 'content.png'
    style = tmp_path / 'style.png'
    Image.fromarray(rng.randint(0, 256, (40, 52, 3)).astype(np.uint8)).save(
        content)
    Image.fromarray(rng.randint(0, 256, (44, 44, 3)).astype(np.uint8)).save(
        style)
    return str(content), str(style)


def _read_csv(path):
    with open(path, newline='') as f:
        rows = list(csv.DictReader(f))
    return [{k: (None if v == '' else float(v)) for k, v in row.items()
             if k != 'step'} for row in rows]


def _both_clis(tmp_path, tag, args):
    """Runs the JAX CLI and the port's CLI on the same arguments, each in
    <tmp>/<jax or port>/<tag> ('{run}' in an argument stands for
    <tmp>/<jax or port>); returns {'jax': dir, 'port': dir} holding out.png
    and trace.csv."""
    content, style = _write_images(tmp_path)
    dirs = {}
    for name, main, flags in (('jax', jax_cli_main, ['--platform', 'cpu']),
                              ('port', cli.main, ['--device', 'cpu'])):
        d = tmp_path / name / tag
        d.mkdir(parents=True, exist_ok=True)
        argv = [content, style, '-o', str(d / 'out.png'),
                '--trace-csv', str(d / 'trace.csv'),
                '--model-weights', 'random'] + flags + [
                    a.replace('{run}', str(tmp_path / name)) for a in args]
        assert main(argv) == 0
        dirs[name] = d
    return dirs


def _png_size(path):
    with Image.open(path) as img:
        return img.size


def _fevals(rows):
    return [None if r['fevals'] is None else int(r['fevals']) for r in rows]


def test_cli_multi_scale_and_resume_match_jax(tmp_path):
    """The mirror of tests/test_cli.py's multi-scale + resume run."""
    run = _both_clis(tmp_path, 'ladder', [
        '--size', '36', '--iterations', '3', '--optimizer', 'lbfgs',
        '--multi-scale', '--min-scale', '18', '--steps-per-dispatch', '2',
        '--checkpoint', '{run}/ladder/ckpt'])
    want = _read_csv(run['jax'] / 'trace.csv')
    got = _read_csv(run['port'] / 'trace.csv')
    # Three rungs, each a prime row and three iterations.
    assert _fevals(got) == _fevals(want) == [None, 1, 2, 3, None, 4, 5, 6,
                                             None, 7, 8, 9]
    _assert_traces_close(got, want, 'multi-scale trace')
    assert _png_size(run['port'] / 'out.png') == \
        _png_size(run['jax'] / 'out.png') == (36, 28)

    resumed = _both_clis(tmp_path, 'resumed', [
        '--size', '36', '--iterations', '2', '--optimizer', 'lbfgs',
        '--multi-scale', '--min-scale', '18',
        '--resume', '{run}/ladder/ckpt'])
    # Resumed at the top rung: nothing left to climb, the image is kept.
    assert _read_csv(resumed['port'] / 'trace.csv') == []
    for name in ('port', 'jax'):
        assert _png_size(resumed[name] / 'out.png') == (36, 28)
    np.testing.assert_array_equal(
        np.asarray(Image.open(resumed['port'] / 'out.png')),
        np.asarray(Image.open(run['port'] / 'out.png')))


def _polish_clis(tmp_path, precision):
    """The mirror of tests/test_cli.py's --polish run: 8 iterations in
    `precision`, then 16 float32 iterations that inherit the main run's
    norms. Returns {'jax' or 'port': (main rows, polish rows)}."""
    run = _both_clis(tmp_path, precision, [
        '--size', '32', '--iterations', '8', '--optimizer', 'lbfgs',
        '--steps-per-dispatch', '4', '--precision', precision,
        '--polish', '16', '--polish-precision', 'float32'])
    rows = {}
    for name in ('port', 'jax'):
        main = _read_csv(run[name] / 'trace.csv')
        polish = _read_csv(run[name] / 'trace.polish.csv')
        assert len(main) == 9 and len(polish) == 17, name
        assert _fevals(polish) == [None] + list(range(1, 17))
        assert min(r['loss'] for r in polish) < polish[0]['loss'], name
        rows[name] = main, polish
    assert _png_size(run['port'] / 'out.png') == \
        _png_size(run['jax'] / 'out.png') == (32, 25)
    return rows


def test_cli_polish_matches_jax(tmp_path):
    """float32_fast (full float32 on the CPU) polished in float32: both
    trace CSVs within the golden rtol of the JAX CLI's, so the hand-off,
    the second engine and the inherited norms follow the reference."""
    rows = _polish_clis(tmp_path, 'float32_fast')
    for i, where in enumerate(('main trace', 'polish trace')):
        _assert_traces_close(rows['port'][i], rows['jax'][i], where)


def test_cli_polish_from_bfloat16_beside_jax(tmp_path):
    """A bf16 main run polished in float32. bf16 rounding differs between
    the two CPU backends (the first evaluation within 1.3e-3 of the JAX
    CLI's), and the fixed-step L-BFGS at 32px amplifies it from the second
    step on, so whole traces are compared only in float32 (above). Here:
    the first evaluation and step within the golden rtol, the whole loss
    column within BF16_LOSS_RTOL of the JAX CLI's, and the polish's first
    evaluation, the bf16 run's last image in float32 under the inherited
    norms, within 5e-3 of that run's last bf16 loss."""
    rows = _polish_clis(tmp_path, 'bfloat16')
    (main, polish), (jmain, jpolish) = rows['port'], rows['jax']
    _assert_traces_close(main[:2], jmain[:2], 'bf16 first step')
    np.testing.assert_allclose([r['loss'] for r in main + polish],
                               [r['loss'] for r in jmain + jpolish],
                               rtol=BF16_LOSS_RTOL)
    for name, (m, p) in rows.items():
        assert abs(p[0]['loss'] - m[-1]['loss']) / m[-1]['loss'] < 5e-3, \
            name
