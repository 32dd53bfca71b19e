"""Video mode of the port against the JAX package, on the CPU: the
temporal-consistency term in the objective and the engine, several chunks
collected at once, and the VideoStylizer and its CLI frame by frame. The
JAX side runs with use_pallas=True (the Pallas kernels in interpret mode),
as tests/test_torch_golden.py runs it; float32 traces are held at the golden
rtol 5e-3 and images at atol 0.75, as there."""

import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.engine.objective import \
    ObjectiveSpec as JaxObjectiveSpec
from style_transfer2_tpu.engine.objective import \
    scalars_to_arrays as jax_scalars_to_arrays
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.video import VideoStylizer as JaxVideoStylizer
from style_transfer2_tpu.video import main as jax_video_main
from style_transfer2_tpu_torch import video
from style_transfer2_tpu_torch.engine import StyleTransfer
from style_transfer2_tpu_torch.engine.objective import (ObjectiveSpec,
                                                        scalars_to_arrays)
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.ops import image as image_ops

# tests/test_video.py's objective and frames.
WEIGHTS = {'content': {'conv2_2': 0.1},
           'style': {'conv1_1': 1.0, 'conv2_1': 1.0}, 'deepdream': {}}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
RTOL = 5e-3
# tests/test_torch_ladder.py's bound on a bf16 run's losses against the JAX
# run's: the two backends' bf16 rounding diverges under fixed-step L-BFGS.
BF16_LOSS_RTOL = 0.2
STEP_SIZES = {'adam': 10.0, 'lbfgs': 1.0}


def _frames(n=3, hw=(24, 24), seed=0):
    """A pattern translating one pixel per frame."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (hw[0] + n, hw[1] + n, 3)).astype(np.uint8)
    return [base[i:i + hw[0], i:i + hw[1]] for i in range(n)]


def _style(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (24, 24, 3)).astype(np.uint8)


def _assert_trace_match(got, want, where, rtol=RTOL):
    keys = [k for k in want if k not in ('time', 'fevals')]
    assert [k for k in got if k not in ('time', 'fevals')] == keys, where
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg='%s: %s' % (where, key))
    assert got.get('fevals') == want.get('fevals'), where


def _assert_histories_match(st, jst):
    assert len(st.traces) == len(jst.traces)
    for i, (got, want) in enumerate(zip(st.traces, jst.traces)):
        _assert_trace_match(got.data, want.data, 'history %d' % i)


@pytest.fixture
def one_thread():
    """One intra-op thread: these shapes are tiny, and where the test runner
    runs several workers at once, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures('one_thread')


# -- the objective ------------------------------------------------------------

@pytest.mark.parametrize('temporal', [None, 0.0, 1e-16, 100.0, -3.0])
def test_spec_temporal_flag_and_keys_match_jax(temporal):
    params = dict(SCALARS) if temporal is None else dict(SCALARS,
                                                         temporal=temporal)
    spec = ObjectiveSpec.from_weights(WEIGHTS, params)
    jspec = JaxObjectiveSpec.from_weights(WEIGHTS, params)
    assert spec.temporal == jspec.temporal == (
        temporal is not None and abs(temporal) > 1e-15)
    assert spec.trace_keys == jspec.trace_keys
    if spec.temporal:
        keys = spec.trace_keys
        assert keys.index('temporal_loss') == keys.index('p_loss') + 1
        assert keys.index('temporal_grad') == keys.index('p_grad') + 1
        assert keys.index('temporal_grad') == len(keys) - 3
    got, want = scalars_to_arrays(params), jax_scalars_to_arrays(params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key] and got[key].dtype == np.float32


def _engines(optimizer, images, params):
    out = []
    for engine in (StyleTransfer(params, device='cpu'),
                   JaxStyleTransfer(params, use_pallas=True)):
        engine.set_weights(WEIGHTS, SCALARS)
        engine.set_optimizer(optimizer)
        engine.set_step_size(STEP_SIZES[optimizer])
        content, style, inp = images
        engine.set_content(content)
        engine.set_style(style)
        engine.set_input(inp)
        assert engine.start()
        out.append(engine)
    return out


def _images(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randint(0, 256, (24, 24, 3)).astype(np.uint8)
                 for _ in range(4))


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_set_temporal_parity_with_jax(optimizer):
    """One plain step, then the temporal term toward a host image: 5 steps
    with every trace key within the golden rtol, the L-BFGS re-prime
    included."""
    content, style, inp, target = _images(3)
    st, jst = _engines(optimizer, (content, style, inp), random_params(5))
    st.step()
    jst.step()
    for engine in (st, jst):
        engine.set_temporal(target, 1e5)
        assert engine.spec().temporal
    for step in range(5):
        img, trace = st.step()
        jimg, jtrace = jst.step()
        assert 'temporal_loss' in trace and 'temporal_grad' in trace
        _assert_trace_match(trace, jtrace, 'step %d' % step)
        np.testing.assert_allclose(img, jimg, rtol=1e-2, atol=0.75,
                                   err_msg='image at step %d' % step)
    _assert_histories_match(st, jst)


def test_temporal_weight_lifecycle():
    """set_weights keeps a temporal weight that params do not name;
    set_temporal clears the weight cache, so a new weight under the same
    spec takes effect at once; a target of another shape raises; and
    clear_temporal takes the term away."""
    content, style, inp, target = _images(4)
    st = StyleTransfer(random_params(5), device='cpu')
    st.set_weights(WEIGHTS, SCALARS)
    st.set_content(content)
    st.set_style(style)
    st.set_input(inp)
    assert st.start()
    st.set_temporal(target, 1e3)
    _, trace = st.step()
    assert 'temporal_loss' in trace

    st.set_weights(WEIGHTS, SCALARS)
    assert st.scalar_params['temporal'] == 1e3 and st.spec().temporal
    st.set_weights(WEIGHTS, dict(SCALARS, temporal=5e3))
    assert st.scalar_params['temporal'] == 5e3

    # The L-BFGS prime after the change evaluates the term at the current
    # iterate with the new weight.
    x = st._input.clone()
    st.set_temporal(target, 2e3)
    assert st._weights_cache is None
    st.step()
    prime = st.traces[-2].data
    assert 'fevals' not in prime
    pre = vgg19.preprocess(target, 'cpu')
    want = 2e3 * float(torch.mean(torch.square((x - pre) / 255.0)))
    np.testing.assert_allclose(prime['temporal_loss'], want, rtol=1e-5)

    st.temporal_target = st.temporal_target[:, :12]
    with pytest.raises(ValueError, match='temporal target'):
        st.step()

    st.clear_temporal()
    assert st.temporal_target is None and not st.spec().temporal
    assert 'temporal' not in st.scalar_params
    _, trace = st.step()
    assert 'temporal_loss' not in trace and 'temporal_grad' not in trace
    st.clear_temporal()              # a second clear is a no-op
    assert not st.spec().temporal


def test_collect_steps_many_parity_with_jax():
    """Two chunks in flight, the second primed under the temporal term (so
    its rows are two keys wider), collected together: the prime traces land
    just before their own chunk's steps (tests/test_scan.py), every trace
    and both images as the JAX engine's."""
    content, style, inp, target = _images(5)
    st, jst = _engines('lbfgs', (content, style, inp), random_params(11))
    results = []
    for engine in (st, jst):
        a = engine.begin_steps(2)
        engine.set_temporal(target, 1e5)
        b = engine.begin_steps(2)
        results.append(engine.collect_steps_many([a, b], fetch_image=True))
    assert [t.data.get('fevals') for t in st.traces] == [None, 1, 2, None,
                                                         3, 4]
    _assert_histories_match(st, jst)
    assert 'temporal_loss' not in st.traces[1].data
    assert 'temporal_loss' in st.traces[3].data
    for (img, traces), (jimg, jtraces) in zip(*results):
        assert img.shape == (24, 24, 3) and img.dtype == np.float32
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=1e-2,
                                   atol=0.75)
        assert len(traces) == len(jtraces) == 2
    # One chunk alone, and fetch_image=False.
    a = st.begin_steps(1)
    [(img, traces)] = st.collect_steps_many([a], fetch_image=False)
    assert img is None and traces[0].data['fevals'] == 5


# -- the VideoStylizer --------------------------------------------------------

def _stylizers(optimizer, precision='float32', temporal_weight=1e4,
               iterations=(4, 3)):
    params = random_params(5)
    out = []
    for cls, kw in ((video.VideoStylizer, {'device': 'cpu'}),
                    (JaxVideoStylizer, {'use_pallas': True})):
        v = cls(params, WEIGHTS, SCALARS, optimizer=optimizer,
                step_size=STEP_SIZES[optimizer],
                first_iterations=iterations[0], iterations=iterations[1],
                temporal_weight=temporal_weight, precision=precision,
                seed=2, **kw)
        v.set_style(_style())
        out.append(v)
    return out


@pytest.mark.parametrize('optimizer,n_frames', [('lbfgs', 3), ('adam', 4)])
def test_video_stylizer_parity_with_jax(optimizer, n_frames):
    """The same frames through both stylizers, float32: each frame's image
    within atol 0.75 and rtol 1e-2, every trace of the whole history (the
    primes included) within the golden rtol."""
    v, jv = _stylizers(optimizer)
    for i, frame in enumerate(_frames(n_frames)):
        img, trace = v.stylize_frame(frame)
        jimg, jtrace = jv.stylize_frame(frame)
        assert img.shape == (24, 24, 3)
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=1e-2,
                                   atol=0.75, err_msg='frame %d' % i)
        _assert_trace_match(trace, jtrace, 'frame %d' % i)
        assert ('temporal_loss' in trace) == (i > 0)
    _assert_histories_match(v.st, jv.st)
    # Each chained frame's prime is taken where the warm start and the
    # target hold the same values.
    primes = [t.data for t in v.st.traces if 'fevals' not in t.data]
    if optimizer == 'lbfgs':
        assert len(primes) == n_frames
        assert 'temporal_loss' not in primes[0]
        assert all(p['temporal_loss'] == 0.0 for p in primes[1:])


def test_video_stylizer_bfloat16_beside_jax():
    """bfloat16, L-BFGS: each frame's last loss within BF16_LOSS_RTOL of
    the JAX stylizer's, finite images; the iterate and the temporal target
    stay float32."""
    v, jv = _stylizers('lbfgs', precision='bfloat16')
    for i, frame in enumerate(_frames(3)):
        img, trace = v.stylize_frame(frame)
        _, jtrace = jv.stylize_frame(frame)
        assert np.isfinite(img).all()
        np.testing.assert_allclose(trace['loss'], jtrace['loss'],
                                   rtol=BF16_LOSS_RTOL,
                                   err_msg='frame %d' % i)
    assert v.st.opt_state['x'].dtype == torch.float32
    assert v.st.temporal_target.dtype == torch.float32


def test_pipelined_matches_serial():
    """begin_frame of frame k + 1 enqueued before collect_frame of frame k
    gives the serial path's frames and trace count (tests/test_video.py's
    tolerance)."""
    frames = _frames(4)

    def make():
        v = video.VideoStylizer(random_params(5), WEIGHTS, SCALARS,
                                optimizer='lbfgs', step_size=1.0,
                                first_iterations=4, iterations=3,
                                temporal_weight=1e4, seed=2, device='cpu')
        v.set_style(_style())
        return v

    serial = make()
    outs_serial = [serial.stylize_frame(f)[0] for f in frames]
    piped = make()
    outs_piped, pending = [], None
    for f in frames:
        d = piped.begin_frame(f)
        if pending is not None:
            outs_piped.append(piped.collect_frame(pending)[0])
        pending = d
    outs_piped.append(piped.collect_frame(pending)[0])
    for i, (a, b) in enumerate(zip(outs_piped, outs_serial)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3,
                                   err_msg='frame %d' % i)
    assert len(piped.st.traces) == len(serial.st.traces)
    # Three frames collected with one copy give the same frames.
    batched = make()
    handles = [batched.begin_frame(f) for f in frames[:3]]
    for (img, _), want in zip(batched.collect_frames(handles),
                              outs_serial):
        np.testing.assert_allclose(img, want, rtol=1e-4, atol=1e-3)


def test_chained_warm_start_stays_on_the_device(monkeypatch):
    """After frame 1 the host preprocess runs only for each frame's content:
    the warm start and the target come from preprocess_on_device on the
    previous frame's clipped end image, as two distinct tensors."""
    host, device_side = [], []
    real_host, real_device = vgg19.preprocess, video.preprocess_on_device
    monkeypatch.setattr(vgg19, 'preprocess',
                        lambda img, dev: host.append(np.shape(img))
                        or real_host(img, dev))
    monkeypatch.setattr(video, 'preprocess_on_device',
                        lambda x: device_side.append(x) or real_device(x))
    v = video.VideoStylizer(random_params(5), WEIGHTS, SCALARS,
                            first_iterations=2, iterations=2, seed=2,
                            device='cpu')
    v.set_style(_style())
    assert len(host) == 1
    for i, frame in enumerate(_frames(3)):
        dispatch = v.begin_frame(frame)
        # Frame 1: its content and its random start; later: the content.
        assert len(host) == (3 if i == 0 else 3 + i), host
        assert len(device_side) == i + 1
        assert isinstance(device_side[-1], torch.Tensor)
        assert float(device_side[-1].min()) >= 0
        assert float(device_side[-1].max()) <= 255
        pre, target = v._prev_pre
        assert pre.data_ptr() != target.data_ptr()
        assert torch.equal(pre, target)
        if i:
            assert v.st.temporal_target.data_ptr() != \
                v.st._input.data_ptr()
        v.collect_frame(dispatch)


# -- the video CLI ------------------------------------------------------------

def _cli_inputs(tmp_path, n):
    frames_dir = tmp_path / 'frames'
    frames_dir.mkdir()
    for i, f in enumerate(_frames(n)):
        Image.fromarray(f).save(frames_dir / ('frame_%03d.png' % i))
    style_path = tmp_path / 'style.png'
    Image.fromarray(_style(1)).save(style_path)
    return frames_dir, style_path


CLI_FLAGS = ['--size', '24', '--first-iterations', '4', '--iterations', '2',
             '--model-weights', 'random', '--steps-per-dispatch', '2',
             '--optimizer', 'adam']


def _pngs(out_dir):
    return {p.name: np.asarray(Image.open(p), np.int16)
            for p in sorted(out_dir.iterdir())}


def test_video_cli_beside_jax(tmp_path):
    """Both video CLIs on the same 4 frames (two collected together, then
    the rest): the same PNG names, each within 2 levels of the JAX CLI's."""
    frames_dir, style_path = _cli_inputs(tmp_path, 4)
    assert video.main([str(frames_dir), str(style_path),
                       str(tmp_path / 'out'), '--device', 'cpu',
                       '--pallas', '--platform', 'cpu'] + CLI_FLAGS) == 0
    assert jax_video_main([str(frames_dir), str(style_path),
                           str(tmp_path / 'jout'), '--platform', 'cpu',
                           '--pallas'] + CLI_FLAGS) == 0
    got, want = _pngs(tmp_path / 'out'), _pngs(tmp_path / 'jout')
    assert sorted(got) == sorted(want) == [
        'frame_%03d_stylized.png' % i for i in range(4)]
    for name in want:
        assert got[name].shape == (24, 24, 3)
        assert np.abs(got[name] - want[name]).max() <= 2, name


def test_video_resume_continues_the_chain(tmp_path):
    """--resume skips the contiguous prefix of existing outputs, reseeds the
    chain from the last written frame, leaves the done frames untouched,
    and with everything present writes nothing
    (tests/test_video.py::test_video_resume_continues_the_chain)."""
    frames_dir, style_path = _cli_inputs(tmp_path, 4)
    out_dir = tmp_path / 'out'
    args = [str(frames_dir), str(style_path), str(out_dir),
            '--device', 'cpu'] + CLI_FLAGS
    assert video.main(args) == 0
    assert len(list(out_dir.iterdir())) == 4
    (out_dir / 'frame_002_stylized.png').unlink()
    (out_dir / 'frame_003_stylized.png').write_bytes(b'')   # half-written
    (out_dir / 'frame_001_stylized.png').write_bytes(
        (out_dir / 'frame_001_stylized.png').read_bytes()[:40])
    mtime0 = (out_dir / 'frame_000_stylized.png').stat().st_mtime
    seeded = []
    real = video.VideoStylizer.seed_from
    video.VideoStylizer.seed_from = \
        lambda self, img: seeded.append(img.shape) or real(self, img)
    try:
        assert video.main(args + ['--resume']) == 0
    finally:
        video.VideoStylizer.seed_from = real
    # frame_001 was corrupt: the chain reseeded from frame_000.
    assert seeded == [(24, 24, 3)]
    outs = sorted(out_dir.iterdir())
    assert len(outs) == 4
    assert (out_dir / 'frame_000_stylized.png').stat().st_mtime == mtime0
    assert all(Image.open(o).size == (24, 24) for o in outs)
    mtimes = {o.name: o.stat().st_mtime for o in outs}
    assert video.main(args + ['--resume']) == 0
    assert {o.name: o.stat().st_mtime
            for o in sorted(out_dir.iterdir())} == mtimes


def test_video_main_calls_on_frame_before_each_collect(tmp_path):
    """main's on_frame seam: called once a frame, in order, with the one
    stylizer, after the frame's work is enqueued and before anything of it
    is collected (four frames, collected in threes: none before the
    fourth is enqueued)."""
    frames_dir, style_path = _cli_inputs(tmp_path, 4)
    calls = []
    assert video.main([str(frames_dir), str(style_path),
                       str(tmp_path / 'out'), '--device', 'cpu']
                      + CLI_FLAGS, on_frame=lambda stylizer, index:
                      calls.append((stylizer, index,
                                    len(stylizer.st.traces)))) == 0
    assert [index for _, index, _ in calls] == [0, 1, 2, 3]
    assert len({id(stylizer) for stylizer, _, _ in calls}) == 1
    assert isinstance(calls[0][0], video.VideoStylizer)
    assert [n for _, _, n in calls] == [0, 0, 0, 0]
    assert len(calls[0][0].st.traces) > 0


def test_seed_from_takes_the_temporal_branch():
    v = video.VideoStylizer(random_params(5), WEIGHTS, SCALARS,
                            first_iterations=2, iterations=2, seed=2,
                            device='cpu')
    v.set_style(_style())
    prev = _frames(1)[0]
    v.seed_from(prev)
    pre, target = v._prev_pre
    assert torch.equal(pre, image_ops.preprocess(prev, 'cpu'))
    _, trace = v.stylize_frame(_frames(2)[1])
    assert 'temporal_loss' in trace


def test_video_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    frames_dir, style_path = _cli_inputs(tmp_path, 2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        video.main([str(frames_dir), str(style_path), str(tmp_path / 'out')]
                   + CLI_FLAGS)
    assert not (tmp_path / 'out').exists()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        video.VideoStylizer(random_params(5), WEIGHTS, SCALARS)
