"""K-step chunks in the port (engine/steps.py build_scan_fn,
parallel/batch.py build_masked_batched_scan_fn, engine/graphs.py), on the
CPU.

  * tests/test_scan.py's chunk tests on the port's engine: a chunk equals
    as many single steps, two primed chunks in flight keep their traces in
    dispatch order, a step after a chunk continues it.
  * The port's chunk functions against the JAX package's build_scan_fn and
    build_masked_batched_scan_fn on the same inputs (the same numpy images
    and random_params through each package's engine): every trace key, the
    final state and the norms at the golden rtol 5e-3, images at atol 0.75
    (tests/test_torch_golden.py).
  * The static-buffer layer of engine/graphs.py, with FakeGraphs in place
    of the card's capture backend: a capture records the step and runs
    nothing, a replay runs it over the static buffers, as a CUDA graph
    replays its kernels. The graphed engine must give the eager engine's
    bits after every setter that can come between two chunks, keep two
    chunks in flight apart, and keep lane_state's and lane_norms' promised
    lifetimes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.engine.batched import (
    BatchedStyleTransfer as JaxBatchedStyleTransfer)
from style_transfer2_tpu.engine.steps import build_scan_fn as jax_scan_fn
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.optim import adam as jadam
from style_transfer2_tpu.parallel.batch import (
    build_masked_batched_scan_fn as jax_masked_scan_fn)
from style_transfer2_tpu_torch.engine import StyleTransfer, build_scan_fn
from style_transfer2_tpu_torch.engine import graphs
from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
from style_transfer2_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.optim import adam
from style_transfer2_tpu_torch.parallel import build_masked_batched_scan_fn

WEIGHTS = {
    'content': {'conv2_2': 0.1},
    'style': {'conv1_1': 1.0, 'conv2_1': 1.0},
    'deepdream': {},
}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
STEP_SIZES = {'adam': 10.0, 'lbfgs': 1.0}
RTOL = 5e-3
IMAGE_ATOL = 0.75
HW = (24, 32)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the shapes are tiny, and the test runner runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeGraph:
    """A captured step: replay() runs it again over the static buffers."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class FakeGraphs:
    """engine/graphs.py CudaGraphs without a card: warm() runs the step,
    capture() records it and runs nothing, reset() counts the pools it
    would release."""

    def __init__(self):
        self.resets = 0

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        return FakeGraph(fn)

    def reset(self):
        self.resets += 1


def _graphed(engine):
    engine._graphs = graphs.StepGraphs(FakeGraphs())
    return engine


def _images(seed, hw=HW):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
            for _ in range(3)]


def _make(seed, optimizer, cls=StyleTransfer, params_seed=11, **kw):
    content, style, inp = _images(seed)
    st = cls(random_params(params_seed), **kw)
    st.set_weights(WEIGHTS, SCALARS)
    st.set_optimizer(optimizer)
    st.set_step_size(STEP_SIZES[optimizer])
    st.set_content(content)
    st.set_style(style)
    st.set_input(inp)
    assert st.start()
    return st


def _rows(st):
    return [{k: v for k, v in t.data.items() if k != 'time'}
            for t in st.traces]


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_scan_matches_single_steps(optimizer):
    a = _make(5, optimizer, device='cpu')
    b = _make(5, optimizer, device='cpu')
    imgs_a = [a.step()[0] for _ in range(4)]
    img_b, _ = b.run_steps(4)
    assert a.t == b.t == 4
    assert _rows(a) == _rows(b)
    np.testing.assert_array_equal(imgs_a[-1], img_b)


def test_pipelined_primed_traces_stay_in_dispatch_order():
    st = _make(21, 'lbfgs', device='cpu')
    assert st._needs_init                      # fresh start: A primes
    a = st.begin_steps(2)
    st.set_weights(WEIGHTS, SCALARS)           # objective change: B primes
    assert st._needs_init
    b = st.begin_steps(2)                      # in flight behind A
    st.collect_steps(a, fetch_image=False)
    st.collect_steps(b, fetch_image=False)
    # A.prime, A.step1, A.step2, B.prime, B.step1, B.step2; prime traces
    # are eval traces, with no 'fevals'.
    fevals = [t.data.get('fevals') for t in st.traces]
    assert fevals == [None, 1, 2, None, 3, 4], fevals
    assert all(np.isfinite(t.data['loss']) for t in st.traces)

    st2 = _make(21, 'lbfgs', device='cpu')
    a2 = st2.begin_steps(2)
    st2.set_weights(WEIGHTS, SCALARS)
    b2 = st2.begin_steps(2)
    st2.collect_steps_many([a2, b2], fetch_image=False)
    assert _rows(st2) == _rows(st)


def test_scan_then_step_continues():
    st = _make(3, 'adam', device='cpu')
    st.run_steps(2, fetch_image=False)
    img, trace = st.step()
    assert st.t == 3 and trace['fevals'] == 3
    assert np.isfinite(trace['loss'])
    np.testing.assert_array_equal(st.snapshot(), img)


# -- the chunk functions against the JAX package's ---------------------------

def _assert_state_close(got, want, what):
    """A state tensor against the JAX one at the golden rtol of its own
    scale: elementwise relative error means nothing where a gradient
    crosses zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _pair(seed, optimizer):
    """The port's CPU engine and the JAX engine (Pallas kernels, CPU
    interpret mode), from the same images and weights, started."""
    st = _make(seed, optimizer, device='cpu')
    jst = _make(seed, optimizer, cls=JaxStyleTransfer, use_pallas=True)
    return st, jst


def _jax_rows(traces):
    """The JAX scan's traces (a tuple of (K,) arrays, one a key) as (K,
    n_keys)."""
    return np.stack([np.asarray(t) for t in traces], axis=1)


def test_input_property_matches_jax():
    """StyleTransfer.input is the iterate, as the JAX engine's input
    property: the preprocessed (1, H, W, 3) image, before and after a
    chunk."""
    st, jst = _pair(10, 'lbfgs')
    np.testing.assert_array_equal(st.input.numpy(), np.asarray(jst.input))
    st.run_steps(2)
    jst.run_steps(2)
    assert st.input is st.opt_state['x']
    assert st.input.shape == (1,) + HW + (3,)
    np.testing.assert_allclose(st.input.numpy(), np.asarray(jst.input),
                               rtol=RTOL, atol=IMAGE_ATOL)


def _chunk_pair(st, jst, n_steps, primed):
    spec, jspec = st.spec(), jst.spec()
    assert spec.trace_keys == jspec.trace_keys
    state, norms, rows, prime = build_scan_fn(
        spec, st.optimizer_name, primed)(
        st.model, st.opt_state, st._gather_inputs(spec), st.step_size,
        n_steps)
    jscan = jax_scan_fn(jspec, jst.optimizer_name, 'float32', n_steps,
                        use_pallas=True, primed=primed)
    out = jscan(jst.params, jst.opt_state, jst._gather_inputs(jspec),
                jnp.float32(jst.step_size))
    np.testing.assert_allclose(rows.numpy(), _jax_rows(out[2]), rtol=RTOL)
    if primed:
        np.testing.assert_allclose(prime.numpy(),
                                   np.stack([np.asarray(v) for v in out[4]]),
                                   rtol=RTOL)
    else:
        assert prime is None
    np.testing.assert_allclose(vgg19.deprocess(state['x']),
                               np.asarray(out[3]), rtol=RTOL,
                               atol=IMAGE_ATOL)
    for key in spec.norm_keys:
        np.testing.assert_allclose(float(norms[0][key]),
                                   float(out[1][0][key]), rtol=RTOL)
        assert bool(norms[1][key]) == bool(out[1][1][key])
    return state, norms, out


@pytest.mark.parametrize('primed', [True, False])
def test_lbfgs_chunk_matches_jax_build_scan_fn(primed):
    st, jst = _pair(8, 'lbfgs')
    if not primed:
        # An earlier step primed both caches.
        st.step()
        jst.step()
    state, norms, out = _chunk_pair(st, jst, 3, primed)
    jstate = out[0]
    np.testing.assert_allclose(float(state['loss']), float(jstate['loss']),
                               rtol=RTOL)
    for key in ('grad', 'syk'):
        _assert_state_close(state[key], jstate[key], key)
    assert int(state['count']) == int(jstate['count'])
    assert int(state['pos']) == int(jstate['pos'])


def test_adam_chunks_across_an_objective_change_match_jax():
    st, jst = _pair(9, 'adam')
    state, norms, out = _chunk_pair(st, jst, 2, False)
    st.opt_state, jst.opt_state = state, out[0]
    st._absorb_norms(st.spec(), norms)
    jst._absorb_norms(jst.spec(), out[1])
    st.opt_state = adam.objective_changed(st.opt_state)
    jst.opt_state = jadam.objective_changed(jst.opt_state)
    state, _, out = _chunk_pair(st, jst, 3, False)
    for key in ('g1_items', 'g2_items', 't'):
        assert state[key] == int(out[0][key]), key
    assert (state['g1_items'], state['g2_items']) == (3, 5)
    for key in ('g1_mean', 'g2_mean'):
        _assert_state_close(state[key], out[0][key], key)


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_masked_chunk_matches_jax_with_a_lane_frozen(optimizer):
    """Three lanes, lane 1 masked out for the chunk: every running lane's
    traces and end state against the JAX masked scan, and lane 1's state
    exactly as it was."""
    params = random_params(12)
    ours = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, 3,
                                optimizer=optimizer, device='cpu')
    theirs = JaxBatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, 3,
                                     optimizer=optimizer)
    for lane in range(3):
        job = _images(30 + lane)
        ours.add_job(*job, lane=lane)
        theirs.add_job(*job, lane=lane)
    # One step each, every lane running: primes the L-BFGS caches.
    ours.step_all()
    theirs.step_all()
    mask = [True, False, True]
    frozen = {k: v[1].clone() for k, v in ours.states.items()}
    states, norms, traces = build_masked_batched_scan_fn(
        ours.spec, optimizer, 3)(ours.model, ours.states, ours.inputs,
                                 ours.step_sizes, torch.tensor(mask))
    jstates, jnorms, jtraces = jax_masked_scan_fn(
        theirs.spec, optimizer, 'float32', 3)(
        theirs.params, theirs.states, theirs.inputs, theirs.step_sizes,
        jnp.asarray(mask))
    assert traces.shape == (len(ours.spec.trace_keys), 3, 3)
    for lane in (0, 2):
        want = np.stack([np.asarray(t)[lane] for t in jtraces])
        np.testing.assert_allclose(traces[:, lane].numpy(), want, rtol=RTOL)
        # The iterates, before deprocessing's mean shift.
        np.testing.assert_allclose(
            states['x'][lane].numpy(),
            np.asarray(jstates['x'][lane]).reshape(HW + (3,)),
            rtol=RTOL, atol=IMAGE_ATOL)
    for key, value in frozen.items():
        assert torch.equal(states[key][1], value), key
    for key in ours.spec.norm_keys:
        np.testing.assert_allclose(norms[0][key].numpy(),
                                   np.asarray(jnorms[0][key]), rtol=RTOL)


# -- the static-buffer layer (engine/graphs.py) with FakeGraphs --------------

def _both(seed, optimizer, **kw):
    """(eager engine, graphed engine) from the same inputs."""
    return (_make(seed, optimizer, device='cpu', **kw),
            _graphed(_make(seed, optimizer, device='cpu', **kw)))


def _assert_same(eager, graphed):
    assert _rows(eager) == _rows(graphed)
    assert torch.equal(eager.input, graphed.input)
    for key, value in eager.opt_state.items():
        got = graphed.opt_state[key]
        assert (torch.equal(got, value) if torch.is_tensor(value)
                else got == value), key
    assert {k: float(v) for k, v in eager.norm_vals.items()} == {
        k: float(v) for k, v in graphed.norm_vals.items()}


SETTERS = {
    'set_weights': lambda st, rng: st.set_weights(
        WEIGHTS, dict(SCALARS, tv=4.0)),
    'set_content': lambda st, rng: st.set_content(_images(rng)[0]),
    'set_style': lambda st, rng: st.set_style(_images(rng)[1]),
    'set_input': lambda st, rng: st.set_input(_images(rng)[2]),
    'set_input_tensor': lambda st, rng: st.set_input(
        vgg19.preprocess(_images(rng)[2], st.device), preprocessed=True),
    'set_temporal': lambda st, rng: st.set_temporal(_images(rng)[0], 50.0),
    'set_step_size': lambda st, rng: st.set_step_size(0.5),
    'objective_changed': lambda st, rng: st.objective_changed(),
    'seed_norms': lambda st, rng: st.seed_norms(
        {'conv1_1:s': 2.0}, {'conv1_1:s': True}),
}


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
@pytest.mark.parametrize('setter', sorted(SETTERS))
def test_setter_between_chunks_reaches_the_next_replay(optimizer, setter):
    """Two chunks (warm-up, capture, replays), the setter, two more: the
    graphed engine gives the eager engine's bits, replays included."""
    eager, graphed = _both(40, optimizer)
    replays = graphs.replays
    for st in (eager, graphed):
        st.run_steps(2)
        st.run_steps(2)
        SETTERS[setter](st, 41)
        st.run_steps(2)
        st.step()
    assert graphs.replays - replays >= 5
    _assert_same(eager, graphed)


def test_checkpoint_load_reaches_the_next_replay(tmp_path):
    """A checkpoint loaded into a graphed engine between chunks: its state
    is copied into the static buffers before the next replay."""
    eager, graphed = _both(42, 'lbfgs')
    source = _make(43, 'lbfgs', device='cpu')
    source.run_steps(3)
    save_checkpoint(source, tmp_path)
    for st in (eager, graphed):
        st.run_steps(2)
        st.run_steps(2)
        load_checkpoint(st, tmp_path)
        st.run_steps(3)
    _assert_same(eager, graphed)


def test_graphs_hold_static_buffers_across_replays():
    """After a replay the engine's state and norms are the step graph's
    static buffers, the same tensors every replay. The one prime ran
    eagerly (a key's first call), so only the step has a graph."""
    _, st = _both(44, 'lbfgs')
    st.run_steps(2)
    st.run_steps(1)
    x, norms = st.opt_state['x'], dict(st.norm_vals)
    st.run_steps(1)
    assert st.opt_state['x'] is x and st.input is x
    assert all(st.norm_vals[k] is v for k, v in norms.items())
    assert len(st._graphs) == 1


def test_pipelined_graphed_chunks_keep_their_rows_and_images():
    """Two chunks in flight on a graphed engine: each handle's rows and end
    image are its own (the eager engine's), though the replays rewrite one
    static output row and one static iterate."""
    eager, graphed = _both(45, 'lbfgs')
    got = {}
    for name, st in (('eager', eager), ('graphed', graphed)):
        st.run_steps(2)
        a = st.begin_steps(3)
        b = st.begin_steps(2)
        assert not torch.equal(a.traces[-1], b.traces[-1])
        got[name] = (a.traces.clone(), a.image.clone(), b.traces.clone(),
                     b.image.clone(), st.collect_steps_many([a, b]))
    for want, have in zip(got['eager'][:4], got['graphed'][:4]):
        assert torch.equal(want, have)
    for (img_e, tr_e), (img_g, tr_g) in zip(got['eager'][4],
                                            got['graphed'][4]):
        np.testing.assert_array_equal(img_e, img_g)
        assert ([{k: v for k, v in t.data.items() if k != 'time'}
                 for t in tr_e] == [{k: v for k, v in t.data.items()
                                     if k != 'time'} for t in tr_g])


def test_warm_start_drops_the_old_grids_graphs():
    _, st = _both(46, 'lbfgs')
    st.run_steps(2)
    st.run_steps(2)
    assert len(st._graphs) == 1
    st.resample_input((20, 28))
    st.resample_content((20, 28))
    assert len(st._graphs) == 0
    st.run_steps(2)
    assert np.isfinite(st.traces[-1].data['loss'])


def test_graphs_release_their_pool_on_a_warm_start_and_when_dropped():
    """A warm start to another grid drops the graphs and has the backend
    release their pool; so does an engine that goes with graphs held."""
    _, st = _both(49, 'lbfgs')
    backend = st._graphs.backend
    st.run_steps(2)
    st.run_steps(1)
    assert backend.resets == 0
    st.resample_input((20, 28))
    assert backend.resets == 1
    st.resample_content((20, 28))
    st.run_steps(2)
    assert len(st._graphs) == 1
    del st
    assert backend.resets == 2


def test_graph_cache_is_bounded():
    """More objective structures than MAX_GRAPHS keeps the newest."""
    _, st = _both(47, 'adam')
    for i in range(graphs.MAX_GRAPHS + 2):
        weights = dict(WEIGHTS, content={'conv2_2': 0.1},
                       deepdream={'conv1_%d' % (1 + i % 2): 0.1}
                       if i % 3 else {})
        weights['style'] = {'conv1_1': 1.0} if i < 3 else {'conv2_1': 1.0}
        st.set_weights(weights, SCALARS)
        st.run_steps(2)
        st.run_steps(1)
    assert len(st._graphs) == graphs.MAX_GRAPHS


def test_a_replay_refuses_args_of_another_shape():
    _, st = _both(48, 'adam')
    st.run_steps(2)
    key = next(iter(st._graphs._graphs))
    graph = st._graphs._graphs[key]
    args = graphs._rebuild({'a': 0}, iter([None]))
    with pytest.raises(ValueError, match='captured structure'):
        graph.replay(args)


def _lanes_pair(optimizer):
    params = random_params(13)
    out = []
    for graphed in (False, True):
        bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, 3,
                                  optimizer=optimizer, device='cpu')
        if graphed:
            _graphed(bt)
        for lane in (0, 2):
            bt.add_job(*_images(50 + lane), lane=lane)
        out.append(bt)
    return out


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_graphed_lanes_match_eager_through_lane_writes(optimizer):
    """The masked step and prime through FakeGraphs against the eager
    batched engine, across a pause, a lane's new weights, a step size, an
    add_job into a free lane and a requeue with lane_state and
    lane_norms."""
    eager, graphed = _lanes_pair(optimizer)
    runs = []
    for bt in (eager, graphed):
        rows = [bt.run_steps_all(2), bt.run_steps_all(2)]
        bt.set_running(0, False)
        rows.append(bt.run_steps_all(2))
        bt.set_running(0, True)
        bt.set_lane_weights(2, WEIGHTS, dict(SCALARS, tv=3.0))
        bt.set_step_size(0, STEP_SIZES[optimizer] / 2)
        rows.append(bt.run_steps_all(2))
        bt.add_job(*_images(53), lane=1)
        rows.append(bt.run_steps_all(1))
        state = {k: v.clone() for k, v in bt.lane_state(0).items()}
        norms = bt.lane_norms(0)
        bt.remove_job(0)
        bt.add_job(*_images(50), lane=0, lane_state=state, norms=norms,
                   t=bt.t[2])
        rows.append(bt.run_steps_all(2))
        runs.append((rows, {k: v.clone() for k, v in bt.states.items()}))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        assert torch.equal(runs[1][1][key], value), key
    assert len(graphed._graphs) >= 1


def test_lane_views_and_norms_keep_their_lifetimes():
    """lane_state() views are the static buffers: they hold until the lane
    is next written, and a step that runs the lane rewrites them in place.
    lane_norms() copies, so a later step leaves the copy alone."""
    _, bt = _lanes_pair('adam')
    bt.run_steps_all(2)
    bt.run_steps_all(1)                     # a replay
    view = bt.lane_state(0)
    assert view['x'].data_ptr() == bt.states['x'].data_ptr()
    before = view['x'].clone()
    norms = bt.lane_norms(0)
    kept = {k: v.clone() for k, v in norms[0].items()}
    bt.set_running(0, False)
    bt.run_steps_all(1)                     # lane 0 paused: views hold
    assert torch.equal(view['x'], before)
    bt.set_running(0, True)
    bt.run_steps_all(1)                     # lane 0 runs: rewritten
    assert not torch.equal(view['x'], before)
    assert all(torch.equal(norms[0][k], v) for k, v in kept.items())
    assert all(norms[0][k] is not bt.inputs['norms_vals'][k]
               for k in kept)
