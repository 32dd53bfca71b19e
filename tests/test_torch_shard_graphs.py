"""Graphed spatially sharded chunks of the port on the CPU: the static
buffers of engine/graphs.py over Sharded leaves (parallel/spatial.py), and
the capture backend's join of several cards.

  * A stand-in capture backend (tests/test_torch_scan.py's FakeGraphs: a
    capture records the step and runs nothing, a replay reruns it over the
    static buffers, as a CUDA graph replays its kernels) on engines over
    CPU meshes of 2 and 4 entries, H-sharded and W-sharded: the graphed
    chunk gives the eager sharded chunk's bits, after every setter that
    can come between two chunks, a checkpoint load and objective_changed,
    and with two chunks in flight; and it matches the JAX package's
    sharded engine on tests/conftest.py's 8 virtual devices within
    tests/test_parallel.py's rtol, L-BFGS with a captured prime and Adam.
  * A warm start drops the graphs and has the backend reset its pools; a
    replay refuses a leaf of another layout; a replay credits the sharded
    path's launches as an eager step counts them.
  * CudaGraphs over several cards, against a recording stand-in of
    torch.cuda: the other cards' side streams join inside the capture, are
    current while the step runs, allocate into a pool of their own card
    and are joined back before the capture ends; a replay is ordered
    after and before every card's current stream; a reset releases each
    card's pool once a capture.
"""

import contextlib

import numpy as np
import pytest
import torch

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.parallel import (
    SpatialPlacement as JaxSpatialPlacement, make_mesh as jax_make_mesh)
from style_transfer2_tpu_torch.engine import (StyleTransfer, graphs,
                                              load_checkpoint,
                                              save_checkpoint)
from style_transfer2_tpu_torch.engine.steps import graph_key
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.ops import conv, style
from style_transfer2_tpu_torch.parallel import (Sharded, SpatialPlacement,
                                                make_mesh)

WEIGHTS = {
    'content': {'conv2_2': 0.1},
    'style': {'conv1_1': 1.0, 'conv2_1': 1.0},
    'deepdream': {},
}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
STEP_SIZES = {'adam': 10.0, 'lbfgs': 1.0}
# tests/test_parallel.py's tolerances.
TRACE_RTOL, TRACE_ATOL = 5e-4, 1e-6
IMAGE_RTOL, IMAGE_ATOL = 1e-3, 0.1
# (mesh entries, grid, sharded axis of the iterate): H over 2 and 4
# entries, and W where H (34) does not divide by 4.
LAYOUTS = {'H2': (2, (32, 32), 1), 'H4': (4, (32, 32), 1),
           'W4': (4, (34, 32), 2)}
HW = (24, 32)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the grids are tiny, and the test runner runs
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


def _placement(n):
    return SpatialPlacement(make_mesh(n, axis_names=('space',),
                                      device='cpu'))


def _images(seed, hw):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
            for _ in range(3)]


def _start(st, optimizer, hw, seed):
    content, style_img, inp = _images(seed, hw)
    st.set_weights(WEIGHTS, SCALARS)
    st.set_optimizer(optimizer)
    st.set_step_size(STEP_SIZES[optimizer])
    st.set_content(content)
    st.set_style(style_img)
    st.set_input(inp)
    assert st.start()
    return st


def _make(optimizer, n=4, hw=HW, graphed=False, seed=3, params_seed=2):
    st = StyleTransfer(random_params(params_seed), device='cpu',
                       placement=_placement(n))
    if graphed:
        st._graphs = graphs.StepGraphs(FakeGraphs())
    return _start(st, optimizer, hw, seed)


def _both(optimizer, **kw):
    """(eager sharded engine, graphed sharded engine) from the same
    inputs."""
    return _make(optimizer, **kw), _make(optimizer, graphed=True, **kw)


def _rows(st):
    return [{k: v for k, v in t.data.items() if k != 'time'}
            for t in st.traces]


def _gathered(tree):
    return {k: v.gather() if isinstance(v, Sharded) else v
            for k, v in tree.items()}


def _assert_same(eager, graphed):
    """Traces, iterate, optimizer state (each Sharded gathered) and norms
    bit for bit."""
    assert _rows(eager) == _rows(graphed)
    assert torch.equal(eager.input, graphed.input)
    want, got = _gathered(eager.opt_state), _gathered(graphed.opt_state)
    assert want.keys() == got.keys()
    for key, value in want.items():
        assert (torch.equal(got[key], value) if torch.is_tensor(value)
                else got[key] == value), key
    assert {k: float(v) for k, v in eager.norm_vals.items()} == {
        k: float(v) for k, v in graphed.norm_vals.items()}


def _chunks(st):
    """A chunk (the keys' warm-ups), a chunk (the step captured), an
    objective change and a chunk (an L-BFGS prime captured)."""
    st.run_steps(1)
    st.run_steps(2)
    st.objective_changed()
    return st.run_steps(1)


def _assert_traces(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        keys = [k for k in w if k != 'time']
        assert [k for k in g if k != 'time'] == keys
        for key in keys:
            np.testing.assert_allclose(
                g[key], w[key], rtol=TRACE_RTOL, atol=TRACE_ATOL,
                err_msg='%s: row %d, trace key %r' % (what, i, key))


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_graphed_sharded_chunks_match_eager_and_jax(optimizer, layout):
    """Chunks through warm-up, capture and replay on a graphed sharded
    engine: the eager sharded engine's bits, and every trace row and the
    image of the JAX package's sharded engine (the same chunks over the
    'space' axis of a mesh of the same size) within tests/test_parallel.py's
    tolerances. L-BFGS captures its prime after the objective change."""
    n, hw, axis = LAYOUTS[layout]
    eager = _make(optimizer, n, hw)
    graphed = _make(optimizer, n, hw, graphed=True)
    replays = graphs.replays
    img_e, _ = _chunks(eager)
    img_g, _ = _chunks(graphed)
    assert isinstance(graphed._input, Sharded)
    assert graphed._input.axis == axis and len(graphed._input.shards) == n
    assert graphs.replays - replays == 3 + (optimizer == 'lbfgs')
    assert len(graphed._graphs) == (2 if optimizer == 'lbfgs' else 1)
    _assert_same(eager, graphed)
    np.testing.assert_array_equal(img_e, img_g)

    jst = _start(JaxStyleTransfer(random_params(2), placement=(
        JaxSpatialPlacement(jax_make_mesh(n, axis_names=('space',))))),
        optimizer, hw, 3)
    img_j, _ = _chunks(jst)
    _assert_traces(_rows(graphed), [t.data for t in jst.traces],
                   'graphed sharded vs JAX sharded')
    np.testing.assert_allclose(img_g, np.asarray(img_j), rtol=IMAGE_RTOL,
                               atol=IMAGE_ATOL)


SETTERS = {
    'set_weights': lambda st, rng: st.set_weights(
        WEIGHTS, dict(SCALARS, tv=4.0)),
    'set_content': lambda st, rng: st.set_content(_images(rng, HW)[0]),
    'set_style': lambda st, rng: st.set_style(_images(rng, HW)[1]),
    'set_input': lambda st, rng: st.set_input(_images(rng, HW)[2]),
    'set_input_tensor': lambda st, rng: st.set_input(
        vgg19.preprocess(_images(rng, HW)[2], st.device),
        preprocessed=True),
    'set_temporal': lambda st, rng: st.set_temporal(_images(rng, HW)[0],
                                                    50.0),
    'set_step_size': lambda st, rng: st.set_step_size(0.5),
    'objective_changed': lambda st, rng: st.objective_changed(),
    'seed_norms': lambda st, rng: st.seed_norms(
        {'conv1_1:s': 2.0}, {'conv1_1:s': True}),
}


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
@pytest.mark.parametrize('setter', sorted(SETTERS))
def test_setter_between_sharded_chunks_reaches_the_next_replay(optimizer,
                                                               setter):
    """Two chunks (warm-up, capture, replays), the setter, two more on 4
    shards: the graphed engine gives the eager engine's bits, replays
    included."""
    eager, graphed = _both(optimizer, seed=40)
    replays = graphs.replays
    for st in (eager, graphed):
        st.run_steps(2)
        st.run_steps(2)
        SETTERS[setter](st, 41)
        st.run_steps(2)
        st.step()
    assert graphs.replays - replays >= 5
    _assert_same(eager, graphed)


def test_sharded_checkpoint_load_reaches_the_next_replay(tmp_path):
    """A checkpoint loaded into a graphed sharded engine between chunks:
    placed again, its shards are copied into the static buffers before
    the next replay."""
    eager, graphed = _both('lbfgs', seed=42)
    source = _make('lbfgs', seed=43)
    source.run_steps(3)
    save_checkpoint(source, tmp_path)
    for st in (eager, graphed):
        st.run_steps(2)
        st.run_steps(2)
        load_checkpoint(st, tmp_path)
        assert isinstance(st.opt_state['sk'], Sharded)
        st.run_steps(3)
    _assert_same(eager, graphed)


def test_sharded_graphs_hold_static_shards_across_replays():
    """After a replay the engine's sharded state is the step graph's static
    shards, the same tensors every replay, each shard's buffer on its
    shard's device and laid out as the iterate."""
    _, st = _both('lbfgs', n=2, seed=44)
    st.run_steps(2)
    st.run_steps(1)
    x, sk = st.opt_state['x'], st.opt_state['sk']
    shards = list(x.shards)
    st.run_steps(1)
    assert st.opt_state['x'] is x and st._input is x
    assert all(a is b for a, b in zip(st.opt_state['x'].shards, shards))
    assert st.opt_state['sk'] is sk and sk.axis == x.axis + 1
    assert x.devices == st.placement.devices
    assert len(st._graphs) == 1


def test_pipelined_graphed_sharded_chunks_keep_their_rows_and_images():
    """Two chunks in flight on a graphed sharded engine: each handle's rows
    and end image are its own (the eager engine's), though the replays
    rewrite one static output row and one static sharded iterate."""
    eager, graphed = _both('lbfgs', seed=45)
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
    _assert_same(eager, graphed)


def test_sharded_warm_start_drops_the_graphs_and_resets_the_pools():
    """resample_input places the state again on a new grid: the old grid's
    graphs go and the backend releases their pools; an engine that goes
    with graphs held releases them too."""
    _, st = _both('lbfgs', seed=46)
    backend = st._graphs.backend
    st.run_steps(2)
    st.run_steps(2)
    assert len(st._graphs) == 1 and backend.resets == 0
    st.resample_input((16, 32))
    st.resample_content((16, 32))
    assert len(st._graphs) == 0 and backend.resets == 1
    assert isinstance(st._input, Sharded) and st.input_hw == (16, 32)
    st.run_steps(2)
    st.run_steps(1)
    assert np.isfinite(st.traces[-1].data['loss'])
    assert len(st._graphs) == 1
    del st
    assert backend.resets == 2


def test_sharded_graph_key_names_the_layout():
    """The key of a sharded step holds the iterate's axis and devices; an
    unsharded state's holds none."""
    st = _make('adam', n=4, hw=(34, 32))
    key = graph_key('step', st.spec(), 'adam', st.opt_state)
    assert key.hw == (34, 32)
    assert key.layout == (2, (torch.device('cpu'),) * 4)
    plain = {'x': torch.zeros(1, 34, 32, 3)}
    assert graph_key('step', st.spec(), 'adam', plain).layout is None


def _other_layouts(x):
    """x (a Sharded (1, 24, 32, 3) on 4 CPU entries, H-sharded) with
    another shard count, on the other axis, with other extents and on
    another device, each with the error it must raise."""
    whole = x.gather()
    return {
        'shards': (_placement(2).image(whole), 'captured structure'),
        'axis': (Sharded(list(torch.chunk(whole, 4, 2)), 2),
                 'captured structure'),
        'extents': (Sharded([whole.narrow(1, a, n) for a, n in (
            (0, 8), (8, 6), (14, 6), (20, 4))], 1), 'captured as'),
        'device': (x.map(lambda s: torch.empty_like(s, device='meta')),
                   'captured as'),
    }


@pytest.mark.parametrize('what', ['shards', 'axis', 'extents', 'device'])
def test_a_sharded_replay_refuses_another_layout(what):
    """A replay whose sharded iterate has another shard count, axis, shard
    extents or device than at the capture raises; nothing replays."""
    _, st = _both('adam', seed=48)
    st.run_steps(2)
    graph = next(iter(st._graphs._graphs.values()))
    seen, replay = [], graph.replay
    graph.replay = lambda args: replay(seen.append(args) or args)
    st.run_steps(1)
    args = dict(seen[0])
    args['state'] = dict(args['state'])
    args['state']['x'], match = _other_layouts(st.opt_state['x'])[what]
    replays = graphs.replays
    with pytest.raises(ValueError, match=match):
        replay(args)
    assert graphs.replays == replays


class _CountFreeGraph(FakeGraph):
    """A replay that, as on the card, calls no kernel wrapper: it reruns
    the step and takes back the launches the rerun counted."""

    def replay(self):
        before = graphs._launch_counts()
        self.fn()
        after = graphs._launch_counts()
        graphs._credit({k: n - before.get(k, 0) for k, n in after.items()},
                       -1)


class _CountFreeGraphs(FakeGraphs):
    """A capture that calls every wrapper once, as a capture on the card
    does (what it writes, the replay's copy-in writes over before it
    runs)."""

    def capture(self, fn):
        fn()
        return _CountFreeGraph(fn)


def test_replays_credit_the_sharded_launches(monkeypatch):
    """The sharded path's wrappers (each shard's conv forward and backward
    through the halo, both style phases) counting a launch a call: a
    graphed sharded run's counts after its replays equal an eager run's,
    each graph crediting what its capture launched."""
    real_fwd = conv.conv3x3_bias_relu_plain

    def counted_conv(x, w, b, wt):
        conv.path_launches[('fwd', 'plain')] = conv.path_launches.get(
            ('fwd', 'plain'), 0) + 1
        return real_fwd(x, w, b)

    real_gram, real_grad = style.style_gram, style.style_grad

    def counted_gram(feat, size):
        style.gram_launches += 1
        return real_gram(feat, size)

    def counted_grad(feat, gram_diff, size):
        style.grad_launches += 1
        return real_grad(feat, gram_diff, size)

    monkeypatch.setattr(vgg19, 'conv3x3_bias_relu', counted_conv)
    monkeypatch.setattr(style, 'style_gram', counted_gram)
    monkeypatch.setattr(style, 'style_grad', counted_grad)
    counts = []
    for backend in (None, _CountFreeGraphs()):
        st = _make('lbfgs', seed=47)
        if backend is not None:
            st._graphs = graphs.StepGraphs(backend)
        before = graphs._launch_counts()
        replays = graphs.replays
        st.run_steps(2)
        st.run_steps(3)
        after = graphs._launch_counts()
        counts.append({k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)})
        if backend is not None:
            assert graphs.replays - replays == 4
    # 6 evaluations (the prime and 5 steps), 2 shard-level style layers
    # on 4 shards; a forward of each of the 4 sharded convs on 4 shards.
    assert counts[1][('style_gram',)] == 6 * 2 * 4
    assert counts[1][('style_grad',)] == 6 * 2 * 4
    assert counts[1][('conv', 'fwd', 'plain')] == 6 * 4 * 4
    assert counts[0] == counts[1]


# -- CudaGraphs over several cards, on a recording stand-in ------------------

class _Stream:
    def __init__(self, log, device, name):
        self.log, self.device, self.name = log, torch.device(device), name

    def wait_stream(self, other):
        self.log.append(('wait', self.name, other.name))

    def __repr__(self):
        return self.name


class _Card:
    """torch.cuda as CudaGraphs sees it, recording: streams, the current
    device and each device's current stream, captures, replays, the
    allocator's pools."""

    def __init__(self, monkeypatch, n_cards=3):
        self.log = []
        self.current_device = 0
        self.current = {i: _Stream(self.log, torch.device('cuda', i),
                                   'caller%d' % i) for i in range(n_cards)}
        self.n_streams = 0
        self.n_pools = 0
        cuda = torch.cuda
        card = self
        for name, value in (
                ('Stream', self.stream_of),
                ('current_stream', lambda d=None: self.current[
                    self.index(d)]),
                ('stream', self.stream_context),
                ('current_device', lambda: self.current_device),
                ('graph_pool_handle', self.pool_handle),
                ('empty_cache', lambda: self.log.append(('empty_cache',))),
                ('memory_reserved', lambda d: 0),
                ('memory_allocated', lambda d: 0),
                ('mem_get_info', lambda d: (1 << 30, 80 << 30))):
            monkeypatch.setattr(cuda, name, value)

        class Graph:
            def capture_begin(self, pool, capture_error_mode):
                card.log.append(('begin', card.current[card.current_device]
                                 .name, card.current_device, pool,
                                 capture_error_mode))

            def capture_end(self):
                card.log.append(('end', card.current[card.current_device]
                                 .name))

            def replay(self):
                card.log.append(('replay', card.current[0].name))

        monkeypatch.setattr(cuda, 'CUDAGraph', Graph)
        for name in ('route_to_pool', 'end_route', 'release_pool'):
            monkeypatch.setattr(graphs, '_' + name, self.recorder(name))

    def recorder(self, name):
        def record(device, pool):
            self.log.append((name, self.index(device), pool))
        return record

    def index(self, d):
        d = torch.device('cuda', self.current_device) if d is None else \
            torch.device(d)
        return self.current_device if d.index is None else d.index

    def stream_of(self, device):
        self.n_streams += 1
        return _Stream(self.log, device, 'side%d' % self.index(device))

    def pool_handle(self):
        self.n_pools += 1
        return (0, self.n_pools)

    @contextlib.contextmanager
    def stream_context(self, stream):
        i = self.index(stream.device)
        prev = self.current[i], self.current_device
        self.current[i], self.current_device = stream, i
        try:
            yield
        finally:
            self.current[i], self.current_device = prev

    def streams_now(self):
        return {i: s.name for i, s in self.current.items()}, \
            self.current_device


DEVICES = ['cuda:0', 'cuda:1', 'cuda:0', 'cuda:2']


def test_one_card_capture_is_the_plain_capture(monkeypatch):
    """Shards that all share one card: one side stream, no joins, no pool
    routing; capture() returns the graph itself."""
    card = _Card(monkeypatch)
    backend = graphs.CudaGraphs(torch.device('cuda', 0), ['cuda:0'] * 4)
    assert backend.others == () and card.n_streams == 1
    graph = backend.capture(lambda: card.log.append(('fn',)
                                                    + card.streams_now()))
    assert isinstance(graph, torch.cuda.CUDAGraph)
    assert card.log == [
        ('begin', 'side0', 0, (0, 1), 'thread_local'),
        ('fn', {0: 'side0', 1: 'caller1', 2: 'caller2'}, 0),
        ('end', 'side0')]


def test_multi_card_capture_joins_each_card_inside_and_back(monkeypatch):
    """Shards on three cards (cuda:0 repeated): the capture begins on the
    first card's side stream; each other card's side stream waits on it
    (joins), routes its card's allocations into the pool, and is current
    while the step runs, with the first card current; each is joined back
    (the first side stream waits on it) and stops routing before the
    capture ends. A replay waits on every card's current stream and has
    them wait on it. A reset releases each other card's pool once a
    capture, then empties the cache and takes a fresh pool."""
    card = _Card(monkeypatch)
    backend = graphs.CudaGraphs(torch.device('cuda', 0), DEVICES)
    assert [str(d) for d, _ in backend.others] == ['cuda:1', 'cuda:2']
    assert card.n_streams == 3
    graph = backend.capture(lambda: card.log.append(('fn',)
                                                    + card.streams_now()))
    pool = (0, 1)
    assert card.log == [
        ('begin', 'side0', 0, pool, 'thread_local'),
        ('wait', 'side1', 'side0'), ('route_to_pool', 1, pool),
        ('wait', 'side2', 'side0'), ('route_to_pool', 2, pool),
        ('fn', {0: 'side0', 1: 'side1', 2: 'side2'}, 0),
        ('wait', 'side0', 'side2'), ('end_route', 2, pool),
        ('wait', 'side0', 'side1'), ('end_route', 1, pool),
        ('end', 'side0')]
    assert card.streams_now() == ({0: 'caller0', 1: 'caller1',
                                   2: 'caller2'}, 0)

    del card.log[:]
    graph.replay()
    assert card.log == [
        ('wait', 'caller0', 'caller1'), ('wait', 'caller0', 'caller2'),
        ('replay', 'caller0'),
        ('wait', 'caller1', 'caller0'), ('wait', 'caller2', 'caller0')]

    backend.capture(lambda: None)
    del card.log[:]
    backend.reset()
    assert card.log == [('release_pool', 1, pool), ('release_pool', 2, pool),
                        ('release_pool', 1, pool), ('release_pool', 2, pool),
                        ('empty_cache',)]
    assert backend.pool == (0, 2)
    del card.log[:]
    backend.reset()
    assert card.log == [('empty_cache',)]


def test_multi_card_warm_up_runs_on_every_side_stream(monkeypatch):
    """warm() orders each card's side stream after that card's caller
    stream, runs the step with every side stream current (the first card
    current), and orders the caller streams after them."""
    card = _Card(monkeypatch)
    backend = graphs.CudaGraphs(torch.device('cuda', 0), DEVICES)
    del card.log[:]
    assert backend.warm(lambda: card.log.append(('fn',)
                                                + card.streams_now())) is None
    assert card.log == [
        ('wait', 'side0', 'caller0'), ('wait', 'side1', 'caller1'),
        ('wait', 'side2', 'caller2'),
        ('fn', {0: 'side0', 1: 'side1', 2: 'side2'}, 0),
        ('wait', 'caller0', 'side0'), ('wait', 'caller1', 'side1'),
        ('wait', 'caller2', 'side2')]


def test_a_failed_multi_card_capture_still_joins_back(monkeypatch):
    """A step that raises inside the capture: every joined stream is joined
    back and stops routing, the capture ends, the error propagates."""
    card = _Card(monkeypatch)
    backend = graphs.CudaGraphs(torch.device('cuda', 0), DEVICES)

    def fail():
        raise RuntimeError('capture failed')

    with pytest.raises(RuntimeError, match='capture failed'):
        backend.capture(fail)
    assert card.log[-5:] == [
        ('wait', 'side0', 'side2'), ('end_route', 2, (0, 1)),
        ('wait', 'side0', 'side1'), ('end_route', 1, (0, 1)),
        ('end', 'side0')]


def test_multi_card_make_room_reads_every_card(monkeypatch):
    """make_room empties the cache once when any card of the placement is
    short of free memory for its cached blocks."""
    card = _Card(monkeypatch)
    backend = graphs.CudaGraphs(torch.device('cuda', 0), DEVICES)
    free = {0: 40 << 30, 1: 40 << 30, 2: 1 << 30}
    monkeypatch.setattr(torch.cuda, 'memory_reserved', lambda d: 12 << 30)
    monkeypatch.setattr(torch.cuda, 'memory_allocated', lambda d: 2 << 30)
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda d: (
        free[card.index(d)], 80 << 30))
    before = graphs.emptied
    del card.log[:]
    backend.make_room()
    assert card.log == [('empty_cache',)]
    assert graphs.emptied - before == 1
    free[2] = 40 << 30
    backend.make_room()
    assert card.log == [('empty_cache',)]
