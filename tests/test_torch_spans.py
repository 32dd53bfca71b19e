"""The port's span and counter recorder (utils/profiling.py) and the spans
and counters the engines and the step graphs feed it (engine/transfer.py,
engine/batched.py, engine/graphs.py).

On the CPU: the ring, nesting, the clock the benchmark's driver reads,
counters, the collector's spans, the NVTX mirror, the spans in the
--profile trace, the launch credit, and the engine's spans on a 2-rung
ladder of the single engine and on the batched engine (eager: no replay,
no capture), and the graphs' spans with a stand-in of the capture backend.
Tests marked `cuda` run on the card: a grid's warm-ups and captures, and a
replay's kernels inside its span on torch.profiler's clock. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import gc
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer2_tpu_torch.engine import StyleTransfer, graphs
from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
from style_transfer2_tpu_torch.models.weights import random_params
from style_transfer2_tpu_torch.ops import conv, style
from style_transfer2_tpu_torch.utils import profiling
from style_transfer2_tpu_torch.utils.profiling import (RECORDER, Recorder,
                                                       Span, chrome_events,
                                                       device_trace)

BENCH = Path(__file__).resolve().parents[1] / 'benchmark'

WEIGHTS = {'content': {'conv2_2': 0.1},
           'style': {'conv1_1': 1.0, 'conv2_1': 1.0}, 'deepdream': {}}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
ENGINE = ('engine.begin', 'engine.collect', 'engine.collect.wait',
          'engine.warm_start', 'engine.content')
GRAPHS = ('graphs.warm', 'graphs.capture', 'graphs.release')


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the shapes are tiny, and the test runner runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver():
    sys.path.insert(0, str(BENCH))
    from portbench import driver
    return driver


def _image(seed, hw):
    return np.random.RandomState(seed).randint(
        0, 256, tuple(hw) + (3,)).astype(np.uint8)


def _engine(hw, device='cpu', precision='float32'):
    st = StyleTransfer(random_params(3), precision=precision, device=device)
    st.set_weights(WEIGHTS, SCALARS)
    st.set_optimizer('lbfgs')
    st.set_step_size(1.0)
    st.set_content(_image(1, hw))
    st.set_style(_image(2, hw))
    st.set_input(_image(3, hw))
    assert st.start()
    return st


class FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class FakeGraphs:
    """engine/graphs.py CudaGraphs without a card: warm() runs the step,
    capture() records it, reset() releases nothing."""

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        return FakeGraph(fn)

    def reset(self):
        pass


# -- the recorder -------------------------------------------------------------

def test_ring_overwrites_its_oldest_spans_and_never_grows():
    rec = Recorder(size=8)
    ring = rec._ring
    for i in range(13):
        with rec.span('s%d' % i):
            pass
        assert rec._ring is ring and len(ring) == 8
    assert [s.name for s in rec.spans()] == ['s%d' % i for i in range(5, 13)]
    assert [s.name for s in rec.spans(names=('s7', 's3'))] == ['s7']


def test_child_spans_nest_inside_their_parents():
    rec = Recorder()
    with rec.span('outer', a=1) as outer:
        with rec.span('child') as child:
            with rec.span('grandchild'):
                pass
        with rec.span('sibling') as sibling:
            sibling.attrs['late'] = 2
    with rec.span('top'):
        pass
    spans = {s.name: s for s in rec.spans()}
    assert spans['outer'].parent is None and spans['top'].parent is None
    assert spans['child'].parent == outer.id
    assert spans['sibling'].parent == outer.id
    assert spans['grandchild'].parent == child.id
    assert spans['outer'].attrs == {'a': 1}
    assert spans['sibling'].attrs == {'late': 2}
    for name in ('child', 'grandchild', 'sibling'):
        inner, parent = spans[name], spans['outer']
        assert parent.t0_ns <= inner.t0_ns <= inner.t1_ns <= parent.t1_ns
    assert spans['sibling'].t0_ns >= spans['child'].t1_ns
    # By start time, a parent before its children.
    assert [s.name for s in rec.spans()] == [
        'outer', 'child', 'grandchild', 'sibling', 'top']


def test_spans_are_on_the_clock_of_the_benchmark_driver():
    driver = _driver()
    rec = Recorder()
    before = driver.now()
    with rec.span('x') as span:
        time.sleep(0.002)
    after = driver.now()
    assert before <= span.t0_ns * 1e-9 <= span.t1_ns * 1e-9 <= after
    assert span.t1_ns - span.t0_ns >= 2_000_000
    # epoch_ns puts it on the profiler's clock (ns since the epoch).
    assert abs(driver.epoch_ns(span.t0_ns * 1e-9) - time.time_ns()) < 1e9


def test_counters_and_jobs():
    rec = Recorder()
    rec.count('a')
    rec.count('a', 2)
    assert rec.counters == {'a': 3}
    with rec.span('before'):
        pass
    rec.new_job()
    with rec.span('after'):
        rec.new_job()          # a span keeps the job it began in
    jobs = {s.name: s.job for s in rec.spans()}
    assert jobs == {'before': 0, 'after': 1}


def test_collections_are_counted_and_the_oldest_generation_spanned():
    rec = Recorder()
    rec.watch_gc()
    rec.watch_gc()
    try:
        assert gc.callbacks.count(rec._on_gc) == 1
        with rec.span('work') as work:
            gc.collect()
    finally:
        gc.callbacks.remove(rec._on_gc)
    assert rec.counters['gc.gen2'] >= 1
    [span] = [s for s in rec.spans() if s.name == 'gc']
    assert span.parent == work.id
    assert set(span.attrs) == {'collected', 'uncollectable', 'thread'}
    assert span.attrs['thread'] == threading.current_thread().name
    assert work.t0_ns <= span.t0_ns <= span.t1_ns <= work.t1_ns


def test_a_collection_in_another_thread_is_put_down_to_the_open_span():
    """Autograd's device thread runs an eager backward for the engine's
    thread: a collection there belongs to the span the engine has open."""
    rec = Recorder()
    rec.watch_gc()
    worker = threading.Thread(target=gc.collect, name='collector')
    try:
        with rec.span('outer'):
            with rec.span('work') as work:
                worker.start()
                worker.join(timeout=60)
    finally:
        gc.callbacks.remove(rec._on_gc)
    assert not worker.is_alive()
    [span] = [s for s in rec.spans() if s.name == 'gc']
    assert span.parent == work.id and span.attrs['thread'] == 'collector'


def test_nvtx_mirror_is_off_until_asked_for(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, 'range_push',
                        lambda name: calls.append(('push', name)))
    monkeypatch.setattr(torch.cuda.nvtx, 'range_pop',
                        lambda: calls.append(('pop',)))
    with RECORDER.span('quiet'):
        pass
    assert calls == []
    profiling.mirror_nvtx()
    try:
        with RECORDER.span('outer'):
            with RECORDER.span('inner'):
                pass
    finally:
        profiling.mirror_nvtx(False)
    with RECORDER.span('quiet'):
        pass
    assert calls == [('push', 'outer'), ('push', 'inner'), ('pop',),
                     ('pop',)]


def test_chrome_events_map_spans_and_moved_counters():
    spans = [Span('engine.begin', 5_000, 9_000, None, 2,
                  {'steps': 60, 'hw': (96, 128)}, 1)]
    events = chrome_events(spans, {'a': 1, 'b': 4}, {'a': 3, 'b': 4},
                           epoch_offset_ns=1_000_000, base_ns=6_000,
                           t0_ns=4_000, t1_ns=10_000)
    [meta, span, a0, a1] = events
    assert meta['args'] == {'name': 'program spans'}
    assert span['ph'] == 'X' and span['name'] == 'engine.begin'
    assert span['ts'] == pytest.approx((5_000 + 1_000_000 - 6_000) / 1e3)
    assert span['dur'] == pytest.approx(4.0)
    assert span['args'] == {'steps': 60, 'hw': '(96, 128)', 'job': 2,
                            'id': 1, 'parent': None}
    assert [(c['name'], c['args']['value']) for c in (a0, a1)] == [
        ('a', 1), ('a', 3)]
    assert a1['ts'] - a0['ts'] == pytest.approx(6.0)
    json.dumps(events)


def test_profile_trace_carries_the_spans_on_its_timeline(tmp_path):
    """device_trace on the CPU: a span recorded between two ops lies
    between them on the trace's timeline."""
    x = torch.ones(64, 64)
    with device_trace(tmp_path, 'cpu') as path:
        torch.mm(x, x)
        time.sleep(0.002)
        with RECORDER.span('test.between'):
            time.sleep(0.002)
        time.sleep(0.002)
        torch.add(x, x)
    events = json.loads(Path(path).read_text())['traceEvents']
    [span] = [e for e in events if e.get('name') == 'test.between']
    assert span['cat'] == 'program' and span['dur'] >= 2000
    [mm] = [e for e in events if e.get('name') == 'aten::mm']
    [add] = [e for e in events if e.get('name') == 'aten::add']
    assert mm['ts'] + mm['dur'] < span['ts']
    assert span['ts'] + span['dur'] < add['ts']


# -- the launch credit ---------------------------------------------------------

def test_credit_plan_adds_and_takes_back(monkeypatch):
    monkeypatch.setattr(conv, 'path_launches', {('fwd', 'tile'): 5})
    monkeypatch.setattr(style, 'launches', 7)
    delta = {('conv', 'fwd', 'tile'): 3, ('conv', 'bwd', 'narrow'): 1,
             ('style',): 4}
    plan = graphs._credit_plan(delta)
    graphs._apply(plan)
    graphs._apply(plan)
    assert conv.path_launches == {('fwd', 'tile'): 11, ('bwd', 'narrow'): 2}
    assert style.launches == 15
    graphs._credit(delta, -1)
    assert graphs._launch_counts()[('conv', 'fwd', 'tile')] == 8
    assert style.launches == 11
    # A rebound conv.path_launches is the one credited.
    monkeypatch.setattr(conv, 'path_launches', {})
    graphs._apply(plan)
    assert conv.path_launches == {('fwd', 'tile'): 3, ('bwd', 'narrow'): 1}


# -- the engines' spans ----------------------------------------------------------

def _since(t0_ns, names):
    return RECORDER.spans(names=names, since_ns=t0_ns)


def test_single_engine_spans_on_a_two_rung_ladder():
    rungs = [(16, 24), (24, 32)]
    t0 = time.perf_counter_ns()
    st = _engine(rungs[0])
    job = RECORDER.job
    for r, hw in enumerate(rungs):
        if r:
            st.resample_input(hw)
            st.set_content(_image(4, hw))
            assert st.start()
        a = st.begin_steps(2)
        b = st.begin_steps(1)
        st.collect_steps_many([a, b], fetch_image=r == len(rungs) - 1)
    spans = _since(t0, ENGINE + GRAPHS)
    names = [s.name for s in spans]
    assert not set(names) & set(GRAPHS)
    begins = [s for s in spans if s.name == 'engine.begin']
    assert [(s.attrs['steps'], s.attrs['primed']) for s in begins] == [
        (2, True), (1, False), (2, True), (1, False)]
    for s in begins:
        assert (s.attrs['replays'], s.attrs['warms'],
                s.attrs['captures']) == (0, 0, 0)
    collects = [s for s in spans if s.name == 'engine.collect']
    assert [s.attrs['chunks'] for s in collects] == [2, 2]
    waits = [s for s in spans if s.name == 'engine.collect.wait']
    # The rows' copy on each rung, the images' on the last.
    assert [w.parent for w in waits] == [collects[0].id] + [
        collects[1].id] * 2
    [warm] = [s for s in spans if s.name == 'engine.warm_start']
    assert warm.attrs['hw'] == rungs[1]
    contents = [s for s in spans if s.name == 'engine.content']
    assert [s.attrs['hw'] for s in contents] == rungs
    assert all(s.t0_ns > warm.t1_ns for s in contents[1:])
    # One job: no reset after the start.
    assert {s.job for s in begins} == {job}


def test_batched_engine_spans():
    hw = (16, 16)
    t0 = time.perf_counter_ns()
    bt = BatchedStyleTransfer(random_params(3), WEIGHTS, SCALARS, hw, 2,
                              optimizer='lbfgs', device='cpu')
    job = RECORDER.job
    for lane in range(2):
        bt.add_job(_image(lane, hw), _image(5, hw), _image(6 + lane, hw))
    assert RECORDER.job == job + 2
    handle = bt.begin_steps_all(2)
    bt.collect_steps_all(handle)
    spans = _since(t0, ENGINE + GRAPHS)
    [begin, collect, wait] = spans
    assert (begin.name, collect.name, wait.name) == (
        'engine.begin', 'engine.collect', 'engine.collect.wait')
    assert begin.attrs == {'steps': 2, 'lanes': 2, 'primed': True,
                           'replays': 0, 'warms': 0, 'captures': 0,
                           'own_ns': 0, 'launch_ns': 0}
    assert wait.parent == collect.id and collect.parent is None


def test_graph_spans_counters_and_capture_seconds():
    """With a stand-in of the capture backend: a grid's two warm-ups and
    its captures as spans inside engine.begin, the release inside
    engine.warm_start, the capture ring's seconds the capture span's, the
    replay accumulators, and evictions past MAX_GRAPHS."""
    t0 = time.perf_counter_ns()
    st = _engine((16, 24))
    st._graphs = graphs.StepGraphs(FakeGraphs())
    counters = dict(RECORDER.counters)
    own, launch = graphs.replay_own_ns, graphs.replay_launch_ns
    st.collect_steps(st.begin_steps(3), fetch_image=False)
    st.reset()
    st.collect_steps(st.begin_steps(2), fetch_image=False)
    st.resample_input((24, 32))
    spans = _since(t0, ENGINE + GRAPHS)
    begins = [s for s in spans if s.name == 'engine.begin']
    assert [(b.attrs['replays'], b.attrs['warms'], b.attrs['captures'])
            for b in begins] == [(2, 2, 1), (3, 0, 1)]
    assert sum(b.attrs['own_ns'] for b in begins) == \
        graphs.replay_own_ns - own > 0
    assert sum(b.attrs['launch_ns'] for b in begins) == \
        graphs.replay_launch_ns - launch > 0
    builds = [s for s in spans if s.name in GRAPHS]
    assert [(s.name, s.attrs.get('kind')) for s in builds] == [
        ('graphs.warm', 'prime'), ('graphs.warm', 'step'),
        ('graphs.capture', 'step'), ('graphs.capture', 'prime'),
        ('graphs.release', None)]
    assert [s.parent for s in builds[:3]] == [begins[0].id] * 3
    assert builds[3].parent == begins[1].id
    [warm] = [s for s in spans if s.name == 'engine.warm_start']
    assert builds[4].parent == warm.id and builds[4].attrs == {'graphs': 2}
    assert builds[0].attrs == {'kind': 'prime', 'hw': (16, 24), 'lanes': 1,
                               'dtype': 'float32', 'shards': 1}
    assert builds[2].attrs['emptied'] == 0
    entry = graphs.captures[-1]
    assert entry == {'kind': 'prime', 'hw': (16, 24), 'lanes': 1,
                     'dtype': 'float32', 'shards': 1,
                     'seconds': (builds[3].t1_ns - builds[3].t0_ns) * 1e-9}
    moved = {k: RECORDER.counters.get(k, 0) - counters.get(k, 0)
             for k in ('graphs.warms', 'graphs.captures',
                       'graphs.evictions')}
    assert moved == {'graphs.warms': 2, 'graphs.captures': 2,
                     'graphs.evictions': 0}


def test_graphs_beyond_the_limit_are_counted_as_evictions():
    sg = graphs.StepGraphs(FakeGraphs())
    evictions = RECORDER.counters.get('graphs.evictions', 0)

    def body(args):
        return {'state': {'x': args['state']['x'] + 1}}, torch.zeros(1)

    args = {'state': {'x': torch.zeros(2)}}
    for i in range(graphs.MAX_GRAPHS + 2):
        key = graphs.GraphKey('step', i, 'lbfgs', (1, 2), 1, torch.float32,
                              None, None, None)
        sg.run(key, body, args, ('state',), (1,), 'cpu')
        sg.run(key, body, args, ('state',), (1,), 'cpu')
    assert len(sg) == graphs.MAX_GRAPHS
    assert RECORDER.counters['graphs.evictions'] - evictions == 2


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA is not available here)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_one_grid_builds_twice_then_only_replays(cuda):
    """An L-BFGS grid: the prime's and the step's eager first calls and
    their captures (the step's in the first job, the prime's at the next
    job's prime), then replays alone."""
    t0 = time.perf_counter_ns()
    st = _engine((96, 128), cuda)
    st.collect_steps(st.begin_steps(3), fetch_image=False)
    st.reset()
    st.collect_steps(st.begin_steps(3), fetch_image=False)
    builds = _since(t0, GRAPHS)
    assert [(s.name, s.attrs['kind']) for s in builds] == [
        ('graphs.warm', 'prime'), ('graphs.warm', 'step'),
        ('graphs.capture', 'step'), ('graphs.capture', 'prime')]
    t1 = time.perf_counter_ns()
    st.reset()
    st.collect_steps(st.begin_steps(3), fetch_image=False)
    assert _since(t1, GRAPHS) == []
    [begin] = _since(t1, ('engine.begin',))
    assert (begin.attrs['replays'], begin.attrs['warms'],
            begin.attrs['captures']) == (4, 0, 0)
    assert begin.attrs['own_ns'] > 0 and begin.attrs['launch_ns'] > 0


# A replay's kernels against its span, both on the profiler's clock. The
# span is mapped by the benchmark's epoch_ns (perf_counter onto time_ns,
# read once at import); the profiler stamps kernels with the card's timer
# mapped onto the host's clock. Those two mappings agree to microseconds,
# so 100 us is the tolerance: a tenth of a millisecond against a 384x512
# float32 step of about 8 ms, so that a clock off by a step's length, or
# spans on another clock, fail.
SPAN_TOL_NS = 100_000


@pytest.mark.cuda
def test_a_span_encloses_its_replays_kernels(cuda):
    from torch.profiler import ProfilerActivity, profile
    driver = _driver()
    from portbench.trace import _device_events
    st = _engine((384, 512), cuda)
    st.collect_steps(st.begin_steps(2), fetch_image=False)
    st.reset()
    st.collect_steps(st.begin_steps(2), fetch_image=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with RECORDER.span('test.replay') as span:
            handle = st.begin_steps(1)
            torch.cuda.synchronize()
        torch.cuda.synchronize()
    st.collect_steps(handle, fetch_image=False)
    events = _device_events(prof)
    assert len(events) >= 20, events
    lo = driver.epoch_ns(span.t0_ns * 1e-9)
    hi = driver.epoch_ns(span.t1_ns * 1e-9)
    first = min(a for _, a, _ in events)
    last = max(b for _, _, b in events)
    print('span %.1f us; first kernel %.1f us after its start, last %.1f us '
          'before its end' % ((hi - lo) / 1e3, (first - lo) / 1e3,
                              (hi - last) / 1e3))
    assert lo - SPAN_TOL_NS <= first and last <= hi + SPAN_TOL_NS
    # The step's own kernels fill most of the span.
    assert last - first > (hi - lo) / 2
