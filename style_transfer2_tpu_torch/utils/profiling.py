"""Profiling for the port: the span and counter recorder that the engines
and the step graphs feed (RECORDER), and device_trace, the torch.profiler
counterpart of the JAX package's jax.profiler trace
(style_transfer2_tpu/utils/profiling.py), which carries the recorder's
spans on the kernels' timeline.

Spans. A span is Span(name, t0_ns, t1_ns, parent, job, attrs, id), its
times on time.perf_counter_ns(), the clock the benchmark maps onto
torch.profiler's: parent is the id of the span open on the same thread
when it began (the span that caused it; None at the top; for a collection
see watch_gc), job the process's count of engine resets when it began
(engine/transfer.py reset, engine/batched.py add_job), so that the spans
of one image share it, and attrs a dict of what the site records. Spans are recorded only
around chunk-level calls and rare events (a graph's warm-up, capture or
release, a warm start, a content forward, a collection of the oldest
generation), a few per chunk of steps; per replay the step graphs add to
plain integers instead (engine/graphs.py). Recording is always on and
costs a few perf_counter_ns calls and a store into a ring of SPAN_RING
preallocated slots: it never grows, and the newest span overwrites the
oldest.

Counters are plain integers by name (Recorder.counters): the graphs'
warm-ups, captures and evictions, and the garbage collector's collections
of each generation once watch_gc() ran.

mirror_nvtx() also opens every span as an NVTX range (torch.cuda.nvtx),
for Nsight Systems; it is off until asked for.
"""

import collections
import gc
import itertools
import json
import os
import socket
import threading
import time
from contextlib import contextmanager
from pathlib import Path

# Slots of the span ring.
SPAN_RING = 1 << 14

# The collector's counters, by generation.
GC_COUNTERS = ('gc.gen0', 'gc.gen1', 'gc.gen2')

Span = collections.namedtuple('Span', ('name', 't0_ns', 't1_ns', 'parent',
                                       'job', 'attrs', 'id'))


class _Open:
    """A span being recorded: `with recorder.span(name, **attrs) as s`.
    s.attrs takes what is learnt inside; t0_ns and t1_ns are set on entry
    and exit."""

    __slots__ = ('rec', 'name', 'attrs', 'id', 'parent', 'job', 't0_ns',
                 't1_ns')

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.job = rec.job
        stack.append(self.id)
        if rec.nvtx is not None:
            rec.nvtx[0](self.name)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        rec = self.rec
        rec._stack().pop()
        if rec.nvtx is not None:
            rec.nvtx[1]()
        rec._store(Span(self.name, self.t0_ns, self.t1_ns, self.parent,
                        self.job, self.attrs, self.id))


class Recorder:
    """A ring of spans and a dict of counters (module docstring)."""

    def __init__(self, size=SPAN_RING):
        self.size = size
        self._ring = [None] * size
        # Slot and span numbers; next() on a count is atomic, so threads
        # and the collector's callback need no lock.
        self._slots = itertools.count()
        self._ids = itertools.count(1)
        # Each thread's open spans by id, innermost last.
        self._stacks = {}
        # Reentrant: the collector's callback counts in whatever thread
        # allocates, inside count() too.
        self._count_lock = threading.RLock()
        self.counters = {}
        self.job = 0
        # (range_push, range_pop) while spans are mirrored as NVTX ranges.
        self.nvtx = None
        self._gc_open = None

    def _stack(self):
        stack = self._stacks.get(threading.get_ident())
        if stack is None:
            stack = self._stacks[threading.get_ident()] = []
        return stack

    def _cause(self):
        """The innermost span open on this thread, else the newest span
        open on any (a collection in autograd's device thread, which runs
        an eager backward for the engine's thread), else None."""
        stack = self._stacks.get(threading.get_ident())
        if stack:
            return stack[-1]
        tops = [s[-1] for s in list(self._stacks.values()) if s]
        return max(tops) if tops else None

    def _store(self, span):
        self._ring[next(self._slots) % self.size] = span

    def span(self, name, **attrs):
        """A context manager recording one span (module docstring)."""
        return _Open(self, name, attrs)

    def count(self, name, n=1):
        with self._count_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def new_job(self):
        """An engine reset: the spans from here on belong to the next job."""
        self.job += 1

    def spans(self, names=None, since_ns=None, until_ns=None):
        """The stored spans by start time, those named in `names` (any
        name where None) that began within [since_ns, until_ns]."""
        out = [s for s in self._ring if s is not None
               and (names is None or s.name in names)
               and (since_ns is None or s.t0_ns >= since_ns)
               and (until_ns is None or s.t0_ns <= until_ns)]
        out.sort(key=lambda s: (s.t0_ns, s.id))
        return out

    def watch_gc(self):
        """From now on: each collection counted by its generation
        (counters 'gc.gen0' to 'gc.gen2'), and each of the oldest
        generation recorded as a span 'gc' with what it collected and the
        thread it ran in, its parent the span open there or else the
        newest open on any thread (_cause). Once a recorder; later calls
        do nothing."""
        if self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        gen = info['generation']
        if phase == 'start':
            self.count(GC_COUNTERS[gen])
            if gen == 2:
                self._gc_open = (time.perf_counter_ns(), self._cause())
                if self.nvtx is not None:
                    self.nvtx[0]('gc')
        elif gen == 2 and self._gc_open is not None:
            t0, parent = self._gc_open
            self._gc_open = None
            if self.nvtx is not None:
                self.nvtx[1]()
            attrs = {'collected': info['collected'],
                     'uncollectable': info['uncollectable'],
                     'thread': threading.current_thread().name}
            self._store(Span('gc', t0, time.perf_counter_ns(), parent,
                             self.job, attrs, next(self._ids)))


RECORDER = Recorder()


def mirror_nvtx(on=True):
    """Opens every span of RECORDER as an NVTX range too (on=False: no
    longer), for Nsight Systems' timeline."""
    if on:
        from torch.cuda import nvtx
        RECORDER.nvtx = (nvtx.range_push, nvtx.range_pop)
    else:
        RECORDER.nvtx = None


def chrome_events(spans, counters0, counters1, epoch_offset_ns, base_ns,
                  t0_ns, t1_ns):
    """Chrome trace events for a trace whose times are microseconds after
    base_ns on the epoch clock: each span as a complete event (its attrs,
    job, id and parent as args) on a track of its own, named 'program
    spans', and each counter that moved between counters0 and counters1
    as a counter event at t0_ns and at t1_ns. epoch_offset_ns maps a
    perf_counter_ns time onto the epoch clock."""
    pid, tid = os.getpid(), 0

    def us(t):
        return (t + epoch_offset_ns - base_ns) / 1e3

    events = [{'ph': 'M', 'name': 'thread_name', 'pid': pid, 'tid': tid,
               'args': {'name': 'program spans'}}]
    for s in spans:
        args = dict(s.attrs, job=s.job, id=s.id, parent=s.parent)
        events.append({'ph': 'X', 'cat': 'program', 'name': s.name,
                       'pid': pid, 'tid': tid, 'ts': us(s.t0_ns),
                       'dur': (s.t1_ns - s.t0_ns) / 1e3,
                       'args': {k: v if isinstance(v, (int, float, str))
                                or v is None else str(v)
                                for k, v in args.items()}})
    for name in sorted(counters1):
        if counters1[name] == counters0.get(name, 0):
            continue
        for t, value in ((t0_ns, counters0.get(name, 0)),
                         (t1_ns, counters1[name])):
            events.append({'ph': 'C', 'name': name, 'pid': pid,
                           'ts': us(t), 'args': {'value': value}})
    return events


@contextmanager
def device_trace(log_dir, device):
    """Captures a torch.profiler trace of the enclosed code: host activity
    always, and the card's kernels and copies where device is a CUDA
    device. On leaving, writes it as a Chrome trace
    (<host>.<ns>.pt.trace.json, as torch.profiler.tensorboard_trace_handler
    names it) into log_dir, for chrome://tracing, Perfetto or TensorBoard's
    profiler plugin, with RECORDER's spans of the enclosed code and the
    counters it moved (chrome_events). Yields the trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / ('%s.%d.pt.trace.json' % (socket.gethostname(),
                                                time.time_ns()))
    counters0 = dict(RECORDER.counters)
    t0_ns = time.perf_counter_ns()
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.device(device).type == 'cuda':
                torch.cuda.synchronize(device)
    t1_ns = time.perf_counter_ns()
    prof.export_chrome_trace(str(path))
    offset = time.time_ns() - time.perf_counter_ns()
    with open(path) as f:
        trace = json.load(f)
    spans = [s for s in RECORDER.spans(since_ns=t0_ns, until_ns=t1_ns)
             if s.t1_ns <= t1_ns]
    trace['traceEvents'] += chrome_events(
        spans, counters0, dict(RECORDER.counters), offset,
        int(trace.get('baseTimeNanoseconds', 0)), t0_ns, t1_ns)
    with open(path, 'w') as f:
        json.dump(trace, f)
