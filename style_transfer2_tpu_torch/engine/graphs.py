"""CUDA graphs of one optimizer step: the port of the JAX package's fused
multi-step dispatch (style_transfer2_tpu/engine/steps.py build_scan_fn,
parallel/batch.py build_masked_batched_scan_fn).

The JAX package runs K steps as one XLA program. The port captures ONE
step, and for L-BFGS the prime (the first evaluation of a stale cache), as
a CUDA graph per key, and replays it: a K-step chunk is K replays
(engine/steps.py build_scan_fn, parallel/batch.py). One step and not K,
because the web app's tuner changes K every dispatch, the CLI's chunk
tails are min(K, remaining), each step writes its own trace row, and a
graph of K steps would grow with K (the CLI's 240-step chunks would hold
some 150k nodes). L-BFGS's count and pos are device tensors, the step size
is a 0-d device tensor and Adam's bias corrections are read from 0-d
device tensors, so one graph serves every step of a run.

Static buffers. A graph reads and writes fixed tensors. The args of a step
are a tree of dicts, tuples, tensors and floats; at capture each leaf gets
a static buffer of its shape (a float: a 0-d float32 tensor). At the end
of the captured step the leaves under `writes` (the optimizer state, the
norms) are copied back into their own static buffers, and replay returns
those buffers, so between replays the caller's state lives there. Before a
replay each leaf the caller hands over is copied in unless it is its
static buffer already; a read-only leaf is also skipped when it is the
tensor copied last time, unchanged since (its version counter), and a
float is filled in only when its value changed. So a setter that rebinds
a tensor (set_input, set_content, set_style, set_temporal, set_weights,
objective_changed, a checkpoint load, a lane write) reaches the next
replay, and one that writes a static buffer in place needs no copy. The
trace row is a static output: the caller copies it into its chunk's own
rows before the next replay, so two chunks in flight never share one.

Warm-up, capture, replay. The first call at a key runs eagerly, on the
side stream that captures later: it sets up the lazy state a capture may
not create (the kernels' cudaFuncSetAttribute, cuBLAS's workspace for the
side stream, autograd's device thread, the wgmma weight blocks). The
second call captures (capture_error_mode='thread_local': the app and the
pool launch from an executor thread while the event loop may touch the
card) and replays. The caller holds its precision scope around both, so
TF32 is fixed at capture as the engine's precision says. A capture or
replay error raises; nothing falls back to the eager step.

Memory. The graphs of one StepGraphs share one private memory pool. That
is safe whatever order they replay in: nothing allocated inside a capture
outlives it (the static buffers and the output row are allocated before
the capture begins, the step's own tensors are dead at its end), and the
graphs replay one after another on the caller's stream. The warm-up's
blocks stay cached in the ordinary pool, and a capture cannot free them
when it runs out of memory; so where the card's free memory is less than
those cached blocks (a large grid: the capture will want about as much
again), the capture gives them back first, which waits for the card
(`emptied` counts it), and not otherwise. An engine drops
its graphs when it warm-starts to another grid (a ladder never comes back
to a rung), and keeps at most MAX_GRAPHS, least recently used first out:
a prime and a step graph for each of two objective structures, which is
what an objective change back and forth (the web app's weight edits,
video's first and chained frames) needs.

Spatial sharding. A Sharded leaf (parallel/spatial.py) flattens into one
leaf a shard, its path ending in a ShardOf (the sharded axis, the shard's
index), and each shard's static buffer lives on its shard's device; the
tree is rebuilt with a Sharded of the static shards on the same axis. So
the sharded iterate, history, moments, content taps and temporal target
follow the copy-in rules above shard by shard, a setter that places a new
Sharded reaches the next replay, and a leaf of another layout raises
(another shard count or axis: another structure; other extents: another
shape; another device). The trace row stays one float32 buffer on the
first device. Shards that share one card (a device repeated in the mesh)
are captured as any step is: every .to between them is the tensor itself.
Shards on several cards are one capture too (CudaGraphs with `devices`):
it begins on the first card's side stream; each other card's side stream
joins it by waiting on an event recorded inside the capture, is that
card's current stream while the step runs (a copy between cards orders
itself after the current streams of both, and autograd runs a card's
backward on the stream its forward used), allocates into a private pool
on its card, and is joined back before the capture ends. A replay then
orders the first card's stream after every other card's current stream
(the copy-in) and theirs after it.

Rematerialization. A remat engine's step (models/vgg19.py) is captured
and replayed like any other: the recomputed forward runs inside
autograd's backward, on the capture stream, into the graphs' pool. The
key has no remat field: the policy is fixed per engine, and a polish
engine is a new engine with its own graphs.

Launch accounting. A replay does not call the kernels' Python wrappers,
so each graph records the launches its capture made (ops/conv.py
path_launches and the flat counters of ops/style.py, ops/reduce.py,
ops/image.py, ops/pool.py and ops/epilogue.py, _COUNTERS), takes them
back off the counters (a capture runs nothing), and credits them again on
every replay, from a plan made at the capture: a few dict and attribute
additions, no lookup by name. `replays` and `captures` count what every
engine did (chip_smoke.py reads them).

Recording (utils/profiling.py RECORDER). A warm-up, a capture and the
release of the graphs' pool are spans ('graphs.warm', 'graphs.capture',
'graphs.release'); warm-ups, captures and evictions (graphs dropped
beyond MAX_GRAPHS) are counters ('graphs.warms', 'graphs.captures',
'graphs.evictions'). A replay records no span: it adds its own host
nanoseconds (flatten, copy-in, launch credit) to `replay_own_ns` and those
of the launch call alone, where a full launch queue holds the host, to
`replay_launch_ns`; the engines' 'engine.begin' spans take a chunk's share
of each (tally).
"""

import collections
import contextlib
import sys
import time

import torch

from ..ops import conv, epilogue, image, pool, reduce, style
from ..parallel.spatial import Sharded
from ..utils.profiling import RECORDER

# Least recently used graphs beyond this many are dropped (docstring).
MAX_GRAPHS = 4

replays = 0
# Host ns of every replay: its own (flatten, copy-in, credit) and its
# launch call's (module docstring).
replay_own_ns = 0
replay_launch_ns = 0
# Captures that first gave the ordinary pool's cached blocks back
# (CudaGraphs.make_room).
emptied = 0
# One entry a capture, newest last: {'kind', 'hw', 'lanes', 'dtype',
# 'shards', 'seconds'}, the seconds those of its 'graphs.capture' span
# (chip_smoke.py reports capture seconds from it).
captures = collections.deque(maxlen=256)

# What a graph is captured for: kind 'step' or 'prime', the ObjectiveSpec,
# the optimizer, the grid, the lanes (1 for the single engine), the
# compute dtype, the L-BFGS history's dtype (None for Adam) and its
# length, and the iterate's layout: None, or for a Sharded iterate its
# sharded axis and its shards' devices (H or W follows from the grid).
GraphKey = collections.namedtuple('GraphKey', (
    'kind', 'spec', 'optimizer', 'hw', 'lanes', 'dtype', 'history_dtype',
    'n_corr', 'layout'))

# The last element of a shard's path: the Sharded's axis and the shard's
# index in it.
ShardOf = collections.namedtuple('ShardOf', ('axis', 'index'))


def _flatten(tree, path=()):
    """[(path, leaf)] of a tree of dicts (by sorted key), tuples and lists
    (by position), with tensors, floats and None (no buffer) as leaves; a
    Sharded gives one leaf a shard, at path + (ShardOf(axis, i),)."""
    if isinstance(tree, Sharded):
        return [(path + (ShardOf(tree.axis, i),), shard)
                for i, shard in enumerate(tree.shards)]
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], path + (key,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, leaf in enumerate(tree):
            out += _flatten(leaf, path + (i,))
        return out
    return [(path, tree)]


def _rebuild(tree, leaves):
    """tree's structure with the leaves from the iterator `leaves`, in
    _flatten's order."""
    if isinstance(tree, Sharded):
        return Sharded([next(leaves) for _ in tree.shards], tree.axis)
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(leaf, leaves) for leaf in tree)
    return next(leaves)


def _device_leaf(leaf, device):
    """A float leaf as a 0-d float32 tensor on device; others as they are."""
    if isinstance(leaf, float):
        return torch.full((), leaf, dtype=torch.float32, device=device)
    return leaf


def materialize(args, device):
    """args with every float leaf a 0-d float32 tensor on device: what the
    eager step takes."""
    leaves = (_device_leaf(leaf, device) for _, leaf in _flatten(args))
    return _rebuild(args, leaves)


def _describe(leaf):
    """A leaf's dtype, shape and device, for an error message."""
    return 'None' if leaf is None else '%s %s on %s' % (
        leaf.dtype, tuple(leaf.shape), leaf.device)


# The wrappers' flat launch counters: key -> (module of ops, attribute).
# The convs' counters are conv.path_launches, by (direction, path).
_COUNTERS = {
    ('style',): (style, 'launches'),
    ('style_gram',): (style, 'gram_launches'),
    ('style_grad',): (style, 'grad_launches'),
    ('style_gram_bf16',): (style, 'gram_bf16_launches'),
    ('style_grad_bf16',): (style, 'grad_bf16_launches'),
    ('sumsq',): (reduce, 'launches'),
    ('pool_fwd',): (pool, 'fwd_launches'),
    ('pool_bwd',): (pool, 'bwd_launches'),
    ('tap_epilogue',): (epilogue, 'launches'),
    ('preprocess',): (image, 'preprocess_launches'),
    ('deprocess',): (image, 'deprocess_launches'),
}


def _launch_counts():
    """Every kernel wrapper's launch counter, flat."""
    counts = {('conv',) + key: n for key, n in conv.path_launches.items()}
    for key, (module, attr) in _COUNTERS.items():
        counts[key] = getattr(module, attr)
    return counts


def _credit_plan(delta):
    """delta (_launch_counts' keys) as what _apply adds: ([(conv path
    key, n)], [(module, attribute, n)])."""
    paths = [(key[1:], n) for key, n in delta.items() if key[0] == 'conv']
    flat = [_COUNTERS[key] + (n,) for key, n in delta.items()
            if key[0] != 'conv']
    return paths, flat


def _apply(plan, sign=1):
    paths, flat = plan
    launches = conv.path_launches
    for key, n in paths:
        launches[key] = launches.get(key, 0) + sign * n
    for module, attr, n in flat:
        setattr(module, attr, getattr(module, attr) + sign * n)


def _credit(delta, sign=1):
    """Adds sign * delta to the wrappers' launch counters."""
    _apply(_credit_plan(delta), sign)


def tally():
    """(replays, warm-ups, captures, replays' own host ns, their launch
    calls' host ns) so far: an engine.begin span records the difference
    over its chunk."""
    counters = RECORDER.counters
    return (replays, counters.get('graphs.warms', 0),
            counters.get('graphs.captures', 0), replay_own_ns,
            replay_launch_ns)


def tally_since(before):
    """tally() less `before`, by name."""
    return dict(zip(('replays', 'warms', 'captures', 'own_ns', 'launch_ns'),
                    (b - a for a, b in zip(before, tally()))))


def _index(device):
    """A CUDA device's index (the current device's for a bare 'cuda')."""
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else \
        device.index


def _route_to_pool(device, pool):
    """From now on, device's allocations on its current stream come from
    the private pool `pool` on that card (from any thread: autograd's
    device thread too)."""
    torch._C._cuda_beginAllocateCurrentStreamToPool(_index(device), pool)


def _end_route(device, pool):
    torch._C._cuda_endAllocateToPool(_index(device), pool)


def _release_pool(device, pool):
    """Drops one capture's hold on device's private pool `pool`; its
    memory goes back at the next emptying of the cache once no capture
    holds it."""
    torch._C._cuda_releasePool(_index(device), pool)


class CudaGraphs:
    """The capture backend on the card: a side stream for warm-ups and
    captures, one private memory pool for every graph of its StepGraphs
    until they are all dropped (reset). devices: a spatial placement's
    devices (a device may repeat); each card among them other than
    `device` gets a side stream of its own and a private pool there, and
    joins every capture (module docstring)."""

    # The other cards: ((device, side stream), ...), none for one card.
    others = ()

    def __init__(self, device, devices=()):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        seen = {_index(self.device)}
        others = []
        for d in map(torch.device, devices):
            if _index(d) not in seen:
                seen.add(_index(d))
                others.append((d, torch.cuda.Stream(d)))
        self.others = tuple(others)
        # One entry a capture's hold on another card's pool.
        self._held = []

    def reset(self):
        """Once every graph of the pool is gone: its memory back to CUDA,
        on every card, and a fresh pool for the graphs captured from now
        on. The caching allocator keeps a pool whose last graph died until
        its cache is emptied, even when an allocation elsewhere runs out
        of memory, and refuses it another capture. Emptying the cache
        waits for the cards, so that a replay still in flight finishes
        first."""
        for device in self._held:
            _release_pool(device, self.pool)
        self._held = []
        torch.cuda.empty_cache()
        self.pool = torch.cuda.graph_pool_handle()

    def make_room(self):
        """Empties the allocator's cache where a card's free memory is less
        than the bytes it caches beyond those in use (mostly the warm-up's
        working set, which the capture will allocate again in the graphs'
        pool): a capture that ran out could not free them."""
        global emptied
        for device in [self.device] + [d for d, _ in self.others]:
            cached = (torch.cuda.memory_reserved(device)
                      - torch.cuda.memory_allocated(device))
            if torch.cuda.mem_get_info(device)[0] < cached:
                torch.cuda.empty_cache()
                emptied += 1
                return

    @contextlib.contextmanager
    def _current(self):
        """Each other card's side stream current on its card, then the
        first card's side stream current (the first card current)."""
        with contextlib.ExitStack() as stack:
            for _, stream in self.others:
                stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.cuda.stream(self.stream))
            yield

    def warm(self, fn):
        """fn() eagerly on the side streams, ordered after the caller's
        streams' work and before their later work."""
        callers = [(torch.cuda.current_stream(self.device), self.stream)] + [
            (torch.cuda.current_stream(d), s) for d, s in self.others]
        for caller, side in callers:
            side.wait_stream(caller)
        with self._current():
            result = fn()
        for caller, side in callers:
            caller.wait_stream(side)
        return result

    @contextlib.contextmanager
    def _joined(self):
        """Inside a capture begun on the first card's side stream: each
        other card's side stream joins it (an event recorded inside the
        capture), is current on its card and allocates into its private
        pool; at the end each is joined back (the first card's stream
        waits on it) before its pool stops taking allocations."""
        with contextlib.ExitStack() as stack:
            for device, stream in self.others:
                stack.enter_context(torch.cuda.stream(stream))
                stream.wait_stream(self.stream)
                _route_to_pool(device, self.pool)
                self._held.append(device)
                stack.callback(_end_route, device, self.pool)
                stack.callback(self.stream.wait_stream, stream)
            stack.enter_context(torch.cuda.stream(self.stream))
            yield

    def capture(self, fn):
        """fn's launches captured (not run) as a graph with replay(). The
        capture begins and ends here rather than in torch.cuda.graph, which
        first syncs the card and empties the device and pinned-host caches:
        nothing captured depends on work in flight, and a dispatch in the
        serving loop should not wait for the card or lose the caches
        (make_room does both only where memory is short)."""
        self.make_room()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode='thread_local')
            try:
                with self._joined():
                    fn()
            finally:
                graph.capture_end()
        if not self.others:
            return graph
        return _JoinedGraph(graph, self.device, [d for d, _ in self.others])


class _JoinedGraph:
    """A graph captured over several cards. replay() launches it on the
    first card's current stream after every other card's current stream
    (where the copy-in ran), and orders those after it."""

    def __init__(self, graph, device, others):
        self.graph, self.device, self.others = graph, device, others

    def replay(self):
        main = torch.cuda.current_stream(self.device)
        streams = [torch.cuda.current_stream(d) for d in self.others]
        for stream in streams:
            main.wait_stream(stream)
        self.graph.replay()
        for stream in streams:
            stream.wait_stream(main)


class _Graph:
    """One captured step over static buffers (module docstring)."""

    def __init__(self, backend, body, args, writes, out_shape, device):
        flat = _flatten(args)
        self.paths = [path for path, _ in flat]
        self.written = [path[0] in writes for path in self.paths]
        self.static = []
        for _, leaf in flat:
            if isinstance(leaf, float):
                leaf = torch.zeros((), dtype=torch.float32, device=device)
            self.static.append(None if leaf is None else torch.empty_like(
                leaf, memory_format=torch.contiguous_format))
        self.last = [None] * len(flat)
        self._copy_in(flat)
        tree = _rebuild(args, iter(self.static))
        self.out = torch.empty(out_shape, dtype=torch.float32, device=device)
        self.new = {key: tree[key] for key in writes}
        by_path = {path: buf for path, buf in zip(self.paths, self.static)}

        def step():
            new, out = body(tree)
            for path, leaf in _flatten({key: new[key] for key in writes}):
                dst = by_path[path]
                if leaf is not dst:
                    dst.copy_(leaf)
            self.out.copy_(out)

        before = _launch_counts()
        self.graph = backend.capture(step)
        after = _launch_counts()
        self.credit = _credit_plan({key: n - before.get(key, 0)
                                    for key, n in after.items()
                                    if n != before.get(key, 0)})
        _apply(self.credit, -1)

    def _copy_in(self, flat):
        for i, (_, leaf) in enumerate(flat):
            dst = self.static[i]
            if isinstance(leaf, float):
                if leaf != self.last[i]:
                    dst.fill_(leaf)
                    self.last[i] = leaf
                continue
            if leaf is dst:
                continue
            if (leaf is None or dst is None or leaf.shape != dst.shape
                    or leaf.dtype != dst.dtype or leaf.device != dst.device):
                raise ValueError('step graph: %s is %s, captured as %s' % (
                    '/'.join(map(str, self.paths[i])), _describe(leaf),
                    _describe(dst)))
            if not self.written[i]:
                last = self.last[i]
                if (last is not None and last[0] is leaf
                        and last[1] == leaf._version):
                    continue
                self.last[i] = (leaf, leaf._version)
            dst.copy_(leaf)

    def replay(self, args):
        """Copies args in, replays; returns (the written static subtrees,
        the static output row)."""
        global replays, replay_own_ns, replay_launch_ns
        t0 = time.perf_counter_ns()
        flat = _flatten(args)
        if [path for path, _ in flat] != self.paths:
            raise ValueError('step graph: the args do not have the captured '
                             'structure')
        self._copy_in(flat)
        t1 = time.perf_counter_ns()
        self.graph.replay()
        t2 = time.perf_counter_ns()
        _apply(self.credit)
        replays += 1
        replay_launch_ns += t2 - t1
        replay_own_ns += t1 - t0 + time.perf_counter_ns() - t2
        return self.new, self.out


class StepGraphs:
    """An engine's captured steps, by key. run() is the eager step where
    there is no backend (the CPU), else warm-up, capture and replay."""

    def __init__(self, backend=None):
        self.backend = backend
        self._graphs = collections.OrderedDict()
        self._warm = set()
        RECORDER.watch_gc()

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        """Drops every graph, and with them their memory pool. A launch
        still in flight completes: CUDA frees its graph after it."""
        held = len(self._graphs)
        self._graphs.clear()
        self._warm.clear()
        if held and self.backend is not None:
            with RECORDER.span('graphs.release', graphs=held):
                self.backend.reset()

    def __del__(self):
        # An engine that goes drops its graphs before its backend, so that
        # their pool's memory goes back too.
        if getattr(self, '_graphs', None) and not sys.is_finalizing():
            self.clear()

    def run(self, key, body, args, writes, out_shape, device):
        """One step at key (a GraphKey). body(args) -> (new, out), where
        new holds the args' subtrees under `writes` advanced by one step
        and out the step's trace row (out_shape, float32). Returns (new,
        out): on a replay, the static buffers, valid until the next replay
        at this key."""
        if self.backend is None:
            return body(materialize(args, device))
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph.replay(args)
        attrs = {'kind': key.kind, 'hw': key.hw, 'lanes': key.lanes,
                 'dtype': str(key.dtype).replace('torch.', ''),
                 'shards': 1 if key.layout is None else len(key.layout[1])}
        if key not in self._warm:
            # Kept after the capture too: a key evicted and met again
            # captures at once.
            self._warm.add(key)
            RECORDER.count('graphs.warms')
            with RECORDER.span('graphs.warm', **attrs):
                return self.backend.warm(
                    lambda: body(materialize(args, device)))
        before = emptied
        with RECORDER.span('graphs.capture', **attrs) as span:
            graph = _Graph(self.backend, body, args, writes, out_shape,
                           device)
            span.attrs['emptied'] = emptied - before
        RECORDER.count('graphs.captures')
        captures.append(dict(attrs, seconds=(span.t1_ns - span.t0_ns) * 1e-9))
        self._graphs[key] = graph
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
            RECORDER.count('graphs.evictions')
        return graph.replay(args)
