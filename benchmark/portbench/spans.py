"""Readings of the program's own spans (style_transfer2_tpu_torch/utils/
profiling.py RECORDER, in the process the run drives), which the harness's
host clock cannot see: the step graphs' builds and releases, the host's own
time per replay, the card's idle time under the builds. Each gives None
where the program records no spans (a program without the recorder)."""

from .driver import epoch_ns

BUILD = ('graphs.warm', 'graphs.capture', 'graphs.release')


def recorder():
    """The program's recorder, or None."""
    try:
        from style_transfer2_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    return RECORDER


def graph_build_s(ctx):
    """Host seconds an image spends in 'graphs.warm' (a key's eager first
    call), 'graphs.capture' and 'graphs.release' (the old grid's graph pool
    going back at a warm start): summed over the window's finished images,
    over their number."""
    rec = recorder()
    done = [j for j in ctx.record.jobs
            if j['finished'] and ctx.t0 <= j['t0'] and j['t1'] <= ctx.t1]
    if rec is None or not done:
        return None
    spans = rec.spans(BUILD)
    total_ns = 0
    for j in done:
        total_ns += sum(s.t1_ns - s.t0_ns for s in spans
                        if j['t0'] <= s.t0_ns * 1e-9 <= j['t1'])
    return total_ns * 1e-9 / sum(j['lanes'] for j in done)


def replay_host_us(ctx):
    """The program's own host us a replay (flatten, copy-in, launch
    credit), its launch call excluded: the own_ns of the window's
    'engine.begin' spans over their replays."""
    rec = recorder()
    if rec is None:
        return None
    spans = [s for s in rec.spans(('engine.begin',))
             if ctx.t0 <= s.t0_ns * 1e-9 <= ctx.t1]
    replays = sum(s.attrs['replays'] for s in spans)
    if not replays:
        return None
    return sum(s.attrs['own_ns'] for s in spans) * 1e-3 / replays


def _union(intervals):
    merged = []
    for a, b in sorted(ab for ab in intervals if ab[1] > ab[0]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_in_build_pct(ctx):
    """The share of the traced part in which the card is idle (the gaps of
    trace.busy_intervals) while a build span is open, the spans mapped onto
    the profiler's clock by epoch_ns."""
    rec, tr = recorder(), ctx.trace
    if rec is None or tr is None or tr.window_s() <= 0 or not tr.events:
        return None
    lo, hi = tr.window_ns()
    edges = [lo] + [x for ab in tr.busy_intervals() for x in ab] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    build = _union((max(epoch_ns(s.t0_ns * 1e-9), lo),
                    min(epoch_ns(s.t1_ns * 1e-9), hi))
                   for s in rec.spans(BUILD))
    overlap_ns = sum(max(0, min(b, d) - max(a, c))
                     for a, b in idle for c, d in build)
    return 100.0 * overlap_ns * 1e-9 / tr.window_s()
