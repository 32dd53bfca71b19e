"""The traced part of a --trace 1 run: torch.profiler over whole jobs after the
window, read into device intervals, kernel classes and the idle gaps between
them.

Only the card's activity is recorded (ProfilerActivity.CUDA): kernels,
copies and sets, also those a CUDA graph's replay launches. A job ends with
its final image on the host, so every piece of work enqueued inside the
traced part runs inside it. Times are on the profiler's clock (nanoseconds
since the epoch), which driver.epoch_ns maps host times onto.
"""

import json
import re
from pathlib import Path

import torch

from .driver import epoch_ns, now

KERNELS = Path(__file__).resolve().parents[1] / 'kernels'


def kernel_classes():
    """[(class name, [compiled patterns])] in priority order, from the
    pattern files under benchmark/kernels/."""
    out = []
    for path in sorted(KERNELS.glob('*.json')):
        spec = json.loads(path.read_text())
        out.append((spec['priority'], path.stem,
                    [re.compile(p) for p in spec['patterns']]))
    return [(name, pats) for _, name, pats in sorted(out)]


def classify(name, classes):
    for cls, pats in classes:
        if any(p.search(name) for p in pats):
            return cls
    return None


class Tracer:
    def __init__(self, spec):
        self.spec = dict(spec)
        self.prof = None
        self.t0 = self.t1 = None
        self.events = []       # (name, start_ns, end_ns) on the device

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = now()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = now()
        self.prof.stop()
        self.events = _device_events(self.prof)
        self.prof = None

    # -- reading --------------------------------------------------------

    def window_ns(self):
        return epoch_ns(self.t0), epoch_ns(self.t1)

    def clipped(self):
        lo, hi = self.window_ns()
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.events
                if b > lo and a < hi]

    def busy_intervals(self):
        merged = []
        for _, a, b in sorted(self.clipped(), key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def window_s(self):
        lo, hi = self.window_ns()
        return (hi - lo) * 1e-9

    def seconds_by_name(self):
        out = {}
        for n, a, b in self.clipped():
            out[n] = out.get(n, 0.0) + (b - a) * 1e-9
        return out

    def class_seconds(self, classes):
        """{class or None: device seconds} over the traced part."""
        out = {}
        for n, s in self.seconds_by_name().items():
            c = classify(n, classes)
            out[c] = out.get(c, 0.0) + s
        return out

    def idle_gaps(self, spans):
        """[(label, seconds)]: the gaps between device work inside the
        traced part, each labelled by the innermost host span of the driver
        that was open when it began."""
        lo, hi = self.window_ns()
        edges = [lo] + [x for ab in self.busy_intervals() for x in ab] + [hi]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        spans_ns = [(name, epoch_ns(s0), epoch_ns(s1))
                    for name, s0, s1 in spans]
        out = []
        for a, b in gaps:
            open_ = [(s1 - s0, name) for name, s0, s1 in spans_ns
                     if s0 <= a < s1]
            label = min(open_)[1] if open_ else 'host: between driver calls'
            out.append((label, (b - a) * 1e-9))
        return out


def _device_events(prof):
    """(name, start_ns, end_ns) of every device activity in a profile (the
    harness records no annotation, so each is a kernel, copy or set)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out
