"""The readers of the program's spans (graph_build_s.ladder,
replay_host_us.ladder, idle_in_build_pct.ladder) on synthetic spans, jobs
and a synthetic Tracer, and on a program that records no spans (CPU)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench.driver import Record, epoch_ns  # noqa: E402
from portbench.trace import Tracer  # noqa: E402
from style_transfer2_tpu_torch.utils import profiling  # noqa: E402
from style_transfer2_tpu_torch.utils.profiling import (  # noqa: E402
    Recorder, Span)

READERS = ('graph_build_s.ladder', 'replay_host_us.ladder',
           'idle_in_build_pct.ladder')
MS = 1_000_000


def _read(name, ctx):
    return core.load_reader(BENCH / 'metrics' / (name + '.py'))(ctx)


def _ns(seconds):
    return int(round(seconds * 1e9))


@pytest.fixture
def rec(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, 'RECORDER', rec)
    return rec


def _span(rec, name, t0, t1, **attrs):
    """A span from t0 to t1 seconds on perf_counter."""
    rec._store(Span(name, _ns(t0), _ns(t1), None, 0, attrs, next(rec._ids)))


def _ctx(trace=None):
    r = Record()
    r.jobs += [{'job': 0, 't0': 0.5, 't1': 1.5, 'finished': True,
                'lanes': 1},
               {'job': 1, 't0': 1.5, 't1': 2.5, 'finished': True,
                'lanes': 1},
               {'job': 2, 't0': 2.5, 't1': 2.9, 'finished': False,
                'lanes': 1},
               {'job': 3, 't0': 3.5, 't1': 4.5, 'finished': True,
                'lanes': 1}]
    return core.Context(record=r, t0=0.4, t1=3.0, trace=trace, config={},
                        traffic={}, classes=[], cell={}, setup_s=1.0,
                        peak_bytes=0)


def test_graph_build_s_sums_an_image_s_builds(rec):
    _span(rec, 'graphs.warm', 0.6, 0.7)          # job 0: 0.1 + 0.1
    _span(rec, 'graphs.capture', 0.8, 0.9)
    _span(rec, 'engine.begin', 0.6, 1.0)         # not a build
    _span(rec, 'graphs.release', 1.6, 1.9)       # job 1: 0.3 + 0.1
    _span(rec, 'graphs.warm', 2.0, 2.1)
    _span(rec, 'graphs.capture', 2.6, 2.8)       # the cut job
    _span(rec, 'graphs.capture', 0.1, 0.3)       # set-up
    _span(rec, 'graphs.capture', 3.6, 3.7)       # after the window
    assert _read('graph_build_s.ladder', _ctx()) == pytest.approx(0.3)


def test_replay_host_us_is_own_ns_over_replays(rec):
    _span(rec, 'engine.begin', 0.5, 0.6, replays=10, own_ns=300_000,
          launch_ns=9_000_000)
    _span(rec, 'engine.begin', 1.5, 1.6, replays=30, own_ns=900_000,
          launch_ns=1_000)
    _span(rec, 'engine.begin', 3.5, 3.6, replays=50, own_ns=10 ** 9,
          launch_ns=0)                            # after the window
    _span(rec, 'graphs.capture', 1.0, 1.1)
    assert _read('replay_host_us.ladder', _ctx()) == pytest.approx(30.0)


def test_idle_in_build_pct_is_idle_time_under_build_spans(rec):
    tr = Tracer({'images': 1})
    tr.t0, tr.t1 = 1.0, 2.0
    base = epoch_ns(1.0)
    tr.events = [('k', base + 100 * MS, base + 400 * MS),
                 ('k', base + 600 * MS, base + 800 * MS)]
    # Idle 0-100, 400-600, 800-1000 ms; builds 350-550 (two overlapping)
    # and 900-1100 (clipped at the part's end): 150 + 100 ms idle.
    _span(rec, 'graphs.warm', 1.35, 1.5)
    _span(rec, 'graphs.capture', 1.45, 1.55)
    _span(rec, 'graphs.release', 1.9, 2.1)
    _span(rec, 'engine.begin', 1.0, 1.1)          # not a build
    _span(rec, 'graphs.capture', 0.5, 0.9)        # before the part
    value = _read('idle_in_build_pct.ladder', _ctx(tr))
    assert value == pytest.approx(25.0, abs=1e-4)


def test_nothing_to_read(rec, monkeypatch):
    ctx = _ctx()
    # No spans recorded: no replays, no trace.
    assert _read('replay_host_us.ladder', ctx) is None
    assert _read('idle_in_build_pct.ladder', ctx) is None
    assert _read('graph_build_s.ladder', ctx) == 0.0
    # No finished image in the window; a trace with no device work.
    ctx.record.jobs = [j for j in ctx.record.jobs if not j['finished']]
    assert _read('graph_build_s.ladder', ctx) is None
    tr = Tracer({'images': 1})
    tr.t0, tr.t1 = 1.0, 2.0
    assert _read('idle_in_build_pct.ladder', _ctx(tr)) is None


@pytest.mark.parametrize('name', READERS)
def test_a_program_without_a_recorder_reads_nothing(name, monkeypatch):
    """A program without the span recorder: the readers find no RECORDER
    and give nothing, without raising."""
    monkeypatch.delattr(profiling, 'RECORDER')
    tr = Tracer({'images': 1})
    tr.t0, tr.t1 = 1.0, 2.0
    tr.events = [('k', epoch_ns(1.1), epoch_ns(1.2))]
    assert _read(name, _ctx(tr)) is None


def test_the_ladder_cell_reports_the_span_metrics():
    bench, cell, *_ = core.cell_parts('bf16-1024-ladder')
    names = [m['name'] for m, _ in core.reported(bench, cell, 1)]
    assert set(READERS) <= set(names)
    bench, cell, *_ = core.cell_parts('f32-512-lbfgs')
    names = [m['name'] for m, _ in core.reported(bench, cell, 1)]
    assert not set(READERS) & set(names)
