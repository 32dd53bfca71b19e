"""The end-to-end arithmetic: image_s is all the time of the images the window
finished over their number, and its_per_s all the iterations the window
completed over all its seconds, so one stall moves each where a median of
images or of chunks would not (CPU, synthetic records)."""

import statistics
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from portbench import core  # noqa: E402
from portbench.driver import Record  # noqa: E402


def _read(name, ctx):
    return core.load_reader(BENCH / 'end_to_end' / (name + '.py'))(ctx)


def _images(stall=0.0, n=5, image_s=6.0, cut=True):
    rec, t = Record(), 0.0
    for i in range(n):
        t0 = t
        t += image_s + (stall if i == 2 else 0.0)
        rec.jobs.append({'job': i, 't0': t0, 't1': t, 'finished': True,
                         'lanes': 1})
    if cut:     # the window's edge cuts one more image
        rec.jobs.append({'job': n, 't0': t, 't1': t + 1.0, 'finished': False,
                         'lanes': 1})
        t += 1.0
    return core.Context(record=rec, t0=0.0, t1=t, trace=None)


def test_image_s_counts_the_stall_and_not_the_cut_image():
    assert _read('image_s', _images()) == pytest.approx(6.0)
    assert _read('image_s', _images(stall=3.0)) == pytest.approx(
        (5 * 6.0 + 3.0) / 5)
    assert statistics.median([6.0] * 4 + [9.0]) == 6.0


def test_image_s_reads_nothing_without_a_finished_image():
    rec = Record()
    rec.jobs.append({'job': 0, 't0': 0.0, 't1': 3.0, 'finished': False,
                     'lanes': 1})
    assert _read('image_s', core.Context(record=rec, t0=0.0, t1=3.0,
                                         trace=None)) is None


def _chunks(stall=0.0, n=20, chunk_s=0.5, its=60):
    """A window of n chunks of `its` iterations, one stalled, with a chunk
    collected after its edge."""
    rec, t = Record(), 0.0
    for i in range(n):
        t += chunk_s + (stall if i == 7 else 0.0)
        rec.iterations.append((t, its))
    rec.iterations.append((t + 1.0, its))
    return core.Context(record=rec, t0=0.0, t1=t, trace=None)


def test_its_per_s_counts_the_stall_and_only_the_window():
    assert _read('its_per_s', _chunks()) == pytest.approx(120.0)
    assert _read('its_per_s', _chunks(stall=2.0)) == pytest.approx(
        20 * 60 / (20 * 0.5 + 2.0))
    gaps = [0.5] * 19 + [2.5]
    assert 60 / statistics.median(gaps) == pytest.approx(120.0)


def test_its_per_s_reads_nothing_without_an_iteration():
    assert _read('its_per_s', core.Context(record=Record(), t0=0.0, t1=3.0,
                                           trace=None)) is None


def test_an_image_cut_between_rungs_is_not_finished():
    """The window's edge between two rungs of a ladder leaves the image
    unfinished: it counts in image_s neither as time nor as an image."""
    import torch
    from portbench.driver import Driver, now
    torch.set_num_threads(2)
    _, _, config, traffic, _ = core.cell_parts(
        core.load_json(BENCH.parent / 'BENCHMARK.json')['workloads'][0]
        ['name'])
    # One chunk a rung: the first rung always runs to its end, and the
    # edge falls before the second.
    traffic = dict(traffic, rungs=[[16, 24], [24, 32]], iterations=2,
                   chunk=2, style_size=32)
    d = Driver(traffic, config, 3, torch.device('cpu'),
               core.program_modules())
    d.build()
    assert d.run_job(0, now()) is False
    assert d.rec.jobs[-1]['finished'] is False and not d.answers
    assert d.run_job(1, float('inf')) is True
    assert d.rec.jobs[-1]['finished'] is True and len(d.answers) == 1
    # Every chunk collected counts its iterations, the cut job's too.
    assert [n for _, n in d.rec.iterations] == [2, 2, 2]
