"""The traced part's arithmetic on synthetic device events: busy time, idle
gaps and their labels, kernel classes, and every per-layer reader (CPU)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from portbench import core, roofline  # noqa: E402
from portbench.driver import Record, epoch_ns  # noqa: E402
from portbench.trace import Tracer, kernel_classes  # noqa: E402


def _ctx():
    rec = Record()
    hw = (96, 128)
    rec.work += [(1.0, 'eval', hw, 1, 1, 'conv4_2'),
                 (1.1, 'eval', hw, 1, 10, 'conv4_2'),
                 (1.2, 'fwd', hw, 1, 1, 'conv4_2')]
    rec.spans += [('rung_switch', 0.5, 0.8), ('begin', 1.0, 1.05),
                  ('collect', 1.5, 2.0)]
    rec.jobs.append({'job': 0, 't0': 0.2, 't1': 1.9, 'finished': True,
                     'lanes': 1})
    tr = Tracer({'images': 1})
    tr.t0, tr.t1 = 1.0, 2.0
    base = epoch_ns(0.0)
    ms = 1_000_000

    def ev(name, start_ms, dur_ms):
        return (name, base + 1000 * ms + start_ms * ms,
                base + 1000 * ms + (start_ms + dur_ms) * ms)

    tr.events = [ev('void conv3x3_f32_fwd_kernel(float*)', 100, 300),
                 ev('gram_partials_kernel(float const*)', 350, 100),
                 ev('void at::native::elementwise_kernel<...>', 450, 50),
                 ev('void conv3x3_f32_bwd_kernel<true>(float*)', 600, 200),
                 ev('late kernel outside the part', 1200, 50)]
    config = core.load_json(BENCH / 'configs' / 'vgg19-gatys-f32.json')
    return core.Context(record=rec, t0=0.2, t1=2.0, setup_s=3.0,
                        peak_bytes=2 ** 30, trace=tr, config=config,
                        traffic={}, classes=kernel_classes(), cell={})


def test_busy_idle_and_gaps():
    tr = _ctx().trace
    assert tr.window_s() == pytest.approx(1.0)
    # 100-450 busy (300 + 100 overlapping 50), 450-500, 600-800.
    assert tr.busy_s() == pytest.approx(0.6)
    gaps = [(label, round(s, 6)) for label, s in
            tr.idle_gaps([('collect', 1.5, 2.0), ('begin', 1.0, 1.05)])]
    assert gaps == [('begin', 0.1),                       # 0-100 ms
                    ('collect', 0.1),                     # 500-600 ms
                    ('collect', 0.2)]                     # 800-1000 ms


def test_classes_and_readers():
    ctx = _ctx()
    secs = ctx.trace.class_seconds(ctx.classes)
    assert secs['conv'] == pytest.approx(0.5)
    assert secs['style'] == pytest.approx(0.1)
    assert secs[None] == pytest.approx(0.05)
    read = {p.stem: core.load_reader(p) for p in
            (BENCH / 'metrics').glob('*.py')}
    conv_s, style_s = (roofline.conv_bound_s((96, 128), ctx.config['convs'],
                                             'conv4_2', 'float32'),
                       roofline.style_bound_s((96, 128), ctx.config['convs'],
                                              ['conv1_1', 'conv2_1',
                                               'conv3_1', 'conv4_1'],
                                              'float32'))
    fwd_s = roofline.conv_bound_s((96, 128), ctx.config['convs'], 'conv4_2',
                                  'float32', backward=False)
    assert read['conv_roofline'](ctx) == pytest.approx(
        100 * (11 * conv_s + fwd_s) / 0.5)
    assert read['style_roofline'](ctx) == pytest.approx(
        100 * 11 * style_s / 0.1)
    assert read['glue_ms_per_step'](ctx) == pytest.approx(1e3 * 0.05 / 11)
    assert read['idle_pct'](ctx) == pytest.approx(40.0)
    assert read['rung_switch_s'](ctx) == pytest.approx(0.3)
    flops = 11 * roofline.eval_flops((96, 128), ctx.config['convs'],
                                     ['conv4_2'], ['conv1_1', 'conv2_1',
                                                   'conv3_1', 'conv4_1'])
    flops += roofline.forward_flops((96, 128), ctx.config['convs'],
                                    'conv4_2')
    assert read['mfu_pct'](ctx) == pytest.approx(100 * flops / 1.8 / 67e12)
    # A ladder cell's readers read what the others read.
    for name in read:
        if name.endswith('.ladder'):
            assert read[name](ctx) == read[name[:-len('.ladder')]](ctx)


def test_readers_read_nothing_without_a_trace():
    ctx = _ctx()
    ctx.trace = None
    for name in ('conv_roofline', 'style_roofline', 'glue_ms_per_step',
                 'idle_pct', 'conv_roofline.ladder', 'style_roofline.ladder',
                 'glue_ms_per_step.ladder', 'idle_pct.ladder'):
        assert core.load_reader(BENCH / 'metrics' / (name + '.py'))(ctx) \
            is None
