"""One run of one cell: find its parts by name, make the inputs, build and
warm the engine, measure for --seconds, compare with the reference, print
the result line.

Everything a cell is made of is found by the names in BENCHMARK.json:
  benchmark/configs/<config>.json     sizes, objective, precision, and the
                                      plain reference module it names
                                      (benchmark/reference/<name>.py)
  benchmark/traffic/<traffic>.json    the mix the driver runs
  benchmark/workloads/<cell>.json     the comparison's limits
  benchmark/held/<cell>.json          the limits a non-finite job is held
                                      to (check.classify); a cell without
                                      one counts every such job failed
  benchmark/end_to_end/<metric>.py    read(ctx) of an end-to-end metric
  benchmark/metrics/<metric>.py       read(ctx) of a per-layer metric
  benchmark/kernels/<class>.json      a kernel class's name patterns
"""

import argparse
import gc
import importlib.util
import json
import math
import sys
import types
from pathlib import Path

import torch

from . import check
from .driver import RERUNS, Driver, now
from .trace import Tracer, classify, kernel_classes

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'style_transfer2_tpu')


class Refused(Exception):
    """The run cannot give a result (no card, a part missing)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(path):
    spec = importlib.util.spec_from_file_location(
        'portbench_reader_' + path.stem.replace('.', '_').replace('-', '_'),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_parts(name, bench=None):
    """(BENCHMARK.json, the workload entry, the configuration, the traffic,
    the limits) of the cell `name`."""
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise Refused('no workload %r in BENCHMARK.json' % name)
    cell = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    entry = configs[cell['config']]
    config = load_json(ROOT / entry['file'])
    traffic = load_json(BENCH / 'traffic' / (cell['traffic'] + '.json'))
    limits = load_json(BENCH / 'workloads' / (name + '.json'))
    return bench, cell, config, traffic, limits


def held_spec(name):
    """The cell's held limits (benchmark/held/<cell>.json), or None."""
    path = BENCH / 'held' / (name + '.json')
    return load_json(path) if path.exists() else None


def reported(bench, cell, trace):
    """[(metric entry, reader path)] the cell reports in this run: the
    end-to-end metrics with --trace 0, the per-layer ones with --trace 1;
    a metric without `workloads` is reported in every cell."""
    if trace:
        entries, folder = bench['per_layer'], 'metrics'
    else:
        entries, folder = bench['end_to_end'], 'end_to_end'
    out = []
    for m in entries:
        if 'workloads' in m and cell['name'] not in m['workloads']:
            continue
        out.append((m, BENCH / folder / (m['name'] + '.py')))
    return out


def reference_module(config):
    path = BENCH / 'reference' / (config['reference'] + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_reference_' + config['reference'], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a metric reader reads: the run's record (spans, work, jobs),
    the window, the trace, set-up and peak memory, the configuration, the
    traffic, the kernel classes and the cell."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def work_in(self, t0, t1):
        return [w for w in self.record.work if t0 <= w[0] <= t1]

    def traced_work(self):
        if self.trace is None:
            return []
        return self.work_in(self.trace.t0, self.trace.t1)

    def in_window(self, items):
        """Items (whose first field is a time) of the measured window."""
        return [x for x in items if self.t0 <= x[0] <= self.t1]


def program_modules():
    """The system under test: the port's engines (imported here, after the
    card was found)."""
    sys.path.insert(0, str(ROOT))
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
    return types.SimpleNamespace(StyleTransfer=StyleTransfer,
                                 BatchedStyleTransfer=BatchedStyleTransfer)


def warm_and_start(driver):
    """Set-up's jobs: every first call and capture, and the start the
    comparison follows (for a single grid the second job, whose prime is
    captured too)."""
    warm = driver.warm_job()
    if len(driver.rungs) == 1:
        warm = driver.warm_job()
    return warm


def compare(ref_mod, config, driver, warm, follow, answers, held=(),
            spec=None):
    """The float32 reference's readings of a run's (or the control's)
    records, with its verdicts on the re-run jobs `held` (rerun's) under the
    cell's held limits `spec`; (Readings, answers compared)."""
    ref = ref_mod.Reference(config, driver.weights, 'float32')
    chk = check.Check(ref, driver)
    out = check.Readings(ladder=len(driver.rungs) > 1)
    chk.start(warm, out)
    chk.follow(follow, out)
    n_answers = chk.answers(answers, out)
    out.verdicts = [chk.classify(h, spec) for h in held]
    return out, n_answers


def rerun_nonfinite(driver, spec):
    """Runs again the first RERUNS finished jobs whose answers are not
    finite (driver.rerun), none where the cell has no held limits (spec
    None). Returns (the re-runs, the non-finite answers, the seconds the
    re-runs took)."""
    bad = [a for a in driver.answers if not check.finite(a)]
    t0 = now()
    held = [driver.rerun(a) for a in bad[:RERUNS]] if spec else []
    return held, bad, now() - t0


def tally(verdicts, n_bad):
    """(failed, diverged) of n_bad non-finite jobs: the ones not re-run
    (past RERUNS, or in a cell without held limits) are failed."""
    diverged = sum(v['verdict'] == 'diverged' for v in verdicts)
    return n_bad - diverged, diverged


def verdict_line(v, spec):
    """One line of stderr for a classified job."""
    head = 'job %d rung %s step %s: %s (%s)' % (v['job'], v['rung'], v['step'],
                                                v['verdict'], v['why'])
    if not v['points']:
        return head
    lim = spec['limits']
    steps = [p['step'] for p in v['points']]
    unresolved = sum(p['step_gap'] is None for p in v['points'])
    unread = sum(p['grad_share'] is None for p in v['points'])
    return ('%s; %d states held, steps %s: grad_share %r limit %r, '
            'step_gap %r limit %r (each [worst, at step]); not read: %d '
            'gradients the %s yardstick does not resolve (under %r times '
            'float32), %d steps float32 does not (rounding over %r); the '
            'reference after its step at step %s: loss %r |grad| %r'
            % (head, len(steps), ','.join(map(str, steps)), v['grad_share'],
               lim['held_grad_share'], v['step_gap'], lim['held_step_gap'],
               unread, spec['yardstick'], spec['yardstick_resolved'],
               unresolved, spec['step_resolved'], v['at'], v['stepped_loss'],
               v['stepped_grad']))


def _short(kernel):
    """A kernel's name without its namespace noise and argument list."""
    name = kernel.replace('(anonymous namespace)::', '').replace('void ', '')
    return name.split('(')[0][:90]


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description='One run of one benchmark cell '
                                'of the PyTorch/CUDA port on the card.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv, t_start):
    args = parse(argv)
    bench, cell, config, traffic, limits = cell_parts(args.workload)
    if not torch.cuda.is_available():
        raise Refused('no CUDA device: the benchmark runs only on the card')
    if torch.cuda.device_count() < int(cell['chips']):
        raise Refused('%d CUDA devices, the cell asks for %d'
                      % (torch.cuda.device_count(), cell['chips']))
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    result = run_cell(bench, cell, config, traffic, limits, args.seed,
                      args.seconds, args.trace, device, program_modules(),
                      t_start)
    bad = forbidden_modules()
    if bad:
        raise Refused('modules loaded that the benchmark must not load: %s'
                      % ', '.join(bad))
    for line in result.pop('held'):
        print(line, file=sys.stderr)
    for k, v in result.pop('where').items():
        print('worst %s: %s' % (k, v), file=sys.stderr)
    for k, v in result['check'].items():
        print('check %s %r limit %r' % (k, v['value'], v['limit']),
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_cell(bench, cell, config, traffic, limits, seed, seconds, trace,
             device, program, t_start):
    """One run of a cell on `device` with the program's engine classes;
    returns the result line's dict. (The CPU tests run it on the CPU with
    the program's plain versions at small sizes.)"""
    t_in = now()
    driver = Driver(traffic, config, seed, device, program)
    driver.build()
    t_built = now()
    warm = warm_and_start(driver)
    _sync(device)
    setup_s = now() - t_start
    print('set-up: %.2f s to the harness (imports, the card), %.2f s inputs '
          'and engine, %.2f s warm-up' % (t_in - t_start, t_built - t_in,
                                          now() - t_built), file=sys.stderr)

    t0, t1 = driver.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    print('window: %.2f s, images %s' % (t1 - t0, ' '.join(
        '%.3f%s' % (j['t1'] - j['t0'], '' if j['finished'] else '(cut)')
        for j in driver.rec.jobs)), file=sys.stderr)
    tracer = None
    if trace:
        tracer = Tracer(traffic['trace'])
        driver.traced(tracer)
    follow = driver.follow()

    ctx = Context(record=driver.rec, t0=t0, t1=t1, setup_s=setup_s,
                  peak_bytes=peak, trace=tracer, config=config,
                  traffic=traffic, classes=kernel_classes(), cell=cell)
    metrics = {}
    for entry, path in reported(bench, cell, trace):
        value = load_reader(path)(ctx)
        if value is None:
            if not trace:
                raise Refused('end-to-end metric %s read nothing'
                              % entry['name'])
            continue
        metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    attempted = sum(j['lanes'] for j in driver.rec.jobs
                    if t0 <= j['t0'] <= t1)
    device_info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                   'kind': (torch.cuda.get_device_name(device)
                            if device.type == 'cuda' else 'cpu'),
                   'count': int(cell['chips']),
                   'memory_peak_bytes': int(peak)}
    breakdown = None
    if tracer is not None:
        device_info['busy_s'] = tracer.busy_s()
        device_info['window_s'] = tracer.window_s()
        ops = sorted(tracer.seconds_by_name().items(),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(tracer.idle_gaps(driver.rec.spans),
                      key=lambda g: -g[1])[:10]
        breakdown = {'device_ops': [[n[:160], s] for n, s in ops],
                     'idle_gaps': [[n, s] for n, s in gaps]}
        names = {}
        for n, sec in tracer.seconds_by_name().items():
            names.setdefault(classify(n, ctx.classes), []).append((sec, n))
        for cls, found in sorted(names.items(), key=lambda kv: str(kv[0])):
            print('kernel class %s: %s' % (cls, '; '.join(
                '%s %.4f s' % (_short(n), sec)
                for sec, n in sorted(found, reverse=True))), file=sys.stderr)

    spec = held_spec(cell['name'])
    held, bad, rerun_s = rerun_nonfinite(driver, spec)

    # The program's state goes before the reference runs on the card.
    driver.st = None
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    lim = limits['limits']
    readings, n_answers = compare(reference_module(config), config, driver,
                                  warm, follow, driver.answers, held, spec)
    values = readings.values
    correct = n_answers > 0 and all(
        math.isfinite(values[k]) and values[k] <= lim[k] for k in values)
    checks = {k: {'value': values[k], 'limit': lim[k]} for k in values}
    failed, diverged = tally(readings.verdicts, len(bad))
    result = {'correct': bool(correct), 'attempted': int(attempted),
              'failed': int(failed), 'diverged': int(diverged),
              'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['held'] = (
        ['re-runs: %d of %d non-finite jobs, %.3f s%s'
         % (len(held), len(bad), rerun_s,
            '' if spec else ' (the cell has no held limits: every '
            'non-finite job is failed)')]
        + [verdict_line(v, spec) for v in readings.verdicts]
        + ['job %d: failed (not re-run)' % a['job']
           for a in bad[len(held):]])
    result['where'] = readings.where
    result['check'] = checks
    return result


def main(argv=None, t_start=None):
    t_start = now() if t_start is None else t_start
    try:
        return run(sys.argv[1:] if argv is None else argv, t_start)
    except Refused as e:
        print('benchmark: %s' % e, file=sys.stderr)
        return 2
