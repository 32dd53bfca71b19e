#!/usr/bin/env python3
"""The readings the comparison's limits are set from, on the card: for each
seed, a run of the cell with a short window (the program's readings against
the float32 reference), and with --control also the control's readings (the
reference one precision lower in the program's place, portbench/control.py).
One JSON line a seed, with the verdicts on its non-finite jobs (failed or
diverged, with the readings at each state held), and with --control the
control's verdicts on the same jobs (its gradient and step at those
states); several seeds in one process share the kernels' build.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11 12 13 [--control 11 12 13] [--fault answer]

--fault plants one of portbench/faults.py's faults in the program for the
whole process. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from portbench import control, core, faults  # noqa: E402
from portbench.driver import Driver, now  # noqa: E402


def one_seed(name, seed, seconds, device, program, with_control):
    bench, cell, config, traffic, limits = core.cell_parts(name)
    spec = core.held_spec(name)
    t0 = now()
    driver = Driver(traffic, config, seed, device, program)
    driver.build()
    warm = core.warm_and_start(driver)
    w0, w1 = driver.window(seconds)
    follow = driver.follow()
    held, bad, rerun_s = core.rerun_nonfinite(driver, spec)
    driver.st = None
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    ref_mod = core.reference_module(config)
    t_ref = now()
    prog, n = core.compare(ref_mod, config, driver, warm, follow,
                           driver.answers, held, spec)
    failed, diverged = core.tally(prog.verdicts, len(bad))
    out = {'workload': name, 'seed': seed, 'program': prog.values,
           'program_where': prog.where, 'answers': n,
           'answer_gaps': prog.answer_gaps,
           'finished': sum(j['finished'] for j in driver.rec.jobs
                           if w0 <= j['t0'] <= w1),
           'failed': failed, 'diverged': diverged, 'verdicts': prog.verdicts,
           'rerun_s': rerun_s, 'reference_s': now() - t_ref,
           'run_s': now() - t0}
    if with_control:
        cw, cf, ca, ch = control.records(ref_mod, config, driver, warm,
                                         follow, held)
        r, _ = core.compare(ref_mod, config, driver, cw, cf, ca, ch, spec)
        out['control'] = r.values
        out['control_where'] = r.where
        out['control_verdicts'] = r.verdicts
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control', type=int, nargs='*', default=[])
    p.add_argument('--device', default='cuda')
    p.add_argument('--fault', choices=faults.FAULTS)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 2
    program = core.program_modules()
    if args.fault:
        faults.plant(args.fault)
    for seed in list(args.seeds) + [s for s in args.control
                                    if s not in args.seeds]:
        print(json.dumps(one_seed(args.workload, seed, args.seconds, device,
                                  program, seed in args.control)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
