"""Where one optimization step's time goes on the card.

    python -m style_transfer2_tpu_torch.profile_step [CLI flags]

Builds the engine exactly as the CLI does (the CLI's flags pass through;
--content and --style default to the two example images), runs --warmup
steps, times --steps steps with the host clock (each step ends in the
trace's host sync), then runs --steps more under torch.profiler and prints
one JSON line. With --batch, the engine is the batched one with --lanes
lanes, each a job on the content image from its own random start, and a
step advances every lane:
the step's wall ms, the device-kernel ms summed per step, the device's idle
share (1 - kernel ms / wall ms), kernels launched per step, and the costliest
kernels; and the wall ms read against the step's roofline
(utils/perfmodel.py model_step at the engine's taps, grid, precision and
remat; with --batch, lanes times one image's): model_flops, floor_ms,
bound_by, mfu (model FLOPs over the card's peak over the wall ms) and
share_of_floor (the floor over the wall ms). With --mesh, the floor is
the unsharded step's work. Needs CUDA; there is no CPU fallback.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import cli
from .utils import fit_into_square, perfmodel


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--top', type=int, default=12)
    p.add_argument('--chrome-trace', default=None,
                   help='also write the profiled steps as a Chrome trace')
    p.add_argument('--content',
                   default=str(cli.ROOT_DIR / 'examples' / 'golden_gate.jpg'))
    p.add_argument('--style',
                   default=str(cli.ROOT_DIR / 'examples' / 'starry_night.jpg'))
    args, rest = p.parse_known_args(argv)
    return args, cli.parse_args([args.content, args.style] + rest)


def batched_steps(cli_args):
    """(run_steps(n), hw, the objective's spec) of a BatchedStyleTransfer
    with cli_args.lanes jobs on the content image, built as the CLI's
    --batch builds it."""
    from .engine import resolve_device
    from .engine.batched import BatchedStyleTransfer
    device = resolve_device(cli_args.device)
    params, (weights, scalars), content_pil, style_np = cli.load_inputs(
        cli_args)
    wh = fit_into_square(content_pil.size, cli_args.size, scale_up=True)
    hw = (wh[1], wh[0])
    engine = BatchedStyleTransfer(
        params, weights, scalars, hw, max_lanes=cli_args.lanes,
        optimizer=cli_args.optimizer, precision=cli_args.precision,
        device=device)
    content = cli.fit_content(content_pil, hw)
    rng = np.random.RandomState(cli_args.seed)
    for _ in range(cli_args.lanes):
        engine.add_job(content, style_np,
                       rng.uniform(0, 255, hw + (3,)).astype(np.uint8),
                       step_size=cli_args.step_size)
    return engine.run_steps_all, hw, engine.spec


def single_steps(cli_args):
    """(run_steps(n), hw, the objective's spec) of the CLI's single-image
    engine."""
    st, inputs, hw = cli.setup(cli_args)
    cli.start_first_rung(st, cli_args, cli.fit_content(inputs[2], hw), hw,
                         np.random.RandomState(cli_args.seed))
    return lambda n: st.run_steps(n, fetch_image=False), hw, st.spec()


def roofline(cli_args, hw, spec, wall_ms):
    """The step's roofline fields at wall_ms a step (module docstring)."""
    lanes = cli_args.lanes if cli_args.batch else 1
    model = perfmodel.model_step(
        hw, cli_args.precision, False if cli_args.batch else cli_args.remat,
        content_layers=spec.content_layers, style_layers=spec.style_layers)
    return model.lanes(lanes).fields_at(wall_ms / 1e3)


def main(argv=None):
    args, cli_args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('profile_step needs CUDA')
    run_steps, hw, spec = (batched_steps if cli_args.batch
                           else single_steps)(cli_args)
    run_steps(args.warmup)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    run_steps(args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps(args.steps)
        torch.cuda.synchronize()
    kernels = {}
    launches = 0
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[event.name] = kernels.get(event.name, 0.0) \
            + event.device_time / 1e3 / args.steps
        launches += 1
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]
    if args.chrome_trace:
        prof.export_chrome_trace(args.chrome_trace)
    print(json.dumps(dict({
        'device': torch.cuda.get_device_name(0),
        'precision': cli_args.precision, 'hw': list(hw),
        'lanes': cli_args.lanes if cli_args.batch else 1,
        'remat': False if cli_args.batch else cli_args.remat,
        'wall_ms_per_step': wall_ms, 'kernel_ms_per_step': busy_ms,
        'idle_share': 1.0 - busy_ms / wall_ms,
        'kernels_per_step': launches / args.steps,
        'top_kernels_ms': [[name[:80], ms] for name, ms in top]},
        **roofline(cli_args, hw, spec, wall_ms))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
