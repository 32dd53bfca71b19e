"""Where one optimization step's time goes on the card.

    python -m style_transfer2_tpu_torch.profile_step [CLI flags]

Builds the engine exactly as the CLI does (the CLI's flags pass through;
--content and --style default to the two example images), runs --warmup
steps, times --steps steps with the host clock (each step ends in the
trace's host sync), then runs --steps more under torch.profiler and prints
one JSON line:
the step's wall ms, the device-kernel ms summed per step, the device's idle
share (1 - kernel ms / wall ms), kernels launched per step, and the costliest
kernels. Needs CUDA; there is no CPU fallback.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import cli


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


def main(argv=None):
    args, cli_args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('profile_step needs CUDA')
    st, inputs, hw = cli.setup(cli_args)
    cli.start_first_rung(st, cli_args, cli.fit_content(inputs[2], hw), hw,
                         np.random.RandomState(cli_args.seed))
    st.run_steps(args.warmup, fetch_image=False)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    st.run_steps(args.steps, fetch_image=False)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st.run_steps(args.steps, fetch_image=False)
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
    print(json.dumps({
        'device': torch.cuda.get_device_name(0),
        'precision': cli_args.precision, 'hw': list(hw),
        'wall_ms_per_step': wall_ms, 'kernel_ms_per_step': busy_ms,
        'idle_share': 1.0 - busy_ms / wall_ms,
        'kernels_per_step': launches / args.steps,
        'top_kernels_ms': [[name[:80], ms] for name, ms in top]}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
