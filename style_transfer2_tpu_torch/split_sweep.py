"""What the float32 backward's split path buys, per shape and end to end.

    python -m style_transfer2_tpu_torch.split_sweep [--steps 60] [--reps 2]

1. At every float32 trunk backward shape of the 384x512, 543x724 and
   768x1024 iterates that does not take the narrow path, times the tile
   backward split 1, 2, 3, 4, 6 and 8 ways (the counts ops.conv.bwd_plan
   can pick; median CUDA-event time of 15 calls after 3 warm-ups) beside
   the split bwd_plan picks: the measurements its cost model is held to.
2. End to end: float32 L-BFGS steps at --size 512 and 724 (the 384x512 and
   543x724 iterates, built as the CLI builds them) with bwd_plan as it is
   and with every split replaced by the unsplit tile, in turns (on, off,
   off, on, --reps times) in one process after warm-up; each turn times
   --steps steps in one chunk with the host clock, synced at both ends.

Prints one JSON line per shape and per size. Needs CUDA; there is no CPU
fallback.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import cli
from .ops import conv
from .utils import sm_count, tf32

SPLIT_COUNTS = (1, 2, 3, 4, 6, 8)
SIZES = (512, 724)


def trunk_backward_shapes(h, w):
    """(H, W, K, Cout) of each backward the iterate runs up to conv4_2 on an
    h x w grid (ceil pools): the cotangent's K channels, dx's Cout."""
    shapes, cin = [], 3
    for block, (n, cout) in enumerate(((2, 64), (2, 128), (4, 256),
                                       (2, 512))):
        if block:
            h, w = -(-h // 2), -(-w // 2)
        for _ in range(n):
            shapes.append((h, w, cout, cin))
            cin = cout
    return shapes


def median_ms(fn, reps=15, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sweep(shape, rng, dev):
    """{splits: ms} of the tile backward at one shape, and the plan's
    (path, splits)."""
    h, w, k, cout = shape
    g = torch.as_tensor(np.float32(rng.randn(1, h, w, k)), device=dev)
    y = torch.relu(torch.as_tensor(np.float32(rng.randn(1, h, w, k)),
                                   device=dev))
    wt = conv.backward_weights(torch.as_tensor(np.float32(rng.normal(
        0, np.sqrt(2.0 / (9 * cout)), (3, 3, cout, k))), device=dev))
    times = {}
    for want in SPLIT_COUNTS:
        kspan = -(-(-(-k // want)) // conv._KC) * conv._KC
        splits = -(-k // kspan)
        if splits != want or (splits > 1
                              and kspan < conv._MIN_SPLIT_CHANNELS):
            continue
        plan = ((conv.TILE, 1, k) if splits == 1
                else (conv.SPLIT, splits, kspan))
        times[splits] = median_ms(lambda: conv._launch_bwd(g, y, wt, plan))
    path, splits, _ = conv.bwd_plan(1, h, w, k, cout, torch.float32,
                                    sm_count(dev))
    return times, path, splits


def without_splits(plan):
    """bwd_plan with every SPLIT plan replaced by the unsplit tile."""
    def bwd_plan(n, h, w, k, cout, dtype, sms):
        path, splits, kspan = plan(n, h, w, k, cout, dtype, sms)
        if path == conv.SPLIT:
            return conv.TILE, 1, k
        return path, splits, kspan
    return bwd_plan


def end_to_end(size, steps, reps, warmup):
    """it/s of float32 L-BFGS steps at --size with and without splits, in
    turns (on, off, off, on, ...)."""
    cli_args = cli.parse_args([
        str(cli.ROOT_DIR / 'examples' / 'golden_gate.jpg'),
        str(cli.ROOT_DIR / 'examples' / 'starry_night.jpg'),
        '--size', str(size), '--precision', 'float32',
        '--optimizer', 'lbfgs'])
    st, inputs, hw = cli.setup(cli_args)
    cli.start_first_rung(st, cli_args, cli.fit_content(inputs[2], hw), hw,
                         np.random.RandomState(cli_args.seed))
    st.run_steps(warmup, fetch_image=False)
    torch.cuda.synchronize()
    planned = conv.bwd_plan
    rates = {'split': [], 'tile': []}
    try:
        for _ in range(reps):
            for which in ('split', 'tile', 'tile', 'split'):
                conv.bwd_plan = (planned if which == 'split'
                                 else without_splits(planned))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st.run_steps(steps, fetch_image=False)
                torch.cuda.synchronize()
                rates[which].append(steps / (time.perf_counter() - t0))
    finally:
        conv.bwd_plan = planned
    return hw, rates


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=60)
    p.add_argument('--reps', type=int, default=2)
    p.add_argument('--warmup', type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('split_sweep needs CUDA')
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    device = torch.cuda.get_device_name(0)
    seen = set()
    with tf32(False):
        for h, w in ((384, 512), (543, 724), (768, 1024)):
            for shape in trunk_backward_shapes(h, w):
                if shape[3] <= conv._NARROW_MAX_COUT or shape in seen:
                    continue
                seen.add(shape)
                times, path, splits = sweep(shape, rng, dev)
                best = min(times, key=times.get)
                print(json.dumps({
                    'device': device, 'shape_hwkc': list(shape),
                    'ms_by_splits': times, 'planned': [path, splits],
                    'fastest': best,
                    'planned_over_fastest': times[splits] / times[best]}),
                    flush=True)
    for size in SIZES:
        hw, rates = end_to_end(size, args.steps, args.reps, args.warmup)
        print(json.dumps({
            'device': device, 'size': size, 'hw': list(hw),
            'steps': args.steps, 'it_s_with_splits': rates['split'],
            'it_s_tile_only': rates['tile'],
            'median_gain': float(np.median(rates['split'])
                                 / np.median(rates['tile']) - 1)}),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
