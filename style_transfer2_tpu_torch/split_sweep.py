"""What the split paths buy, per shape and end to end, in float32 and in
bfloat16.

    python -m style_transfer2_tpu_torch.split_sweep [--steps 60] [--reps 2]
    python -m style_transfer2_tpu_torch.split_sweep --fit sweep.jsonl

1. At every trunk backward shape of the 384x512, 543x724 and 768x1024
   iterates that does not take the narrow path, times the backward split
   every way ops.conv.bwd_plan can pick (1 to 8 ranges of channels; median
   CUDA-event time of 15 calls after 3 warm-ups) beside the split bwd_plan
   picks and its rank among them: the measurements its cost model is held
   to. Float32 (the tile kernel) and bfloat16 (the wgmma kernel).
2. Likewise the forward: every forward shape of those iterates and of the
   410x512 style image (to conv5_1) that the split kernels take (not the
   float32 scalar path, not the bf16 mma.sync path), split 1 .. 8 ways
   beside fwd_plan's choice and its rank, in both dtypes.
3. End to end: L-BFGS steps at --size 512 and 724 (the 384x512 and 543x724
   iterates, built as the CLI builds them) in float32 and bfloat16 with
   fwd_plan and bwd_plan as they are and with every split replaced by the
   unsplit kernel, in turns (on, off, off, on, --reps times) in one
   process after warm-up; each turn times --steps steps in one chunk with
   the host clock, synced at both ends.

Prints one JSON line per shape and per size. Needs CUDA; there is no CPU
fallback. --fit reads the shape lines of such a run and needs no card:
for each direction and dtype, each resident-block count (1, 2) and each
value of the split cost constant (FIT_OVERHEADS for float32's overhead
share, FIT_PARTIALS for bfloat16's partial-sum traffic), the summed time
of the splits the planner would pick at those shapes, beside the fastest
splits' sum and the worst ratio of one shape; the planners' constants are
the least sum.
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

SIZES = (512, 724)
FIT_OVERHEADS = (0.0, 0.02, 0.05, 0.08, 0.1, 0.15)
FIT_PARTIALS = (0.0, 16.0, 32.0, 64.0, 96.0, 128.0, 192.0, 256.0)
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
# Each (direction, dtype)'s planner, the names of its two fitted constants
# in ops.conv, and the values the second is fitted over.
PLANNERS = {
    ('fwd', 'float32'): ('fwd_plan', '_FWD_RESIDENT', '_FWD_SPLIT_OVERHEAD',
                         FIT_OVERHEADS),
    ('bwd', 'float32'): ('bwd_plan', '_BWD_RESIDENT', '_SPLIT_OVERHEAD',
                         FIT_OVERHEADS),
    ('fwd', 'bfloat16'): ('fwd_plan', '_BF16_FWD_RESIDENT',
                          '_BF16_FWD_PARTIALS', FIT_PARTIALS),
    ('bwd', 'bfloat16'): ('bwd_plan', '_BF16_BWD_RESIDENT',
                          '_BF16_BWD_PARTIALS', FIT_PARTIALS)}


def trunk_convs(h, w):
    """(H, W, Cin, Cout) of each 3x3 conv an h x w image runs up to
    conv4_2 (ceil pools), a shape run three times a step listed three
    times."""
    shapes, cin = [], 3
    for block, (n, cout) in enumerate(((2, 64), (2, 128), (4, 256),
                                       (2, 512))):
        if block:
            h, w = -(-h // 2), -(-w // 2)
        for _ in range(n):
            shapes.append((h, w, cin, cout))
            cin = cout
    return shapes


def trunk_backward_shapes(h, w):
    """(H, W, K, Cout) of each backward the iterate runs up to conv4_2 on an
    h x w grid: the cotangent's K channels, dx's Cout."""
    return [(hh, ww, cout, cin) for hh, ww, cin, cout in trunk_convs(h, w)]


def forward_shapes():
    """(H, W, Cin, Cout) of every distinct float32 forward the 512px path
    and the 1024px ladder's top rungs run: the trunk of the 384x512,
    543x724 and 768x1024 iterates to conv4_2, and the 410x512 style image
    to conv5_1 (once per style)."""
    shapes = [s for hw in ((384, 512), (543, 724), (768, 1024), (410, 512))
              for s in trunk_convs(*hw)]
    shapes.append((26, 32, 512, 512))   # the style image's conv5_1
    return list(dict.fromkeys(shapes))


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


def split_plans(k, dtype=torch.float32):
    """{splits: (path, splits, kspan)} of every split count the planners
    can pick for k channels summed: the float32 tile kernel's ranges a
    multiple of 8 channels, the bf16 wgmma kernel's of 16."""
    unit = conv._KC if dtype == torch.float32 else conv._WG_K
    whole, split = ((conv.TILE, conv.SPLIT) if dtype == torch.float32
                    else (conv.WGMMA, conv.WGMMA_SPLIT))
    plans = {}
    for want in range(1, conv._MAX_SPLITS + 1):
        kspan = -(-(-(-k // want)) // unit) * unit
        splits = -(-k // kspan)
        if splits != want or (splits > 1
                              and kspan < conv._MIN_SPLIT_CHANNELS):
            continue
        plans[splits] = ((whole, 1, k) if splits == 1
                         else (split, splits, kspan))
    return plans


def sweep(shape, rng, dev, dtype=torch.float32):
    """{splits: ms} of the backward at one shape, and the plan's (path,
    splits)."""
    h, w, k, cout = shape
    g = torch.as_tensor(np.float32(rng.randn(1, h, w, k)), device=dev)
    y = torch.relu(torch.as_tensor(np.float32(rng.randn(1, h, w, k)),
                                   device=dev))
    wt = conv.backward_weights(torch.as_tensor(np.float32(rng.normal(
        0, np.sqrt(2.0 / (9 * cout)), (3, 3, cout, k))), device=dev))
    g, y, wt = g.to(dtype), y.to(dtype), wt.to(dtype)
    times = {splits: median_ms(lambda: conv._launch_bwd(g, y, wt, plan))
             for splits, plan in split_plans(k, dtype).items()}
    path, splits, _ = conv.bwd_plan(1, h, w, k, cout, dtype, sm_count(dev))
    return times, path, splits


def sweep_forward(shape, rng, dev, dtype=torch.float32):
    """{splits: ms} of the forward at one shape (H, W, Cin, Cout), and
    fwd_plan's (path, splits)."""
    h, w, cin, cout = shape
    x = torch.as_tensor(np.float32(rng.randn(1, h, w, cin)), device=dev)
    wt = torch.as_tensor(np.float32(rng.normal(
        0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout))), device=dev)
    b = torch.as_tensor(np.float32(rng.randn(cout) * 0.1), device=dev)
    x, wt, b = x.to(dtype), wt.to(dtype), b.to(dtype)
    times = {splits: median_ms(lambda: conv._launch_fwd(x, wt, b, plan))
             for splits, plan in split_plans(cin, dtype).items()}
    path, splits, _ = conv.fwd_plan(1, h, w, cin, cout, dtype,
                                    sm_count(dev))
    return times, path, splits


def report(device, sms, kind, dtype, shape, times, path, splits):
    """One JSON line: the times by split count, the plan and its rank (1:
    the fastest)."""
    best = min(times, key=times.get)
    print(json.dumps({
        'device': device, 'sms': sms, 'kind': kind, 'dtype': dtype,
        'shape': list(shape), 'ms_by_splits': times,
        'planned': [path, splits], 'fastest': best,
        'planned_rank': sorted(times, key=times.get).index(splits) + 1,
        'planned_over_fastest': times[splits] / times[best]}), flush=True)


def without_splits(plan):
    """A planner (fwd_plan or bwd_plan) with every split plan replaced by
    the same kernel unsplit."""
    def unsplit(n, h, w, k, cout, dtype, sms):
        path, splits, kspan = plan(n, h, w, k, cout, dtype, sms)
        if path == conv.SPLIT:
            return conv.TILE, 1, k
        if path == conv.WGMMA_SPLIT:
            return conv.WGMMA, 1, k
        return path, splits, kspan
    return unsplit


def end_to_end(size, steps, reps, warmup, precision='float32'):
    """it/s of L-BFGS steps at --size in `precision` with and without
    splits, in turns (on, off, off, on, ...)."""
    cli_args = cli.parse_args([
        str(cli.ROOT_DIR / 'examples' / 'golden_gate.jpg'),
        str(cli.ROOT_DIR / 'examples' / 'starry_night.jpg'),
        '--size', str(size), '--precision', precision,
        '--optimizer', 'lbfgs'])
    st, inputs, hw = cli.setup(cli_args)
    cli.start_first_rung(st, cli_args, cli.fit_content(inputs[2], hw), hw,
                         np.random.RandomState(cli_args.seed))
    st.run_steps(warmup, fetch_image=False)
    torch.cuda.synchronize()
    planned = conv.fwd_plan, conv.bwd_plan
    rates = {'split': [], 'tile': []}
    try:
        for _ in range(reps):
            for which in ('split', 'tile', 'tile', 'split'):
                conv.fwd_plan, conv.bwd_plan = (
                    planned if which == 'split'
                    else tuple(map(without_splits, planned)))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st.run_steps(steps, fetch_image=False)
                torch.cuda.synchronize()
                rates[which].append(steps / (time.perf_counter() - t0))
    finally:
        conv.fwd_plan, conv.bwd_plan = planned
    return hw, rates


def fit(lines):
    """One dict per direction, dtype, resident-block count and value of the
    split cost constant: the summed ms of the splits the planner picks at
    the swept shapes (from `lines`, this module's JSON output; a line with
    no dtype is float32), the fastest splits' sum, and the worst ratio of
    one shape (`unswept` counts the shapes whose planned split the run did
    not time, left out of both sums). The module's constants are
    restored."""
    out = []
    for (kind, dtype), (name, resident_name, overhead_name,
                        values) in PLANNERS.items():
        rows = [r for r in lines if r.get('kind', '').startswith(kind)
                and r.get('dtype', 'float32') == dtype]
        if not rows:
            continue
        planner = getattr(conv, name)
        saved = getattr(conv, resident_name), getattr(conv, overhead_name)
        try:
            for resident in (1, 2):
                for overhead in values:
                    setattr(conv, resident_name, resident)
                    setattr(conv, overhead_name, overhead)
                    planner.cache_clear()
                    planned = fastest = 0.0
                    worst, unswept = 1.0, 0
                    for r in rows:
                        times = {int(s): t
                                 for s, t in r['ms_by_splits'].items()}
                        splits = planner(1, *r['shape'], DTYPES[dtype],
                                         r['sms'])[1]
                        if splits not in times:
                            unswept += 1
                            continue
                        planned += times[splits]
                        fastest += min(times.values())
                        worst = max(worst, times[splits] / min(
                            times.values()))
                    out.append({'kind': kind, 'dtype': dtype,
                                'resident': resident,
                                'overhead': overhead, 'shapes': len(rows),
                                'unswept': unswept, 'planned_ms': planned,
                                'fastest_ms': fastest, 'worst': worst})
        finally:
            setattr(conv, resident_name, saved[0])
            setattr(conv, overhead_name, saved[1])
            planner.cache_clear()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=60)
    p.add_argument('--reps', type=int, default=2)
    p.add_argument('--warmup', type=int, default=10)
    p.add_argument('--fit', metavar='JSONL',
                   help='fit the planners to an earlier run\'s output')
    args = p.parse_args(argv)
    if args.fit:
        with open(args.fit) as f:
            lines = [json.loads(line) for line in f
                     if line.startswith('{')]
        for row in fit(lines):
            print(json.dumps(row))
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError('split_sweep needs CUDA')
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    device = torch.cuda.get_device_name(0)
    backwards = list(dict.fromkeys(
        s for hw in ((384, 512), (543, 724), (768, 1024))
        for s in trunk_backward_shapes(*hw)
        if s[3] > conv._NARROW_MAX_COUT))
    sms = sm_count(dev)
    with tf32(False):
        for name, dtype in DTYPES.items():
            for shape in backwards:
                if name == 'bfloat16' and (shape[2] % 8 or shape[3] % 8):
                    continue            # the mma.sync path has no splits
                report(device, sms, 'bwd (H, W, K, Cout)', name, shape,
                       *sweep(shape, rng, dev, dtype))
            for shape in forward_shapes():
                if shape[2] % (4 if name == 'float32' else 8) or (
                        shape[3] % 4):
                    continue  # the scalar and mma.sync paths: no splits
                report(device, sms, 'fwd (H, W, Cin, Cout)', name, shape,
                       *sweep_forward(shape, rng, dev, dtype))
    for precision in DTYPES:
        for size in SIZES:
            hw, rates = end_to_end(size, args.steps, args.reps, args.warmup,
                                   precision)
            print(json.dumps({
                'device': device, 'precision': precision, 'size': size,
                'hw': list(hw), 'steps': args.steps,
                'it_s_with_splits': rates['split'],
                'it_s_tile_only': rates['tile'],
                'median_gain': float(np.median(rates['split'])
                                     / np.median(rates['tile']) - 1)}),
                flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
