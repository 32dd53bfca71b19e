"""Host cost of one kernel launch through the ctypes binding, by part.

    python -m style_transfer2_tpu_torch.launch_cost [--calls 200] [--rounds 15]

Needs CUDA; there is no CPU fallback. Times, on the host clock, batches of
back-to-back calls with no sync inside a batch (the card drains each batch
before the next starts), in rounds that alternate the two variants of each
pair, and prints one JSON line with the median microseconds per call:

  stream — torch.cuda.current_stream(dev).cuda_stream against
           torch._C._cuda_getCurrentRawStream(index) (_build.stream);
  loader — one st2_deprocess launch at the 96x128 rung with fixed
           arguments through the library loaded by ctypes.CDLL against
           ctypes.PyDLL; the same call with an empty plan, which returns
           before the launch (the ctypes call alone); and the whole
           deprocess wrapper with each;
  alloc  — torch.empty(..., device=) against Tensor.new_empty, given a
           tuple or the sizes as arguments, and torch.empty_like with a
           dtype, for the wrappers' outputs;
  conv_bf16 — at three bf16 conv shapes, the forward and backward
           wrappers on the planned path (wgmma_split at the last), on the
           unsplit wgmma path (their weights blocked once, then looked up)
           and on the mma.sync tile path, and the blocked-weights lookup
           alone.

_build.LOADER is the loader this measurement chose.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build
from .ops import conv, image

# (H, W, Cin, Cout) of the bf16 convs conv_bf16 times: a 512px conv3 shape
# and a 768x1024 conv2 shape, both planned on the unsplit wgmma path, and
# the 512px conv4_2 shape, planned on wgmma_split in both directions.
CONV_SHAPES = ((96, 128, 256, 256), (192, 256, 128, 128), (48, 64, 512, 512))


def per_call_us(fn, calls):
    """Host microseconds per call over `calls` back-to-back calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def compare(variants, calls, rounds):
    """Median us per call of each named variant, the variants timed in
    turns (a, b, b, a, ...) so that drift falls on both alike."""
    names = list(variants)
    times = {name: [] for name in names}
    for fn in variants.values():
        fn()                                    # warm-up
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(per_call_us(variants[name], calls))
    return {name: float(np.median(t)) for name, t in times.items()}


def conv_bf16(dev, calls, rounds):
    """{shape: us per call} of the bf16 conv wrappers on each path."""
    out = {}
    for h, w, cin, cout in CONV_SHAPES:
        bf = torch.bfloat16
        x = torch.randn(1, h, w, cin, device=dev).to(bf)
        wt = (torch.randn(3, 3, cin, cout, device=dev) * 0.05).to(bf)
        b = torch.zeros(cout, device=dev, dtype=bf)
        g = torch.randn(1, h, w, cout, device=dev).to(bf)
        y = torch.relu(torch.randn(1, h, w, cout, device=dev)).to(bf)
        wb = conv.backward_weights(wt)
        wgmma, tile = (conv.WGMMA, 1, cin), (conv.TILE, 1, cin)
        out['%dx%dx%dx%d' % (h, w, cin, cout)] = {
            **compare({
                'fwd_planned': lambda: conv._launch_fwd(x, wt, b),
                'fwd_wgmma': lambda: conv._launch_fwd(x, wt, b, wgmma),
                'fwd_tile': lambda: conv._launch_fwd(x, wt, b, tile)},
                calls, rounds),
            **compare({
                'bwd_planned': lambda: conv._launch_bwd(g, y, wb),
                'bwd_wgmma': lambda: conv._launch_bwd(
                    g, y, wb, (conv.WGMMA, 1, cout)),
                'bwd_tile': lambda: conv._launch_bwd(
                    g, y, wb, (conv.TILE, 1, cout))}, calls, rounds),
            **compare({'blocked_lookup': lambda: conv._wgmma_weights(wt)},
                      calls, rounds)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--calls', type=int, default=200)
    p.add_argument('--rounds', type=int, default=15)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('launch_cost needs CUDA')
    dev = torch.device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    x = torch.zeros((1, 96, 128, 3), dtype=torch.float32, device=dev)
    out = torch.empty((96, 128, 3), dtype=torch.float32, device=dev)
    plan = image._plan_arg(x.numel(), True)[1]
    empty_plan = image._plan_arg(0, True)[1]
    libs = {'CDLL': _build.bind(ctypes.CDLL),
            'PyDLL': _build.bind(ctypes.PyDLL)}
    raw = _build.stream(x)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()

    def launch(handle, plan=plan):
        return lambda: handle.st2_deprocess(x_ptr, out_ptr, plan, raw)

    def wrapper(handle):
        def call():
            _build._lib = handle
            return image._launch_deprocess(x)
        return call

    saved = _build._lib
    try:
        result = {
            'card': smi,
            'stream': compare({
                'current_stream': lambda: torch.cuda.current_stream(
                    dev).cuda_stream,
                'raw_stream': lambda: _build.stream(x)},
                args.calls, args.rounds),
            'loader_launch': compare({k: launch(h) for k, h in libs.items()},
                                     args.calls, args.rounds),
            'loader_call_only': compare(
                {k: launch(h, empty_plan) for k, h in libs.items()},
                args.calls, args.rounds),
            'loader_wrapper': compare(
                {k: wrapper(h) for k, h in libs.items()}, args.calls,
                args.rounds),
            'alloc': compare({
                'torch.empty': lambda: torch.empty(
                    (96, 128, 3), dtype=torch.float32, device=x.device),
                'new_empty(tuple)': lambda: x.new_empty((96, 128, 3)),
                'new_empty(ints)': lambda: x.new_empty(96, 128, 3),
                'empty_like(dtype)': lambda: torch.empty_like(
                    x, dtype=torch.float32)},
                args.calls, args.rounds),
            'conv_bf16': conv_bf16(dev, args.calls, args.rounds),
            'calls': args.calls, 'rounds': args.rounds,
            'loader_chosen': _build.LOADER.__name__}
    finally:
        _build._lib = saved
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
