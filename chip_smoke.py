#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own line; any failure raises and the script
exits non-zero:

  1. device  — CUDA must be available; prints nvidia-smi's name and power
               limit of the card.
  2. build   — compiles the kernels in style_transfer2_tpu_torch/csrc with
               nvcc (one process per source, in parallel) and prints the
               seconds taken.
  3. kernels — every hand-written kernel against its plain PyTorch version
               on the card (TF32 off), with median CUDA-event times of both:
               the conv kernels at the 512px main-path shapes and at the
               iterate shapes of the 1024px ladder's top rung and of its
               odd 543x724 rung, float32 and bfloat16, within stated
               tolerances, the forward's path (float32: tile, split,
               scalar; bfloat16: wgmma, wgmma_split, tile) and the
               backward's (narrow, split, tile; bfloat16 wgmma,
               wgmma_split) of each shape recorded, in bfloat16 the
               mma.sync kernel (tile) also held at every shape, forced
               and on views one element off, and each step's conv
               times summed beside cuDNN's;
               the batched engine's trunk: the 512px iterate shapes at
               N = 4 in both precisions, with their paths and cuDNN at
               N = 4, summed over a 4-lane step;
               the style branch at the taps of the 512px, 543x724 and
               768x1024 iterates, and with a lane axis at the 512px taps,
               4 lanes in one launch sequence, each lane also held against
               the one-map kernel on that lane and two torch.bmm timed as
               the library call; the image kernels (preprocess from uint8
               and float32, deprocess) at every rung of the 1024px ladder,
               bit for bit. The conv forward and backward and the style
               branch must give the same bits on a second call. Each row
               prints its time beside the plain version's
               (and their ratio), the least time the card could take (the
               bound) and the share of it reached, and, where one PyTorch
               call computes the same function, that call's time (cuDNN
               for the convs, one elementwise op for the image kernels).
               These times hold both host and device work: the card
               waits for the host's launch between its events.
  4. main    — the CLI's main() at --size 512 --optimizer lbfgs from the two
               example images, one step per dispatch (comparable with the
               first slice's runs), once in float32 and once in bfloat16:
               finite, falling loss, the PNG written, every kernel launched
               and each precision's conv paths (bfloat16: the wgmma kernel
               in both directions) among the launches.
  5. ladder  — the CLI's main() at --size 1024 --multi-scale --min-scale 96,
               20 L-BFGS iterations a rung in the default chunked dispatch,
               in float32 and in bfloat16 with a 20-iteration float32
               polish: finite losses, falling over the first rung, each
               warm-started rung starting at most WARM_START_RISE times
               the rung below's last loss, a 1024x768 PNG, every kernel
               launched; each rung's it/s, the polish's time and first and
               last loss, the wall time, then a single-scale 1024px run of
               the same iteration count for comparison.
  6. parity  — the CUDA engine against the CPU engine (the plain versions)
               on small inputs, 5 steps at one size and a 2-rung ladder:
               every trace key within the golden rtol.
  7. batch   — the CLI's --batch --lanes 4 at --size 512, L-BFGS, 20
               iterations one step a dispatch, in float32 and in bfloat16,
               full-width VGG-19 with random_params(0), on a directory of
               golden_gate.jpg, its three flips (one full wave of 4 lanes)
               and starry_night.jpg (a wave of one lane beside 3 inactive
               ones): each lane's loss finite and falling, five PNGs of
               their sizes, every kernel launched and the conv paths
               planned at N = 4 among the launches; each wave's it/s a
               lane and in aggregate beside phase 4's single-image it/s,
               and the peak device memory; then a 2-lane float32
               BatchedStyleTransfer against two single CUDA engines at
               48x64, 5 L-BFGS steps, every trace key within the golden
               rtol; batch.json.
  8. serve   — the web app (style_transfer2_tpu_torch.serve.app) on the
               card with config.ini's dispatch defaults (adaptive 60, depth
               2, latency target 2.0 s), driven over a real localhost
               socket by the browser protocol, full-width VGG-19 with
               random_params(0), the example images, initial_weights.yaml:
               (a) float32 at 512px: start, 60 iterates, applyParams with
               a style weight and the step size changed (newParams with no
               error), a resize to 768 (newSize, 30 iterates at the new
               grid), pause, /output a PNG of that grid, /stats naming the
               card; (b) bfloat16 with serve_ladder 20, ladder_min_scale
               256, serve_polish 10 at float32 to 512: each rung's grid,
               the driver respawned at float32 for the polish, the pause
               the schedule makes. Both: finite losses, falling over the
               first rung, the engine on CUDA, every kernel launched; each
               session's it/s (host clock and the app's itsPerS), first
               iterate, the control latency and the polish respawn's
               seconds printed; serve.json.
  9. profile — every kernel and library call timed in phase 3, on the
               same inputs: host_us, the host clock over HOST_CALLS
               back-to-back calls with no sync (the enqueue cost), then
               device_ms, its kernels' own time from torch.profiler's CUDA
               events over PROFILE_CALLS calls (several kernels of one call
               summed; two sessions that saw as many kernels must agree,
               else "not measured"), each step's conv device times summed
               beside cuDNN's
               and the bound, and each image kernel's share of its byte
               bound at 768x1024. Last: the host loops keep the card busy for
               seconds, and a profiler session leaves torch's host path
               slower for the rest of the process.

The line before the last is one JSON object with each kernel's measured
numbers; the last line is {"ok": true, "device": {...}}. Outputs go to
chiprun_out/chip_smoke/.
"""

import csv
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out' / 'chip_smoke'
CONTENT = ROOT / 'examples' / 'golden_gate.jpg'
STYLE = ROOT / 'examples' / 'starry_night.jpg'
ITERATIONS = 20
LADDER_ITERATIONS = 20     # per rung
POLISH = 20
# A warm-started rung's first loss over the last loss of the rung below:
# 0.897-1.032 on an H100 in float32 and bfloat16 (the content's new size
# and the resampled iterate move it a little). A resample that lost the
# optimized image would start near the random start's ~1e8.
WARM_START_RISE = 1.25

# Tolerances, as max |kernel - plain| / max(1, max |plain|), the plain
# version run in float32 with TF32 off on the same inputs: float32 sums the
# same products in another order; bfloat16 rounds the output to 8 mantissa
# bits (tests/test_pallas_conv.py uses 3e-2). The image kernels do the plain
# version's one float32 add or subtract per element: tolerance 0.
TOL = {'float32': 1e-4, 'bfloat16': 3e-2}
STYLE_TOL = 1e-4          # float32 only: the taps are float32 in both modes
PARITY_RTOL = 5e-3        # tests/test_golden.py's trace tolerance

# Calls of each kernel and library call under torch.profiler (device_ms),
# and back-to-back calls timed on the host clock (host_us).
PROFILE_CALLS = 3
# Sessions per profile: two, and more, up to PROFILE_ATTEMPTS, where they
# disagree on how many kernels they saw (some sessions see only part of a
# call's kernels). The sessions with the most kernels are kept, and two of
# them must agree.
PROFILE_SESSIONS = 2
PROFILE_ATTEMPTS = 4
HOST_CALLS = 200
# What the summary line sums for each kernel (the style branch has no
# library call: its library_* are None).
STEP_FIELDS = ('ms', 'plain_ms', 'bound_ms', 'library_ms', 'device_ms',
               'host_us', 'library_device_ms', 'library_host_us')

KERNELS = ('conv3x3_bias_relu_fwd', 'conv3x3_bias_relu_bwd',
           'fused_style_branch', 'preprocess', 'deprocess')
# Each kernel's sources (the first holds its entry point) and the TPU
# kernel it replaces. The convs' bfloat16 wgmma paths and their split sum
# run in conv3x3_wgmma.cu, everything else of the convs in conv3x3.cu.
_CONV_SOURCES = ('style_transfer2_tpu_torch/csrc/conv3x3.cu',
                 'style_transfer2_tpu_torch/csrc/conv3x3_wgmma.cu')
SOURCES = {
    'conv3x3_bias_relu_fwd': (_CONV_SOURCES,
                              'style_transfer2_tpu/ops/pallas/conv.py:174'),
    'conv3x3_bias_relu_bwd': (_CONV_SOURCES,
                              'style_transfer2_tpu/ops/pallas/conv.py:183'),
    'fused_style_branch': (('style_transfer2_tpu_torch/csrc/style.cu',),
                           'style_transfer2_tpu/ops/pallas/'
                           'style_kernel.py:35'),
    'preprocess': (('style_transfer2_tpu_torch/csrc/image.cu',),
                   'style_transfer2_tpu/ops/pallas/preprocess.py:34'),
    'deprocess': (('style_transfer2_tpu_torch/csrc/image.cu',),
                  'style_transfer2_tpu/ops/pallas/preprocess.py:40'),
}

# The serve phase: session (a) runs float32 at 512px, SERVE_ITERATES
# iterates, then a weight change and a resize to 768 with at least
# SERVE_RESIZE_ITERATES iterates there; session (b) climbs bfloat16 rungs
# (SERVE_LADDER iterations each) from SERVE_MIN_SCALE to 512, then a
# SERVE_POLISH-iteration float32 polish. SERVE_TIMEOUT bounds each.
SERVE_SIZE = 512
SERVE_RESIZE = 768
SERVE_ITERATES = 60          # session (a) at 512 before the weight change
SERVE_RESIZE_ITERATES = 30   # session (a) at the 768 grid
SERVE_LADDER = 20            # session (b): iterations a rung
SERVE_MIN_SCALE = 256
SERVE_POLISH = 10
SERVE_TIMEOUT = 240          # seconds, each session
SERVE_DEVICE = 'cuda'        # the app's device key (the CPU tests set cpu)
# The grids of session (b): utils.scales((384, 512), min_size=256).
SERVE_RUNGS = [(192, 256), (272, 362), (384, 512)]

# The ladder run's --size and --min-scale, and its rungs
# (utils.scales((768, 1024), min_size=96)).
LADDER_SIZE = 1024
MIN_SCALE = 96
LADDER_1024 = [(96, 128), (136, 181), (192, 256), (272, 362), (384, 512),
               (543, 724), (768, 1024)]


def trunk_convs(h, w):
    """(H, W, Cin, Cout) of each 3x3 conv the iterate runs up to conv4_2 on
    an h x w grid (ceil pools), forward and backward every step."""
    shapes, cin = [], 3
    for block, (n, cout) in enumerate(((2, 64), (2, 128), (4, 256),
                                       (2, 512))):
        if block:
            h, w = -(-h // 2), -(-w // 2)
        for _ in range(n):
            shapes.append((h, w, cin, cout))
            cin = cout
    return shapes


# The 512px main path: the 384x512 iterate, and the 410x512 style image
# through conv5_4 (forward, once; odd H after pools).
ITERATE_CONVS = trunk_convs(384, 512)
STYLE_CONVS = [
    (410, 512, 3, 64), (410, 512, 64, 64), (205, 256, 64, 128),
    (205, 256, 128, 128), (103, 128, 128, 256), (103, 128, 256, 256),
    (52, 64, 256, 512), (52, 64, 512, 512), (26, 32, 512, 512)]


# The iterate sizes whose conv rows chip_smoke sums over one step, by the
# `where` of their rows; '512x4' is the batch phase's step, four lanes of
# the 384x512 iterate at N = 4.
STEP_SIZES = {'512': '384x512', '543x724': '543x724', '1024': '768x1024',
              '512x4': '4 x 384x512'}
# Lanes of the batch phase's wave, and of the kernels phase's N = 4 conv
# rows and B = 4 style rows; the batch phase's --size and device (the CPU
# tests set a small size and cpu).
LANES = 4
BATCH_SIZE = 512
BATCH_DEVICE = 'cuda'


def style_taps(h, w):
    """(H, W, C) of the four style taps of an h x w iterate: conv1_1 ..
    conv4_1 (ceil pools)."""
    taps = []
    for c in (64, 128, 256, 512):
        taps.append((h, w, c))
        h, w = -(-h // 2), -(-w // 2)
    return taps


# The style taps of the 512px iterate, and of the 1024px ladder's odd
# 543x724 rung and its 768x1024 top.
STYLE_TAPS = {'512': style_taps(384, 512), '543x724': style_taps(543, 724),
              '1024': style_taps(768, 1024)}

# The least time the card could take: the larger of the operations over the peak rate of their type and the
# bytes over the memory rate, each input read once and each output written
# once. NVIDIA's H100 SXM data sheet: FP32 67 TFLOP/s outside the tensor
# cores, bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s.
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
HBM_BYTES_S = 3.35e12
ITEMSIZE = {'float32': 4, 'bfloat16': 2}


def bound(flops, nbytes, dtype_name='float32'):
    """(bound ms, 'operations' or 'bytes')."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_mem = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_mem else (t_mem, 'bytes')


def conv_bounds(shape, dtype_name, n=1):
    """Bounds (ms, kind) of the forward and the masked backward at (H, W,
    Cin, Cout) over n images: 2*9*n*H*W*Cin*Cout operations each; the
    forward moves x, w, b and y, the backward g, y, w and dx."""
    h, w, cin, cout = shape
    px = n * h * w
    flops = 2 * 9 * px * cin * cout
    size = ITEMSIZE[dtype_name]
    fwd = bound(flops, size * (px * (cin + cout) + 9 * cin * cout + cout),
                dtype_name)
    bwd = bound(flops, size * (px * (2 * cout + cin) + 9 * cin * cout),
                dtype_name)
    return fwd, bwd


def say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def median_ms(fn, torch, reps=15, warmup=3):
    """Median CUDA-event time of fn() in milliseconds, after warm-up. The
    card is idle between the two events until fn's launches arrive, so
    this time holds the host's launch work as well as the device's."""
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


def profile_session(fn, torch, calls):
    """(kernels seen, their summed device ms) of one torch.profiler session
    over `calls` calls of fn()."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.device_time for e in kernels) / 1e3


def agreed_ms(sessions, calls):
    """The device ms per call from (kernels seen, summed ms) sessions: the
    mean over the sessions that saw the most kernels, where at least two
    of them did and saw some; else None. A session that saw fewer kernels
    than another of the same calls missed some of them."""
    most = max(count for count, _ in sessions)
    kept = [ms for count, ms in sessions if count == most]
    if most == 0 or len(kept) < 2:
        return None
    return sum(kept) / len(kept) / calls


def device_ms(fn, torch, calls=PROFILE_CALLS):
    """The device's own milliseconds per call of fn(): the durations of
    every kernel it launched (all of them, where one call launches
    several), from torch.profiler's CUDA events over `calls` calls, by
    agreed_ms over PROFILE_SESSIONS sessions and up to PROFILE_ATTEMPTS
    where they disagree; None where no two agree. Call after fn has been
    warmed up. A profiler session leaves torch's host path slower for the
    rest of the process, so this runs after every other timing
    (phase_costs)."""
    sessions = []
    for _ in range(PROFILE_ATTEMPTS):
        sessions.append(profile_session(fn, torch, calls))
        if len(sessions) >= PROFILE_SESSIONS:
            ms = agreed_ms(sessions, calls)
            if ms is not None:
                return ms
    say('profile', 'no two sessions agree: (kernels, ms) %s' % sessions)
    return None


def host_us(fn, torch, calls=HOST_CALLS):
    """The host's microseconds per call of fn() over `calls` back-to-back
    calls with no sync: the enqueue cost. The card drains the queue after
    the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def rel_err(got, want):
    """(max abs error, that error over max(1, max |want|))."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def path_counts():
    """The conv wrappers' launches by direction and path."""
    from style_transfer2_tpu_torch.ops import conv
    return {'%s %s' % key: n for key, n in sorted(conv.path_launches.items())}


def require_paths(what, precision):
    """Each direction's kernels of the precision went through the paths
    its planner picks for the trunk: bf16 through the wgmma kernel (and the
    narrow backward, the mma.sync forward for conv1_1's 3 channels),
    float32 through its tile and scalar kernels."""
    from style_transfer2_tpu_torch.ops import conv
    counts = conv.path_launches
    want = ([('fwd', conv.WGMMA), ('bwd', conv.WGMMA), ('fwd', conv.TILE),
             ('bwd', conv.NARROW)] if precision == 'bfloat16'
            else [('fwd', conv.TILE), ('fwd', conv.SCALAR),
                  ('bwd', conv.NARROW)])
    for key in want:
        require(counts.get(key, 0) > 0, '%s %s: no %s launches on the %s '
                'path' % (what, precision, key[0], key[1]))


def counters():
    """Every kernel's launch count, by name."""
    from style_transfer2_tpu_torch.ops import conv, image, style
    return {'conv3x3_bias_relu_fwd': conv.launches('fwd'),
            'conv3x3_bias_relu_bwd': conv.launches('bwd'),
            'fused_style_branch': style.launches,
            'preprocess': image.preprocess_launches,
            'deprocess': image.deprocess_launches}


def reset_counters():
    from style_transfer2_tpu_torch.ops import conv, image, style
    style.launches = 0
    conv.path_launches.clear()
    image.preprocess_launches = image.deprocess_launches = 0


class CliLog(logging.Handler):
    """Keeps the CLI's log records, to read its per-rung and polish
    timings."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def args_of(self, msg):
        """The args of every kept record with this format string."""
        return [r.args for r in self.records if r.msg == msg]


def phase_device(torch):
    require(torch.cuda.is_available(), 'CUDA is not available')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    say('device', '%s, torch %s, CUDA %s, %d device(s)' % (
        torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))
    print(smi[0], flush=True)
    return smi[0]


def phase_build():
    from style_transfer2_tpu_torch import _build
    t0 = time.perf_counter()
    _build.lib()
    dt = time.perf_counter() - t0
    log = (_build.build_dir() / 'build.log')
    report = [line.strip() for line in log.read_text().splitlines()
              if 'registers' in line or 'spill' in line]
    say('build', 'kernels ready in %.1f s (%s)' % (dt, _build.build_dir()))
    for line in report:
        say('build', line)


def check_conv(torch, rng, shape, dtype_name, where, pending, n=1):
    """Holds the conv kernels against the plain version at one shape, over
    n images (the batched engine's lanes), and times both. Returns the row
    for kernels.json; appends to `pending` the (row, field, fn) of each
    device time to profile later."""
    import torch.nn.functional as F
    from style_transfer2_tpu_torch.ops import conv
    h, w, cin, cout = shape
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        dtype_name]
    dev = torch.device('cuda')

    def as_t(a):
        return torch.as_tensor(np.float32(a), device=dev).to(dtype)

    x = as_t(rng.randn(n, h, w, cin))
    wt = as_t(rng.normal(0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout)))
    b = as_t(rng.randn(cout) * 0.1)
    g = as_t(rng.randn(n, h, w, cout))

    # The reference is the plain version in float32 on the same (for bf16:
    # bf16-valued) inputs, TF32 off: the kernel computes that sum and
    # rounds once. The backward reference is autograd of the plain conv
    # with the cotangent masked by the kernel's own forward output: an
    # activation within rounding of zero can fall on either side of the
    # ReLU in two implementations, and each such flip moves a few dx
    # entries by a whole g*w term. The flips are counted, and the plain
    # bf16 version's own distance from the reference is printed beside.
    xr = x.detach().requires_grad_(True)
    x32 = x.float().requires_grad_(True)
    w32, b32, g32 = wt.float(), b.float(), g.float()
    w_bwd = conv.backward_weights(wt)
    y_k = conv.conv3x3_bias_relu(x, wt, b, w_bwd)
    y_r = conv.conv3x3_bias_relu_plain(x32, w32, b32)
    dx_k = torch.autograd.grad(conv.conv3x3_bias_relu(xr, wt, b, w_bwd), xr,
                               g)[0]
    pre_r = F.conv2d(x32.permute(0, 3, 1, 2), w32.permute(3, 2, 0, 1), b32,
                     padding=1).permute(0, 2, 3, 1)
    dx_r = torch.autograd.grad(pre_r, x32, g32 * (y_k > 0).float())[0]
    flips = int(((y_k > 0) != (y_r > 0)).sum())
    torch.cuda.synchronize()
    fe, fr = rel_err(y_k, y_r)
    be, br = rel_err(dx_k, dx_r)
    plain_note = ' (%d ReLU flips)' % flips
    if dtype != torch.float32:
        y_p = conv.conv3x3_bias_relu_plain(x, wt, b)
        dx_p = torch.autograd.grad(
            conv.conv3x3_bias_relu_plain(xr, wt, b), xr, g)[0]
        plain_note += ' (plain bf16 err %.2g/%.2g)' % (
            rel_err(y_p, y_r)[1], rel_err(dx_p, dx_r)[1])
        del y_p, dx_p
    require(math.isfinite(fr) and fr <= TOL[dtype_name],
            'conv fwd %s %s: rel err %.3g' % (dtype_name, shape, fr))
    require(math.isfinite(br) and br <= TOL[dtype_name],
            'conv bwd %s %s: rel err %.3g' % (dtype_name, shape, br))
    alt = {}
    if dtype != torch.float32:
        alt = check_mma_sync(torch, x, wt, b, g, y_k, w_bwd, y_r, dx_r,
                             '%s %s' % (dtype_name, shape))
        fe, be = (max([e] + [alt[k] for k in alt if k.startswith(d)
                             and k.endswith('_abs_err')])
                  for e, d in ((fe, 'fwd'), (be, 'bwd')))
    del x32, w32, b32, g32, y_r, pre_r, dx_k, dx_r

    y = y_k.detach()
    # Determinism: the split paths sum their partials in a fixed order, so
    # two calls on the same inputs give the same bits.
    require(torch.equal(conv._launch_fwd(x, wt, b),
                        conv._launch_fwd(x, wt, b)),
            'conv fwd %s %s: two calls differ' % (dtype_name, shape))
    require(torch.equal(conv._launch_bwd(g, y, w_bwd),
                        conv._launch_bwd(g, y, w_bwd)),
            'conv bwd %s %s: two calls differ' % (dtype_name, shape))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fpath, fsplits, _ = conv.fwd_plan(n, h, w, cin, cout, dtype, sms)
    path, splits, _ = conv.bwd_plan(n, h, w, cout, cin, dtype, sms)
    def fwd():
        return conv._launch_fwd(x, wt, b)

    def bwd():
        return conv._launch_bwd(g, y, w_bwd)

    fwd_k = median_ms(fwd, torch)
    fwd_p = median_ms(lambda: conv.conv3x3_bias_relu_plain(x, wt, b), torch)
    bwd_k = median_ms(bwd, torch)
    # Where the narrow kernel is planned, and in bfloat16 everywhere, the
    # tile kernel (in bfloat16 the mma.sync kernel) on the same inputs in
    # the same run.
    bwd_tile = fwd_tile = None
    if path == conv.NARROW or alt:
        bwd_tile = median_ms(lambda: conv._launch_bwd(
            g, y, w_bwd, (conv.TILE, 1, cout)), torch)
    if alt:
        fwd_tile = median_ms(lambda: conv._launch_fwd(
            x, wt, b, (conv.TILE, 1, cin)), torch)
    bwd_p = median_ms(lambda: torch.autograd.grad(
        conv.conv3x3_bias_relu_plain(xr, wt, b), xr, g), torch)
    # The plain backward's time includes its forward (autograd needs it);
    # report its backward alone.
    bwd_p = max(bwd_p - fwd_p, 0.0)
    # One library call each (cuDNN), a yardstick the port never calls: the
    # conv with its bias (no ReLU), and its input gradient of the masked
    # cotangent (the mask not included).
    x_c, w_c = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    g_c = (g * (y > 0).to(dtype)).permute(0, 3, 1, 2)

    def fwd_lib():
        return F.conv2d(x_c, w_c, b, padding=1)

    def bwd_lib():
        return torch.nn.grad.conv2d_input(x_c.shape, w_c, g_c, padding=1)

    fwd_l = median_ms(fwd_lib, torch)
    bwd_l = median_ms(bwd_lib, torch)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = conv_bounds(shape, dtype_name, n)
    gflop = 2 * 9 * n * h * w * cin * cout / 1e9
    say('kernels', 'conv %-8s %-8s %-21s fwd %s%s %.3f ms (plain %.3f, '
        'x%.2f; cuDNN %.3f, x%.2f; %.1f TFLOP/s, %.0f%% of bound %.3f) bwd '
        '%s%s %.3f ms (plain %.3f, x%.2f; cuDNN dgrad %.3f; %.0f%% of bound '
        '%.3f%s) err %.2g/%.2g%s; fwd and bwd bitwise repeatable%s' % (
            dtype_name, where, shape, fpath,
            '/%d' % fsplits if fsplits > 1 else '', fwd_k, fwd_p,
            fwd_k / fwd_p, fwd_l, fwd_k / fwd_l, gflop / fwd_k,
            100 * fwd_b / fwd_k, fwd_b, path,
            '/%d' % splits if splits > 1 else '', bwd_k, bwd_p,
            bwd_k / max(bwd_p, 1e-9), bwd_l, 100 * bwd_b / bwd_k, bwd_b,
            '' if bwd_tile is None else '; tile kernel %.3f' % bwd_tile,
            fr, br, plain_note, '' if not alt else (
                '; mma.sync fwd %.3f ms err %.2g, unaligned view %.2g; bwd '
                'err %.2g, unaligned view %.2g; bitwise repeatable' % (
                    fwd_tile, alt['fwd_tile_rel_err'],
                    alt['fwd_unaligned_rel_err'], alt['bwd_tile_rel_err'],
                    alt['bwd_unaligned_rel_err']))))
    row = {'kernel': 'conv3x3', 'dtype': dtype_name, 'where': where,
            'shape': list(shape), 'n': n, 'fwd_ms': fwd_k,
            'fwd_plain_ms': fwd_p, 'fwd_library_ms': fwd_l, 'fwd_bound_ms': fwd_b,
            'fwd_bound_by': fwd_by, 'bwd_bound_by': bwd_by,
            'bwd_ms': bwd_k, 'bwd_plain_ms': bwd_p, 'bwd_library_ms': bwd_l,
            'bwd_bound_ms': bwd_b, 'fwd_path': fpath, 'fwd_splits': fsplits,
            'bwd_path': path, 'bwd_splits': splits,
            'bwd_tile_ms': bwd_tile, 'fwd_tile_ms': fwd_tile,
            'fwd_tflops': gflop / fwd_k, 'fwd_rel_err': fr,
            'bwd_rel_err': br, 'fwd_abs_err': fe, 'bwd_abs_err': be,
            **{k: v for k, v in alt.items() if k.endswith('_rel_err')}}
    pending.extend((row, prefix, fn) for prefix, fn in (
        ('fwd_', fwd), ('bwd_', bwd), ('fwd_library_', fwd_lib),
        ('bwd_library_', bwd_lib)))
    return row


def check_mma_sync(torch, x, wt, b, g, y, w_bwd, y_r, dx_r, what):
    """Holds the bfloat16 mma.sync kernel, which the port takes for
    conv1_1's forward, channels not in eights and operands not 16-byte
    aligned, against the references y_r and dx_r at a shape the planner
    gives to wgmma: forced through its plan on the aligned inputs (16-byte
    staging), twice for the same bits, and planned on views one element
    off (element staging), which the wrappers must send to it. Returns
    {fwd|bwd}_{tile|unaligned}_{rel|abs}_err."""
    from style_transfer2_tpu_torch.ops import conv
    from style_transfer2_tpu_torch.utils import sm_count
    cin, cout = x.shape[3], wt.shape[3]

    def shifted(t):
        view = t.new_empty(t.numel() + 1)[1:].view_as(t)
        return view.copy_(t)

    def tile_launches():
        return {d: conv.path_launches.get((d, conv.TILE), 0)
                for d in ('fwd', 'bwd')}

    tile_fwd, tile_bwd = (conv.TILE, 1, cin), (conv.TILE, 1, cout)
    before = tile_launches()
    got = {
        'fwd_tile': conv._launch_fwd(x, wt, b, tile_fwd),
        'fwd_unaligned': conv._launch_fwd(shifted(x), wt, b),
        'bwd_tile': conv._launch_bwd(g, y, w_bwd, tile_bwd),
        'bwd_unaligned': conv._launch_bwd(shifted(g), y, w_bwd)}
    after = tile_launches()
    n, h, w = x.shape[:3]
    narrow = conv.bwd_plan(n, h, w, cout, cin, x.dtype, sm_count(
        x.device))[0] == conv.NARROW     # which an unaligned g keeps
    for d, want in (('fwd', 2), ('bwd', 1 if narrow else 2)):
        require(after[d] - before[d] == want, 'conv %s %s: an unaligned '
                'view did not take the mma.sync path' % (d, what))
    require(torch.equal(got['fwd_tile'],
                        conv._launch_fwd(x, wt, b, tile_fwd))
            and torch.equal(got['bwd_tile'],
                            conv._launch_bwd(g, y, w_bwd, tile_bwd)),
            'conv %s mma.sync: two calls differ' % what)
    errs = {}
    for name, out in got.items():
        err, rel = rel_err(out, y_r if name.startswith('fwd') else dx_r)
        require(math.isfinite(rel) and rel <= TOL['bfloat16'],
                'conv %s %s (mma.sync): rel err %.3g' % (name, what, rel))
        errs[name + '_abs_err'], errs[name + '_rel_err'] = err, rel
    return errs


def check_style(torch, rng, tap, where, pending, lanes=1):
    """Holds the style branch against its plain version at one tap and
    times both: one map with its (c, c) target, or `lanes` maps with their
    (lanes, c, c) targets in one launch sequence, each lane then also held
    against the one-map kernel on that lane alone and timed beside two
    torch.bmm (the Gram and the gradient product) as the library call."""
    from style_transfer2_tpu_torch.ops import style
    h, w, c = tap
    m = h * w
    dev = torch.device('cuda')
    feat = torch.relu(torch.as_tensor(np.float32(rng.randn(lanes, h, w, c)),
                                      device=dev))
    other = torch.relu(torch.as_tensor(np.float32(rng.randn(lanes, m, c)),
                                       device=dev))
    gram_style = torch.bmm(other.transpose(1, 2), other) / (m * c)
    if lanes == 1:
        feat, gram_style = feat[:1], gram_style[0]
    s_k, gd_k = style.fused_style_branch(feat, gram_style)
    s_p, gd_p = style.fused_style_branch_plain(feat, gram_style)
    s_2, gd_2 = style.fused_style_branch(feat, gram_style)
    torch.cuda.synchronize()
    require(torch.equal(s_k, s_2) and torch.equal(gd_k, gd_2),
            'style %s x%d: two calls differ' % (tap, lanes))

    def errs(s_got, gd_got, s_want, gd_want, target):
        """s_grad is ~1e-9 in magnitude: its error is relative to its own
        max; gram_diff's to the larger of its and the target's max."""
        se = float((s_got - s_want).abs().max())
        ge = float((gd_got - gd_want).abs().max())
        return (se, se / float(s_want.abs().max()), ge,
                ge / max(float(gd_want.abs().max()),
                         float(target.abs().max())))

    se, sr, ge, gr = errs(s_k, gd_k, s_p, gd_p, gram_style)
    require(math.isfinite(sr) and sr <= STYLE_TOL,
            'style s_grad %s x%d: rel err %.3g' % (tap, lanes, sr))
    require(math.isfinite(gr) and gr <= STYLE_TOL,
            'style gram_diff %s x%d: rel err %.3g' % (tap, lanes, gr))
    lane_err = f64_err = None
    if lanes > 1:
        # s_grad of the kernel, of the plain version and of two torch.bmm
        # against a float64 reference, each relative to the reference's max.
        x64 = feat.double().reshape(lanes, m, c)
        scale = 2.0 / (c * c * m * c)
        gd64 = (torch.bmm(x64.transpose(1, 2), x64) / (m * c)
                - gram_style.double())
        s64 = torch.bmm(x64, gd64).reshape(feat.shape) * scale
        del x64, gd64
        flat = feat.reshape(lanes, m, c)
        gd_b = torch.bmm(flat.transpose(1, 2), flat) / (m * c) - gram_style
        s_b = torch.bmm(flat, gd_b).reshape(feat.shape) * scale
        f64_err = {name: float((got.double() - s64).abs().max()
                               / s64.abs().max())
                   for name, got in (('kernel', s_k), ('plain', s_p),
                                     ('bmm', s_b))}
        del s64, gd_b, s_b
        lane_err = 0.0
        for lane in range(lanes):
            s_1, gd_1 = style.fused_style_branch(feat[lane:lane + 1],
                                                 gram_style[lane])
            _, lsr, _, lgr = errs(s_k[lane:lane + 1], gd_k[lane], s_1, gd_1,
                                  gram_style[lane])
            require(max(lsr, lgr) <= STYLE_TOL, 'style %s lane %d of %d '
                    'against the one-map kernel: rel err %.3g/%.3g'
                    % (tap, lane, lanes, lsr, lgr))
            lane_err = max(lane_err, lsr, lgr)

    def kernel():
        return style._launch(feat, gram_style)

    t_k = median_ms(kernel, torch)
    t_p = median_ms(
        lambda: style.fused_style_branch_plain(feat, gram_style), torch)
    lib, t_l = None, None
    if lanes > 1:
        def lib():
            return (torch.bmm(flat.transpose(1, 2), flat),
                    torch.bmm(flat, gd_k))

        t_l = median_ms(lib, torch)
    # Operations: M*C*(C+1) for the Gram (symmetric: the upper triangle
    # with its diagonal) and 2*M*C^2 for the gradient product; bytes: X and
    # G_style read, and G_diff and s_grad written, once; each per lane.
    t_b, t_by = bound(lanes * (m * c * (c + 1) + 2 * m * c * c),
                      lanes * 4 * (2 * m * c + 2 * c * c))
    say('kernels', 'style float32 %-8s %-16s %.3f ms (plain, two cuBLAS '
        'matmuls, %.3f; x%.2f; %.0f%% of bound %.3f) err %.2g/%.2g; '
        'bitwise repeatable%s' % (
            where, tap, t_k, t_p, t_k / t_p, 100 * t_b / t_k, t_b, sr, gr,
            '' if lanes == 1 else '; %d lanes in one launch, two torch.bmm '
            '%.3f (x%.2f), each lane within %.2g of the one-map kernel; '
            's_grad against float64: kernel %.2g, plain %.2g, torch.bmm '
            '%.2g' % (lanes, t_l, t_k / t_l, lane_err, f64_err['kernel'],
                      f64_err['plain'], f64_err['bmm'])))
    row = {'kernel': 'fused_style_branch', 'dtype': 'float32',
           'where': where, 'shape': list(tap), 'lanes': lanes, 'ms': t_k,
           'plain_ms': t_p, 'library_ms': t_l, 'bound_ms': t_b,
           'bound_by': t_by, 's_grad_rel_err': sr, 'gram_diff_rel_err': gr,
           'lane_rel_err': lane_err, 'f64_rel_err': f64_err,
           'abs_err': max(se, ge)}
    pending.append((row, '', kernel))
    if lib is not None:
        pending.append((row, 'library_', lib))
    return row


def check_image(torch, rng, hw, pending):
    """Preprocess from uint8 and from float32 and deprocess at one rung,
    bit for bit against the plain versions. Times: the kernel alone on a
    device tensor against the plain version's device op and against one
    PyTorch call of the same function on the same device tensor (the
    subtract with its dtype promotion; the add), and preprocess end to end
    from the host array (the kernel's input crosses in its own dtype, the
    plain version's as float32)."""
    from style_transfer2_tpu_torch.ops import image
    dev = torch.device('cuda')
    mean = torch.as_tensor(image.MEAN_RGB, device=dev)
    rows = []
    for dtype_name in ('uint8', 'float32'):
        img = (rng.randint(0, 256, hw + (3,)).astype(np.uint8)
               if dtype_name == 'uint8'
               else np.float32(rng.uniform(-20, 275, hw + (3,))))
        x_k = image.preprocess(img, dev)
        x_p = image.preprocess_plain(img, dev)
        y_k = image.deprocess_on_device(x_k)
        y_p = image.deprocess_plain(x_k)
        torch.cuda.synchronize()
        pre_err = float((x_k - x_p).abs().max())
        de_err = float((y_k - y_p).abs().max())
        require(torch.equal(x_k, x_p), 'preprocess %s %s: max abs err %.3g'
                % (dtype_name, hw, pre_err))
        require(torch.equal(y_k, y_p), 'deprocess %s: max abs err %.3g'
                % (hw, de_err))
        src = torch.from_numpy(img).to(dev)
        src32 = src.float()

        def pre():
            return image._launch_preprocess(src)

        def de():
            return image._launch_deprocess(x_k)

        def pre_lib():
            return torch.sub(src, mean)

        def de_lib():
            return torch.add(x_k[0], mean)

        pre_k = median_ms(pre, torch)
        pre_p = median_ms(lambda: src32[None] - mean, torch)
        e2e_k = median_ms(lambda: image.preprocess(img, dev), torch)
        e2e_p = median_ms(lambda: image.preprocess_plain(img, dev), torch)
        de_k = median_ms(de, torch)
        de_p = median_ms(lambda: image.deprocess_plain(x_k), torch)
        pre_l = median_ms(pre_lib, torch)
        de_l = median_ms(de_lib, torch)
        # Bytes: the image in its own dtype and 12 bytes a pixel out
        # (preprocess); 12 in and 12 out (deprocess).
        px = hw[0] * hw[1]
        pre_b = bound(0, px * (3 * src.element_size() + 12))[0]
        de_b = bound(0, px * 24)[0]
        say('kernels', 'image %-7s %-12s preprocess %.4f ms (plain %.4f, '
            'x%.2f; torch.sub %.4f; %.0f%% of bound %.4f), from host %.3f '
            'ms (plain %.3f); deprocess %.4f ms (plain %.4f, x%.2f; '
            'torch.add %.4f; %.0f%% of bound %.4f); bitwise equal' % (
                dtype_name, hw, pre_k, pre_p, pre_k / pre_p, pre_l,
                100 * pre_b / pre_k, pre_b, e2e_k, e2e_p, de_k, de_p,
                de_k / de_p, de_l, 100 * de_b / de_k, de_b))
        rows.append({'kernel': 'image', 'dtype': dtype_name,
                     'shape': list(hw), 'preprocess_ms': pre_k,
                     'preprocess_plain_ms': pre_p,
                     'preprocess_from_host_ms': e2e_k,
                     'preprocess_from_host_plain_ms': e2e_p,
                     'deprocess_ms': de_k, 'deprocess_plain_ms': de_p,
                     'preprocess_library_ms': pre_l,
                     'deprocess_library_ms': de_l,
                     'preprocess_bound_ms': pre_b,
                     'deprocess_bound_ms': de_b,
                     'preprocess_bound_by': 'bytes',
                     'deprocess_bound_by': 'bytes',
                     'preprocess_abs_err': pre_err,
                     'deprocess_abs_err': de_err})
        pending.extend((rows[-1], prefix, fn) for prefix, fn in (
            ('preprocess_', pre), ('deprocess_', de),
            ('preprocess_library_', pre_lib),
            ('deprocess_library_', de_lib)))
    return rows


def phase_kernels(torch):
    """Every kernel against its plain version, with its times. Returns the
    worst absolute error of each kernel, the rows of kernels.json, the
    (row, field prefix) that each kernel's summary entry sums, and the
    (row, field prefix, fn) of each call still to cost (phase_costs)."""
    rng = np.random.RandomState(0)
    rows, pending = [], []
    worst = dict.fromkeys(KERNELS, 0.0)
    # What the summary line sums for each kernel: float32 at one 512px
    # step's shapes for the convs and the style branch (a shape run three
    # times a step counts three times), uint8 over the 7 rungs of the
    # 1024px ladder for the image kernels.
    parts = {k: [] for k in KERNELS}
    # (dtype, where) -> the conv rows of one step at that iterate size, a
    # shape run three times a step three times.
    steps = {}

    # The N = 4 rows draw from their own generator, so that the rows above
    # keep their inputs.
    lanes_rng = np.random.RandomState(LANES)
    for dtype_name in ('float32', 'bfloat16'):
        cases = ([(s, '512') for s in ITERATE_CONVS]
                 + [(s, 'style') for s in STYLE_CONVS]
                 + [(s, '543x724') for s in trunk_convs(543, 724)]
                 + [(s, '1024') for s in trunk_convs(768, 1024)]
                 + [(s, '512x4') for s in ITERATE_CONVS])
        seen = {}
        for shape, where in cases:
            key = (shape, where)
            if key not in seen:
                if where == '512x4':
                    seen[key] = check_conv(torch, lanes_rng, shape,
                                           dtype_name, where, pending, LANES)
                else:
                    seen[key] = check_conv(torch, rng, shape, dtype_name,
                                           where, pending)
                rows.append(seen[key])
            row = seen[key]
            worst['conv3x3_bias_relu_fwd'] = max(
                worst['conv3x3_bias_relu_fwd'], row['fwd_abs_err'])
            worst['conv3x3_bias_relu_bwd'] = max(
                worst['conv3x3_bias_relu_bwd'], row['bwd_abs_err'])
            if dtype_name == 'float32' and where == '512':
                parts['conv3x3_bias_relu_fwd'].append((row, 'fwd_'))
                parts['conv3x3_bias_relu_bwd'].append((row, 'bwd_'))
            if where in STEP_SIZES:
                steps.setdefault((dtype_name, where), []).append(row)
        for where, size in STEP_SIZES.items():
            step_sums(steps[(dtype_name, where)], dtype_name, size)

    for where, taps in list(STYLE_TAPS.items()) + [
            ('512x4', STYLE_TAPS['512'])]:
        total = [0.0, 0.0, 0.0]
        for tap in taps:
            if where == '512x4':
                row = check_style(torch, lanes_rng, tap, where, pending,
                                  LANES)
            else:
                row = check_style(torch, rng, tap, where, pending)
            rows.append(row)
            worst['fused_style_branch'] = max(worst['fused_style_branch'],
                                              row['abs_err'])
            for i, field in enumerate(('ms', 'plain_ms', 'bound_ms')):
                total[i] += row[field]
            if where == '512':
                parts['fused_style_branch'].append((row, ''))
        say('kernels', 'style float32 summed over the %s taps: %.3f ms '
            '(plain %.3f, x%.2f; %.0f%% of bound %.3f)' % (
                where, total[0], total[1], total[0] / total[1],
                100 * total[2] / total[0], total[2]))

    for hw in LADDER_1024:
        for row in check_image(torch, rng, hw, pending):
            rows.append(row)
            worst['preprocess'] = max(worst['preprocess'],
                                      row['preprocess_abs_err'])
            worst['deprocess'] = max(worst['deprocess'],
                                     row['deprocess_abs_err'])
            if row['dtype'] == 'uint8':
                for name in ('preprocess', 'deprocess'):
                    parts[name].append((row, name + '_'))
    image_sums(parts, ('ms', 'library_ms'), 'kernels', 'ms', 4)
    write_kernels_json(rows)
    return worst, rows, parts, pending, steps


def step_sums(step_rows, dtype_name, size):
    """Prints the conv kernels' launch-inclusive times summed over one
    step's shapes beside the plain version's and cuDNN's, and their ratio
    to cuDNN's."""
    total = {field: sum(r[field] for r in step_rows) for field in (
        'fwd_ms', 'fwd_plain_ms', 'fwd_library_ms', 'fwd_bound_ms', 'bwd_ms',
        'bwd_plain_ms', 'bwd_library_ms', 'bwd_bound_ms')}
    say('kernels', 'conv %s summed over one %s step\'s shapes: fwd %.3f ms '
        '(plain %.3f; cuDNN %.3f, x%.3f; bound %.3f), bwd %.3f ms (plain '
        '%.3f; cuDNN dgrad %.3f, x%.3f; bound %.3f)' % (
            dtype_name, size, total['fwd_ms'], total['fwd_plain_ms'],
            total['fwd_library_ms'], total['fwd_ms'] / total['fwd_library_ms'],
            total['fwd_bound_ms'], total['bwd_ms'], total['bwd_plain_ms'],
            total['bwd_library_ms'], total['bwd_ms'] / total['bwd_library_ms'],
            total['bwd_bound_ms']))


def image_sums(parts, fields, phase, unit, digits):
    """Prints each image kernel's `fields` (its own, its library call's)
    summed over the 7 rungs, uint8, and their ratio."""
    for name, lib in (('preprocess', 'torch.sub'), ('deprocess', 'torch.add')):
        mine, theirs = (sum(r[pre + field] for r, pre in parts[name])
                        for field in fields)
        say(phase, '%s from uint8 over the 7 rungs: %.*f %s, %s %.*f (x%.2f)'
            % (name, digits, mine, unit, lib, digits, theirs, mine / theirs))


def write_kernels_json(rows):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / 'kernels.json').write_text(json.dumps(rows, indent=1))


def phase_costs(torch, rows, parts, pending, steps):
    """Each kernel's and library call's host_us, then its device_ms, on the
    inputs of phase 3, after every other phase: the host loops keep the
    card busy for seconds (which would heat it under the timings that
    follow), and a profiler session slows torch's host path for the rest
    of the process. kernels.json is written again with both."""
    t0 = time.perf_counter()
    for row, prefix, fn in pending:
        row[prefix + 'host_us'] = host_us(fn, torch)
    t1 = time.perf_counter()
    # Keep CUPTI subscribed from one profiler session to the next: torch
    # 2.11 otherwise tears it down after each session and sets it up again
    # at the next, and some sessions on an H100 then held the launches but
    # none of the kernels.
    os.environ['TEARDOWN_CUPTI'] = '0'
    for row, prefix, fn in pending:
        row[prefix + 'device_ms'] = device_ms(fn, torch)
    missing = sum(row[prefix + 'device_ms'] is None
                  for row, prefix, _ in pending)
    say('profile', '%d calls: host_us in %.1f s, device_ms in %.1f s (%d '
        'not measured)' % (len(pending), t1 - t0, time.perf_counter() - t1,
                           missing))
    for row in rows:
        prefixes = [k[:-len('device_ms')] for k in row
                    if k.endswith('device_ms')]
        say('profile', '%s %s %s %s: %s' % (
            row['kernel'], row['dtype'], row.get('where', ''),
            tuple(row['shape']), '; '.join(
                '%s %s%s, host %.1f us' % (
                    prefix.rstrip('_') or 'kernel',
                    fmt(row[prefix + 'device_ms']), share(row, prefix),
                    row[prefix + 'host_us'])
                for prefix in prefixes)))
    image_sums(parts, ('host_us', 'library_host_us'), 'profile', 'host us',
               1)
    for (dtype_name, where), step_rows in steps.items():
        say('profile', 'conv %s %s step, summed: %s' % (
            dtype_name, STEP_SIZES[where], '; '.join(
                device_sum(step_rows, pre, lib) for pre, lib in (
                    ('fwd_', 'cuDNN'), ('bwd_', 'cuDNN dgrad')))))
    top = [r for r in rows if r['kernel'] == 'image'
           and tuple(r['shape']) == LADDER_1024[-1]]
    say('profile', 'image kernels at %dx%d, device time against the byte '
        'bound:%s' % (LADDER_1024[-1] + (';'.join(
            ' %s %s%s' % (name, r['dtype'], share(r, name + '_'))
            for r in top for name in ('preprocess', 'deprocess')),)))
    write_kernels_json(rows)


def device_sum(step_rows, pre, lib):
    """'fwd device_ms X (cuDNN Y, xR; S% of bound B), host H us (cuDNN
    L)' over one step's rows; 'not measured' where a row's device time
    is."""
    def total(field):
        values = [r[pre + field] for r in step_rows]
        return None if None in values else sum(values)
    mine, theirs = total('device_ms'), total('library_device_ms')
    bound_ms = total('bound_ms')
    text = '%s device_ms %s' % (pre.rstrip('_'), fmt(mine))
    if mine is not None and theirs is not None:
        text += ' (%s %.4f ms, x%.3f; %.1f%% of bound %.3f)' % (
            lib, theirs, mine / theirs, 100 * bound_ms / mine, bound_ms)
    return text + ', host %.1f us (%s %.1f)' % (
        total('host_us'), lib, total('library_host_us'))


def share(row, prefix):
    """' (x% of bound)' for a measured device time whose kernel has a
    bound."""
    bound_ms, ms = row.get(prefix + 'bound_ms'), row[prefix + 'device_ms']
    if bound_ms is None or ms is None:
        return ''
    return ' (%.1f%% of bound)' % (100 * bound_ms / ms)


def fmt(ms):
    return 'not measured' if ms is None else '%.4f ms' % ms


def summarize(parts):
    """Each kernel's summary entry: the fields of STEP_FIELDS summed over
    its rows (None for the style branch's library call, which no one
    PyTorch call computes), and bound_by the kind holding the larger share
    of the summed bound."""
    step = {}
    for name, contributions in parts.items():
        entry = {}
        for field in STEP_FIELDS:
            values = [row.get(pre + field) for row, pre in contributions]
            entry[field] = None if None in values else sum(values)
        by = {}
        for row, pre in contributions:
            kind = row[pre + 'bound_by']
            by[kind] = by.get(kind, 0.0) + row[pre + 'bound_ms']
        entry['bound_by'] = max(by, key=by.get)
        step[name] = entry
    return step


def read_trace(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def require_all_launched(counts, what):
    for name, n in counts.items():
        require(n > 0, '%s: kernel %s never launched' % (what, name))


def phase_main(torch):
    """The 512px single-scale measurement, one step per dispatch: every
    trace row carries its own time, and the steady-state rate stays
    comparable with runs from before the chunked dispatch."""
    from style_transfer2_tpu_torch import cli
    from PIL import Image
    launches = dict.fromkeys(KERNELS, 0)
    rates = {}
    for precision in ('float32', 'bfloat16'):
        png = OUT_DIR / ('main_%s.png' % precision)
        trace_csv = OUT_DIR / ('main_%s.csv' % precision)
        png.unlink(missing_ok=True)
        reset_counters()
        t0 = time.perf_counter()
        rc = cli.main([str(CONTENT), str(STYLE), '-o', str(png),
                       '--size', '512', '--iterations', str(ITERATIONS),
                       '--optimizer', 'lbfgs', '--precision', precision,
                       '--steps-per-dispatch', '1', '--pipeline-depth', '1',
                       '--trace-csv', str(trace_csv)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        paths = path_counts()
        require(rc == 0, 'cli.main returned %r' % (rc,))
        require_all_launched(counts, 'main ' + precision)
        require_paths('main', precision)
        for name, n in counts.items():
            launches[name] += n

        rows = read_trace(trace_csv)
        losses = [float(r['loss']) for r in rows]
        steps = [r for r in rows if r.get('fevals')]
        require(len(steps) == ITERATIONS, '%d step rows' % len(steps))
        require(all(math.isfinite(v) for v in losses), 'non-finite loss')
        require(losses[-1] < losses[0], 'loss did not fall: %.6g -> %.6g'
                % (losses[0], losses[-1]))
        times = [float(r['time']) for r in steps]
        it_s = (len(times) - 1) / (times[-1] - times[0])
        with Image.open(png) as img:
            require(img.size == (512, 384), 'PNG size %s' % (img.size,))
        rates[precision] = it_s
        say('main', '%s: %d L-BFGS iterations at 512x384, loss %.6g -> '
            '%.6g, %.2f it/s (steady), %.1f s wall; launches %s; conv '
            'paths %s' % (precision, ITERATIONS, losses[0], losses[-1],
                          it_s, wall, counts, paths))
    return launches, rates


def split_rungs(rows):
    """Trace rows split at each L-BFGS prime row (no fevals): one list per
    rung, since every rung's resample and set_content re-prime."""
    rungs = []
    for row in rows:
        if not row.get('fevals'):
            rungs.append([])
        rungs[-1].append(row)
    return rungs


def phase_ladder(torch, log):
    """The coarse-to-fine 1024px CLI run, in float32 and in bfloat16 with
    a float32 polish, each against a single-scale 1024px run of as many
    iterations."""
    from style_transfer2_tpu_torch import cli
    from PIL import Image
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    common = [str(CONTENT), str(STYLE), '--size', str(LADDER_SIZE),
              '--optimizer', 'lbfgs']
    top_wh = LADDER_1024[-1][::-1]
    for precision, extra in (('float32', []),
                             ('bfloat16', ['--polish', str(POLISH)])):
        png = OUT_DIR / ('ladder_%s.png' % precision)
        trace_csv = OUT_DIR / ('ladder_%s.csv' % precision)
        png.unlink(missing_ok=True)
        reset_counters()
        log.records.clear()
        t0 = time.perf_counter()
        rc = cli.main(common + [
            '-o', str(png), '--multi-scale', '--min-scale', str(MIN_SCALE),
            '--iterations', str(LADDER_ITERATIONS), '--precision', precision,
            '--trace-csv', str(trace_csv)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        paths = path_counts()
        require(rc == 0, 'cli.main returned %r' % (rc,))
        require_all_launched(counts, 'ladder ' + precision)
        require_paths('ladder', precision)
        for name, n in counts.items():
            launches[name] += n
        rung_logs = log.args_of('scale %dx%d: %d iters in %.2fs '
                                '(%.2f it/s)')

        rungs = split_rungs(read_trace(trace_csv))
        require(len(rungs) == len(LADDER_1024), '%d rungs in the trace'
                % len(rungs))
        require([tuple(a[:2]) for a in rung_logs] == LADDER_1024,
                'rungs logged: %s' % ([a[:2] for a in rung_logs],))
        # The loss must fall over the first rung, from the random start.
        # A warm-started rung optimizes a new objective (the content at the
        # new size, the first rung's norms), and the reference's fixed-step
        # L-BFGS overshoots at its first step and need not get back below
        # the rung's first evaluation within 20 iterations (the JAX CLI
        # does the same); what the ladder must show there is that the warm
        # start carries the optimized image up: each rung's first
        # evaluation at most WARM_START_RISE times the last of the rung
        # below.
        last = None
        for rung, (hw, rows, args) in enumerate(zip(LADDER_1024, rungs,
                                                    rung_logs)):
            losses = [float(r['loss']) for r in rows]
            require(len(rows) == LADDER_ITERATIONS + 1,
                    'rung %s: %d trace rows' % (hw, len(rows)))
            require(all(math.isfinite(v) for v in losses),
                    'rung %s: non-finite loss' % (hw,))
            if rung == 0:
                require(losses[-1] < losses[0], 'rung %s: loss did not '
                        'fall: %.6g -> %.6g' % (hw, losses[0], losses[-1]))
            else:
                require(losses[0] <= WARM_START_RISE * last, 'rung %s: '
                        'warm start at loss %.6g, the rung below ended at '
                        '%.6g' % (hw, losses[0], last))
            last = losses[-1]
            say('ladder', '%s rung %dx%d: %d iterations in %.3f s, %.2f '
                'it/s, loss %.6g -> %.6g' % (precision, hw[0], hw[1],
                                             args[2], args[3], args[4],
                                             losses[0], losses[-1]))
        with Image.open(png) as img:
            require(img.size == top_wh, 'PNG size %s' % (img.size,))
        entry = {'wall_s': wall, 'rungs': [
            {'hw': list(hw), 'it_s': a[4], 's': a[3]}
            for hw, a in zip(LADDER_1024, rung_logs)]}
        if extra:
            polish = read_trace(OUT_DIR / ('ladder_%s.polish.csv'
                                           % precision))
            losses = [float(r['loss']) for r in polish]
            require(len(polish) == POLISH + 1, '%d polish rows'
                    % len(polish))
            require(all(math.isfinite(v) for v in losses),
                    'non-finite polish loss')
            polish_s = [a[1] for a in
                        log.args_of('polish: %d iters in %.2fs')]
            require(len(polish_s) == 1, 'polish time not logged')
            entry['polish'] = {'s': polish_s[0], 'first_loss': losses[0],
                               'last_loss': losses[-1]}
            say('ladder', '%s polish: %d float32 iterations at %dx%d in '
                '%.3f s, loss %.6g -> %.6g' % (
                    precision, POLISH, top_wh[1], top_wh[0], polish_s[0],
                    losses[0], losses[-1]))
        say('ladder', '%s: %d rungs x %d iterations%s, %.2f s wall; '
            'launches %s; conv paths %s' % (
                precision, len(LADDER_1024), LADDER_ITERATIONS,
                ' + %d polish' % POLISH if extra else '', wall, counts,
                paths))

        # The single-scale run of as many iterations, for the first
        # benchmark's comparison (a measurement, not a checked path).
        png1 = OUT_DIR / ('single_%s.png' % precision)
        csv1 = OUT_DIR / ('single_%s.csv' % precision)
        t0 = time.perf_counter()
        rc = cli.main(common + [
            '-o', str(png1), '--precision', precision, '--iterations',
            str(LADDER_ITERATIONS * len(LADDER_1024)),
            '--trace-csv', str(csv1)] + extra)
        torch.cuda.synchronize()
        entry['single_scale_wall_s'] = time.perf_counter() - t0
        require(rc == 0, 'single-scale cli.main returned %r' % (rc,))
        single = [float(r['loss']) for r in read_trace(csv1)]
        entry['single_scale_loss'] = [single[0], single[-1]]
        entry['ladder_final_loss'] = float(rungs[-1][-1]['loss'])
        with Image.open(png1) as img:
            require(img.size == top_wh, 'PNG size %s' % (img.size,))
        say('ladder', '%s single-scale %dx%d, %d iterations%s: %.2f s '
            'wall (ladder %.2f s); loss %.6g -> %.6g before any polish '
            '(ladder ends at %.6g)' % (
                precision, top_wh[1], top_wh[0],
                LADDER_ITERATIONS * len(LADDER_1024),
                ' + %d polish' % POLISH if extra else '',
                entry['single_scale_wall_s'], wall, single[0], single[-1],
                entry['ladder_final_loss']))
        summary[precision] = entry
    (OUT_DIR / 'ladder.json').write_text(json.dumps(summary, indent=1))
    return launches


def phase_parity(torch):
    """The CUDA engine against the CPU engine on small inputs: 5 steps at
    48x64, and a 2-rung ladder 24x32 -> 34x45 in chunks."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    rng = np.random.RandomState(0)
    content, style_img, inp = (rng.randint(0, 256, (48, 64, 3)).astype(
        np.uint8) for _ in range(3))
    rung1, rung2 = (rng.randint(0, 256, hw + (3,)).astype(np.uint8)
                    for hw in ((24, 32), (34, 45)))
    weights = {'content': {'conv4_2': 0.08},
               'style': {n: 1.0 for n in
                         ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1')}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    params = random_params(0)
    traces = {}
    for device in ('cpu', 'cuda'):
        st = StyleTransfer(params, 'float32', device=device)
        st.set_weights(weights, scalars)
        st.set_content(content)
        st.set_style(style_img)
        st.set_input(inp)
        require(st.start(), 'parity engine did not start')
        steps = [st.step(fetch_image=False)[1] for _ in range(5)]

        lad = StyleTransfer(params, 'float32', device=device)
        lad.set_weights(weights, scalars)
        lad.set_content(rung1)
        lad.set_style(style_img)
        lad.set_input(inp[:24, :32])
        require(lad.start(), 'ladder parity engine did not start')
        lad.run_steps(3)
        lad.resample_input((34, 45))
        lad.set_content(rung2)
        require(lad.start(), 'ladder parity engine did not restart')
        lad.run_steps(3)
        traces[device] = (steps, [t.data for t in lad.traces])
    worst = [0.0, 0.0]
    for which in (0, 1):
        want_rows, got_rows = traces['cpu'][which], traces['cuda'][which]
        require(len(want_rows) == len(got_rows), 'parity: row counts')
        for i, (want, got) in enumerate(zip(want_rows, got_rows)):
            for key, value in want.items():
                if key in ('time', 'fevals'):
                    continue
                err = abs(got[key] - value) / max(abs(value), 1e-30)
                worst[which] = max(worst[which], err)
                require(err <= PARITY_RTOL, 'trace %s at row %d: cuda %.6g '
                        'cpu %.6g' % (key, i, got[key], value))
    say('parity', '5 float32 L-BFGS steps at 48x64, CUDA vs CPU engine: '
        'worst trace rel err %.3g (rtol %g)' % (worst[0], PARITY_RTOL))
    say('parity', '2-rung float32 L-BFGS ladder 24x32 -> 34x45, 3 steps a '
        'rung: worst trace rel err %.3g (rtol %g)' % (worst[1],
                                                      PARITY_RTOL))


class GridLog:
    """Records (method, iterate counter, grid after) for every engine call
    that changes the iterate's grid or the objective: iterates numbered
    above the counter ran after it (the driver applies control with no
    dispatch in flight)."""

    METHODS = ('set_input', 'resample_input', 'set_weights')

    def __init__(self, cls):
        self.cls = cls
        self.events = []
        self.saved = {name: getattr(cls, name) for name in self.METHODS}
        for name, real in self.saved.items():
            setattr(cls, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def wrapped(engine, *args, **kw):
            out = real(engine, *args, **kw)
            self.events.append((name, engine.t, engine.input_hw))
            return out
        return wrapped

    def restore(self):
        for name, real in self.saved.items():
            setattr(self.cls, name, real)


class Browser:
    """A browser over the app's real localhost socket: every frame it
    receives, with the host clock at receipt."""

    def __init__(self, http, base):
        self.http = http
        self.base = base
        self.ws = None
        self.frames = []

    async def connect(self):
        self.ws = await self.http.ws_connect(self.base + '/websocket')

    async def send(self, kind, **fields):
        await self.ws.send_str(json.dumps(dict(fields, type=kind)))
        return time.perf_counter()

    async def recv(self, timeout=SERVE_TIMEOUT):
        import aiohttp
        msg = await self.ws.receive(timeout=timeout)
        require(msg.type == aiohttp.WSMsgType.TEXT, 'websocket: %r' % (msg,))
        data = json.loads(msg.data)
        self.frames.append((time.perf_counter(), data))
        return data

    async def until(self, pred):
        while True:
            data = await self.recv()
            if pred(data):
                return data

    def iterates(self, since=0):
        return [(t, d) for t, d in self.frames[since:]
                if d['type'] == 'iterateInfo']


def serve_config(port, **keys):
    """config.ini as it stands (its dispatch defaults: adaptive 60, depth
    2, latency target 2.0 s) with the smoke's own keys over it."""
    from style_transfer2_tpu_torch import utils
    config = utils.read_config()
    config.update({'device': SERVE_DEVICE, 'weights': 'random',
                   'http_host': '127.0.0.1', 'http_port': str(port),
                   'initial_size': str(SERVE_SIZE)})
    config.update({k: str(v) for k, v in keys.items()})
    return config


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def host_it_s(frames):
    """Iterates a second over received frames: (last i - first i) over the
    host time between them."""
    (t0, d0), (t1, d1) = frames[0], frames[-1]
    return (d1['i'] - d0['i']) / (t1 - t0) if t1 > t0 else float('nan')


def after(frames, t):
    """The iterate frames numbered above iterate counter t."""
    return [f for f in frames if f[1]['i'] > t]


def first_event(log, name, hw):
    return next(e for e in log.events if e[0] == name and e[2] == hw)


async def serve_session(torch, which, log, drive, keys):
    """Starts the port's app on a free localhost port with these config
    keys, runs drive(browser, tier, http, log, torch) with the kernel
    counts set to 0 just before, and returns (counts, drive's result)."""
    import aiohttp
    from aiohttp import web
    from style_transfer2_tpu_torch.serve import app as serve_app
    port = free_port()
    app = serve_app.init(config=serve_config(port, **keys))
    tier = app['tier']
    runner = web.AppRunner(app)
    log.events.clear()
    reset_counters()
    await runner.setup()
    try:
        await web.TCPSite(runner, '127.0.0.1', port).start()
        async with aiohttp.ClientSession() as http:
            browser = Browser(http, 'http://127.0.0.1:%d' % port)
            await browser.connect()
            result = await drive(browser, tier, http, log, torch)
            await browser.ws.close()
    finally:
        await runner.cleanup()
    torch.cuda.synchronize()
    counts = counters()
    require_all_launched(counts, 'serve ' + which)
    require_paths('serve ' + which, keys.get('precision', 'float32'))
    return counts, result


async def drive_float32(browser, tier, http, log, torch):
    """Session (a): start, 60 iterates at 512, a weight and step-size
    change, a resize to 768 with 30 iterates there, pause, /output and
    /stats."""
    import io

    import yaml
    from PIL import Image
    from style_transfer2_tpu_torch import utils
    await browser.until(lambda d: d['type'] == 'thumbnails')
    while not tier.sess.worker_ready:
        await browser.recv()
    require(tier.driver.transfer.device.type == SERVE_DEVICE,
            'serve float32: engine on %s' % tier.driver.transfer.device)
    grid0 = tuple(tier.sess.input_arr.shape[:2])
    t_start = await browser.send('start')
    await browser.until(lambda d: d['type'] == 'iterateInfo'
                        and d['i'] >= SERVE_ITERATES)
    first = browser.iterates()
    params = yaml.safe_load(tier.sess.params_yaml())
    params['weights'][0]['style']['conv2_1'] = 2.0
    params['optimizer_step_size'] = 0.5
    n = len(log.events)
    t_apply = await browser.send('applyParams',
                                 params=yaml.safe_dump(params))
    reply = await browser.until(lambda d: d['type'] == 'newParams')
    require(reply.get('errorString') == '', 'applyParams: %r'
            % reply.get('errorString'))
    while not any(e[0] == 'set_weights' for e in log.events[n:]):
        await browser.recv()
    t_weights = next(e for e in log.events[n:] if e[0] == 'set_weights')[1]
    await browser.until(lambda d: d['type'] == 'iterateInfo'
                        and d['i'] > t_weights)
    control_s = browser.frames[-1][0] - t_apply
    require(tier.driver.transfer.weights['style']['conv2_1'] == 2.0
            and tier.driver.transfer.step_size == 0.5,
            'serve float32: the new weights did not reach the engine')

    params['size'] = SERVE_RESIZE
    want = tuple(utils.fit_into_square(tier.sess.input_arr.shape[:2],
                                       SERVE_RESIZE, True))
    n = len(log.events)
    t_resize = await browser.send('applyParams',
                                  params=yaml.safe_dump(params))
    size = await browser.until(lambda d: d['type'] == 'newSize')
    grid = (size['height'], size['width'])
    require(grid == want, 'serve float32: newSize %s' % (grid,))
    while not any(e[2] == grid for e in log.events[n:]):
        await browser.recv()
    t_grid = next(e for e in log.events[n:] if e[2] == grid)[1]
    await browser.until(lambda d: d['type'] == 'iterateInfo'
                        and d['i'] >= t_grid + SERVE_RESIZE_ITERATES)
    await browser.send('pause')
    await browser.until(lambda d: d['type'] == 'state'
                        and not d['running'])

    async with http.get(browser.base + '/output') as resp:
        require(resp.status == 200, '/output %d' % resp.status)
        png = await resp.read()
    with Image.open(io.BytesIO(png)) as img:
        require(img.format == 'PNG' and img.size == grid[::-1],
                '/output: %s %s' % (img.format, img.size))
    async with http.get(browser.base + '/stats') as resp:
        stats = await resp.text()
    require(torch.cuda.get_device_name(0) in stats,
            '/stats does not name the card')

    frames = browser.iterates()
    require(all(math.isfinite(d['trace']['loss']) for _, d in frames),
            'serve float32: non-finite loss')
    at512 = [f for f in first if f[1]['i'] >= 2]
    losses = [d['trace']['loss'] for _, d in first]
    require(losses[-1] < losses[0], 'serve float32: loss did not fall at '
            '512: %.6g -> %.6g' % (losses[0], losses[-1]))
    at768 = after(frames, t_grid)
    require(len(at768) >= SERVE_RESIZE_ITERATES, 'serve float32: %d '
            'iterates at %s' % (len(at768), grid))
    return {'first_iterate_s': tier.first_iterate_s,
            'first_iterate_host_s': first[0][0] - t_start,
            'it_s_512': host_it_s(at512),
            'its_per_s_512': first[-1][1]['itsPerS'],
            'it_s_768': host_it_s(at768),
            'its_per_s_768': at768[-1][1]['itsPerS'],
            'control_s': control_s,
            'resize_s': at768[0][0] - t_resize,
            'iterates_512': len(first), 'iterates_768': len(at768),
            'grid_512': list(grid0), 'grid_768': list(grid),
            'loss_512': [losses[0], losses[-1]],
            'loss_768': [at768[0][1]['trace']['loss'],
                         at768[-1][1]['trace']['loss']]}


async def drive_ladder(browser, tier, http, log, torch):
    """Session (b): bfloat16 up the rungs, the float32 polish respawn, the
    pause the schedule makes."""
    await browser.until(lambda d: d['type'] == 'thumbnails')
    while not tier.sess.worker_ready:
        await browser.recv()
    first_driver = tier.driver
    require(first_driver.transfer.device.type == SERVE_DEVICE
            and first_driver.transfer.precision == 'bfloat16',
            'serve ladder: engine %s %s' % (first_driver.transfer.device,
                                            first_driver.transfer.precision))
    mark = len(browser.frames)
    t_start = await browser.send('start')
    # After the start: newSize at each rung; at the polish, state False
    # (the engine goes down), workerReady (the float32 engine is up);
    # state False with the schedule gone is its closing pause.
    sizes = []
    t_down = t_ready = None
    while True:
        d = await browser.recv()
        if d['type'] == 'newSize':
            sizes.append((d['height'], d['width']))
        elif d['type'] == 'state' and not d['running']:
            if t_down is None:
                t_down = browser.frames[-1][0]
            elif t_ready is not None and tier.sched is None:
                break
        elif d['type'] == 'workerReady' and t_down is not None:
            t_ready = browser.frames[-1][0]
    require(sizes == SERVE_RUNGS, 'serve ladder: grids %s' % (sizes,))
    polish_driver = tier.driver
    require(polish_driver is not first_driver
            and polish_driver.transfer.precision == 'float32'
            and polish_driver.transfer.device.type == SERVE_DEVICE,
            'serve ladder: no float32 polish engine on the card')
    frames = browser.iterates(mark)
    polish = [f for f in frames if f[0] > t_ready]
    ladder = [f for f in frames if f[0] < t_down]
    require(len(polish) >= SERVE_POLISH, 'serve ladder: %d polish '
            'iterates' % len(polish))
    require(all(math.isfinite(d['trace']['loss']) for _, d in frames),
            'serve ladder: non-finite loss')
    bounds = [first_event(log, 'set_input', SERVE_RUNGS[0])[1]] + [
        first_event(log, 'resample_input', hw)[1] for hw in SERVE_RUNGS[1:]]
    rungs = []
    for r, hw in enumerate(SERVE_RUNGS):
        rows = [f for f in ladder if f[1]['i'] > bounds[r]
                and (r + 1 == len(bounds) or f[1]['i'] <= bounds[r + 1])]
        require(len(rows) >= SERVE_LADDER, 'serve ladder: %d iterates at '
                '%s' % (len(rows), hw))
        losses = [d['trace']['loss'] for _, d in rows]
        if r == 0:
            require(losses[-1] < losses[0], 'serve ladder: loss did not '
                    'fall at %s: %.6g -> %.6g' % (hw, losses[0],
                                                   losses[-1]))
        rungs.append({'hw': list(hw), 'iterates': len(rows),
                      'it_s': host_it_s(rows),
                      'its_per_s': rows[-1][1]['itsPerS'],
                      'loss': [losses[0], losses[-1]]})
    return {'first_iterate_s': tier.first_iterate_s,
            'first_iterate_host_s': frames[0][0] - t_start,
            'rungs': rungs,
            'polish_respawn_s': polish[0][0] - t_down,
            'polish_ready_s': t_ready - t_down,
            'polish_it_s': host_it_s(polish),
            'polish_iterates': len(polish),
            'polish_loss': [polish[0][1]['trace']['loss'],
                            polish[-1][1]['trace']['loss']]}


def batch_inputs():
    """The batch phase's input directory under OUT_DIR: golden_gate.jpg and
    its left-right, top-bottom and double flips (one grid, 384x512 at
    BATCH_SIZE 512: one full wave of LANES lanes) and starry_night.jpg
    (410x512: a wave of one lane beside LANES - 1 inactive ones). Returns
    (directory, {output name: (width, height)}, the full wave's (h, w),
    the lone lane's (h, w))."""
    from PIL import Image
    from style_transfer2_tpu_torch.utils import fit_into_square
    indir = OUT_DIR / 'batch_in'
    shutil.rmtree(indir, ignore_errors=True)
    indir.mkdir(parents=True)
    with Image.open(CONTENT) as img:
        pixels = np.asarray(img.convert('RGB'))
    for name, flipped in (('golden_gate', pixels),
                          ('golden_gate_lr', pixels[:, ::-1]),
                          ('golden_gate_tb', pixels[::-1]),
                          ('golden_gate_both', pixels[::-1, ::-1])):
        Image.fromarray(np.ascontiguousarray(flipped)).save(
            indir / (name + '.png'))
    shutil.copy(STYLE, indir / STYLE.name)
    fitted = []
    for path in (CONTENT, STYLE):
        with Image.open(path) as img:
            fitted.append(tuple(fit_into_square(img.size, BATCH_SIZE,
                                                scale_up=True)))
    sizes = {'golden_gate%s_styled.png' % v: fitted[0]
             for v in ('', '_lr', '_tb', '_both')}
    sizes[STYLE.stem + '_styled.png'] = fitted[1]
    return indir, sizes, fitted[0][::-1], fitted[1][::-1]


def batch_paths(torch, precision):
    """The (direction, path) pairs the planners pick for the 384x512
    iterate's trunk at N = LANES."""
    from style_transfer2_tpu_torch.ops import conv
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[precision]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = set()
    for h, w, cin, cout in ITERATE_CONVS:
        want.add(('fwd', conv.fwd_plan(LANES, h, w, cin, cout, dtype,
                                       sms)[0]))
        want.add(('bwd', conv.bwd_plan(LANES, h, w, cout, cin, dtype,
                                       sms)[0]))
    return sorted(want)


def wave_rates(log, start):
    """{(h, w): (lanes, steady per-lane it/s, the wave line's seconds and
    aggregate it/s)} from the CLI's records after index `start`: the
    steady rate from the times of its per-iterate collects (one step a
    dispatch), first to last, as phase 4 reads its trace."""
    records = log.records[start:]
    times = {}
    for r in records:
        if r.msg == 'wave at %dx%d iterate %d loss %s':
            times.setdefault(r.args[:2], []).append(r.created)
    out = {}
    for r in records:
        if r.msg.startswith('wave of %d at %dx%d'):
            n, h, w, _, dt, agg = r.args
            t = times[(h, w)]
            out[(h, w)] = (n, (len(t) - 1) / (t[-1] - t[0]), dt, agg)
    return out


def phase_batch(torch, log, rates, smi):
    """The CLI's --batch on the card: LANES lanes at 512px, L-BFGS, one
    step a dispatch (as phase 4), in float32 and in bfloat16, full-width
    VGG-19 with random_params(0); then the batched engine against single
    engines at 48x64."""
    from PIL import Image
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.ops import conv
    indir, sizes, full_hw, lone_hw = batch_inputs()
    launches = dict.fromkeys(KERNELS, 0)
    results = {}
    for precision in ('float32', 'bfloat16'):
        outdir = OUT_DIR / ('batch_%s' % precision)
        shutil.rmtree(outdir, ignore_errors=True)
        start = len(log.records)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        rc = cli.main([str(indir), str(STYLE), '--batch', '-o', str(outdir),
                       '--lanes', str(LANES), '--size', str(BATCH_SIZE),
                       '--iterations', str(ITERATIONS), '--optimizer',
                       'lbfgs', '--precision', precision, '--model-weights',
                       'random', '--steps-per-dispatch', '1',
                       '--pipeline-depth', '1', '--device', BATCH_DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        paths = path_counts()
        peak_all = torch.cuda.max_memory_allocated()
        peak = peak_all - base
        require(rc == 0, 'batch %s: cli.main returned %r' % (precision, rc))
        require_all_launched(counts, 'batch ' + precision)
        for key in batch_paths(torch, precision):
            require(conv.path_launches.get(key, 0) > 0, 'batch %s: no %s '
                    'launches on the %s path planned at N = %d'
                    % (precision, key[0], key[1], LANES))
        for name, n in counts.items():
            launches[name] += n
        losses = {r.args[0]: r.args[2:] for r in log.records[start:]
                  if r.msg == '%s -> %s (loss %.6g -> %.6g)'}
        require(len(losses) == len(sizes), 'batch %s: %d images styled'
                % (precision, len(losses)))
        for name, (first, last) in losses.items():
            require(math.isfinite(first) and math.isfinite(last)
                    and last < first, 'batch %s %s: loss %.6g -> %.6g'
                    % (precision, name, first, last))
        for name, size in sizes.items():
            with Image.open(outdir / name) as img:
                require(img.size == size, 'batch %s %s: PNG size %s'
                        % (precision, name, img.size))
        waves = wave_rates(log, start)
        n, lane_it_s, dt, agg = waves[full_hw]
        one = waves[lone_hw]
        require(n == LANES and one[0] == 1, 'batch %s: waves %s'
                % (precision, waves))
        results[precision] = {
            'lanes': n, 'lane_it_s': lane_it_s,
            'aggregate_it_s': n * lane_it_s, 'wave_s': dt,
            'wave_aggregate_it_s': agg, 'single_it_s': rates[precision],
            'lone_lane_it_s': one[1], 'peak_bytes': peak,
            'max_memory_allocated': peak_all, 'wall_s': wall,
            'launches': counts, 'paths': paths,
            'losses': {k: list(v) for k, v in losses.items()}}
        say('batch', '%s; %s: %d lanes at %dx%d, %d L-BFGS iterations '
            'one step a dispatch: %.2f it/s a lane, %.2f aggregate (the '
            'wave line: %.2f s, %.2f aggregate it/s) against %.2f it/s '
            'single-image (phase 4), x%.2f; a lone lane of %d at %dx%d '
            '%.2f it/s; peak device memory %.0f MiB over the start '
            '(max_memory_allocated %.0f MiB); %.1f s wall; launches %s; '
            'conv paths %s' % (
                smi, precision, n, full_hw[0], full_hw[1], ITERATIONS,
                lane_it_s, n * lane_it_s, dt, agg, rates[precision],
                n * lane_it_s / rates[precision], LANES, lone_hw[0],
                lone_hw[1], one[1], peak / 2 ** 20, peak_all / 2 ** 20, wall,
                counts, paths))
        say('batch', '%s: losses %s' % (precision, ', '.join(
            '%s %.6g -> %.6g' % (k, *v) for k, v in sorted(losses.items()))))
    results['parity_worst_rel_err'] = batch_parity(torch)
    (OUT_DIR / 'batch.json').write_text(json.dumps(
        dict(results, device=smi), indent=1))
    return launches


def batch_parity(torch):
    """A 2-lane float32 BatchedStyleTransfer on the card against two single
    CUDA StyleTransfer engines at 48x64, 5 L-BFGS steps: every trace key
    within PARITY_RTOL. Returns the worst relative error."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    rng = np.random.RandomState(1)
    jobs = [[rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
             for _ in range(3)] for _ in range(2)]
    weights = {'content': {'conv4_2': 0.08},
               'style': {n: 1.0 for n in
                         ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1')}}
    scalars = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
    params = random_params(0)
    bt = BatchedStyleTransfer(params, weights, scalars, (48, 64),
                              max_lanes=2, optimizer='lbfgs',
                              device=BATCH_DEVICE)
    for job in jobs:
        bt.add_job(*job)
    got = [bt.step_all() for _ in range(5)]
    worst = 0.0
    for lane, (content, style_img, inp) in enumerate(jobs):
        st = StyleTransfer(params, 'float32', device=BATCH_DEVICE)
        st.set_weights(weights, scalars)
        st.set_content(content)
        st.set_style(style_img)
        st.set_input(inp)
        require(st.start(), 'batch parity engine did not start')
        for i in range(5):
            want = st.step(fetch_image=False)[1]
            for key, value in want.items():
                if key == 'time':
                    continue
                err = abs(got[i][lane][key] - value) / max(abs(value),
                                                           1e-30)
                worst = max(worst, err)
                require(err <= PARITY_RTOL, 'batch parity lane %d %s at '
                        'step %d: lanes %.6g single %.6g' % (
                            lane, key, i, got[i][lane][key], value))
    say('batch', '2 float32 lanes against 2 single CUDA engines at 48x64, '
        '5 L-BFGS steps: worst trace rel err %.3g (rtol %g)' % (
            worst, PARITY_RTOL))
    return worst


def phase_serve(torch, smi):
    """The port's web app on the card, two sessions over a real localhost
    socket, the full-width VGG-19 with random_params(0), config.ini's
    dispatch defaults."""
    import asyncio
    from style_transfer2_tpu_torch.engine.transfer import StyleTransfer
    launches = dict.fromkeys(KERNELS, 0)
    log = GridLog(StyleTransfer)
    results = {}
    try:
        for which, drive, keys in (
                ('float32', drive_float32, {'precision': 'float32'}),
                ('bfloat16 ladder', drive_ladder, {
                    'precision': 'bfloat16', 'serve_ladder': SERVE_LADDER,
                    'ladder_min_scale': SERVE_MIN_SCALE,
                    'serve_polish': SERVE_POLISH,
                    'polish_precision': 'float32'})):
            counts, results[which] = asyncio.run(asyncio.wait_for(
                serve_session(torch, which, log, drive, keys),
                SERVE_TIMEOUT))
            results[which]['launches'] = counts
            for name, n in counts.items():
                launches[name] += n
    finally:
        log.restore()
    a, b = results['float32'], results['bfloat16 ladder']
    say('serve', '%s; float32 at %dx%d: %d iterates, %.2f it/s (host '
        'clock), itsPerS %.2f, first iterate %.2f s (app) / %.2f s (host), '
        'loss %.6g -> %.6g' % (
            smi, a['grid_512'][0], a['grid_512'][1], a['iterates_512'],
            a['it_s_512'], a['its_per_s_512'],
            a['first_iterate_s'], a['first_iterate_host_s'],
            a['loss_512'][0], a['loss_512'][1]))
    say('serve', '%s; float32 control latency (applyParams to the first '
        'iterate under the new weights) %.3f s; resize to %dx%d: %.3f s '
        'to its first iterate, %d iterates, %.2f it/s (host clock), '
        'itsPerS %.2f' % (smi, a['control_s'], a['grid_768'][0],
                          a['grid_768'][1], a['resize_s'],
                          a['iterates_768'], a['it_s_768'],
                          a['its_per_s_768']))
    for rung in b['rungs']:
        say('serve', '%s; bfloat16 rung %dx%d: %d iterates, %.2f it/s (host '
            'clock), itsPerS %.2f, loss %.6g -> %.6g' % (
                smi, rung['hw'][0], rung['hw'][1], rung['iterates'],
                rung['it_s'], rung['its_per_s'], rung['loss'][0],
                rung['loss'][1]))
    say('serve', '%s; bfloat16 first iterate %.2f s (app) / %.2f s (host); '
        'float32 polish respawn %.3f s (engine down to first polish '
        'iterate; %.3f s to workerReady), %d iterates, %.2f it/s, loss '
        '%.6g -> %.6g' % (
            smi, b['first_iterate_s'], b['first_iterate_host_s'],
            b['polish_respawn_s'], b['polish_ready_s'], b['polish_iterates'],
            b['polish_it_s'], b['polish_loss'][0], b['polish_loss'][1]))
    say('serve', 'launches: float32 %s; bfloat16 ladder %s' % (
        a['launches'], b['launches']))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / 'serve.json').write_text(json.dumps(
        dict(results, device=smi), indent=1))
    return launches


def main():
    import torch
    smi = phase_device(torch)
    phase_build()
    from style_transfer2_tpu_torch.utils import tf32
    with tf32(False):              # TF32 off for the plain versions
        worst, rows, parts, pending, steps = phase_kernels(torch)
    log = CliLog()
    logging.getLogger('cli').addHandler(log)
    launches, rates = phase_main(torch)
    for name, n in phase_ladder(torch, log).items():
        launches[name] += n
    phase_parity(torch)
    for name, n in phase_batch(torch, log, rates, smi).items():
        launches[name] += n
    for name, n in phase_serve(torch, smi).items():
        launches[name] += n
    with tf32(False):
        phase_costs(torch, rows, parts, pending, steps)
    step = summarize(parts)

    kernels = [dict({'name': name, 'route': 'cuda',
                     'source': SOURCES[name][0][0],
                     'sources': list(SOURCES[name][0]),
                     'replaces': SOURCES[name][1],
                     'launches': launches[name], 'max_abs_err': worst[name]},
                    **step[name]) for name in KERNELS]
    say('summary', 'ms / plain_ms / bound_ms / library_ms, float32: the '
        'convs and the style branch summed over one 512px step\'s shapes '
        '(library: cuDNN conv, cuDNN dgrad), the image kernels (uint8 '
        'preprocess, deprocess) over the 7 rungs of the 1024px ladder '
        '(library: torch.sub, torch.add); device_ms: the kernels\' own '
        'time (torch.profiler); host_us: the host\'s enqueue cost a call; '
        'launches over the main, ladder and serve runs; 512px it/s float32 '
        '%.3f, bfloat16 %.3f' % (rates['float32'], rates['bfloat16']))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
