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
               tolerances, the backward's path (narrow, split, tile) of
               each shape recorded; the style branch at the taps of the
               512px, 543x724 and 768x1024 iterates; the image kernels
               (preprocess from uint8 and float32, deprocess) at every
               rung of the 1024px ladder, bit for bit. The conv backward
               and the style branch must give the same bits on a second
               call. Each row prints its time beside the plain version's
               (and their ratio), the least time the card could take (the
               bound) and the share of it reached, and, where one PyTorch
               call computes the same function, that call's time (cuDNN
               for the convs, one elementwise op for the image kernels).
  4. main    — the CLI's main() at --size 512 --optimizer lbfgs from the two
               example images, one step per dispatch (comparable with the
               first slice's runs), once in float32 and once in bfloat16:
               finite, falling loss, the PNG written, every kernel launched.
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

The line before the last is one JSON object with each kernel's measured
numbers; the last line is {"ok": true, "device": {...}}. Outputs go to
chiprun_out/chip_smoke/.
"""

import csv
import json
import logging
import math
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

KERNELS = ('conv3x3_bias_relu_fwd', 'conv3x3_bias_relu_bwd',
           'fused_style_branch', 'preprocess', 'deprocess')
SOURCES = {
    'conv3x3_bias_relu_fwd': ('style_transfer2_tpu_torch/csrc/conv3x3.cu',
                              'style_transfer2_tpu/ops/pallas/conv.py:174'),
    'conv3x3_bias_relu_bwd': ('style_transfer2_tpu_torch/csrc/conv3x3.cu',
                              'style_transfer2_tpu/ops/pallas/conv.py:183'),
    'fused_style_branch': ('style_transfer2_tpu_torch/csrc/style.cu',
                           'style_transfer2_tpu/ops/pallas/'
                           'style_kernel.py:35'),
    'preprocess': ('style_transfer2_tpu_torch/csrc/image.cu',
                   'style_transfer2_tpu/ops/pallas/preprocess.py:34'),
    'deprocess': ('style_transfer2_tpu_torch/csrc/image.cu',
                  'style_transfer2_tpu/ops/pallas/preprocess.py:40'),
}

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


def conv_bounds(shape, dtype_name):
    """Bounds (ms, kind) of the forward and the masked backward at (H, W,
    Cin, Cout): 2*9*H*W*Cin*Cout operations each; the forward moves x, w,
    b and y, the backward g, y, w and dx."""
    h, w, cin, cout = shape
    flops = 2 * 9 * h * w * cin * cout
    size = ITEMSIZE[dtype_name]
    fwd = bound(flops, size * (h * w * (cin + cout) + 9 * cin * cout + cout),
                dtype_name)
    bwd = bound(flops, size * (h * w * (2 * cout + cin) + 9 * cin * cout),
                dtype_name)
    return fwd, bwd


def say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def median_ms(fn, torch, reps=15, warmup=3):
    """Median CUDA-event time of fn() in milliseconds, after warm-up."""
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


def rel_err(got, want):
    """(max abs error, that error over max(1, max |want|))."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def counters():
    """Every kernel's launch count, by name."""
    from style_transfer2_tpu_torch.ops import conv, image, style
    return {'conv3x3_bias_relu_fwd': conv.fwd_launches,
            'conv3x3_bias_relu_bwd': conv.bwd_launches,
            'fused_style_branch': style.launches,
            'preprocess': image.preprocess_launches,
            'deprocess': image.deprocess_launches}


def reset_counters():
    from style_transfer2_tpu_torch.ops import conv, image, style
    conv.fwd_launches = conv.bwd_launches = style.launches = 0
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


def check_conv(torch, rng, shape, dtype_name, where):
    """Holds the conv kernels against the plain version at one shape and
    times both. Returns the row for kernels.json."""
    import torch.nn.functional as F
    from style_transfer2_tpu_torch.ops import conv
    h, w, cin, cout = shape
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        dtype_name]
    dev = torch.device('cuda')

    def as_t(a):
        return torch.as_tensor(np.float32(a), device=dev).to(dtype)

    x = as_t(rng.randn(1, h, w, cin))
    wt = as_t(rng.normal(0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout)))
    b = as_t(rng.randn(cout) * 0.1)
    g = as_t(rng.randn(1, h, w, cout))

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
    del x32, w32, b32, g32, y_r, pre_r, dx_k, dx_r

    y = y_k.detach()
    # Determinism: the backward's split sums run in a fixed order, so two
    # calls on the same inputs give the same bits.
    require(torch.equal(conv._launch_bwd(g, y, w_bwd),
                        conv._launch_bwd(g, y, w_bwd)),
            'conv bwd %s %s: two calls differ' % (dtype_name, shape))
    path, splits, _ = conv.bwd_plan(1, h, w, cout, cin, dtype,
                                    torch.cuda.get_device_properties(
                                        dev).multi_processor_count)
    fwd_k = median_ms(lambda: conv._launch_fwd(x, wt, b), torch)
    fwd_p = median_ms(lambda: conv.conv3x3_bias_relu_plain(x, wt, b), torch)
    bwd_k = median_ms(lambda: conv._launch_bwd(g, y, w_bwd), torch)
    # Where the narrow kernel is planned, the tile kernel it replaces, on
    # the same inputs in the same run.
    bwd_tile = None
    if path == conv.NARROW:
        bwd_tile = median_ms(lambda: conv._launch_bwd(
            g, y, w_bwd, (conv.TILE, 1, cout)), torch)
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
    fwd_l = median_ms(lambda: F.conv2d(x_c, w_c, b, padding=1), torch)
    bwd_l = median_ms(lambda: torch.nn.grad.conv2d_input(
        x_c.shape, w_c, g_c, padding=1), torch)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = conv_bounds(shape, dtype_name)
    gflop = 2 * 9 * h * w * cin * cout / 1e9
    say('kernels', 'conv %-8s %-8s %-21s fwd %.3f ms (plain %.3f, x%.2f; '
        'cuDNN %.3f; %.1f TFLOP/s, %.0f%% of bound %.3f) bwd %s%s %.3f ms '
        '(plain %.3f, x%.2f; cuDNN dgrad %.3f; %.0f%% of bound %.3f%s) err '
        '%.2g/%.2g%s; bwd bitwise repeatable' % (
            dtype_name, where, shape, fwd_k, fwd_p, fwd_k / fwd_p, fwd_l,
            gflop / fwd_k, 100 * fwd_b / fwd_k, fwd_b, path,
            '/%d' % splits if splits > 1 else '', bwd_k, bwd_p,
            bwd_k / max(bwd_p, 1e-9), bwd_l, 100 * bwd_b / bwd_k, bwd_b,
            '' if bwd_tile is None else '; tile kernel %.3f' % bwd_tile,
            fr, br, plain_note))
    return {'kernel': 'conv3x3', 'dtype': dtype_name, 'where': where,
            'shape': list(shape), 'fwd_ms': fwd_k, 'fwd_plain_ms': fwd_p,
            'fwd_library_ms': fwd_l, 'fwd_bound_ms': fwd_b,
            'fwd_bound_by': fwd_by, 'bwd_bound_by': bwd_by,
            'bwd_ms': bwd_k, 'bwd_plain_ms': bwd_p, 'bwd_library_ms': bwd_l,
            'bwd_bound_ms': bwd_b, 'bwd_path': path, 'bwd_splits': splits,
            'bwd_tile_ms': bwd_tile,
            'fwd_tflops': gflop / fwd_k, 'fwd_rel_err': fr,
            'bwd_rel_err': br, 'fwd_abs_err': fe, 'bwd_abs_err': be}


def check_style(torch, rng, tap, where):
    from style_transfer2_tpu_torch.ops import style
    h, w, c = tap
    dev = torch.device('cuda')
    feat = torch.relu(torch.as_tensor(np.float32(rng.randn(1, h, w, c)),
                                      device=dev))
    other = torch.relu(torch.as_tensor(np.float32(rng.randn(1, h, w, c)),
                                       device=dev))
    flat = other.reshape(-1, c)
    gram_style = flat.T @ flat / flat.numel()
    s_k, gd_k = style.fused_style_branch(feat, gram_style)
    s_p, gd_p = style.fused_style_branch_plain(feat, gram_style)
    s_2, gd_2 = style.fused_style_branch(feat, gram_style)
    torch.cuda.synchronize()
    require(torch.equal(s_k, s_2) and torch.equal(gd_k, gd_2),
            'style %s: two calls differ' % (tap,))
    # s_grad is ~1e-9 in magnitude: its error is relative to its own max;
    # gram_diff's to the larger of its and the target's max.
    se = float((s_k - s_p).abs().max())
    sr = se / float(s_p.abs().max())
    ge = float((gd_k - gd_p).abs().max())
    gr = ge / max(float(gd_p.abs().max()), float(gram_style.abs().max()))
    require(math.isfinite(sr) and sr <= STYLE_TOL,
            'style s_grad %s: rel err %.3g' % (tap, sr))
    require(math.isfinite(gr) and gr <= STYLE_TOL,
            'style gram_diff %s: rel err %.3g' % (tap, gr))
    t_k = median_ms(lambda: style._launch(feat, gram_style), torch)
    t_p = median_ms(
        lambda: style.fused_style_branch_plain(feat, gram_style), torch)
    # Operations: M*C*(C+1) for the Gram (symmetric: the upper triangle
    # with its diagonal) and 2*M*C^2 for the gradient product; bytes: X and
    # G_style read, and G_diff and s_grad written, once.
    m = h * w
    t_b, t_by = bound(m * c * (c + 1) + 2 * m * c * c,
                      4 * (2 * m * c + 2 * c * c))
    say('kernels', 'style float32 %-8s %-16s %.3f ms (plain, two cuBLAS '
        'matmuls, %.3f; x%.2f; %.0f%% of bound %.3f) err %.2g/%.2g; '
        'bitwise repeatable' % (where, tap, t_k, t_p, t_k / t_p,
                                100 * t_b / t_k, t_b, sr, gr))
    return {'kernel': 'fused_style_branch', 'dtype': 'float32',
            'where': where, 'shape': list(tap), 'ms': t_k, 'plain_ms': t_p,
            'bound_ms': t_b, 'bound_by': t_by, 's_grad_rel_err': sr, 'gram_diff_rel_err': gr,
            'abs_err': max(se, ge)}


def check_image(torch, rng, hw):
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
        pre_k = median_ms(lambda: image._launch_preprocess(src), torch)
        pre_p = median_ms(lambda: src32[None] - mean, torch)
        e2e_k = median_ms(lambda: image.preprocess(img, dev), torch)
        e2e_p = median_ms(lambda: image.preprocess_plain(img, dev), torch)
        de_k = median_ms(lambda: image._launch_deprocess(x_k), torch)
        de_p = median_ms(lambda: image.deprocess_plain(x_k), torch)
        pre_l = median_ms(lambda: torch.sub(src, mean), torch)
        de_l = median_ms(lambda: torch.add(x_k[0], mean), torch)
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
    return rows


def add_bound(entry, kind, ms):
    """Adds a shape's bound to a summed entry's share by kind: the sum's
    bound_by is the kind that holds the larger share."""
    entry['by'][kind] = entry['by'].get(kind, 0.0) + ms


def phase_kernels(torch):
    rng = np.random.RandomState(0)
    rows = []
    worst = dict.fromkeys(KERNELS, 0.0)
    # float32 ms of each kernel, its plain version, its bound and its
    # library call (None for the style branch, which no one call computes):
    # the convs and the style branch summed over one 512px step's shapes,
    # the image kernels over the 7 rungs of the 1024px ladder.
    step = {k: {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                'library_ms': 0.0, 'by': {}} for k in KERNELS}
    step['fused_style_branch']['library_ms'] = None
    sums_1024 = {}                 # dtype -> [fwd, plain, bwd, plain]

    for dtype_name in ('float32', 'bfloat16'):
        cases = ([(s, '512') for s in ITERATE_CONVS]
                 + [(s, 'style') for s in STYLE_CONVS]
                 + [(s, '543x724') for s in trunk_convs(543, 724)]
                 + [(s, '1024') for s in trunk_convs(768, 1024)])
        seen = {}
        for shape, where in cases:
            key = (shape, where)
            if key not in seen:
                seen[key] = check_conv(torch, rng, shape, dtype_name, where)
                rows.append(seen[key])
            row = seen[key]
            worst['conv3x3_bias_relu_fwd'] = max(
                worst['conv3x3_bias_relu_fwd'], row['fwd_abs_err'])
            worst['conv3x3_bias_relu_bwd'] = max(
                worst['conv3x3_bias_relu_bwd'], row['bwd_abs_err'])
            if dtype_name == 'float32' and where == '512':
                for name, pre in (('conv3x3_bias_relu_fwd', 'fwd_'),
                                  ('conv3x3_bias_relu_bwd', 'bwd_')):
                    for field in ('ms', 'plain_ms', 'bound_ms',
                                  'library_ms'):
                        step[name][field] += row[pre + field]
                    add_bound(step[name], row[pre + 'bound_by'],
                              row[pre + 'bound_ms'])
            if where == '1024':
                sums = sums_1024.setdefault(dtype_name, [0.0] * 4)
                for i, field in enumerate(('fwd_ms', 'fwd_plain_ms',
                                           'bwd_ms', 'bwd_plain_ms')):
                    sums[i] += row[field]
        say('kernels', 'conv %s summed over one 1024px (768x1024) step\'s '
            'shapes: fwd %.3f ms (plain %.3f), bwd %.3f ms (plain %.3f)'
            % ((dtype_name,) + tuple(sums_1024[dtype_name])))

    for where, taps in STYLE_TAPS.items():
        total = [0.0, 0.0, 0.0]
        for tap in taps:
            row = check_style(torch, rng, tap, where)
            rows.append(row)
            worst['fused_style_branch'] = max(worst['fused_style_branch'],
                                              row['abs_err'])
            for i, field in enumerate(('ms', 'plain_ms', 'bound_ms')):
                total[i] += row[field]
                if where == '512':
                    step['fused_style_branch'][field] += row[field]
            if where == '512':
                add_bound(step['fused_style_branch'], row['bound_by'],
                          row['bound_ms'])
        say('kernels', 'style float32 summed over the %s taps: %.3f ms '
            '(plain %.3f, x%.2f; %.0f%% of bound %.3f)' % (
                where, total[0], total[1], total[0] / total[1],
                100 * total[2] / total[0], total[2]))

    for hw in LADDER_1024:
        for row in check_image(torch, rng, hw):
            rows.append(row)
            worst['preprocess'] = max(worst['preprocess'],
                                      row['preprocess_abs_err'])
            worst['deprocess'] = max(worst['deprocess'],
                                     row['deprocess_abs_err'])
            if row['dtype'] == 'uint8':
                for name in ('preprocess', 'deprocess'):
                    for field in ('ms', 'plain_ms', 'bound_ms',
                                  'library_ms'):
                        step[name][field] += row[name + '_' + field]
                    add_bound(step[name], row[name + '_bound_by'],
                              row[name + '_bound_ms'])

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / 'kernels.json').write_text(json.dumps(rows, indent=1))
    return worst, step


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
        require(rc == 0, 'cli.main returned %r' % (rc,))
        require_all_launched(counts, 'main ' + precision)
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
            '%.6g, %.2f it/s (steady), %.1f s wall; launches %s' % (
                precision, ITERATIONS, losses[0], losses[-1], it_s, wall,
                counts))
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
        require(rc == 0, 'cli.main returned %r' % (rc,))
        require_all_launched(counts, 'ladder ' + precision)
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
            'launches %s' % (precision, len(LADDER_1024), LADDER_ITERATIONS,
                             ' + %d polish' % POLISH if extra else '', wall,
                             counts))

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


def main():
    import torch
    phase_device(torch)
    phase_build()
    from style_transfer2_tpu_torch.utils import tf32
    with tf32(False):              # TF32 off for the plain versions
        worst, step = phase_kernels(torch)
    log = CliLog()
    logging.getLogger('cli').addHandler(log)
    launches, rates = phase_main(torch)
    for name, n in phase_ladder(torch, log).items():
        launches[name] += n
    phase_parity(torch)

    kernels = [{'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
                'replaces': SOURCES[name][1], 'launches': launches[name],
                'max_abs_err': worst[name], 'ms': step[name]['ms'],
                'plain_ms': step[name]['plain_ms'],
                'bound_ms': step[name]['bound_ms'],
                'bound_by': max(step[name]['by'],
                                key=step[name]['by'].get),
                'library_ms': step[name]['library_ms']} for name in KERNELS]
    say('summary', 'ms / plain_ms / bound_ms / library_ms, float32: the '
        'convs and the style branch summed over one 512px step\'s shapes '
        '(library: cuDNN conv, cuDNN dgrad), the image kernels (uint8 '
        'preprocess, deprocess) over the 7 rungs of the 1024px ladder '
        '(library: torch.sub, torch.add); '
        'launches over the main and ladder runs; 512px it/s float32 %.3f, '
        'bfloat16 %.3f' % (rates['float32'], rates['bfloat16']))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
