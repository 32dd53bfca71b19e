#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own line; any failure raises and the script
exits non-zero:

  1. device  — CUDA must be available; prints nvidia-smi's name and power
               limit of the card.
  2. build   — compiles the kernels in style_transfer2_tpu_torch/csrc with
               nvcc and prints the seconds taken.
  3. kernels — every hand-written kernel against its plain PyTorch version
               on the card (TF32 off) at the 512px main-path shapes, float32
               and bfloat16, within stated tolerances; median CUDA-event
               times of both.
  4. main    — the CLI's main() at --size 512 --optimizer lbfgs from the two
               example images, once in float32 and once in bfloat16: finite,
               falling loss, the PNG written, and every kernel launched.
  5. parity  — the CUDA engine against the CPU engine (the plain versions)
               on a small input: every trace key within the golden rtol.

The line before the last is one JSON object with each kernel's measured
numbers; the last line is {"ok": true, "device": {...}}. Outputs go to
chiprun_out/chip_smoke/.
"""

import csv
import json
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

# Tolerances, as max |kernel - plain| / max(1, max |plain|), the plain
# version run in float32 with TF32 off on the same inputs: float32 sums the
# same products in another order; bfloat16 rounds the output to 8 mantissa
# bits (tests/test_pallas_conv.py uses 3e-2).
TOL = {'float32': 1e-4, 'bfloat16': 3e-2}
STYLE_TOL = 1e-4          # float32 only: the taps are float32 in both modes
PARITY_RTOL = 5e-3        # tests/test_golden.py's trace tolerance

# (H, W, Cin, Cout) of every 3x3 conv the 512px main path runs: the
# 384x512 iterate up to conv4_2, forward and backward every step, and the
# 410x512 style image through conv5_4 (forward, once; odd H after pools).
ITERATE_CONVS = [
    (384, 512, 3, 64), (384, 512, 64, 64), (192, 256, 64, 128),
    (192, 256, 128, 128), (96, 128, 128, 256), (96, 128, 256, 256),
    (48, 64, 256, 512), (48, 64, 512, 512)]
STYLE_CONVS = [
    (410, 512, 3, 64), (410, 512, 64, 64), (205, 256, 64, 128),
    (205, 256, 128, 128), (103, 128, 128, 256), (103, 128, 256, 256),
    (52, 64, 256, 512), (52, 64, 512, 512), (26, 32, 512, 512)]
# How many times each iterate conv shape runs per forward up to conv4_2.
ITERATE_REPEATS = [1, 1, 1, 1, 1, 3, 1, 1]
# (H, W, C) of the four style taps of the iterate: conv1_1 .. conv4_1.
STYLE_TAPS = [(384, 512, 64), (192, 256, 128), (96, 128, 256), (48, 64, 512)]


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


def phase_kernels(torch):
    import torch.nn.functional as F
    from style_transfer2_tpu_torch.engine import apply_precision
    from style_transfer2_tpu_torch.ops import conv, style
    apply_precision('float32')     # TF32 off for the plain versions
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    rows = []
    worst = {'conv3x3_bias_relu_fwd': 0.0, 'conv3x3_bias_relu_bwd': 0.0,
             'fused_style_branch': 0.0}
    step_ms = {k: [0.0, 0.0] for k in worst}   # float32 [kernel, plain]

    def as_t(a, dtype):
        return torch.as_tensor(np.float32(a), device=dev).to(dtype)

    for dtype_name, dtype in (('float32', torch.float32),
                              ('bfloat16', torch.bfloat16)):
        shapes = ([(s, 'iterate', r) for s, r in
                   zip(ITERATE_CONVS, ITERATE_REPEATS)]
                  + [(s, 'style', 0) for s in STYLE_CONVS])
        for (h, w, cin, cout), where, repeats in shapes:
            x = as_t(rng.randn(1, h, w, cin), dtype)
            wt = as_t(rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                                 (3, 3, cin, cout)), dtype)
            b = as_t(rng.randn(cout) * 0.1, dtype)
            g = as_t(rng.randn(1, h, w, cout), dtype)

            # The reference is the plain version in float32 on the same
            # (for bf16: bf16-valued) inputs, TF32 off: the kernel computes
            # that sum and rounds once. The backward reference is autograd
            # of the plain conv with the cotangent masked by the kernel's
            # own forward output: an activation within rounding of zero can
            # fall on either side of the ReLU in two implementations, and
            # each such flip moves a few dx entries by a whole g*w term. The
            # flips are counted, and the plain bf16 version's own distance
            # from the reference is printed beside.
            xr = x.detach().requires_grad_(True)
            x32 = x.float().requires_grad_(True)
            w32, b32, g32 = wt.float(), b.float(), g.float()
            y_k = conv.conv3x3_bias_relu(x, wt, b)
            y_r = conv.conv3x3_bias_relu_plain(x32, w32, b32)
            dx_k = torch.autograd.grad(conv.conv3x3_bias_relu(xr, wt, b),
                                       xr, g)[0]
            pre_r = F.conv2d(x32.permute(0, 3, 1, 2), w32.permute(3, 2, 0, 1),
                             b32, padding=1).permute(0, 2, 3, 1)
            dx_r = torch.autograd.grad(pre_r, x32,
                                       g32 * (y_k > 0).float())[0]
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
                    'conv fwd %s %s: rel err %.3g' % (
                        dtype_name, (h, w, cin, cout), fr))
            require(math.isfinite(br) and br <= TOL[dtype_name],
                    'conv bwd %s %s: rel err %.3g' % (
                        dtype_name, (h, w, cin, cout), br))
            worst['conv3x3_bias_relu_fwd'] = max(
                worst['conv3x3_bias_relu_fwd'], fe)
            worst['conv3x3_bias_relu_bwd'] = max(
                worst['conv3x3_bias_relu_bwd'], be)

            y = y_k.detach()
            fwd_k = median_ms(lambda: conv._launch_fwd(x, wt, b), torch)
            fwd_p = median_ms(
                lambda: conv.conv3x3_bias_relu_plain(x, wt, b), torch)
            bwd_k = median_ms(lambda: conv._launch_bwd(g, y, wt), torch)
            bwd_p = median_ms(lambda: torch.autograd.grad(
                conv.conv3x3_bias_relu_plain(xr, wt, b), xr, g), torch)
            # The plain backward's time includes its forward (autograd
            # needs it); report its backward alone.
            bwd_p = max(bwd_p - fwd_p, 0.0)
            gflop = 2 * 9 * h * w * cin * cout / 1e9
            rows.append({'kernel': 'conv3x3', 'dtype': dtype_name,
                         'where': where, 'shape': [h, w, cin, cout],
                         'fwd_ms': fwd_k, 'fwd_plain_ms': fwd_p,
                         'bwd_ms': bwd_k, 'bwd_plain_ms': bwd_p,
                         'fwd_tflops': gflop / fwd_k,
                         'fwd_rel_err': fr, 'bwd_rel_err': br})
            say('kernels', 'conv %-8s %-7s %-21s fwd %.3f ms (plain %.3f, '
                '%.1f TFLOP/s) bwd %.3f ms (plain %.3f) err %.2g/%.2g%s' % (
                    dtype_name, where, (h, w, cin, cout), fwd_k, fwd_p,
                    gflop / fwd_k, bwd_k, bwd_p, fr, br, plain_note))
            if dtype_name == 'float32' and where == 'iterate':
                step_ms['conv3x3_bias_relu_fwd'][0] += repeats * fwd_k
                step_ms['conv3x3_bias_relu_fwd'][1] += repeats * fwd_p
                step_ms['conv3x3_bias_relu_bwd'][0] += repeats * bwd_k
                step_ms['conv3x3_bias_relu_bwd'][1] += repeats * bwd_p
            del x, wt, b, g, xr, x32, w32, b32, g32, y_k, y_r, pre_r, dx_k
            del dx_r, y

    for h, w, c in STYLE_TAPS:
        feat = torch.relu(as_t(rng.randn(1, h, w, c), torch.float32))
        other = torch.relu(as_t(rng.randn(1, h, w, c), torch.float32))
        flat = other.reshape(-1, c)
        gram_style = flat.T @ flat / flat.numel()
        s_k, gd_k = style.fused_style_branch(feat, gram_style)
        s_p, gd_p = style.fused_style_branch_plain(feat, gram_style)
        torch.cuda.synchronize()
        # s_grad is ~1e-9 in magnitude: its error is relative to its own
        # max; gram_diff's to the larger of its and the target's max.
        se = float((s_k - s_p).abs().max())
        sr = se / float(s_p.abs().max())
        ge = float((gd_k - gd_p).abs().max())
        gr = ge / max(float(gd_p.abs().max()), float(gram_style.abs().max()))
        require(math.isfinite(sr) and sr <= STYLE_TOL,
                'style s_grad %s: rel err %.3g' % ((h, w, c), sr))
        require(math.isfinite(gr) and gr <= STYLE_TOL,
                'style gram_diff %s: rel err %.3g' % ((h, w, c), gr))
        worst['fused_style_branch'] = max(worst['fused_style_branch'], se, ge)
        t_k = median_ms(lambda: style._launch(feat, gram_style), torch)
        t_p = median_ms(
            lambda: style.fused_style_branch_plain(feat, gram_style), torch)
        step_ms['fused_style_branch'][0] += t_k
        step_ms['fused_style_branch'][1] += t_p
        rows.append({'kernel': 'fused_style_branch', 'dtype': 'float32',
                     'shape': [h, w, c], 'ms': t_k, 'plain_ms': t_p,
                     's_grad_rel_err': sr, 'gram_diff_rel_err': gr})
        say('kernels', 'style float32 %-16s %.3f ms (plain %.3f) err '
            '%.2g/%.2g' % ((h, w, c), t_k, t_p, sr, gr))

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / 'kernels.json').write_text(json.dumps(rows, indent=1))
    return worst, step_ms


def read_trace(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def phase_main(torch):
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.ops import conv, style
    from PIL import Image
    launches = {'conv3x3_bias_relu_fwd': 0, 'conv3x3_bias_relu_bwd': 0,
                'fused_style_branch': 0}
    rates = {}
    for precision in ('float32', 'bfloat16'):
        png = OUT_DIR / ('main_%s.png' % precision)
        trace_csv = OUT_DIR / ('main_%s.csv' % precision)
        png.unlink(missing_ok=True)
        conv.fwd_launches = conv.bwd_launches = style.launches = 0
        t0 = time.perf_counter()
        rc = cli.main([str(CONTENT), str(STYLE), '-o', str(png),
                       '--size', '512', '--iterations', str(ITERATIONS),
                       '--optimizer', 'lbfgs', '--precision', precision,
                       '--trace-csv', str(trace_csv)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {'conv3x3_bias_relu_fwd': conv.fwd_launches,
                  'conv3x3_bias_relu_bwd': conv.bwd_launches,
                  'fused_style_branch': style.launches}
        require(rc == 0, 'cli.main returned %r' % (rc,))
        for name, n in counts.items():
            require(n > 0, '%s: kernel %s never launched' % (precision, name))
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


def phase_parity(torch):
    """The CUDA engine against the CPU engine on a small input."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    rng = np.random.RandomState(0)
    content, style_img, inp = (rng.randint(0, 256, (48, 64, 3)).astype(
        np.uint8) for _ in range(3))
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
        traces[device] = [st.step(fetch_image=False)[1] for _ in range(5)]
    worst = 0.0
    for i, (want, got) in enumerate(zip(traces['cpu'], traces['cuda'])):
        for key, value in want.items():
            if key in ('time', 'fevals'):
                continue
            err = abs(got[key] - value) / max(abs(value), 1e-30)
            worst = max(worst, err)
            require(err <= PARITY_RTOL, 'trace %s at step %d: cuda %.6g '
                    'cpu %.6g' % (key, i, got[key], value))
    say('parity', '5 float32 L-BFGS steps at 48x64, CUDA vs CPU engine: '
        'worst trace rel err %.3g (rtol %g)' % (worst, PARITY_RTOL))


def main():
    import torch
    phase_device(torch)
    phase_build()
    worst, step_ms = phase_kernels(torch)
    launches, rates = phase_main(torch)
    phase_parity(torch)

    sources = {'conv3x3_bias_relu_fwd': (
                   'style_transfer2_tpu_torch/csrc/conv3x3.cu',
                   'style_transfer2_tpu/ops/pallas/conv.py:174'),
               'conv3x3_bias_relu_bwd': (
                   'style_transfer2_tpu_torch/csrc/conv3x3.cu',
                   'style_transfer2_tpu/ops/pallas/conv.py:183'),
               'fused_style_branch': (
                   'style_transfer2_tpu_torch/csrc/style.cu',
                   'style_transfer2_tpu/ops/pallas/style_kernel.py:35')}
    kernels = [{'name': name, 'route': 'cuda', 'source': src,
                'replaces': rep, 'launches': launches[name],
                'max_abs_err': worst[name], 'ms': step_ms[name][0],
                'plain_ms': step_ms[name][1]}
               for name, (src, rep) in sources.items()]
    say('summary', 'ms / plain_ms: float32, summed over one 512px step\'s '
        'shapes; it/s float32 %.3f, bfloat16 %.3f' % (
            rates['float32'], rates['bfloat16']))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
