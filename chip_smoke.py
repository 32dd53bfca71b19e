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
               the batched engine's trunk: the iterate shapes of each of
               the pool's buckets (384x512, 288x384, 192x256) at N = 4 in
               both precisions, with their paths (the smaller grids take
               the split paths) and cuDNN at N = 4, summed over a 4-lane
               step;
               the style branch at the taps of the 512px, 543x724 and
               768x1024 iterates, and with a lane axis at the 512px taps,
               4 lanes in one launch sequence, each lane also held against
               the one-map kernel on that lane and two torch.bmm timed as
               the library call; the bf16 loss feed's kernels (the style
               branch's bf16 Gram and product phases, sumsq) at the taps
               of the 512px and 768x1024 iterates and of 4 lanes of the
               512px one, each against float64 on the same bf16 values
               and against its plain version, bitwise repeatable, beside
               cuBLAS's bf16 GEMM (check_feed); the step glue's kernels
               (check_pool, check_epilogue): the max pool's forward and
               backward at the float32 512px step's three pools and at
               every pool of the 1024px ladder's 7 rungs in bfloat16, odd
               rungs included, bit for bit in values and gradients, beside
               F.max_pool2d(ceil_mode=True) for the forward, and the tap
               epilogue at the float32 512px step's five taps, its
               cotangent bit for bit and its sums within EPILOGUE_TOL of
               float64; the image kernels (preprocess from uint8
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
  6. highres — the CLI's main() at --size 3840 (a 2880x3840 iterate, a
               3072x3840 style image), L-BFGS, 12 iterations in chunks of
               4 one deep, single-scale, full-width VGG-19 with
               random_params(0): first every conv of the trunk up to
               conv4_2 at that iterate's shapes, forward and backward, in
               float32 and bfloat16 (planned paths, cuDNN's times, the
               step's sums), the style branch at its four taps against its
               plain version in float64 (the float32 plain version's own
               error beside), the image kernels at both grids bit for bit,
               each a median of 5 after 1 warm-up on maps drawn on the
               card, and the bf16 feed's kernels at its taps
               (check_feed); one forward and vjp of the model at that
               iterate
               for each precision and policy (the bytes the forward
               leaves, the peak, the gradient bit for bit the plain one);
               then five runs: float32 and bfloat16 without remat,
               float32 --remat block, bfloat16 --remat conv and --remat
               block. Each: finite, falling loss, a 3840x2880 PNG, every
               kernel launched, the steps replayed from graphs, each remat
               run's trace equal bit for bit to its precision's run
               without remat; its it/s over the last two chunks (host
               clock at the synced collects), capture seconds, peak
               allocated and reserved memory, the reserved memory at each
               chunk, the seconds from the call to the PNG (each PNG is
               deleted once checked: five would outgrow chiprun_out);
               highres.json.
  7. parity  — the CUDA engine against the CPU engine (the plain versions)
               on small inputs, 5 steps at one size and a 2-rung ladder:
               every trace key within the golden rtol; the CUDA bf16
               objective (the loss feed) at each evaluation of a CPU bf16
               run's 5 L-BFGS steps at 48x64, unfolded and folded, within
               FEED_PARITY_RTOL (feed_eval_parity); then random_params(0)
               written as a caffemodel (write_caffemodel) and read back
               (resolve_params), and as a torchvision state dict
               (params_from_torchvision): graphed float32 L-BFGS steps at
               the 512px grid from each equal bit for bit to those from
               random_params(0) itself.
  8. graph   — graphed engines against eager ones on the 512px main path's
               inputs in one process: the bitwise checks, then 20-step
               chunks in turns (ms and host us a step, nodes, capture
               seconds, memory); graph.json.
  9. batch   — the CLI's --batch --lanes 4 at --size 512, L-BFGS, 20
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
 10. serve   — the web app (style_transfer2_tpu_torch.serve.app) on the
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
 11. pool    — the pooled server (style_transfer2_tpu_torch.serve.pool)
               on the card, config.ini with its pool defaults (4 lanes,
               Adam, one step a dispatch, images fetched at most every
               0.25 s) and pool_sizes 256, 384, 512 over it, full-width
               VGG-19 with random_params(0), driven over real localhost
               sockets: (a) float32, four browsers (each its own cookie
               jar) on lanes 0-3 of the 384x512 bucket, a fifth refused
               with 503, all four to 60 iterates, browser 0's applyParams
               (a style weight and the step size: lane 0's values change,
               lanes 1-3's do not), browser 1's resize to 384 (a warm
               migration into a new 288x384 bucket, 30 iterates there,
               its first loss far below its first at 512), each /output a
               PNG of its grid, /stats naming the card with 4 of 8 lanes
               in use, all paused; (b) bfloat16 through the port's router
               (the pool registers on its control port; two browsers
               speak only to its proxy port), serve_ladder 20 up the
               192x256, 288x384 and 384x512 buckets, then serve_polish 10
               in the float32 bucket at 384x512 and the schedule's pause,
               the router's /stats showing the instance. Both: finite
               losses, falling over the first 60 iterates or the first
               rung, every bucket on CUDA, every kernel launched and the
               conv paths planned at N = 4 for each bucket's grid and
               precision among the launches; each
               session's and the aggregate it/s (host clock, the window
               where all of a tier's sessions run) beside the batch
               phase's 4-lane aggregate, the first iterate, the control
               latency, the resize and polish migrations' seconds (and a
               new bucket's first iterate beside a warm one), each rung's
               it/s, the peak device memory; pool.json.
 12. video   — video.main() on 8 frames of a horizontal pan cut from
               golden_gate.jpg (640x480 windows, 16 px apart), --size 512
               (512x384), starry_night.jpg, initial_weights.yaml,
               full-width VGG-19 with random_params(0), L-BFGS, 150
               iterations on the first frame and 40 on each later one:
               (a) float32 and (b) bfloat16 with --temporal 1000, (c)
               float32 with --temporal 0 (the flicker baseline). Each run:
               8 PNGs of 512x384, every frame's loss finite and falling,
               frame 1 without temporal keys, in (a) and (b) every chained
               frame's first trace (the L-BFGS prime, where the warm start
               and the target hold the same values) at temporal_loss 0.0
               exactly, every chained frame's first loss far below frame
               1's, the engine on CUDA, every kernel launched with the
               precision's conv paths, the preprocess and deprocess
               launches the loop implies. Printed and in video.json: the
               first frame's seconds and the steady s/frame (the CLI's log
               line), each chained frame's seconds and it/s on the device
               clock (CUDA events after each frame's launches), the
               flicker (mean over consecutive outputs of mean((a - b)^2))
               with and without the term, the peak device memory. Then a
               pipelined VideoStylizer against a serial one at 96x128; the
               CUDA objective at each of a CPU VideoStylizer's 438
               evaluations over the pan at 48x64 (150 then 40
               iterations), every trace key within the golden rtol; and
               the CLI's --profile in a subprocess, whose trace must name
               the conv, style and image kernels.
 13. shard   — spatial and data sharding (parallel/): first the convs at
               each trunk shape of one shard of a 768x1024 iterate cut 4
               ways on H, halo rows included (h / 4 + 2 rows), float32 and
               bfloat16, and the style branch's two phases (style_gram,
               style_grad) at the shard's four taps against their plain
               versions, beside torch.mm and the fused branch there;
               then full-width VGG-19 with random_params(0), golden_gate
               x starry_night at --size 1024, L-BFGS, 20 steps in chunks
               of 5, over a SpatialPlacement of 4 shards on the card's
               GPUs (cuda:0 repeated where there are fewer; printed)
               against an unsharded engine on the same inputs: float32
               every trace key within the golden rtol, the prime of the
               free runs and each of 20 steps taken from the unsharded
               run's state; bfloat16 the prime within 2e-2, then a finite,
               falling loss; every kernel of the sharded path launched,
               the conv paths planned at the shard shapes among the
               launches, both style phases once a shard a style layer an
               evaluation, the sharded steps replayed from their graphs
               (one capture over the shards, engine/graphs.py); in each
               precision the graphed sharded engine against an eager one
               bit for bit (step, a chunk, an objective change, two
               chunks in flight, step: traces, images, state, norms),
               then 20-step chunks of both in turns (ms and host us a
               step, the memory each holds, each read against the 4
               shards' floor on one card), the node counts of the step
               and prime graphs and the capture seconds; a W-fallback
               grid (510x680) held the same way over 5 steps and graphed
               against eager bit for bit in both precisions; bf16 at
               2880x3840 over the 4 shards, graphed, 8 steps after the
               capture, beside the highres phase's unsharded bf16 step;
               4 float32 lanes at 512px over a 2-way data
               mesh against the unsharded batched engine, every key of
               each lane over 3 steps; a sharded checkpoint resumed, its
               next chunk equal bit for bit; the CLI with --mesh 1, and
               --mesh N for N above the card count exiting with
               make_mesh's message. Printed and in shard.json: ms a step
               sharded and unsharded (the one-card cost of sharding),
               graphed and eager, host us a step, halo bytes a step, peak
               memory.
 14. profile — every kernel and library call timed in phase 3, on the
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

Every run requires each kernel of its precision launched
(PRECISION_KERNELS): every run the pool's two, a bfloat16 run the feed's
bf16 style phases and sumsq, a float32 run the fused float32 style branch
and the tap epilogue (but a lanes run, LANE_FREE_KERNELS); the bf16 main
run and
the feed parity also that no float32 style kernel launched, and the shard
phase the exact count of each style kernel.

Every kernel's bound and every step's floor come from the port's roofline
(style_transfer2_tpu_torch/utils/perfmodel.py: kernel_bound with
conv_cost, style_cost, sumsq_cost, pool_cost, epilogue_cost and
image_cost; model_step; model_step_sharded).
Each step a phase measures is read against its floor: the graph phase's
chunks (512px, one image and 4 lanes, both precisions, eager and
graphed), each ladder rung and the polish, each highres run, and the
shard phase's unsharded step and its sharded steps on one card (graphed
and eager, and at 2880x3840; whose halo bytes must equal the
roofline's). Each record gains model_flops,
floor_ms, bound_by, mfu (model FLOPs over the card's peak over the
measured ms) and share_of_floor; a share above MAX_SHARE fails the run.

The last three lines are JSON objects: the roofline line ({"roofline":
[one row a measured step: path, floor and measured ms, mfu, share,
bound_by], "device": nvidia-smi's name and power limit}), the kernels line
(each kernel's measured numbers; style_gram and style_grad: the style
branch's two phases, which the shard phase runs), and {"ok": true,
"device": {...}}. Outputs go to chiprun_out/chip_smoke/.
"""

import asyncio
import csv
import json
import logging
import math
import os
import re
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
STYLE_TOL = 1e-4          # the float32 branch and phases
# The bf16 loss feed's kernels, each against float64 on the same bf16
# values, relative to the reference's largest magnitude: the Gram sums
# exact products in float32 (FEED_GRAM_TOL, as STYLE_TOL); the product
# rounds its float32 sums to bf16 once, by at most 2^-8 of a value (bf16's
# unit roundoff), plus the float32 sums' own error (FEED_PRODUCT_TOL);
# sumsq sums in float32 (SUMSQ_TOL).
FEED_GRAM_TOL = 1e-4
FEED_PRODUCT_TOL = 2.0 ** -8 + 1e-5
SUMSQ_TOL = 1e-5
# The tap epilogue's sums against float64 on the same float32 terms
# (relative; its cotangent is held bit for bit).
EPILOGUE_TOL = 1e-6
PARITY_RTOL = 5e-3        # tests/test_golden.py's trace tolerance
# The bf16 feed's CUDA objective against the CPU one at the CPU run's
# iterates: the two devices' bf16 convs round some taps apart, as the
# sharded bf16 prime's bound (SHARD_RTOL) allows.
FEED_PARITY_RTOL = 2e-2
FEED_PARITY_STEPS = 5

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
           'fused_style_branch', 'style_gram_bf16', 'style_grad_bf16',
           'sumsq', 'pool_fwd', 'pool_bwd', 'tap_epilogue', 'preprocess',
           'deprocess')
# The bf16 loss feed's kernels (engine/objective.py): a bfloat16 run
# launches them and not the float32 feed's (the fused style branch and the
# tap epilogue); a float32 run the reverse.
FEED_KERNELS = ('style_gram_bf16', 'style_grad_bf16', 'sumsq')
F32_FEED_KERNELS = ('fused_style_branch', 'tap_epilogue')
PRECISION_KERNELS = {
    'float32': tuple(k for k in KERNELS if k not in FEED_KERNELS),
    'bfloat16': tuple(k for k in KERNELS if k not in F32_FEED_KERNELS)}
# The batched engine's float32 feed keeps its PyTorch terms
# (engine/objective.py make_lane_objective): a lanes run launches no tap
# epilogue.
LANE_FREE_KERNELS = ('tap_epilogue',)
# Each kernel's sources (the first holds its entry point; wgmma.cuh holds
# the Hopper helpers both wgmma files include) and the TPU kernel it
# replaces. The convs' bfloat16 wgmma paths and their split sum run in
# conv3x3_wgmma.cu, everything else of the convs in conv3x3.cu.
# sumsq, the pool and the tap epilogue replace no Pallas kernel: they are
# the JAX feed's f32_sumsq, the trunk's jnp.max pool and the float32
# feed's per-tap terms, which XLA fused.
_CONV_SOURCES = ('style_transfer2_tpu_torch/csrc/conv3x3.cu',
                 'style_transfer2_tpu_torch/csrc/conv3x3_wgmma.cu',
                 'style_transfer2_tpu_torch/csrc/wgmma.cuh')
_STYLE_SOURCES = ('style_transfer2_tpu_torch/csrc/style.cu',
                  'style_transfer2_tpu_torch/csrc/wgmma.cuh')
_STYLE_KERNEL = 'style_transfer2_tpu/ops/pallas/style_kernel.py:35'
SOURCES = {
    'conv3x3_bias_relu_fwd': (_CONV_SOURCES,
                              'style_transfer2_tpu/ops/pallas/conv.py:174'),
    'conv3x3_bias_relu_bwd': (_CONV_SOURCES,
                              'style_transfer2_tpu/ops/pallas/conv.py:183'),
    'fused_style_branch': (_STYLE_SOURCES, _STYLE_KERNEL),
    'style_gram_bf16': (_STYLE_SOURCES, _STYLE_KERNEL),
    'style_grad_bf16': (_STYLE_SOURCES, _STYLE_KERNEL),
    'sumsq': (('style_transfer2_tpu_torch/csrc/reduce.cu',),
              'style_transfer2_tpu/engine/objective.py:239'),
    'pool_fwd': (('style_transfer2_tpu_torch/csrc/pool.cu',),
                 'style_transfer2_tpu/models/vgg19.py:182'),
    'pool_bwd': (('style_transfer2_tpu_torch/csrc/pool.cu',),
                 'style_transfer2_tpu/models/vgg19.py:182'),
    'tap_epilogue': (('style_transfer2_tpu_torch/csrc/epilogue.cu',),
                     'style_transfer2_tpu/engine/objective.py:269'),
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

# The pool phase: tier (a) runs POOL_LANES float32 sessions on the
# POOL_SIZE bucket to POOL_ITERATES iterates, then one resizes to
# POOL_RESIZE with at least POOL_RESIZE_ITERATES iterates there; tier (b)
# climbs POOL_BROWSERS_B bfloat16 sessions up the POOL_SIZES buckets
# (POOL_LADDER iterations each), then a POOL_POLISH-iteration float32
# polish. POOL_TIMEOUT bounds each tier.
POOL_SIZES = (256, 384, 512)
POOL_SIZE = 512
POOL_RESIZE = 384
POOL_LANES = 4               # config.ini's default pool_lanes
POOL_ITERATES = 60
POOL_RESIZE_ITERATES = 30
POOL_BROWSERS_B = 2
POOL_LADDER = 20
POOL_POLISH = 10
POOL_TIMEOUT = 240
POOL_DEVICE = 'cuda'         # the pool's device key (the CPU tests set cpu)
# A warm migration's first loss over the session's first loss at
# POOL_SIZE: a cold reseed would start near the random start's loss.
POOL_WARM_MAX = 0.5

# The video phase: VIDEO_FRAMES frames, each a VIDEO_WINDOW (h, w) window
# of golden_gate.jpg (800x600) with its top edge at VIDEO_TOP and its left
# edge at VIDEO_PAN * k (a horizontal pan); --size VIDEO_SIZE fits each to
# 512x384, 12.8 px of motion a frame. VIDEO_FIRST iterations on the first
# frame, VIDEO_ITERATIONS on each later one (the JAX video module's
# documented example).
VIDEO_FRAMES = 8
VIDEO_WINDOW = (480, 640)
VIDEO_TOP = 60
VIDEO_PAN = 16
VIDEO_SIZE = 512
VIDEO_FIRST = 150
VIDEO_ITERATIONS = 40
VIDEO_TEMPORAL = 1000.0
VIDEO_DEVICE = 'cuda'        # the runs' --device (the CPU tests set cpu)
# A chained frame's first loss over frame 1's first loss (at its random
# start): a warm start begins near the previous frame's end.
VIDEO_WARM_MAX = 0.2
# The small checks. Pipelined against serial: VIDEO_PIPE_ITERATIONS on the
# first and each later frame of video_small_inputs at VIDEO_PIPE_HW. CUDA
# against CPU: the pan's frames at VIDEO_PARITY_HW, VIDEO_FIRST then
# VIDEO_ITERATIONS iterations, the CUDA objective evaluated at each of the
# CPU run's iterates (video_eval_parity).
VIDEO_PIPE_ITERATIONS = (6, 4)
# The relative noise on an iterate that shows how far the CPU objective's
# own gradient moves there (float32's spacing is 1.2e-7 of a value).
VIDEO_GRAD_NOISE = (1e-7, 1e-6)
# The trace's gradient terms, whose largest RMS scales the total's.
GRAD_TERMS = ('scd_grad', 't_grad', 'p_grad', 'temporal_grad')
VIDEO_PIPE_HW = (96, 128)
VIDEO_PARITY_HW = (48, 64)
# The CLI's --profile check: its --size, and the trace events that must
# name each kernel family (the kernels' function names in csrc/).
VIDEO_PROFILE_SIZE = 256
VIDEO_PROFILE_CATEGORY = 'kernel'
VIDEO_PROFILE_NAMES = {'conv': 'conv3x3_', 'style': 'style_grad_kernel',
                       'image': 'mean_shift_kernel'}

# The highres phase: the CLI at --size HIGHRES_SIZE, where golden_gate.jpg
# (800x600) becomes a HIGHRES_HW iterate and starry_night.jpg (750x600) a
# HIGHRES_STYLE_HW style image; L-BFGS, single-scale, HIGHRES_ITERATIONS
# in chunks of HIGHRES_CHUNK one deep (the first chunk holds the eager
# warm-up and the capture, the last two the rate), once for each
# (precision, --remat) of HIGHRES_RUNS; the kernels at its shapes timed by
# median_ms with HIGHRES_TIMING (reps, warm-ups).
HIGHRES_SIZE = 3840
HIGHRES_HW = (2880, 3840)
HIGHRES_STYLE_HW = (3072, 3840)
HIGHRES_ITERATIONS = 12
HIGHRES_CHUNK = 4
HIGHRES_RUNS = (('float32', None), ('float32', 'block'),
                ('bfloat16', None), ('bfloat16', 'conv'),
                ('bfloat16', 'block'))
HIGHRES_TIMING = (5, 1)
HIGHRES_DEVICE = 'cuda'      # the runs' --device (the CPU tests set cpu)
# The CLI's log line after each collected chunk.
CHUNK_LOG = 'scale %dx%d iterate %d loss %.6g'

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
# the 384x512 iterate at N = 4, and '384x4', '256x4' the pool's smaller
# buckets' steps at N = 4.
STEP_SIZES = {'512': '384x512', '543x724': '543x724', '1024': '768x1024',
              '512x4': '4 x 384x512', '384x4': '4 x 288x384',
              '256x4': '4 x 192x256'}
# The grid of each N = 4 `where`.
LANE_GRIDS = {'512x4': (384, 512), '384x4': (288, 384), '256x4': (192, 256)}
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

# The least time the card could take: the larger of the operations over
# the peak rate of their type and the bytes over the memory rate, each
# input read once and each output written once. The costs, the H100's
# data-sheet rates and the step floors come from the port's roofline
# (style_transfer2_tpu_torch/utils/perfmodel.py).
def bound(flops, nbytes, dtype_name='float32'):
    """(bound ms, 'operations' or 'bytes')."""
    from style_transfer2_tpu_torch.utils import perfmodel
    t, by = perfmodel.kernel_bound(flops, nbytes, dtype_name)
    return t * 1e3, by


def conv_bounds(shape, dtype_name, n=1):
    """Bounds (ms, kind) of the forward and the masked backward at (H, W,
    Cin, Cout) over n images (perfmodel.conv_cost: 2*9*n*H*W*Cin*Cout
    operations each; the forward moves x, w, b and y, the backward g, y, w
    and dx)."""
    from style_transfer2_tpu_torch.utils import perfmodel
    return tuple(bound(*perfmodel.conv_cost(n, *shape, direction,
                                            dtype_name), dtype_name)
                 for direction in ('fwd', 'bwd'))


# The roofline of each measured step, in the order the phases ran: one
# row a path (roofline()); the line before the kernels line sums it up.
ROOFLINE = []
# No card beats its floor: a share above this fails the run (the margin
# covers host-clock jitter on short chunks).
MAX_SHARE = 1.05


def step_model(hw, precision, remat=False, lanes=1):
    """perfmodel.model_step at an hw iterate with initial_weights.yaml's
    taps (the objective of every measured run here), times `lanes`
    images."""
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.engine.objective import ObjectiveSpec
    from style_transfer2_tpu_torch.utils import perfmodel
    spec = ObjectiveSpec.from_weights(*cli.load_weights_doc(None))
    model = perfmodel.model_step(tuple(hw), precision, remat,
                                 content_layers=spec.content_layers,
                                 style_layers=spec.style_layers)
    return model.lanes(lanes)


def roofline(path, hw, precision, ms, remat=False, lanes=1, model=None):
    """A measured step read against its floor: returns the fields a
    phase's record keeps, model_flops, floor_ms, bound_by, mfu (the model
    FLOPs over the card's peak over the measured ms) and share_of_floor
    (the floor over the measured ms), and appends them to ROOFLINE with
    the path. model: step_model's by default."""
    model = model or step_model(hw, precision, remat, lanes)
    fields = model.fields_at(ms / 1e3)
    ROOFLINE.append(dict(fields, path=path, hw=list(hw),
                         precision=precision, remat=remat or None,
                         lanes=lanes, ms=ms))
    return fields


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


def replay_ms(fn, torch, calls=10, replays=5):
    """The device's milliseconds per call of fn(): `calls` calls captured
    into one CUDA graph on a side stream (after a warm-up there), the
    graph replayed `replays` times between two CUDA events. No host work
    falls between the launches, so this is the kernels' own time and the
    gaps between them; a call's outputs are freed inside the capture, so
    the graph's pool holds about one call's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


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


def draw(torch, rng, shape, scale=1.0):
    """Normal samples of `shape` times `scale`, float32 on the card: from a
    numpy RandomState on the host, or from a torch.Generator on the card
    (the highres shapes, which the host would take minutes to draw)."""
    if isinstance(rng, np.random.RandomState):
        return torch.as_tensor(np.float32(rng.randn(*shape) * scale),
                               device='cuda')
    return torch.randn(shape, generator=rng, device='cuda') * scale


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
    from style_transfer2_tpu_torch.ops import (conv, epilogue, image, pool,
                                               reduce, style)
    return {'conv3x3_bias_relu_fwd': conv.launches('fwd'),
            'conv3x3_bias_relu_bwd': conv.launches('bwd'),
            'fused_style_branch': style.launches,
            'style_gram_bf16': style.gram_bf16_launches,
            'style_grad_bf16': style.grad_bf16_launches,
            'sumsq': reduce.launches,
            'pool_fwd': pool.fwd_launches,
            'pool_bwd': pool.bwd_launches,
            'tap_epilogue': epilogue.launches,
            'preprocess': image.preprocess_launches,
            'deprocess': image.deprocess_launches}


def reset_counters():
    from style_transfer2_tpu_torch.engine import graphs
    from style_transfer2_tpu_torch.ops import (conv, epilogue, image, pool,
                                               reduce, style)
    graphs.replays = 0
    pool.fwd_launches = pool.bwd_launches = epilogue.launches = 0
    style.launches = style.gram_launches = style.grad_launches = 0
    style.gram_bf16_launches = style.grad_bf16_launches = 0
    reduce.launches = 0
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


def check_conv(torch, rng, shape, dtype_name, where, pending, n=1,
               timing=(15, 3)):
    """Holds the conv kernels against the plain version at one shape, over
    n images (the batched engine's lanes), and times both (median_ms's
    reps and warm-ups: `timing`). Returns the row for kernels.json;
    appends to `pending` the (row, field, fn) of each device time to
    profile later."""
    import torch.nn.functional as F
    from style_transfer2_tpu_torch.ops import conv
    h, w, cin, cout = shape

    def timed(fn):
        return median_ms(fn, torch, *timing)

    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        dtype_name]
    dev = torch.device('cuda')

    x = draw(torch, rng, (n, h, w, cin)).to(dtype)
    wt = draw(torch, rng, (3, 3, cin, cout), np.sqrt(2.0 / (9 * cin))).to(
        dtype)
    b = draw(torch, rng, (cout,), 0.1).to(dtype)
    g = draw(torch, rng, (n, h, w, cout)).to(dtype)

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

    fwd_k = timed(fwd)
    fwd_p = timed(lambda: conv.conv3x3_bias_relu_plain(x, wt, b))
    bwd_k = timed(bwd)
    # Where the narrow kernel is planned, and in bfloat16 everywhere, the
    # tile kernel (in bfloat16 the mma.sync kernel) on the same inputs in
    # the same run.
    bwd_tile = fwd_tile = None
    if path == conv.NARROW or alt:
        bwd_tile = timed(lambda: conv._launch_bwd(
            g, y, w_bwd, (conv.TILE, 1, cout)))
    if alt:
        fwd_tile = timed(lambda: conv._launch_fwd(
            x, wt, b, (conv.TILE, 1, cin)))
    bwd_p = timed(lambda: torch.autograd.grad(
        conv.conv3x3_bias_relu_plain(xr, wt, b), xr, g))
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

    fwd_l = timed(fwd_lib)
    bwd_l = timed(bwd_lib)
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


def check_style(torch, rng, tap, where, pending, lanes=1, timing=(15, 3),
                f64=False):
    """Holds the style branch against its plain version at one tap and
    times both: one map with its (c, c) target, or `lanes` maps with their
    (lanes, c, c) targets in one launch sequence, each lane then also held
    against the one-map kernel on that lane alone and timed beside two
    torch.bmm (the Gram and the gradient product) as the library call.
    With f64 (one map), the kernel is held against the plain version in
    float64 instead, and the float32 plain version's own distance from it
    is reported: at millions of rows the float32 sums of both stray."""
    from style_transfer2_tpu_torch.ops import style
    from style_transfer2_tpu_torch.utils import perfmodel
    h, w, c = tap
    m = h * w

    def timed(fn):
        return median_ms(fn, torch, *timing)

    feat = torch.relu(draw(torch, rng, (lanes, h, w, c)))
    other = torch.relu(draw(torch, rng, (lanes, m, c)))
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
    plain_err = None
    if f64:
        # The plain version's two matmuls in float64.
        x64 = feat.double().reshape(m, c)
        gd64 = x64.T @ x64 / (m * c) - gram_style.double()
        s64 = (x64 @ gd64 * (2.0 / (c * c * m * c))).reshape(feat.shape)
        del x64
        plain_err = errs(s_p, gd_p, s64, gd64, gram_style)[1::2]
        say('kernels', 'style float32 %-8s %-16s against float64: kernel '
            'and float32 plain differ by %.2g/%.2g; the plain version is '
            'at %.2g/%.2g of float64' % (where, tap, sr, gr, *plain_err))
        se, sr, ge, gr = errs(s_k, gd_k, s64, gd64, gram_style)
        del s64, gd64
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

    t_k = timed(kernel)
    t_p = timed(
        lambda: style.fused_style_branch_plain(feat, gram_style))
    lib, t_l = None, None
    if lanes > 1:
        def lib():
            return (torch.bmm(flat.transpose(1, 2), flat),
                    torch.bmm(flat, gd_k))

        t_l = timed(lib)
    # perfmodel.style_cost: M*C*(C+1) operations for the Gram (symmetric:
    # the upper triangle with its diagonal) and 2*M*C^2 for the gradient
    # product; bytes: X and G_style read, and G_diff and s_grad written,
    # once; each per lane.
    t_b, t_by = bound(*perfmodel.style_cost(m, c, lanes))
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
           'plain_f64_rel_err': plain_err,
           'abs_err': max(se, ge)}
    pending.append((row, '', kernel))
    if lib is not None:
        pending.append((row, 'library_', lib))
    return row


def check_feed_style(torch, rng, tap, where, pending, lanes=1, n=1,
                     timing=(15, 3)):
    """The bf16 loss feed's style phases (ops/style.py style_gram,
    style_product) at one bf16 tap (h, w, c), one map or `lanes` maps, of
    a map cut n ways (size the whole map's): each against float64 on the
    same bf16 values (FEED_GRAM_TOL, FEED_PRODUCT_TOL) and against its
    plain version, bitwise repeatable, timed beside its plain version and
    cuBLAS's bf16 GEMM (torch.mm, or torch.bmm over lanes: the library
    yardstick, bf16 out), launch-inclusive (ms) and replayed from a CUDA
    graph (replay_ms: the device's own time). The product takes the Gram
    difference the Gram phase gave against a target drawn like the map.
    Prints and returns the two rows."""
    from style_transfer2_tpu_torch.ops import style
    from style_transfer2_tpu_torch.utils import perfmodel
    h, w, c = tap
    m = h * w
    size = n * m * c
    many = lanes > 1

    def timed(fn):
        return median_ms(fn, torch, *timing)

    feat = torch.relu(draw(torch, rng, (lanes, h, w, c))).to(torch.bfloat16)
    other = torch.relu(draw(torch, rng, (lanes, m, c)))
    target = torch.bmm(other.transpose(1, 2), other) / (m * c)
    del other
    if not many:
        target = target[0]
    flat = feat.reshape(lanes, m, c)
    x64 = flat.double()
    g64 = torch.bmm(x64.transpose(1, 2), x64) / size
    g_k = style.style_gram(feat, size, many)
    g_p = style.style_gram_plain(feat, size, many)
    require(torch.equal(g_k, style.style_gram(feat, size, many)),
            'feed gram %s x%d: two calls differ' % (tap, lanes))
    d = (g_p - target).contiguous()
    s_k = style.style_product(feat, d)
    s_p = style.style_product_plain(feat, d)
    require(torch.equal(s_k, style.style_product(feat, d)),
            'feed product %s x%d: two calls differ' % (tap, lanes))
    d_bf16 = d.to(torch.bfloat16)
    s64 = torch.bmm(x64, d_bf16.double().reshape(lanes, c, c))
    del x64
    torch.cuda.synchronize()

    def rel(got, want):
        got = got.double().reshape(want.shape)
        err = float((got - want).abs().max())
        return err, err / float(want.abs().max())

    rows = []
    g_err, g_rel = rel(g_k, g64)
    s_err, s_rel = rel(s_k, s64)
    same = float((s_k == s_p).double().mean())
    plain = (rel(g_p, g64)[1], rel(s_p, s64)[1])
    del g64, s64
    require(math.isfinite(g_rel) and g_rel <= FEED_GRAM_TOL, 'feed gram %s '
            'x%d: rel err %.3g against float64' % (tap, lanes, g_rel))
    require(math.isfinite(s_rel) and s_rel <= FEED_PRODUCT_TOL, 'feed '
            'product %s x%d: rel err %.3g against float64' % (tap, lanes,
                                                              s_rel))
    if many:
        def gram_lib():
            return torch.bmm(flat.transpose(1, 2), flat)

        def grad_lib():
            return torch.bmm(flat, d_bf16)
    else:
        flat2 = flat[0]

        def gram_lib():
            return torch.mm(flat2.T, flat2)

        def grad_lib():
            return torch.mm(flat2, d_bf16)
    calls = 3 if timing == HIGHRES_TIMING else 10
    for name, phase, kernel, plain_fn, lib, err, r, p_rel in (
            ('style_gram_bf16', 'gram',
             lambda: style.style_gram(feat, size, many),
             lambda: style.style_gram_plain(feat, size, many), gram_lib,
             g_err, g_rel, plain[0]),
            ('style_grad_bf16', 'grad', lambda: style.style_product(feat, d),
             lambda: style.style_product_plain(feat, d), grad_lib, s_err,
             s_rel, plain[1])):
        t_b, t_by = bound(*perfmodel.style_cost(m, c, lanes, phase,
                                                'bfloat16'), 'bfloat16')
        row = {'kernel': name, 'dtype': 'bfloat16', 'where': where,
               'shape': list(tap), 'lanes': lanes, 'ms': timed(kernel),
               'plain_ms': timed(plain_fn), 'library_ms': timed(lib),
               'replay_ms': replay_ms(kernel, torch, calls),
               'library_replay_ms': replay_ms(lib, torch, calls),
               'bound_ms': t_b, 'bound_by': t_by, 'abs_err': err,
               'f64_rel_err': r, 'plain_f64_rel_err': p_rel}
        if phase == 'grad':
            row['same_as_plain'] = same
        pending.append((row, '', kernel))
        pending.append((row, 'library_', lib))
        rows.append(row)
        say('kernels', 'style bf16 %-9s %-16s x%d %s: %.4f ms, device %.4f '
            'ms (%.0f%% of its %s bound %.4f); cuBLAS bf16 %.4f ms, device '
            '%.4f; plain %.4f ms; f64 err %.2g (plain %.2g)%s; bitwise '
            'repeatable' % (
                where, tap, lanes, phase, row['ms'], row['replay_ms'],
                100 * t_b / row['replay_ms'], t_by, t_b, row['library_ms'],
                row['library_replay_ms'], row['plain_ms'], r, p_rel,
                ', %.4f of its values the plain version\'s bits' % same
                if phase == 'grad' else ''))
    return rows


def check_sumsq(torch, rng, shape, where, pending, lanes=False,
                timing=(15, 3)):
    """ops/reduce.py sumsq of a bf16 tensor of `shape` (per lane where
    lanes) against float64 on the same values (SUMSQ_TOL) and its plain
    version, bitwise repeatable, timed beside the plain version (no one
    PyTorch call sums float32 squares of bf16 values without a float32
    copy: library_ms None). Returns the row."""
    from style_transfer2_tpu_torch.ops import reduce
    from style_transfer2_tpu_torch.utils import perfmodel

    def timed(fn):
        return median_ms(fn, torch, *timing)

    t = draw(torch, rng, shape).to(torch.bfloat16)
    got = reduce.sumsq(t, lanes)
    require(torch.equal(got, reduce.sumsq(t, lanes)),
            'sumsq %s: two calls differ' % (shape,))
    plain = reduce.sumsq_plain(t, lanes)
    dims = tuple(range(1, len(shape))) if lanes else None
    sq = t.double().square()
    want = sq.sum(dim=dims) if lanes else sq.sum()
    del sq
    err = float((got.double() - want).abs().max())
    r = err / float(want.abs().max())
    p_rel = float((plain.double() - want).abs().max() / want.abs().max())
    require(math.isfinite(r) and r <= SUMSQ_TOL, 'sumsq %s: rel err %.3g '
            'against float64' % (shape, r))

    def kernel():
        return reduce.sumsq(t, lanes)

    t_b, t_by = bound(*perfmodel.sumsq_cost(t.numel()))
    row = {'kernel': 'sumsq', 'dtype': 'bfloat16', 'where': where,
           'shape': list(shape), 'lanes': shape[0] if lanes else 1,
           'ms': timed(kernel),
           'plain_ms': timed(lambda: reduce.sumsq_plain(t, lanes)),
           'library_ms': None, 'bound_ms': t_b, 'bound_by': t_by,
           'abs_err': err, 'f64_rel_err': r, 'plain_f64_rel_err': p_rel}
    pending.append((row, '', kernel))
    say('kernels', 'sumsq bf16 %-8s %-22s %.4f ms (plain %.4f; %.0f%% of '
        'bound %.4f) f64 err %.2g (plain %.2g); bitwise repeatable' % (
            where, tuple(shape), row['ms'], row['plain_ms'],
            100 * t_b / row['ms'], t_b, r, p_rel))
    return row


def pool_inputs(hw):
    """The (1, h, w, c) maps the trunk pools on the way to conv4_2 at an
    hw iterate: conv1_2's, conv2_2's and conv3_4's (ceil pools)."""
    h, w = hw
    shapes = []
    for c in (64, 128, 256):
        shapes.append((1, h, w, c))
        h, w = -(-h // 2), -(-w // 2)
    return shapes


def check_pool(torch, gen, shape, dtype_name, where, pending,
               timing=(15, 3)):
    """ops/pool.py's forward and backward at an (n, h, w, c) ReLU map of
    dtype_name (its zeros tie in many windows) against the plain
    torch.amax pool and its autograd, bit for bit in the pooled map and
    the gradient. Times, launch-inclusive (CUDA events) and from graph
    replays (the device's own): the forward with its mask beside the plain
    forward and F.max_pool2d(ceil_mode=True) on the same map as
    channels-last NCHW; the backward beside the plain version's autograd
    backward (launch-inclusive only: autograd runs it on the forward's
    stream, outside a side stream's capture); forward with backward of all
    three from replays. Given pending, queues the forward, the backward
    and the library forward for phase_costs. Returns the row."""
    import torch.nn.functional as F

    from style_transfer2_tpu_torch.ops import pool
    from style_transfer2_tpu_torch.utils import perfmodel

    def timed(fn):
        return median_ms(fn, torch, *timing)

    dt = getattr(torch, dtype_name)
    n, h, w, c = shape
    x = torch.relu(draw(torch, gen, shape)).to(dt)
    g = draw(torch, gen, (n, (h + 1) // 2, (w + 1) // 2, c)).to(dt)
    xk = x.clone().requires_grad_(True)
    y = pool.max_pool_ceil(xk)
    dx, = torch.autograd.grad(y, xk, g)
    xp = x.clone().requires_grad_(True)
    yp = pool.max_pool_ceil_plain(xp)
    dxp, = torch.autograd.grad(yp, xp, g, retain_graph=True)
    fwd_err, bwd_err = rel_err(y, yp)[0], rel_err(dx, dxp)[0]
    require(torch.equal(y, yp), 'pool fwd %s %s: max abs err %.3g against '
            'the plain version' % (dtype_name, shape, fwd_err))
    require(torch.equal(dx, dxp), 'pool bwd %s %s: max abs err %.3g '
            'against the plain version' % (dtype_name, shape, bwd_err))
    _, mask = pool._forward(x, True)
    xl = x.permute(0, 3, 1, 2)
    gl = g.permute(0, 3, 1, 2)
    # The replayed forward-and-backward calls take leaves of their own,
    # first used on replay_ms's side stream: autograd keeps a leaf's
    # stream from its first graph, and would make the default stream wait
    # on the capturing one.
    xr, xpr = (x.clone().requires_grad_(True) for _ in range(2))
    xb = x.clone().permute(0, 3, 1, 2).requires_grad_(True)

    def fwd():
        return pool._forward(x, True)

    def bwd():
        return pool._backward(g, mask, (h, w))

    def fwd_lib():
        return F.max_pool2d(xl, 2, 2, ceil_mode=True)

    def fwd_plain():
        return pool.max_pool_ceil_plain(x)

    both = {'': lambda: torch.autograd.grad(pool.max_pool_ceil(xr), xr, g),
            'plain_': lambda: torch.autograd.grad(
                pool.max_pool_ceil_plain(xpr), xpr, g),
            'library_': lambda: torch.autograd.grad(
                F.max_pool2d(xb, 2, 2, ceil_mode=True), xb, gl)}
    b_ms, b_by = bound(*perfmodel.pool_cost(*shape, dtype_name))
    row = {'kernel': 'pool', 'dtype': dtype_name, 'where': where,
           'shape': list(shape),
           'fwd_ms': timed(fwd), 'fwd_plain_ms': timed(fwd_plain),
           'fwd_library_ms': timed(fwd_lib), 'bwd_ms': timed(bwd),
           'bwd_plain_ms': timed(lambda: torch.autograd.grad(
               yp, xp, g, retain_graph=True)),
           'bwd_library_ms': None,
           'fwd_replay_ms': replay_ms(fwd, torch),
           'fwd_plain_replay_ms': replay_ms(fwd_plain, torch),
           'fwd_library_replay_ms': replay_ms(fwd_lib, torch),
           'bwd_replay_ms': replay_ms(bwd, torch),
           'fwd_bound_ms': b_ms, 'bwd_bound_ms': b_ms, 'fwd_bound_by': b_by,
           'bwd_bound_by': b_by, 'fwd_abs_err': fwd_err,
           'bwd_abs_err': bwd_err}
    for key, fn in both.items():
        row['fwd_bwd_%sreplay_ms' % key] = replay_ms(fn, torch)
    if pending is not None:
        pending.extend([(row, 'fwd_', fwd), (row, 'bwd_', bwd),
                        (row, 'fwd_library_', fwd_lib)])
    say('kernels', 'pool %-8s %-9s %-20s fwd %.4f ms (plain %.4f; '
        'F.max_pool2d %.4f), bwd %.4f (plain %.4f); replays: fwd %.4f '
        '(plain %.4f; F.max_pool2d %.4f; %.0f%% of bound %.4f), bwd %.4f '
        '(%.0f%% of bound), fwd+bwd %.4f (plain %.4f; F.max_pool2d %.4f); '
        'bit for bit' % (
            dtype_name, where, tuple(shape), row['fwd_ms'],
            row['fwd_plain_ms'], row['fwd_library_ms'], row['bwd_ms'],
            row['bwd_plain_ms'], row['fwd_replay_ms'],
            row['fwd_plain_replay_ms'], row['fwd_library_replay_ms'],
            100 * b_ms / row['fwd_replay_ms'], b_ms, row['bwd_replay_ms'],
            100 * b_ms / row['bwd_replay_ms'], row['fwd_bwd_replay_ms'],
            row['fwd_bwd_plain_replay_ms'],
            row['fwd_bwd_library_replay_ms']))
    return row


def check_epilogue(torch, gen, shape, terms, where, pending,
                   timing=(15, 3)):
    """ops/epilogue.py's tap epilogue at a float32 (n, h, w, c) tap with
    the terms named in `terms` ('c', 's', 'd') against its plain version:
    the cotangent bit for bit, the same bits on a second call, and the
    five sums within EPILOGUE_TOL of float64 over the same float32 terms
    (the plain version's float32 reductions beside). Times launch-inclusive
    and from graph replays, beside the plain version's (no one PyTorch call
    computes the same: library_ms None). Given pending, queues the kernel
    for phase_costs. Returns the row."""
    from style_transfer2_tpu_torch.ops import epilogue
    from style_transfer2_tpu_torch.utils import perfmodel

    def timed(fn):
        return median_ms(fn, torch, *timing)

    def scalar(v):
        return torch.tensor(v, device='cuda')

    feat = torch.relu(draw(torch, gen, shape))
    w = torch.tensor([0.08, 1.0, -0.3], device='cuda')
    args = dict(content=None, c_norm=None, s_grad=None, s_scale=None,
                d_norm=None)
    if 'c' in terms:
        args.update(content=torch.relu(draw(torch, gen, shape)),
                    c_norm=scalar(3e-3))
    if 's' in terms:
        args.update(s_grad=draw(torch, gen, shape, 1e-4),
                    s_scale=w[1] / scalar(7e-6))
    if 'd' in terms:
        args.update(d_norm=scalar(1.3e-2))
    diff, sums = epilogue.tap_epilogue(feat, w, **args)
    diff2, sums2 = epilogue.tap_epilogue(feat, w, **args)
    want, want_sums = epilogue.tap_epilogue_plain(feat, w, **args)
    err = rel_err(diff, want)[0]
    require(torch.equal(diff, want), 'tap_epilogue %s %s: cotangent max '
            'abs err %.3g against the plain version' % (terms, shape, err))
    require(torch.equal(diff, diff2) and torch.equal(sums, sums2),
            'tap_epilogue %s %s: two calls differ' % (terms, shape))
    size = float(feat.numel())

    def f64(t):
        return float(t.double().square().sum())

    exact = [0.0] * 5
    if 'c' in terms:
        c_diff = feat - args['content']
        exact[0] = f64(c_diff)
        exact[1] = f64(w[0] * ((2.0 / size) * c_diff) / args['c_norm'])
    if 's' in terms:
        exact[2] = f64(args['s_scale'] * args['s_grad'])
    if 'd' in terms:
        exact[3] = f64(feat)
        exact[4] = f64(w[2] * ((-2.0 / size) * feat) / args['d_norm'])

    def worst_rel(got):
        got = got.double().tolist()
        return max(abs(a - e) / abs(e) if e else abs(a)
                   for a, e in zip(got, exact))

    r, p_rel = worst_rel(sums), worst_rel(want_sums)
    require(math.isfinite(r) and r <= EPILOGUE_TOL, 'tap_epilogue %s %s: '
            'sums rel err %.3g against float64' % (terms, shape, r))

    def kernel():
        return epilogue.tap_epilogue(feat, w, **args)

    def plain():
        return epilogue.tap_epilogue_plain(feat, w, **args)

    t_b, t_by = bound(*perfmodel.epilogue_cost(feat.numel(), terms))
    row = {'kernel': 'tap_epilogue', 'dtype': 'float32', 'where': where,
           'shape': list(shape), 'terms': terms, 'ms': timed(kernel),
           'plain_ms': timed(plain), 'library_ms': None,
           'replay_ms': replay_ms(kernel, torch),
           'plain_replay_ms': replay_ms(plain, torch), 'bound_ms': t_b,
           'bound_by': t_by, 'abs_err': err, 'f64_rel_err': r,
           'plain_f64_rel_err': p_rel}
    if pending is not None:
        pending.append((row, '', kernel))
    say('kernels', 'tap_epilogue %-3s %-6s %-20s %.4f ms (plain %.4f); '
        'replays %.4f ms (plain %.4f; %.0f%% of bound %.4f); cotangent bit '
        'for bit, sums f64 err %.2g (plain %.2g)' % (
            terms, where, tuple(shape), row['ms'], row['plain_ms'],
            row['replay_ms'], row['plain_replay_ms'],
            100 * t_b / row['replay_ms'], t_b, r, p_rel))
    return row


def check_feed(torch, rng, hw, where, pending, worst, parts=None, lanes=1,
               n=1, timing=(15, 3)):
    """The feed's kernels at the style taps of an hw iterate (one shard of
    it cut n ways, or `lanes` maps) and sumsq at those taps and at the
    content tap conv4_2 (one sum a tap: an unfolded step's s_raw and c_diff
    reductions); folds each row's error into worst and, given parts, makes
    the rows the kernels' summary entries. Returns the rows."""
    rows = []
    taps = style_taps(hw[0] // n, hw[1])
    h4, w4, _ = taps[-1]
    for tap in taps:
        rows += check_feed_style(torch, rng, tap, where, pending, lanes, n,
                                 timing)
    for tap in taps + [(h4, w4, 512)]:
        rows.append(check_sumsq(torch, rng, (lanes,) + tap, where, pending,
                                lanes > 1, timing))
    for row in rows:
        worst[row['kernel']] = max(worst[row['kernel']], row['abs_err'])
        if parts is not None:
            parts[row['kernel']].append((row, ''))
    for name in FEED_KERNELS:
        mine = [r for r in rows if r['kernel'] == name]
        device = ''
        if 'replay_ms' in mine[0]:
            device = ', device %.4f (cuBLAS bf16 %.4f, device %.4f)' % (
                sum(r['replay_ms'] for r in mine),
                sum(r['library_ms'] for r in mine),
                sum(r['library_replay_ms'] for r in mine))
        say('kernels', '%s %s x%d summed over its %d calls: %.4f ms%s '
            '(plain %.3f; bound %.4f)' % (name, where, lanes, len(mine),
                                          sum(r['ms'] for r in mine), device,
                                          sum(r['plain_ms'] for r in mine),
                                          sum(r['bound_ms'] for r in mine)))
    return rows


def check_image(torch, rng, hw, pending, timing=(15, 3)):
    """Preprocess from uint8 and from float32 and deprocess at one rung,
    bit for bit against the plain versions. Times: the kernel alone on a
    device tensor against the plain version's device op and against one
    PyTorch call of the same function on the same device tensor (the
    subtract with its dtype promotion; the add), and preprocess end to end
    from the host array (the kernel's input crosses in its own dtype, the
    plain version's as float32)."""
    from style_transfer2_tpu_torch.ops import image
    from style_transfer2_tpu_torch.utils import perfmodel
    dev = torch.device('cuda')
    mean = torch.as_tensor(image.MEAN_RGB, device=dev)
    rows = []

    def timed(fn):
        return median_ms(fn, torch, *timing)

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

        pre_k = timed(pre)
        pre_p = timed(lambda: src32[None] - mean)
        e2e_k = timed(lambda: image.preprocess(img, dev))
        e2e_p = timed(lambda: image.preprocess_plain(img, dev))
        de_k = timed(de)
        de_p = timed(lambda: image.deprocess_plain(x_k))
        pre_l = timed(pre_lib)
        de_l = timed(de_lib)
        # perfmodel.image_cost: the image in its own dtype and 12 bytes a
        # pixel out (preprocess); 12 in and 12 out (deprocess).
        px = hw[0] * hw[1]
        pre_b = bound(*perfmodel.image_cost(px, src.element_size(),
                                            'preprocess'))[0]
        de_b = bound(*perfmodel.image_cost(px, 4, 'deprocess'))[0]
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

    # The N = 4 rows draw from their own generator, and the pool's smaller
    # grids from another, so that the rows before them keep their inputs.
    lanes_rng = np.random.RandomState(LANES)
    grids_rng = np.random.RandomState(2 * LANES)
    for dtype_name in ('float32', 'bfloat16'):
        cases = ([(s, '512') for s in ITERATE_CONVS]
                 + [(s, 'style') for s in STYLE_CONVS]
                 + [(s, '543x724') for s in trunk_convs(543, 724)]
                 + [(s, '1024') for s in trunk_convs(768, 1024)]
                 + [(s, where) for where, hw in LANE_GRIDS.items()
                    for s in trunk_convs(*hw)])
        seen = {}
        for shape, where in cases:
            key = (shape, where)
            if key not in seen:
                if where in LANE_GRIDS:
                    seen[key] = check_conv(
                        torch, lanes_rng if where == '512x4' else grids_rng,
                        shape, dtype_name, where, pending, LANES)
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

    # The bf16 loss feed's kernels at the taps of the 512px and 768x1024
    # iterates and of 4 lanes of the 512px one; the 512px step's rows make
    # their summary entries and are profiled.
    feed_rng = np.random.RandomState(3 * LANES)
    for where, hw, lanes in (('512', (384, 512), 1), ('1024', (768, 1024), 1),
                             ('512x4', (384, 512), LANES)):
        main = where == '512'
        rows += check_feed(torch, feed_rng, hw, where,
                           pending if main else [], worst,
                           parts if main else None, lanes)

    # The step glue's kernels on their own generator: the pool at the
    # float32 512px step's three pools and at every pool of the 7 rungs of
    # the 1024px ladder in bfloat16, the tap epilogue at the float32 512px
    # step's five taps (conv1_1 to conv4_1 with style, conv4_2 with
    # content). The 512px rows make the summary entries and are profiled.
    glue_gen = torch.Generator(device='cuda').manual_seed(5 * LANES)
    for dtype_name, grids in (('float32', [(384, 512)]),
                              ('bfloat16', LADDER_1024)):
        for hw in grids:
            main = dtype_name == 'float32'
            where = '512' if main else '%dx%d' % hw
            for shape in pool_inputs(hw):
                row = check_pool(torch, glue_gen, shape, dtype_name, where,
                                 pending if main else None)
                rows.append(row)
                for d in ('fwd', 'bwd'):
                    worst['pool_' + d] = max(worst['pool_' + d],
                                             row[d + '_abs_err'])
                    if main:
                        parts['pool_' + d].append((row, d + '_'))
    for shape, terms in ([((1,) + tap, 's') for tap in STYLE_TAPS['512']]
                         + [((1, 48, 64, 512), 'c')]):
        row = check_epilogue(torch, glue_gen, shape, terms, '512', pending)
        rows.append(row)
        worst['tap_epilogue'] = max(worst['tap_epilogue'], row['abs_err'])
        parts['tap_epilogue'].append((row, ''))

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


# Step-graph replays of each run that require_all_launched checked.
REPLAYS = {}


def replays():
    """The step-graph replays of every engine since reset_counters."""
    from style_transfer2_tpu_torch.engine import graphs
    return graphs.replays


def require_all_launched(counts, what, precisions, lanes=False):
    """Every kernel of the run's precisions launched (PRECISION_KERNELS:
    a bfloat16 run's style taps take the feed's bf16 phases, a float32
    run's the fused branch and the tap epilogue; a lanes run none of
    LANE_FREE_KERNELS), and the steps ran as graph replays
    (engine/graphs.py; the launch counts above include the replays')."""
    want = {k for p in precisions for k in PRECISION_KERNELS[p]}
    if lanes:
        want -= set(LANE_FREE_KERNELS)
    for name in sorted(want):
        require(counts[name] > 0, '%s: kernel %s never launched'
                % (what, name))
    n = replays()
    require(n > 0, '%s: no step graph replayed' % what)
    REPLAYS[what] = n


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
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
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
        require_all_launched(counts, 'main ' + precision, (precision,))
        if precision == 'bfloat16':
            require(counts['fused_style_branch'] == 0, 'main bfloat16: the '
                    'float32 style branch launched %d times'
                    % counts['fused_style_branch'])
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
        # The first step runs eagerly and the second captures the step
        # graph: from the third on, every step is a replay.
        replay_it_s = (len(times) - 3) / (times[-1] - times[2])
        with Image.open(png) as img:
            require(img.size == (512, 384), 'PNG size %s' % (img.size,))
        rates[precision] = it_s
        say('main', '%s: %d L-BFGS iterations at 512x384, loss %.6g -> '
            '%.6g, %.2f it/s (steady; %.2f from the third step, the '
            'replays), %.1f s wall; %d graph replays; peak device memory '
            '%.0f MiB over the start; launches %s; conv paths %s' % (
                precision, ITERATIONS, losses[0], losses[-1], it_s,
                replay_it_s, wall, REPLAYS['main ' + precision],
                (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
                counts, paths))
    return launches, rates


GRAPH_HW = (384, 512)      # the 512px main path's grid
GRAPH_CHUNK = 20           # steps a timed chunk
# Steps of the chunk whose enqueue gives the host us a step: few enough
# that the host never waits for the card (the enqueue of a 20-step 4-lane
# chunk did), so that it times the host's own work.
GRAPH_HOST_CHUNK = 8
GRAPH_ROUNDS = 3           # eager, graphed, graphed, eager, each round
GRAPH_DEVICE = 'cuda'      # the engines' device (the CPU tests set cpu)
# A factory of the graphed engines' capture backend, None for the engine's
# own (the CPU tests give a stand-in that replays without a card).
GRAPH_BACKEND = None


def graph_inputs():
    """The 512px main path's inputs: golden_gate.jpg at GRAPH_HW, its three
    flips (the 4-lane runs), starry_night.jpg fitted to the grid's longer
    side, a random start
    (seed 0), initial_weights.yaml's objective, random_params(0)."""
    from PIL import Image
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.utils import resize_to_fit
    with Image.open(CONTENT) as img:
        content = cli.fit_content(img.convert('RGB'), GRAPH_HW)
    with Image.open(STYLE) as img:
        style_img = np.uint8(resize_to_fit(img.convert('RGB'),
                                           max(GRAPH_HW)))
    start = np.random.RandomState(0).uniform(
        0, 255, GRAPH_HW + (3,)).astype(np.uint8)
    contents = [content, content[:, ::-1], content[::-1], content[::-1, ::-1]]
    return (random_params(0), cli.load_weights_doc(None),
            [np.ascontiguousarray(c) for c in contents], style_img, start)


def eager(engine):
    """The engine with its steps run eagerly, as before the graphs (the
    plain version the replays are held against; for this A/B only)."""
    from style_transfer2_tpu_torch.engine.graphs import StepGraphs
    engine._graphs = StepGraphs()
    return engine


def graph_single(inputs, precision, optimizer, graphed, backend=None):
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.engine.graphs import StepGraphs
    params, (weights, scalars), contents, style_img, start = inputs
    st = StyleTransfer(params, precision, device=GRAPH_DEVICE)
    backend = backend or (GRAPH_BACKEND and GRAPH_BACKEND())
    if not graphed:
        eager(st)
    elif backend is not None:
        st._graphs = StepGraphs(backend)
    st.set_weights(weights, scalars)
    st.set_optimizer(optimizer)
    st.set_step_size({'adam': 10.0, 'lbfgs': 1.0}[optimizer])
    st.set_content(contents[0])
    st.set_style(style_img)
    st.set_input(start)
    require(st.start(), 'graph: engine did not start')
    return st


def graph_lanes(inputs, precision, graphed):
    from style_transfer2_tpu_torch.engine.batched import (
        BatchedStyleTransfer)
    params, (weights, scalars), contents, style_img, start = inputs
    from style_transfer2_tpu_torch.engine.graphs import StepGraphs
    bt = BatchedStyleTransfer(params, weights, scalars, GRAPH_HW, LANES,
                              optimizer='lbfgs', precision=precision,
                              device=GRAPH_DEVICE)
    if not graphed:
        eager(bt)
    elif GRAPH_BACKEND is not None:
        bt._graphs = StepGraphs(GRAPH_BACKEND())
    for lane, content in enumerate(contents[:LANES]):
        bt.add_job(content, style_img, start, lane=lane)
    return bt


def single_bits(inputs, precision, optimizer, graphed):
    """step, a chunk, an objective change, two chunks in flight, step: the
    traces, the collected images, the state and the norms."""
    st = graph_single(inputs, precision, optimizer, graphed)
    weights, scalars = inputs[1]
    images = [st.step()[0], st.run_steps(4)[0]]
    st.set_weights(weights, dict(scalars, tv=scalars.get('tv', 1.0) * 0.8))
    a, b = st.begin_steps(3), st.begin_steps(2)
    images += [img for img, _ in st.collect_steps_many([a, b])]
    images.append(st.step()[0])
    rows = [{k: v for k, v in t.data.items() if k != 'time'}
            for t in st.traces]
    state = {k: v.clone() if hasattr(v, 'clone') else v
             for k, v in st.opt_state.items()}
    norms = {k: float(v) for k, v in st.norm_vals.items()}
    return rows, images, state, norms


def lanes_bits(inputs, precision, graphed):
    """Four lanes: a step, a chunk, lane 1 paused for a chunk, lane 0's
    weights and lane 3's step size changed, a chunk: traces, state,
    norms."""
    bt = graph_lanes(inputs, precision, graphed)
    weights, scalars = inputs[1]
    rows = [bt.step_all(), bt.run_steps_all(3)]
    bt.set_running(1, False)
    rows.append(bt.run_steps_all(2))
    bt.set_running(1, True)
    bt.set_lane_weights(0, weights, dict(scalars,
                                         tv=scalars.get('tv', 1.0) * 0.8))
    bt.set_step_size(3, 0.5)
    rows.append(bt.run_steps_all(2))
    state = {k: v.clone() for k, v in bt.states.items()}
    keys, vals, set_ = bt.norms_host()
    return rows, [], state, (keys, vals.tolist(), set_.tolist())


def same_bits(what, got, want):
    """(rows, images, state, norms) of a graphed run against the eager
    run's, bit for bit."""
    import torch
    rows, images, state, norms = got
    require(rows == want[0], '%s: trace rows differ' % what)
    for i, (a, b) in enumerate(zip(images, want[1])):
        require(np.array_equal(a, b), '%s: image %d differs' % (what, i))
    require(state.keys() == want[2].keys(), '%s: state keys' % what)
    for key, value in state.items():
        same = (torch.equal(value, want[2][key]) if torch.is_tensor(value)
                else value == want[2][key])
        require(same, '%s: state %s differs' % (what, key))
    require(norms == want[3], '%s: norms differ' % what)


class CountingGraphs:
    """engine/graphs.py CudaGraphs keeping each captured graph's node
    count (cudaGraphGetNodes on the graph torch keeps with keep_graph)."""

    def __init__(self, torch):
        import ctypes
        from style_transfer2_tpu_torch.engine.graphs import CudaGraphs
        self.torch = torch
        self.inner = CudaGraphs(torch.device('cuda'))
        self.nodes = []
        # The driver's entry point: a cudaGraph_t is a CUgraph.
        self.get_nodes = ctypes.CDLL('libcuda.so.1').cuGraphGetNodes
        self.get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]

    def warm(self, fn):
        return self.inner.warm(fn)

    def reset(self):
        self.inner.reset()

    def capture(self, fn):
        import ctypes
        torch = self.torch
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self.inner.pool,
                              stream=self.inner.stream,
                              capture_error_mode='thread_local'):
            fn()
        count = ctypes.c_size_t(0)
        err = self.get_nodes(graph.raw_cuda_graph(), None,
                             ctypes.byref(count))
        require(err == 0, 'cuGraphGetNodes: error %d' % err)
        self.nodes.append(count.value)
        graph.instantiate()
        return graph


def graph_nodes(torch, inputs, precision):
    """Node counts of the 512px L-BFGS step and prime graphs, or None
    where this torch keeps no graph to count."""
    backend = CountingGraphs(torch)
    st = graph_single(inputs, precision, 'lbfgs', True, backend)
    try:
        st.run_steps(2)              # prime and step warm, step captured
        st.objective_changed()
        st.run_steps(1)              # prime captured
    except (TypeError, AttributeError) as e:    # no keep_graph here
        say('graph', 'node count not measured: %s' % e)
        return None
    torch.cuda.synchronize()
    return dict(zip(('step', 'prime'), backend.nodes))


def time_chunks(torch, runs, what, phase='graph'):
    """runs: {'eager': fn, 'graphed': fn}, fn(n) enqueueing one n-step
    chunk and returning a collect callable. In turns (eager, graphed,
    graphed, eager) GRAPH_ROUNDS times: the ms a step over a synced
    GRAPH_CHUNK-step chunk, the most device memory it allocated beyond
    what was allocated before it, and the host us a step until a synced
    GRAPH_HOST_CHUNK-step chunk's enqueue returned."""
    out = {name: {'ms': [], 'host_us': [], 'chunk_peak': 0}
           for name in runs}
    for _ in range(GRAPH_ROUNDS):
        for name in ('eager', 'graphed', 'graphed', 'eager'):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs[name](GRAPH_CHUNK)()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out[name]['ms'].append((t1 - t0) * 1e3 / GRAPH_CHUNK)
            out[name]['chunk_peak'] = max(
                out[name]['chunk_peak'],
                torch.cuda.max_memory_allocated() - base)
            t0 = time.perf_counter()
            collect = runs[name](GRAPH_HOST_CHUNK)
            t1 = time.perf_counter()
            collect()
            torch.cuda.synchronize()
            out[name]['host_us'].append((t1 - t0) * 1e6 / GRAPH_HOST_CHUNK)
    for name, row in out.items():
        row['median_ms'] = float(np.median(row['ms']))
        row['it_s'] = 1e3 / row['median_ms']
        row['median_host_us'] = float(np.median(row['host_us']))
    say(phase, '%s: ms a step eager %s, graphed %s (median %.3f / %.3f, '
        'x%.2f); host us a step until a %d-step chunk is enqueued eager '
        '%.1f, graphed %.1f' % (
            what, ', '.join('%.3f' % v for v in out['eager']['ms']),
            ', '.join('%.3f' % v for v in out['graphed']['ms']),
            out['eager']['median_ms'], out['graphed']['median_ms'],
            out['eager']['median_ms'] / out['graphed']['median_ms'],
            GRAPH_HOST_CHUNK, out['eager']['median_host_us'],
            out['graphed']['median_host_us']))
    return out


def resident(torch, build):
    """(the engine build() returns after two warm chunks, the device
    memory it holds: allocated and reserved bytes over the start, the
    caching allocator's free blocks released before both readings, so
    that reserved beyond allocated is the graphs' private pool)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    engine = build()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return engine, {'allocated': torch.cuda.memory_allocated() - base[0],
                    'reserved': torch.cuda.memory_reserved() - base[1]}


def phase_graph(torch, smi):
    """The step graphs at 512px: graphed against eager bit for bit (one
    image, float32 and bfloat16, L-BFGS with a prime and Adam; 4 lanes,
    L-BFGS), then the ms a step and host us a step of each, in turns in
    one process, the node counts, the capture seconds and the memory
    each engine holds; graph.json."""
    from style_transfer2_tpu_torch.engine import graphs
    inputs = graph_inputs()
    out = {'device': smi, 'hw': list(GRAPH_HW), 'chunk': GRAPH_CHUNK}
    graphs.captures.clear()
    replays = graphs.replays
    for precision in ('float32', 'bfloat16'):
        for optimizer in ('lbfgs', 'adam'):
            what = 'one image %s %s' % (precision, optimizer)
            same_bits(what, single_bits(inputs, precision, optimizer, True),
                      single_bits(inputs, precision, optimizer, False))
        same_bits('4 lanes ' + precision,
                  lanes_bits(inputs, precision, True),
                  lanes_bits(inputs, precision, False))
    require(graphs.replays > replays, 'graph: nothing replayed')
    say('graph', 'graphed equal to eager bit for bit (traces, images, '
        'state, norms): one image float32 and bfloat16, L-BFGS with a '
        'prime and Adam; 4 lanes L-BFGS in both; %d replays'
        % (graphs.replays - replays))
    out['bitwise'] = True

    def warm_single(precision, graphed):
        def build():
            st = graph_single(inputs, precision, 'lbfgs', graphed)
            st.run_steps(2)
            st.run_steps(2)
            return st
        return resident(torch, build)

    def warm_lanes(precision, graphed):
        def build():
            bt = graph_lanes(inputs, precision, graphed)
            bt.run_steps_all(2)
            bt.run_steps_all(2)
            return bt
        return resident(torch, build)

    def single_chunk(st):
        def run(n):
            handle = st.begin_steps(n)
            return lambda: st.collect_steps(handle, fetch_image=False)
        return run

    def lanes_chunk(bt):
        def run(n):
            handle = bt.begin_steps_all(n)
            return lambda: bt.collect_steps_all(handle)
        return run

    for precision in ('float32', 'bfloat16'):
        entry = out[precision] = {'nodes': graph_nodes(torch, inputs,
                                                       precision)}
        for kind, warm, chunk in (('one_image', warm_single, single_chunk),
                                  ('lanes4', warm_lanes, lanes_chunk)):
            engines, memory = {}, {}
            for name, graphed in (('eager', False), ('graphed', True)):
                engines[name], memory[name] = warm(precision, graphed)
            rates = time_chunks(torch, {n: chunk(e) for n, e in
                                        engines.items()},
                                '%s %s' % (kind, precision))
            for name in rates:
                rates[name]['memory'] = memory[name]
                rates[name]['roofline'] = roofline(
                    'graph %s %s %s' % (kind, precision, name), GRAPH_HW,
                    precision, rates[name]['median_ms'],
                    lanes=1 if kind == 'one_image' else LANES)
            entry[kind] = rates
            say('graph', '%s %s: memory held after warm-up, allocated / '
                'reserved MiB: eager %.0f / %.0f, graphed %.0f / %.0f; a '
                'chunk\'s peak beyond that: eager %.0f, graphed %.0f' % (
                    kind, precision,
                    memory['eager']['allocated'] / 2 ** 20,
                    memory['eager']['reserved'] / 2 ** 20,
                    memory['graphed']['allocated'] / 2 ** 20,
                    memory['graphed']['reserved'] / 2 ** 20,
                    rates['eager']['chunk_peak'] / 2 ** 20,
                    rates['graphed']['chunk_peak'] / 2 ** 20))
            del engines
        say('graph', '%s: graph nodes %s' % (precision, entry['nodes']))
    out['capture_s'] = [dict(c, hw=list(c['hw'])) for c in graphs.captures]
    say('graph', 'capture seconds: %s' % ', '.join(
        '%s %s x%d %s %.3f' % (c['kind'], 'x'.join(map(str, c['hw'])),
                               c['lanes'], c['dtype'], c['seconds'])
        for c in out['capture_s']))
    (OUT_DIR / 'graph.json').write_text(json.dumps(out, indent=1))
    return out


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
    from style_transfer2_tpu_torch.engine import graphs
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
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        graphs.captures.clear()
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
        # The bfloat16 run's polish runs in float32.
        require_all_launched(counts, 'ladder ' + precision,
                             {precision, 'float32'})
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
        # Each rung's ms a step from its logged it/s (the prime and any
        # capture of the rung included) against the rung's floor.
        entry = {'wall_s': wall, 'rungs': [
            dict({'hw': list(hw), 'it_s': a[4], 's': a[3]},
                 **roofline(
                     'ladder %s rung %dx%d' % ((precision,) + hw), hw,
                     precision, 1e3 / a[4]))
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
            entry['polish'] = dict(
                {'s': polish_s[0], 'first_loss': losses[0],
                 'last_loss': losses[-1]},
                **roofline(
                    'ladder %s polish float32' % precision,
                    LADDER_1024[-1], 'float32', 1e3 * polish_s[0] / POLISH))
            say('ladder', '%s polish: %d float32 iterations at %dx%d in '
                '%.3f s, loss %.6g -> %.6g' % (
                    precision, POLISH, top_wh[1], top_wh[0], polish_s[0],
                    losses[0], losses[-1]))
        entry['capture_s'] = [dict(c, hw=list(c['hw']))
                              for c in graphs.captures]
        entry['replays'] = REPLAYS['ladder ' + precision]
        entry['peak_bytes'] = torch.cuda.max_memory_allocated() - base
        say('ladder', '%s: %d rungs x %d iterations%s, %.2f s wall; %d '
            'graph replays; peak device memory %.0f MiB over the start; '
            'capture s %s; '
            'launches %s; conv paths %s' % (
                precision, len(LADDER_1024), LADDER_ITERATIONS,
                ' + %d polish' % POLISH if extra else '', wall,
                entry['replays'], entry['peak_bytes'] / 2 ** 20,
                ', '.join('%s %s %s %.3f' % (
                    c['kind'], 'x'.join(map(str, c['hw'])), c['dtype'],
                    c['seconds']) for c in entry['capture_s']),
                counts, paths))

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


def highres_kernels(torch, worst):
    """Part (a) of the highres phase: every conv of the trunk up to conv4_2
    at the HIGHRES_HW iterate's shapes, forward and backward, in float32
    and bfloat16 (with each shape's planned paths and cuDNN's times, and
    the step's sums), the style branch at its four taps held against its
    plain version in float64, and the image kernels at HIGHRES_HW and
    HIGHRES_STYLE_HW bit for bit; the kernels phase's tolerances, timed
    with HIGHRES_TIMING. The maps are drawn on the card from a seeded
    torch.Generator. Folds each row's error into `worst`; returns the
    rows."""
    from style_transfer2_tpu_torch.utils import tf32
    gen = torch.Generator(device='cuda')
    gen.manual_seed(HIGHRES_SIZE)
    rng = np.random.RandomState(HIGHRES_SIZE)
    size = '%dx%d' % HIGHRES_HW
    rows = []
    with tf32(False):
        for dtype_name in ('float32', 'bfloat16'):
            seen = {}
            for shape in trunk_convs(*HIGHRES_HW):
                if shape not in seen:
                    seen[shape] = check_conv(torch, gen, shape, dtype_name,
                                             size, [], timing=HIGHRES_TIMING)
                    rows.append(seen[shape])
                for d in ('fwd', 'bwd'):
                    name = 'conv3x3_bias_relu_' + d
                    worst[name] = max(worst[name], seen[shape][d + '_abs_err'])
            step_sums([seen[s] for s in trunk_convs(*HIGHRES_HW)],
                      dtype_name, size)
        for tap in style_taps(*HIGHRES_HW):
            row = check_style(torch, gen, tap, size, [],
                              timing=HIGHRES_TIMING, f64=True)
            rows.append(row)
            worst['fused_style_branch'] = max(worst['fused_style_branch'],
                                              row['abs_err'])
        rows += check_feed(torch, gen, HIGHRES_HW, size, [], worst,
                           timing=HIGHRES_TIMING)
        torch.cuda.empty_cache()
        for hw in (HIGHRES_HW, HIGHRES_STYLE_HW):
            for row in check_image(torch, rng, hw, [], timing=HIGHRES_TIMING):
                rows.append(row)
                for name in ('preprocess', 'deprocess'):
                    worst[name] = max(worst[name], row[name + '_abs_err'])
    return rows


def highres_memory(torch):
    """One forward and vjp of VGG19Features to conv4_2 at the HIGHRES_HW
    iterate (taps conv1_1, conv2_1, conv3_1, conv4_1, conv4_2; ones as
    cotangents), for each precision and remat policy: the bytes the
    forward leaves allocated, the evaluation's peak and its seconds; each
    policy's gradient must be the plain one's bits, and in float32 block
    remat must leave less saved. Returns {precision: {policy: entry}}."""
    from style_transfer2_tpu_torch.models import random_params, vgg19
    from style_transfer2_tpu_torch.models.weights import params_from_numpy
    gen = torch.Generator(device='cuda')
    gen.manual_seed(HIGHRES_SIZE)
    x = torch.rand((1,) + HIGHRES_HW + (3,), generator=gen,
                   device='cuda') * 250 - 120
    layers = ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1', 'conv4_2')
    result = {}
    for precision, dtype in (('float32', torch.float32),
                             ('bfloat16', torch.bfloat16)):
        params = params_from_numpy(random_params(0), 'cuda', dtype)
        plain = None
        result[precision] = {}
        for policy in (False, 'conv', 'block'):
            model = vgg19.VGG19Features(params, dtype, policy)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            feats, vjp = model.features_and_vjp(x, layers)
            saved = torch.cuda.memory_allocated() - base
            grad = vjp({n: torch.ones_like(f) for n, f in feats.items()})
            torch.cuda.synchronize()
            entry = {'saved_bytes': saved,
                     'peak_bytes': torch.cuda.max_memory_allocated() - base,
                     'seconds': time.perf_counter() - t0}
            del feats, vjp
            if plain is None:
                plain = grad
            require(torch.equal(grad, plain), 'highres %s remat %s: the '
                    'gradient differs from the plain one' % (precision,
                                                             policy))
            result[precision][str(policy)] = entry
            say('highres', 'evaluation %s remat %-5s: the forward leaves '
                '%.0f MiB, peak %.0f MiB, %.3f s; gradient bit for bit '
                'the plain one' % (precision, policy,
                                    saved / 2 ** 20,
                                    entry['peak_bytes'] / 2 ** 20,
                                    entry['seconds']))
        del plain, grad, params
    f32 = result['float32']
    require(f32['block']['saved_bytes'] < f32['False']['saved_bytes'],
            'highres float32: block remat left no less saved')
    return result


class ChunkMemory(logging.Handler):
    """The card's reserved bytes at each of the CLI's chunk log lines,
    while the engine and its graphs live."""

    def __init__(self, torch):
        super().__init__()
        self.torch = torch
        self.reserved = []

    def emit(self, record):
        if record.msg == CHUNK_LOG:
            self.reserved.append(self.torch.cuda.memory_reserved())


def highres_run(torch, log, memory, precision, remat):
    """One CLI run of the highres phase; returns its entry for
    highres.json with its kernel counts and its trace rows (less the
    time)."""
    import gc
    from PIL import Image
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.engine import graphs
    name = precision + ('' if remat is None else '_remat_' + remat)
    png = OUT_DIR / ('highres_%s.png' % name)
    trace_csv = OUT_DIR / ('highres_%s.csv' % name)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    png.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counters()
    graphs.captures.clear()
    emptied = graphs.emptied
    start = len(log.records)
    memory.reserved.clear()
    t0 = time.time()             # the log records' clock
    rc = cli.main([str(CONTENT), str(STYLE), '-o', str(png),
                   '--size', str(HIGHRES_SIZE), '--optimizer', 'lbfgs',
                   '--precision', precision, '--model-weights', 'random',
                   '--iterations', str(HIGHRES_ITERATIONS),
                   '--steps-per-dispatch', str(HIGHRES_CHUNK),
                   '--pipeline-depth', '1', '--device', HIGHRES_DEVICE,
                   '--trace-csv', str(trace_csv)]
                  + ([] if remat is None else ['--remat', remat]))
    torch.cuda.synchronize()
    what = 'highres ' + name
    counts = counters()
    require(rc == 0, '%s: cli.main returned %r' % (what, rc))
    require_all_launched(counts, what, (precision,))
    require_paths(what, precision)
    records = log.records[start:]
    chunks = [(r.args[2], r.created) for r in records if r.msg == CHUNK_LOG]
    require([n for n, _ in chunks] == list(range(
        HIGHRES_CHUNK, HIGHRES_ITERATIONS + 1, HIGHRES_CHUNK)),
        '%s: chunks collected at %s' % (what, [n for n, _ in chunks]))
    wrote = [r.created for r in records
             if r.msg == 'wrote %s after %d iterations in %.1fs']
    require(len(wrote) == 1, '%s: the PNG was not logged' % what)
    (n0, t_0), (n1, t_1) = chunks[-3], chunks[-1]
    it_s = (n1 - n0) / (t_1 - t_0)
    rows = [{k: v for k, v in r.items() if k != 'time'}
            for r in read_trace(trace_csv)]
    losses = [float(r['loss']) for r in rows]
    require(len(rows) == HIGHRES_ITERATIONS + 1, '%s: %d trace rows'
            % (what, len(rows)))
    require(all(math.isfinite(v) for v in losses), '%s: non-finite loss'
            % what)
    require(losses[-1] < losses[0], '%s: loss did not fall: %.6g -> %.6g'
            % (what, losses[0], losses[-1]))
    hw = tuple(r.args[:2] for r in records if r.msg == CHUNK_LOG)[0]
    with Image.open(png) as img:
        require(img.size == HIGHRES_HW[::-1] and hw == HIGHRES_HW,
                '%s: PNG size %s, grid %s' % (what, img.size, hw))
    # Five 3840px PNGs would outgrow what chiprun_out may bring back.
    png.unlink()
    entry = {
        'precision': precision, 'remat': remat, 'it_s': it_s,
        'ms_step': 1e3 / it_s, 'wall_s': wrote[0] - t0,
        'capture_s': [c['seconds'] for c in graphs.captures],
        'cache_emptied_at_capture': graphs.emptied - emptied,
        'peak_bytes': torch.cuda.max_memory_allocated() - base,
        'max_memory_allocated': torch.cuda.max_memory_allocated(),
        'max_memory_reserved': torch.cuda.max_memory_reserved(),
        'memory_reserved_at_chunks': list(memory.reserved),
        'base_allocated': base, 'losses': [losses[0], losses[-1]],
        'replays': REPLAYS[what], 'launches': counts,
        'paths': path_counts()}
    entry.update(roofline(what, hw, precision, entry['ms_step'], remat))
    say('highres', '%s: %d L-BFGS iterations at %dx%d in chunks of %d: '
        '%.3f it/s (%.1f ms a step) over the last %d, loss %.6g -> %.6g, '
        '%.1f s from the call to the PNG; capture s %s%s; peak allocated '
        '%.0f MiB over the start (%.0f MiB before it), peak reserved %.0f '
        'MiB, reserved at the chunks %s MiB; '
        '%d graph replays; launches %s; conv paths %s; floor %.2f ms '
        '(%s), %.1f%% of it, MFU %.1f%%' % (
            what, HIGHRES_ITERATIONS, hw[0], hw[1], HIGHRES_CHUNK, it_s,
            entry['ms_step'], n1 - n0, losses[0], losses[-1],
            entry['wall_s'], ', '.join('%.3f' % t for t in
                                       entry['capture_s']),
            ' (the cache emptied first)' if entry[
                'cache_emptied_at_capture'] else '',
            entry['peak_bytes'] / 2 ** 20, base / 2 ** 20,
            entry['max_memory_reserved'] / 2 ** 20,
            ' '.join('%.0f' % (b / 2 ** 20) for b in memory.reserved),
            entry['replays'], counts, entry['paths'], entry['floor_ms'],
            entry['bound_by'], 100 * entry['share_of_floor'],
            100 * entry['mfu']))
    return entry, counts, rows


def phase_highres(torch, log, smi, worst):
    """The 3840px phase: the kernels at its shapes (highres_kernels), then
    the CLI once for each of HIGHRES_RUNS: finite, falling losses, a
    3840x2880 PNG, every kernel launched, the steps replayed from graphs,
    and each remat run's trace equal bit for bit to its precision's run
    without remat. Returns the runs' kernel counts; writes highres.json."""
    kernels = highres_kernels(torch, worst)
    return highres_runs(torch, log, smi, kernels, highres_memory(torch))


def highres_runs(torch, log, smi, kernels, evaluation=None):
    """The CLI runs of phase_highres; writes highres.json with the kernel
    rows and highres_memory's `evaluation` beside them."""
    launches = dict.fromkeys(KERNELS, 0)
    runs, plain = {}, {}
    memory = ChunkMemory(torch)
    logger = logging.getLogger('cli')
    logger.addHandler(memory)
    try:
        for precision, remat in HIGHRES_RUNS:
            entry, counts, rows = highres_run(torch, log, memory, precision,
                                              remat)
            for name, n in counts.items():
                launches[name] += n
            if remat is None:
                plain[precision] = (entry, rows)
            else:
                base, want = plain[precision]
                require(rows == want, 'highres %s --remat %s: the trace '
                        'differs from the run without remat' % (precision,
                                                                remat))
                entry['remat_ms_step'] = entry['ms_step'] - base['ms_step']
                entry['saved_bytes'] = (base['peak_bytes']
                                        - entry['peak_bytes'])
                say('highres', '%s --remat %s: the trace equals the run '
                    'without remat bit for bit; %+.1f ms a step, %.0f MiB '
                    'less peak allocated, %.0f MiB less peak reserved' % (
                        precision, remat, entry['remat_ms_step'],
                        entry['saved_bytes'] / 2 ** 20,
                        (base['max_memory_reserved']
                         - entry['max_memory_reserved']) / 2 ** 20))
            runs['%s %s' % (precision, remat or 'no remat')] = entry
    finally:
        logger.removeHandler(memory)
    (OUT_DIR / 'highres.json').write_text(json.dumps(
        {'device': smi, 'runs': runs, 'evaluation': evaluation,
         'kernels': kernels}, indent=1))
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
    reset_counters()
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
    require_all_launched(counters(), 'parity', ('float32',))
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
    for fold in (False, True):
        feed_eval_parity(torch, params, weights, scalars,
                         (content, style_img, inp), fold)
    weights_round_trip()


def feed_eval_parity(torch, params, weights, scalars, images, fold,
                     device='cuda'):
    """The CUDA bf16 objective (the loss feed: its bf16 style phases and
    sumsq) at each evaluation of a CPU bf16 engine's FEED_PARITY_STEPS
    L-BFGS steps on images, from that evaluation's iterate and first-eval
    norms (video_evaluate), so that no difference carries from one to the
    next: every trace key within FEED_PARITY_RTOL, but the total
    gradient's RMS, `grad`, against the scale of its terms (GRAD_TERMS,
    as video_eval_parity holds it). fold: both engines fold the style
    scale (objective.STYLE_FOLD_MIN_PIXELS at 0 for the run). The CUDA
    evaluations launch the feed's kernels and no float32 style kernel.
    device: the engine held against the CPU one (the CPU tests run both
    on the CPU). Returns the worst (rel err, key, evaluation)."""
    from style_transfer2_tpu_torch.engine import StyleTransfer, objective
    content, style_img, inp = images
    floor = objective.STYLE_FOLD_MIN_PIXELS
    objective.STYLE_FOLD_MIN_PIXELS = 0 if fold else floor
    try:
        engines = {}
        for name, dev in (('cpu', 'cpu'), ('held', device)):
            st = StyleTransfer(params, 'bfloat16', device=dev)
            st.set_weights(weights, scalars)
            st.set_content(content)
            st.set_style(style_img)
            st.set_input(inp)
            require(st.start(), 'feed parity engine did not start')
            engines[name] = st
        cpu = engines['cpu']
        evals = []
        real = cpu._graphs.run

        def run(key, body, args, *rest):
            norms = ({k: float(v) for k, v in args['norms_vals'].items()},
                     {k: bool(v) for k, v in args['norms_set'].items()})
            new, row = real(key, body, args, *rest)
            evals.append((key.spec, new['state']['x'].clone(),
                          row.tolist(), norms))
            return new, row

        cpu._graphs.run = run
        cpu.run_steps(FEED_PARITY_STEPS)
        reset_counters()
        worst = (0.0, '', -1)
        for i, (spec, x, row, norms) in enumerate(evals):
            got, _ = video_evaluate(engines['held'], spec, x, norms)
            keys = list(spec.trace_keys)
            errs = trace_rel_errs(keys, got, row)
            scale = max(row[keys.index(t)] for t in GRAD_TERMS if t in keys)
            at = keys.index('grad')
            errs['grad'] = abs(got[at] - row[at]) / scale
            key = max(errs, key=errs.get)
            require(errs[key] <= FEED_PARITY_RTOL, 'feed parity%s: '
                    'evaluation %d: %s off by %.4g' % (
                        ' (folded)' if fold else '', i, key, errs[key]))
            if errs[key] > worst[0]:
                worst = (errs[key], key, i)
        counts = counters()
        for name in FEED_KERNELS:
            require(counts[name] > 0, 'feed parity: %s never launched'
                    % name)
        require(counts['fused_style_branch'] == 0, 'feed parity: the '
                'float32 style branch launched')
    finally:
        objective.STYLE_FOLD_MIN_PIXELS = floor
    say('parity', 'bf16 loss feed%s at 48x64: the CUDA objective at each '
        'of a CPU bf16 run\'s %d evaluations (%d L-BFGS steps), worst trace '
        'rel err %.3g (%s, evaluation %d; grad over its terms\' scale) '
        'within rtol %g; launches %s' % (
            ' folded' if fold else '', len(evals), FEED_PARITY_STEPS,
            worst[0], worst[1], worst[2], FEED_PARITY_RTOL,
            {k: counts[k] for k in FEED_KERNELS}))
    return worst


def torchvision_state_dict(params):
    """params as a torchvision vgg19().state_dict() of CPU tensors:
    'features.N.weight' (OIHW) and 'features.N.bias', N counting the
    features module's layers (a ReLU after each conv, a pool after each
    block)."""
    import torch
    from style_transfer2_tpu_torch.models import CONV_SPECS
    state, index, block = {}, 0, '1'
    for name, _ in CONV_SPECS:
        if name[4] != block:
            index, block = index + 1, name[4]        # the block's pool
        state['features.%d.weight' % index] = torch.from_numpy(
            np.ascontiguousarray(params[name]['w'].transpose(3, 2, 0, 1)))
        state['features.%d.bias' % index] = torch.from_numpy(
            params[name]['b'])
        index += 2                                   # the conv and its ReLU
    return state


def weights_round_trip():
    """random_params(0) written by write_caffemodel and read back by
    resolve_params, and as a torchvision state dict through
    params_from_torchvision: graphed float32 L-BFGS steps at the 512px
    grid from each (single_bits: traces, images, state, norms) equal, bit
    for bit, those from random_params(0) passed directly."""
    from style_transfer2_tpu_torch.engine import graphs
    from style_transfer2_tpu_torch.models import (params_from_torchvision,
                                                  resolve_params,
                                                  write_caffemodel)
    inputs = graph_inputs()
    params = inputs[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / 'round_trip.caffemodel'
    try:
        write_caffemodel(params, path)
        size = path.stat().st_size
        from_caffe = resolve_params(str(path))
    finally:
        path.unlink(missing_ok=True)     # 80 MB: not kept with the outputs
    from_torch = params_from_torchvision(torchvision_state_dict(params))
    replays = graphs.replays
    want = single_bits(inputs, 'float32', 'lbfgs', True)
    for what, loaded in (('caffemodel', from_caffe),
                         ('torchvision', from_torch)):
        same_bits('weights from a %s' % what,
                  single_bits((loaded,) + tuple(inputs[1:]), 'float32',
                              'lbfgs', True), want)
    require(graphs.replays > replays, 'weights round trip: nothing '
            'replayed')
    say('parity', 'random_params(0) through a %d-byte caffemodel '
        '(write_caffemodel, resolve_params) and a torchvision state dict '
        '(params_from_torchvision): graphed float32 L-BFGS steps at %dx%d '
        'equal bit for bit to random_params(0)\'s (traces, images, state, '
        'norms)' % ((size,) + GRAPH_HW))


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
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
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
    # Session (b)'s bfloat16 ladder ends in a float32 polish.
    require_all_launched(counts, 'serve ' + which,
                         {keys.get('precision', 'float32'), 'float32'})
    require_paths('serve ' + which, keys.get('precision', 'float32'))
    say('serve', '%s: %d graph replays, peak device memory %.0f MiB over '
        'the start' % (which, REPLAYS['serve ' + which],
                       (torch.cuda.max_memory_allocated() - base) / 2 ** 20))
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


def planned_paths(torch, precision, hw, n):
    """The (direction, path) pairs the planners pick for the trunk of an
    hw iterate at N = n."""
    from style_transfer2_tpu_torch.ops import conv
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[precision]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = set()
    for h, w, cin, cout in trunk_convs(*hw):
        want.add(('fwd', conv.fwd_plan(n, h, w, cin, cout, dtype, sms)[0]))
        want.add(('bwd', conv.bwd_plan(n, h, w, cout, cin, dtype, sms)[0]))
    return sorted(want)


def require_planned(torch, what, buckets, n):
    """Each (direction, path) pair planned for the trunk of each
    (precision, hw) bucket at N = n is among the launches. The counts are
    by direction and path only, so a path two precisions share counts
    for both."""
    from style_transfer2_tpu_torch.ops import conv
    for precision, hw in buckets:
        for key in planned_paths(torch, precision, tuple(hw), n):
            require(conv.path_launches.get(key, 0) > 0, '%s: no %s '
                    'launches on the %s path planned for %s %dx%d at N = %d'
                    % (what, key[0], key[1], precision, hw[0], hw[1], n))


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
    engines at 48x64. Returns the kernel counts and the 4-lane aggregate
    it/s of each precision."""
    from PIL import Image
    from style_transfer2_tpu_torch import cli
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
        require_all_launched(counts, 'batch ' + precision, (precision,),
                             lanes=True)
        require_planned(torch, 'batch ' + precision, [(precision, full_hw)],
                        LANES)
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
    return launches, {p: results[p]['aggregate_it_s']
                      for p in ('float32', 'bfloat16')}


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


def time_migrations(tier):
    """Wraps this tier's migrate (the instance's attribute, which
    migrate_session calls) to keep each migration's session and its
    seconds on the device thread, in order."""
    seconds = []
    real = tier.migrate

    def migrate(sess, *args, **kw):
        t0 = time.perf_counter()
        real(sess, *args, **kw)
        seconds.append((sess.session_id, time.perf_counter() - t0))

    tier.migrate = migrate
    return seconds


class PoolBrowser(Browser):
    """A user of its own: its own HTTP session and cookie jar, so the pool
    (and the router before it) tell it from the others."""

    async def open(self):
        async with self.http.get(self.base + '/') as resp:
            require(resp.status == 200, 'pool: GET / %d' % resp.status)
        await self.connect()
        return self

    def cookie(self, name):
        return next(c.value for c in self.http.cookie_jar if c.key == name)

    def last(self, kind):
        return next(d for _, d in reversed(self.frames) if d['type'] == kind)

    def moves(self, since):
        """Each newSize frame from frame `since` on: the grid, and the
        session's iterate counter at the move, the last iterateInfo's
        before it (the pool pushes newSize before the new bucket's first
        tick; iterates numbered above it ran at the new grid)."""
        out, i = [], 0
        for k, (_, d) in enumerate(self.frames):
            if d['type'] == 'iterateInfo':
                i = d['i']
            elif d['type'] == 'newSize' and k >= since:
                out.append({'t': i, 'hw': (d['height'], d['width'])})
        return out


def pool_config(port, **keys):
    """config.ini as it stands (its pool keys commented out, so the pool's
    defaults: 4 Adam lanes, one step a dispatch, images at most every
    0.25 s) with the smoke's own keys over it."""
    config = serve_config(port, device=POOL_DEVICE, initial_size=POOL_SIZE,
                          pool_sizes=', '.join(str(s) for s in POOL_SIZES))
    config.update({k: str(v) for k, v in keys.items()})
    return config


async def serve_apps(stack, *apps):
    """Serves each (aiohttp app, port) on localhost until the stack
    closes, the last first."""
    from aiohttp import web
    for app, port in apps:
        runner = web.AppRunner(app)
        await runner.setup()
        stack.push_async_callback(runner.cleanup)
        await web.TCPSite(runner, '127.0.0.1', port).start()


async def pool_browser(stack, base):
    import aiohttp
    http = await stack.enter_async_context(aiohttp.ClientSession(
        cookie_jar=aiohttp.CookieJar(unsafe=True)))
    return await PoolBrowser(http, base).open()


async def get_text(http, url):
    async with http.get(url) as resp:
        require(resp.status == 200, '%s: %d' % (url, resp.status))
        return await resp.text()


def window_rates(browsers, t0, t1):
    """Each browser's it/s (host clock) over its iterate frames received
    between t0 and t1, and their sum."""
    rates = [host_it_s([f for f in b.iterates() if t0 <= f[0] <= t1])
             for b in browsers]
    return rates, sum(rates)


def frames_between(frames, lo, hi=None):
    """The iterate frames numbered above lo and at most hi."""
    return [f for f in frames if f[1]['i'] > lo
            and (hi is None or f[1]['i'] <= hi)]


def require_falling(frames, what):
    losses = [d['trace']['loss'] for _, d in frames]
    require(all(math.isfinite(v) for v in losses), '%s: non-finite loss'
            % what)
    require(losses[-1] < losses[0], '%s: loss did not fall: %.6g -> %.6g'
            % (what, losses[0], losses[-1]))
    return [losses[0], losses[-1]]


def require_on_device(tier, what):
    for key, engine in tier.engines.items():
        require(engine.device.type == POOL_DEVICE, '%s: bucket %s on %s'
                % (what, key, engine.device))


async def drive_pool_float32(stack, tier, base, torch, migrations):
    """Tier (a): POOL_LANES float32 sessions on one bucket, a fifth
    refused, a weight change on lane 0, a warm resize of another."""
    import io

    import aiohttp
    import yaml
    from PIL import Image
    grid = tier.hw_for(POOL_SIZE)
    require(tier.default_hw == grid, 'pool float32: default bucket %s'
            % (tier.default_hw,))
    browsers = [await pool_browser(stack, base) for _ in range(POOL_LANES)]
    sessions = [tier.sessions[b.cookie('pool_session')] for b in browsers]
    lanes = [s.lane for s in sessions]
    require(lanes == list(range(POOL_LANES))
            and all(s.bucket_hw == grid for s in sessions),
            'pool float32: lanes %s' % [(s.lane, s.bucket_hw)
                                        for s in sessions])
    async with aiohttp.ClientSession() as http:
        async with http.get(base + '/') as resp:
            require(resp.status == 503, 'pool float32: a fifth session '
                    'got %d, not 503' % resp.status)
    for b in browsers:
        await b.until(lambda d: d['type'] == 'thumbnails')
    engine = tier.engine_of(sessions[0])
    starts = [await b.send('start') for b in browsers]
    await asyncio.gather(*(b.until(lambda d: d['type'] == 'iterateInfo'
                                   and d['i'] >= POOL_ITERATES)
                           for b in browsers))
    firsts = [b.iterates() for b in browsers]
    t0 = max(f[0][0] for f in firsts)
    t1 = min(next(t for t, d in f if d['i'] >= POOL_ITERATES)
             for f in firsts)
    rates, aggregate = window_rates(browsers, t0, t1)
    losses = [require_falling([x for x in f if x[1]['i'] <= POOL_ITERATES],
                              'pool float32 lane %d' % k)
              for k, f in enumerate(firsts)]

    # Browser 0 changes a style weight and the step size.
    b0, b1 = browsers[:2]
    lane0 = sessions[0].lane
    rows, steps = engine._weights.copy(), engine._step_sizes.copy()
    params = yaml.safe_load(b0.last('newParams')['params'])
    params['weights'][0]['style']['conv2_1'] = 2.0
    params['optimizer_step_size'] = 5.0
    t_apply = await b0.send('applyParams', params=yaml.safe_dump(params))
    reply = await b0.until(lambda d: d['type'] == 'newParams')
    require(reply.get('errorString') == '', 'pool applyParams: %r'
            % reply.get('errorString'))
    # The pool sets the weights between ticks and then pushes newParams,
    # so every iterate after it ran under the new weights.
    await b0.until(lambda d: d['type'] == 'iterateInfo')
    control_s = b0.frames[-1][0] - t_apply
    changed = [bool(np.any(engine._weights[k] != rows[k])
                    or engine._step_sizes[k] != steps[k])
               for k in range(POOL_LANES)]
    require(changed == [k == lane0 for k in range(POOL_LANES)]
            and engine._step_sizes[lane0] == 5.0,
            'pool applyParams: lanes changed %s, step sizes %s'
            % (changed, engine._step_sizes))

    # Browser 1 resizes: a warm migration into a new bucket.
    sess1 = sessions[1]
    first_loss = firsts[1][0][1]['trace']['loss']
    params = yaml.safe_load(b1.last('newParams')['params'])
    params['size'] = POOL_RESIZE
    mark = len(b1.frames)
    t_resize = await b1.send('applyParams', params=yaml.safe_dump(params))
    size = await b1.until(lambda d: d['type'] == 'newSize')
    t_size = b1.frames[-1][0]
    resized = (size['height'], size['width'])
    require(resized == tier.hw_for(POOL_RESIZE), 'pool resize: newSize %s'
            % (resized,))
    reply = await b1.until(lambda d: d['type'] == 'newParams')
    require(reply.get('errorString') == '', 'pool resize: %r'
            % reply.get('errorString'))
    moved, = b1.moves(mark)
    require(sess1.bucket_hw == resized and tier.engine_of(sess1).device.type
            == POOL_DEVICE and [sid for sid, _ in migrations]
            == [sess1.session_id], 'pool resize: bucket %s on %s, '
            'migrations %s' % (sess1.bucket_hw,
                               tier.engine_of(sess1).device, migrations))
    await b1.until(lambda d: d['type'] == 'iterateInfo'
                   and d['i'] >= moved['t'] + POOL_RESIZE_ITERATES)
    at_new = frames_between(b1.iterates(), moved['t'])
    new_loss = at_new[0][1]['trace']['loss']
    require(math.isfinite(new_loss) and new_loss
            <= POOL_WARM_MAX * first_loss, 'pool resize: first loss at %s '
            '%.6g against %.6g at the start (a cold reseed?)'
            % (resized, new_loss, first_loss))
    gaps = np.diff([t for t, _ in at_new])

    outputs = {}
    for k, b in enumerate(browsers):
        async with b.http.get(base + '/output') as resp:
            require(resp.status == 200, '/output %d' % resp.status)
            png = await resp.read()
        want = resized if k == 1 else grid
        with Image.open(io.BytesIO(png)) as img:
            require(img.format == 'PNG' and img.size == want[::-1],
                    'pool /output %d: %s %s' % (k, img.format, img.size))
        outputs[k] = list(want)
    stats = await get_text(b0.http, base + '/stats')
    require(torch.cuda.get_device_name(0) in stats,
            'pool /stats does not name the card')
    require('%d/%d engine lanes in use' % (POOL_LANES, 2 * POOL_LANES)
            in stats, 'pool /stats: lanes in use')
    for b in browsers:
        await b.send('pause')
    for b in browsers:
        await b.until(lambda d: d['type'] == 'state' and not d['running'])
    require_on_device(tier, 'pool float32')
    return {'grid': list(grid), 'resize_grid': list(resized),
            'lanes': lanes,
            'first_iterate_s': tier.first_iterate_s,
            'first_iterate_host_s': min(f[0][0] for f in firsts)
            - min(starts),
            'window_s': t1 - t0, 'session_it_s': rates,
            'aggregate_it_s': aggregate, 'losses': losses,
            'control_s': control_s,
            'resize_s': at_new[0][0] - t_resize,
            'resize_device_thread_s': migrations[0][1],
            'resize_first_dispatch_s': at_new[0][0] - t_size,
            'resize_warm_dispatch_s': float(np.median(gaps)),
            'resize_iterates': len(at_new),
            'resize_it_s': host_it_s(at_new),
            'resize_loss': [first_loss, new_loss,
                            at_new[-1][1]['trace']['loss']],
            'outputs': outputs,
            'buckets': [['float32', list(grid)], ['float32', list(resized)]]}


async def drive_pool_ladder(stack, tier, base, torch, migrations, router_app,
                            router_base):
    """Tier (b): POOL_BROWSERS_B bfloat16 sessions through the router, up
    the buckets, then the float32 polish bucket and the schedule's
    pause."""
    for _ in range(300):      # the pool's heartbeat registers it
        if router_app['addrs']:
            break
        await asyncio.sleep(0.1)
    require(len(router_app['addrs']) == 1, 'pool ladder: the pool did not '
            'register with the router')
    browsers = [await pool_browser(stack, router_base)
                for _ in range(POOL_BROWSERS_B)]
    sids = [b.cookie('pool_session') for b in browsers]
    for b in browsers:
        await b.until(lambda d: d['type'] == 'thumbnails')
    rungs = [tier.hw_for(s) for s in POOL_SIZES]
    marks = [len(b.frames) for b in browsers]
    starts = [await b.send('start') for b in browsers]

    async def climb(b, sid):
        """Each bucket the session moved into, (grid, precision, device)
        as the tier's table gives them when its newSize arrives."""
        buckets = []
        while True:
            d = await b.recv()
            if d['type'] == 'newSize':
                engine = tier.engine_of(tier.sessions[sid])
                buckets.append(((d['height'], d['width']), engine.precision,
                                engine.device.type))
            elif (d['type'] == 'state' and not d['running']
                  and len(buckets) > len(rungs)):
                return buckets
    climbed = await asyncio.gather(*(climb(b, sid)
                                     for b, sid in zip(browsers, sids)))
    want = ([(hw, 'bfloat16', POOL_DEVICE) for hw in rungs]
            + [(rungs[-1], 'float32', POOL_DEVICE)])
    sessions = []
    for k, (b, sid, buckets) in enumerate(zip(browsers, sids, climbed)):
        what = 'pool ladder session %d' % k
        require(buckets == want, '%s: buckets %s' % (what, buckets))
        seconds = [sec for s, sec in migrations if s == sid]
        require(len(seconds) == len(want), '%s: %d migrations'
                % (what, len(seconds)))
        sess = tier.sessions[sid]
        require(sess.precision == 'float32' and not sess.running
                and sess.sched is None, '%s: ends %s running=%s'
                % (what, sess.precision, sess.running))
        frames = b.iterates()
        bounds = [m['t'] for m in b.moves(marks[k])]
        per_rung = []
        for r, hw in enumerate(rungs):
            rows = frames_between(frames, bounds[r], bounds[r + 1])
            require(len(rows) >= POOL_LADDER, '%s: %d iterates at %s'
                    % (what, len(rows), hw))
            if r == 0:
                require_falling(rows, '%s at %s' % (what, hw))
            loss = [rows[0][1]['trace']['loss'], rows[-1][1]['trace']['loss']]
            per_rung.append({'hw': list(hw), 'iterates': len(rows),
                             'it_s': host_it_s(rows), 'loss': loss})
        polish = frames_between(frames, bounds[-1])
        require(len(polish) >= POOL_POLISH, '%s: %d polish iterates'
                % (what, len(polish)))
        ladder_end = frames_between(frames, 0, bounds[-1])[-1]
        require(all(math.isfinite(d['trace']['loss']) for _, d in frames),
                '%s: non-finite loss' % what)
        sessions.append({
            'rungs': per_rung, 'polish_iterates': len(polish),
            'polish_it_s': host_it_s(polish),
            'polish_migration_s': polish[0][0] - ladder_end[0],
            'polish_device_thread_s': seconds[-1],
            'rung_migration_s': [
                frames_between(frames, bounds[r])[0][0]
                - frames_between(frames, 0, bounds[r])[-1][0]
                for r in range(1, len(rungs))],
            'polish_loss': [polish[0][1]['trace']['loss'],
                            polish[-1][1]['trace']['loss']],
            'first_iterate_host_s': frames[0][0] - starts[k]})
    t0 = max(b.iterates()[0][0] for b in browsers)
    t1 = min(frames_between(b.iterates(), 0, b.moves(mark)[-1]['t'])[-1][0]
             for b, mark in zip(browsers, marks))
    rates, aggregate = window_rates(browsers, t0, t1)
    stats = await get_text(browsers[0].http, router_base + '/stats')
    require('%d/%d session slots in use' % (POOL_BROWSERS_B, POOL_LANES)
            in stats, 'router /stats does not show the pool instance')
    require_on_device(tier, 'pool ladder')
    return {'rungs': [list(hw) for hw in rungs],
            'first_iterate_s': tier.first_iterate_s,
            'window_s': t1 - t0, 'session_it_s': rates,
            'aggregate_it_s': aggregate, 'sessions': sessions,
            'buckets': [[precision, list(hw)] for hw, precision, _ in want]}


async def pool_tier(torch, which, precision, **keys):
    """Serves the port's pool (and, for the bfloat16 tier, the port's
    router in front of it) on free localhost ports, drives it with the
    kernel counts set to 0 and the peak memory reset just before, requires
    every kernel launched and the conv paths planned for each bucket the
    drive used, and returns (counts, the drive's result with the peak
    bytes over the start)."""
    import contextlib

    from style_transfer2_tpu_torch.serve import pool, router
    port = free_port()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    async with contextlib.AsyncExitStack() as stack:
        if precision == 'float32':
            app = pool.init(config=pool_config(port, precision=precision))
            await serve_apps(stack, (app, port))
            result = await drive_pool_float32(
                stack, app['tier'], 'http://127.0.0.1:%d' % port, torch,
                time_migrations(app['tier']))
        else:
            router_port, control_port = free_port(), free_port()
            config = pool_config(port, precision=precision,
                                 router_host='127.0.0.1',
                                 router_port=router_port,
                                 router_control_port=control_port, **keys)
            router_app = router.init(config=config, state_file=str(
                OUT_DIR / 'pool_router_state.json'))
            await serve_apps(stack, (router_app, router_port))
            # The control app shares the registry the router's startup
            # made; the pool's cleanup (first) unregisters through it.
            await serve_apps(stack, (router.make_control_app(router_app),
                                     control_port))
            app = pool.init(config=config)
            await serve_apps(stack, (app, port))
            result = await drive_pool_ladder(
                stack, app['tier'], 'http://127.0.0.1:%d' % port, torch,
                time_migrations(app['tier']), router_app,
                'http://127.0.0.1:%d' % router_port)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = counters()
    # The bfloat16 tier's polish runs in the float32 bucket.
    require_all_launched(counts, 'pool ' + which, {precision, 'float32'},
                         lanes=True)
    require_paths('pool ' + which, precision)
    require_planned(torch, 'pool ' + which, result['buckets'], POOL_LANES)
    result.update(launches=counts, paths=path_counts(),
                  peak_bytes=peak - base_bytes, max_memory_allocated=peak)
    return counts, result


def phase_pool(torch, smi, batch_it_s):
    """The port's pooled server on the card: four float32 sessions on one
    bucket, then two bfloat16 sessions through the router up the buckets
    and into the float32 polish bucket. batch_it_s: the batch phase's
    4-lane aggregate it/s, by precision, printed beside the pool's."""
    launches = dict.fromkeys(KERNELS, 0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)   # the router's state file
    results = {}
    for which, precision, keys in (
            ('float32', 'float32', {}),
            ('bfloat16 ladder', 'bfloat16', {
                'serve_ladder': POOL_LADDER,
                'serve_polish': POOL_POLISH,
                'polish_precision': 'float32'})):
        counts, results[which] = asyncio.run(asyncio.wait_for(
            pool_tier(torch, which, precision, **keys), POOL_TIMEOUT))
        for name, n in counts.items():
            launches[name] += n
    a, b = results['float32'], results['bfloat16 ladder']
    say('pool', '%s; float32, %d sessions on lanes %s of the %dx%d bucket, '
        'one Adam step a dispatch: %s it/s a session, %.2f aggregate over '
        'the %.2f s all ran (host clock), against the batch phase\'s '
        '4-lane L-BFGS aggregate %.2f (x%.2f); first iterate %.2f s; '
        'losses %s' % (
            smi, POOL_LANES, a['lanes'], a['grid'][0], a['grid'][1],
            ', '.join('%.2f' % r for r in a['session_it_s']),
            a['aggregate_it_s'], a['window_s'], batch_it_s['float32'],
            a['aggregate_it_s'] / batch_it_s['float32'],
            a['first_iterate_s'], ', '.join(
                '%.6g -> %.6g' % tuple(v) for v in a['losses'])))
    say('pool', '%s; float32 control latency (applyParams to the first '
        'iterate under lane 0\'s new weights) %.3f s; resize to %dx%d: '
        '%.3f s to its first iterate there (%.3f s on the device thread; '
        'the new bucket\'s first dispatch %.3f s against %.3f s a warm '
        'one), %d iterates, %.2f it/s, loss %.6g at the start, %.6g -> '
        '%.6g after the move' % (
            smi, a['control_s'], a['resize_grid'][0], a['resize_grid'][1],
            a['resize_s'], a['resize_device_thread_s'],
            a['resize_first_dispatch_s'], a['resize_warm_dispatch_s'],
            a['resize_iterates'], a['resize_it_s'], *a['resize_loss']))
    for k, sess in enumerate(b['sessions']):
        say('pool', '%s; bfloat16 session %d through the router: %s; '
            'rung moves %s s; float32 polish move %.3f s (%.3f s on the '
            'device thread), %d iterates, %.2f it/s, loss %.6g -> %.6g' % (
                smi, k, '; '.join(
                    '%dx%d %d iterates %.2f it/s loss %.6g -> %.6g' % (
                        r['hw'][0], r['hw'][1], r['iterates'], r['it_s'],
                        *r['loss']) for r in sess['rungs']),
                ', '.join('%.3f' % s for s in sess['rung_migration_s']),
                sess['polish_migration_s'], sess['polish_device_thread_s'],
                sess['polish_iterates'], sess['polish_it_s'],
                *sess['polish_loss']))
    say('pool', '%s; bfloat16 %s it/s a session, %.2f aggregate over the '
        '%.2f s both climbed, against the batch phase\'s 4-lane L-BFGS '
        'aggregate %.2f; first iterate %.2f s; peak device memory over '
        'the start: float32 %.0f MiB, bfloat16 ladder %.0f MiB '
        '(max_memory_allocated %.0f, %.0f MiB)' % (
            smi, ', '.join('%.2f' % r for r in b['session_it_s']),
            b['aggregate_it_s'], b['window_s'], batch_it_s['bfloat16'],
            b['first_iterate_s'], a['peak_bytes'] / 2 ** 20,
            b['peak_bytes'] / 2 ** 20, a['max_memory_allocated'] / 2 ** 20,
            b['max_memory_allocated'] / 2 ** 20))
    say('pool', 'launches: float32 %s; bfloat16 ladder %s' % (
        a['launches'], b['launches']))
    (OUT_DIR / 'pool.json').write_text(json.dumps(
        dict(results, batch_aggregate_it_s=batch_it_s, device=smi),
        indent=1))
    return launches


def video_frames():
    """The video phase's input frames under OUT_DIR: VIDEO_FRAMES windows
    of golden_gate.jpg, VIDEO_WINDOW (h, w) each, top edge VIDEO_TOP, left
    edge VIDEO_PAN * k for frame k (a horizontal pan). Returns (the frame
    directory, the (width, height) --size VIDEO_SIZE fits them to)."""
    from PIL import Image
    from style_transfer2_tpu_torch.utils import fit_into_square
    frames = OUT_DIR / 'video' / 'frames'
    shutil.rmtree(frames, ignore_errors=True)
    frames.mkdir(parents=True)
    with Image.open(CONTENT) as img:
        pixels = np.asarray(img.convert('RGB'))
    h, w = VIDEO_WINDOW
    for k in range(VIDEO_FRAMES):
        left = VIDEO_PAN * k
        Image.fromarray(np.ascontiguousarray(
            pixels[VIDEO_TOP:VIDEO_TOP + h, left:left + w])).save(
                frames / ('frame_%03d.png' % k))
    return frames, tuple(fit_into_square((w, h), VIDEO_SIZE, scale_up=True))


def flicker(images):
    """The mean over consecutive pairs of frames of mean((a - b)^2)."""
    return float(np.mean([np.mean(np.square(a - b))
                          for a, b in zip(images, images[1:])]))


def video_run(torch, log, frames, size, precision, temporal):
    """One run of video.main() on the frames at --size VIDEO_SIZE, L-BFGS,
    VIDEO_FIRST iterations on the first frame and VIDEO_ITERATIONS on each
    later one, full-width VGG-19 with random_params(0), and its checks.
    Returns (the kernel counts, the run's figures)."""
    from PIL import Image
    from style_transfer2_tpu_torch import video
    name = '%s_temporal_%g' % (precision, temporal)
    outdir = OUT_DIR / 'video' / name
    shutil.rmtree(outdir, ignore_errors=True)
    made, marks = set(), []

    def on_frame(stylizer, index):
        # An event after each frame's launches: it completes when the
        # device has done that frame's work.
        made.add(stylizer)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    start = len(log.records)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    rc = video.main([str(frames), str(STYLE), str(outdir),
                     '--size', str(VIDEO_SIZE), '--first-iterations',
                     str(VIDEO_FIRST), '--iterations',
                     str(VIDEO_ITERATIONS), '--temporal', str(temporal),
                     '--precision', precision, '--model-weights', 'random',
                     '--device', VIDEO_DEVICE], on_frame=on_frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    paths = path_counts()
    peak_all = torch.cuda.max_memory_allocated()
    what = 'video %s' % name
    require(rc == 0, '%s: video.main returned %r' % (what, rc))
    [stylizer] = made
    st = stylizer.st
    require(st.device.type == VIDEO_DEVICE, '%s: engine on %s'
            % (what, st.device))
    require_all_launched(counts, what, (precision,))
    if VIDEO_DEVICE == 'cuda':
        require_paths(what, precision)
    # The style; each frame's content; the first frame's random start and
    # each frame's chained warm start. One deprocess a frame.
    implied = {'preprocess': 2 * VIDEO_FRAMES + 2,
               'deprocess': VIDEO_FRAMES}
    for kernel, n in implied.items():
        require(counts[kernel] == n, '%s: %d %s launches, the loop implies '
                '%d' % (what, counts[kernel], kernel, n))

    rungs = split_rungs([t.data for t in st.traces])
    require(len(rungs) == VIDEO_FRAMES, '%s: %d frames primed'
            % (what, len(rungs)))
    chained = temporal != 0
    first_losses, last_losses = [], []
    for k, rows in enumerate(rungs):
        steps = VIDEO_FIRST if k == 0 else VIDEO_ITERATIONS
        require(len(rows) == steps + 1, '%s frame %d: %d trace rows'
                % (what, k, len(rows)))
        losses = [r['loss'] for r in rows]
        require(all(math.isfinite(v) for v in losses), '%s frame %d: '
                'non-finite loss' % (what, k))
        require(losses[-1] < losses[0], '%s frame %d: loss %.6g -> %.6g'
                % (what, k, losses[0], losses[-1]))
        with_term = [('temporal_loss' in r) for r in rows]
        require(all(with_term) if (k and chained) else not any(with_term),
                '%s frame %d: temporal keys %s' % (what, k, with_term))
        if k and chained:
            require(rows[0]['temporal_loss'] == 0.0, '%s frame %d: the '
                    'prime\'s temporal_loss %r, not 0' % (
                        what, k, rows[0]['temporal_loss']))
        first_losses.append(losses[0])
        last_losses.append(losses[-1])
    warm = [f / first_losses[0] for f in first_losses[1:]]
    require(max(warm) < VIDEO_WARM_MAX, '%s: a chained frame\'s first loss '
            'over frame 1\'s first: %s' % (what, warm))

    outputs = sorted(outdir.iterdir())
    require(len(outputs) == VIDEO_FRAMES, '%s: %d PNGs' % (what,
                                                          len(outputs)))
    images = []
    for path in outputs:
        with Image.open(path) as img:
            require(img.size == size, '%s: %s is %s' % (what, path.name,
                                                        img.size))
            images.append(np.asarray(img, np.float32))
    [line] = [r.args for r in log.records[start:] if r.msg.startswith(
        'stylized %d frames in')]
    _, total_s, first_s, steady_s = line
    frame_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    result = {
        'precision': precision, 'temporal': temporal, 'frames': VIDEO_FRAMES,
        'hw': [size[1], size[0]], 'wall_s': wall, 'total_s': total_s,
        'first_frame_s': first_s, 'steady_s_per_frame': steady_s,
        'chained_frame_s': frame_s,
        'chained_it_s': [VIDEO_ITERATIONS / s for s in frame_s],
        'flicker': flicker(images), 'first_losses': first_losses,
        'last_losses': last_losses, 'warm_start_ratio': warm,
        'peak_bytes': peak_all - base, 'max_memory_allocated': peak_all,
        'launches': counts, 'implied': implied, 'paths': paths}
    say('video', '%s: %d frames at %dx%d, %d then %d L-BFGS iterations a '
        'frame: first frame %.3f s, steady %.4f s/frame (the CLI\'s log), '
        'chained frames %s s on the device clock (%s it/s); flicker %.4f; '
        'first loss of each chained frame over frame 1\'s: %.4f-%.4f; peak '
        'device memory %.0f MiB over the start (max_memory_allocated %.0f '
        'MiB); %.1f s wall' % (
            name, VIDEO_FRAMES, size[1], size[0], VIDEO_FIRST,
            VIDEO_ITERATIONS, first_s, steady_s,
            ', '.join('%.4f' % s for s in frame_s),
            ', '.join('%.1f' % r for r in result['chained_it_s']),
            result['flicker'], min(warm), max(warm),
            result['peak_bytes'] / 2 ** 20, peak_all / 2 ** 20, wall))
    say('video', '%s: launches %s; preprocess %d, deprocess %d as the loop '
        'implies (%d, %d); conv paths %s; losses %s' % (
            name, counts, counts['preprocess'], counts['deprocess'],
            implied['preprocess'], implied['deprocess'], paths, ', '.join(
                '%.6g -> %.6g' % fl
                for fl in zip(first_losses, last_losses))))
    return counts, result


def video_small_inputs(n, hw):
    """tests/test_video.py's frames at (h, w): a random pattern translating
    one pixel a frame, n of them; and a random style image."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (hw[0] + n, hw[1] + n, 3)).astype(np.uint8)
    return ([base[i:i + hw[0], i:i + hw[1]] for i in range(n)],
            rng.randint(0, 256, tuple(hw) + (3,)).astype(np.uint8))


def video_stylizer(device, style_img, iterations):
    """A VideoStylizer of initial_weights.yaml's objective on
    random_params(0), L-BFGS, iterations = (first frame, each later one)."""
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.video import VideoStylizer
    weights, scalars = cli.load_weights_doc(None)
    v = VideoStylizer(random_params(0), weights, scalars,
                      first_iterations=iterations[0],
                      iterations=iterations[1],
                      temporal_weight=VIDEO_TEMPORAL, device=device)
    v.set_style(style_img)
    return v


def video_pipelined():
    """A pipelined VideoStylizer against a serial one on the card: 4 frames
    of video_small_inputs at VIDEO_PIPE_HW, rtol 1e-4 and atol 1e-3 as
    tests/test_video.py. Returns the largest difference."""
    frames, style_img = video_small_inputs(4, VIDEO_PIPE_HW)
    serial = video_stylizer(VIDEO_DEVICE, style_img, VIDEO_PIPE_ITERATIONS)
    want = [serial.stylize_frame(f)[0] for f in frames]
    piped = video_stylizer(VIDEO_DEVICE, style_img, VIDEO_PIPE_ITERATIONS)
    got, pending = [], None
    for f in frames:
        dispatch = piped.begin_frame(f)
        if pending is not None:
            got.append(piped.collect_frame(pending)[0])
        pending = dispatch
    got.append(piped.collect_frame(pending)[0])
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    for k, (a, b) in enumerate(zip(got, want)):
        require(np.all(np.abs(a - b) <= 1e-3 + 1e-4 * np.abs(b)),
                'video: pipelined frame %d off the serial one by %.4g'
                % (k, float(np.abs(a - b).max())))
    require(len(piped.st.traces) == len(serial.st.traces),
            'video: pipelined and serial trace counts')
    return diff


def trace_rel_errs(keys, got, want):
    """{key: |got - want| / |want|} over two trace rows in keys' order."""
    return {key: abs(a - b) / max(abs(b), 1e-30)
            for key, a, b in zip(keys, got, want)
            if key not in ('time', 'fevals')}


def video_evaluate(engine, spec, x, norms):
    """engine's objective at the iterate x (a CPU tensor) from the
    first-eval norms (host values): (its trace row, its gradient on the
    CPU)."""
    import torch
    from style_transfer2_tpu_torch.engine.steps import (build_step_core,
                                                        precision_scope)
    engine.set_input(x.to(engine.device), preprocessed=True)
    engine.seed_norms(*norms)
    eval_core = build_step_core(spec, 'lbfgs')[1]
    with precision_scope(engine.precision):
        state, _, trace = eval_core(engine.model, {'x': engine._input},
                                    engine._gather_inputs(spec))
    return torch.stack(trace).tolist(), state['grad'].cpu()


def video_eval_parity(frames):
    """The CUDA objective against the CPU one at every evaluation of a CPU
    VideoStylizer run over the pan's VIDEO_FRAMES frames (the PNGs in
    frames) at VIDEO_PARITY_HW, VIDEO_FIRST then VIDEO_ITERATIONS L-BFGS
    iterations, the 512px runs' lengths. A CUDA engine takes each frame's
    content and the CPU run's temporal target, then, evaluation by
    evaluation, the CPU iterate and first-eval norms, so that no difference
    carries from one evaluation to the next. Held at PARITY_RTOL: every
    trace key against itself but the total gradient's RMS, `grad`, which
    is held against the scale of its terms (the largest of GRAD_TERMS):
    the terms cancel as a frame converges, so `grad` falls to a fraction
    of them and carries their rounding magnified. The gradient itself is
    reported, not held: the RMS of the difference over the terms' scale,
    beside how far the CPU's own gradient moves at the worst evaluation
    when that iterate gets VIDEO_GRAD_NOISE relative noise (a ReLU and
    max-pool net's gradient jumps where a unit's input crosses zero or a
    pool's maximum changes hands). Then a CUDA VideoStylizer runs the same
    frames on its own: where its trace history first parts from the CPU
    run's by more than PARITY_RTOL is reported, not held, since fixed-step
    L-BFGS parts two float32 runs that differ only in summation order.
    Returns the figures."""
    import torch
    from PIL import Image
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.utils import resize_to_fit
    t0 = time.perf_counter()
    h, w = VIDEO_PARITY_HW
    pan = []
    for path in sorted(frames.iterdir()):
        with Image.open(path) as img:
            pan.append(np.uint8(img.convert('RGB').resize((w, h),
                                                          Image.LANCZOS)))
    with Image.open(STYLE) as img:
        style_img = np.uint8(resize_to_fit(img.convert('RGB'), max(h, w)))
    lengths = (VIDEO_FIRST, VIDEO_ITERATIONS)
    cpu = video_stylizer('cpu', style_img, lengths)
    st = cpu.st
    evals = []

    def recording(real):
        # Wraps this one CPU engine's step runner (engine/graphs.py
        # StepGraphs.run, each call one evaluation, the prime's or a
        # step's): the evaluation's spec, iterate, gradient and trace row,
        # and the norms it started from.
        def run(key, body, args, *rest):
            norms = ({k: float(v) for k, v in args['norms_vals'].items()},
                     {k: bool(v) for k, v in args['norms_set'].items()})
            new, row = real(key, body, args, *rest)
            evals.append((key.spec, new['state']['x'].clone(),
                          new['state']['grad'].clone(), row.tolist(), norms))
            return new, row
        return run

    def rms(t):
        return float(t.square().mean().sqrt())

    def against(spec, got, g, row, grad):
        # ({key: rel err}, the gradient's RMS difference over the terms'
        # scale, the total gradient's RMS over that scale)
        keys = list(spec.trace_keys)
        scale = max(row[keys.index(t)] for t in GRAD_TERMS if t in keys)
        errs = trace_rel_errs(keys, got, row)
        at = keys.index('grad')
        errs['grad'] = abs(got[at] - row[at]) / scale
        return errs, rms(g - grad) / scale, row[at] / scale

    st._graphs.run = recording(st._graphs.run)
    weights, scalars = cli.load_weights_doc(None)
    engines = {}
    for device in (VIDEO_DEVICE, 'cpu'):
        engines[device] = StyleTransfer(random_params(0), device=device)
        engines[device].set_weights(weights, scalars)
        engines[device].set_style(style_img)
    dev = engines[VIDEO_DEVICE]
    worst, worst_grad, least_ratio, n = (0.0, '', -1), None, math.inf, 0
    for k, frame in enumerate(pan):
        evals.clear()
        cpu.stylize_frame(frame)
        dev.set_content(frame)
        if k:
            dev.set_temporal(st.temporal_target.to(dev.device),
                             VIDEO_TEMPORAL, preprocessed=True)
        for spec, x, grad, row, norms in evals:
            require(spec == dev.spec(), 'video parity: frame %d: specs' % k)
            got, g = video_evaluate(dev, spec, x, norms)
            errs, g_err, ratio = against(spec, got, g, row, grad)
            key = max(errs, key=errs.get)
            require(errs[key] <= PARITY_RTOL, 'video parity: frame %d, '
                    'evaluation %d: %s off by %.4g' % (k, n, key,
                                                       errs[key]))
            if errs[key] > worst[0]:
                worst = (errs[key], key, n)
            least_ratio = min(least_ratio, ratio)
            if worst_grad is None or g_err > worst_grad[0]:
                worst_grad = (g_err, n, k, spec, x, grad, row, norms,
                              st.temporal_target if k else None)
            n += 1

    # The CPU objective's own moves at the worst gradient's iterate under
    # VIDEO_GRAD_NOISE relative noise, three draws each: (the gradient's,
    # the `grad` key's), both over the terms' scale.
    g_err, at, k, spec, x, grad, row, norms, target = worst_grad
    ref = engines['cpu']
    ref.set_content(pan[k])
    if target is not None:
        ref.set_temporal(target, VIDEO_TEMPORAL, preprocessed=True)
    noise = torch.Generator().manual_seed(0)
    moved = {}
    for rel in VIDEO_GRAD_NOISE:
        moves = []
        for _ in range(3):
            xp = x * (1 + rel * torch.randn(x.shape, generator=noise))
            got, g = video_evaluate(ref, spec, xp, norms)
            errs, vec, _ = against(spec, got, g, row, grad)
            moves.append((vec, errs['grad']))
        moved['%g' % rel] = [max(m[i] for m in moves) for i in (0, 1)]

    run = video_stylizer(VIDEO_DEVICE, style_img, lengths)
    for frame in pan:
        run.stylize_frame(frame)
    want_rows = [t.data for t in st.traces]
    got_rows = [t.data for t in run.st.traces]
    require([list(r) for r in got_rows] == [list(r) for r in want_rows],
            'video parity: the runs\' trace keys')
    parting = next((i for i, (a, b) in enumerate(zip(got_rows, want_rows))
                    if max(trace_rel_errs(list(b), list(a.values()),
                                          list(b.values())).values())
                    > PARITY_RTOL), None)
    return {'evaluations': n, 'worst_rel_err': worst[0],
            'worst_key': worst[1], 'worst_evaluation': worst[2],
            'least_grad_over_terms': least_ratio,
            'worst_grad_diff_over_terms': g_err, 'worst_grad_evaluation': at,
            'cpu_moved_by_noise': moved, 'rows': len(want_rows),
            'trajectory_parts_at_row': parting,
            'seconds': time.perf_counter() - t0}


def video_checks(frames):
    """The small-size checks on the card: video_pipelined and
    video_eval_parity. Returns (the largest pipelined-serial difference,
    the parity figures)."""
    diff = video_pipelined()
    parity = video_eval_parity(frames)
    say('video', '4 frames at %dx%d, pipelined against serial: max |diff| '
        '%.3g (rtol 1e-4, atol 1e-3); the pan at %dx%d, %d then %d '
        'iterations: %s objective at each of the CPU run\'s %d '
        'evaluations, worst trace rel err %.3g (%s, evaluation %d; grad '
        'over its terms\' scale, which it falls to %.3g of) within rtol %g; '
        'the gradient\'s RMS difference over that scale at most %.3g '
        '(evaluation %d), where relative noise on the iterate moves the '
        'CPU\'s own gradient, and grad, by %s; a %s run of its own parts '
        'from the CPU run by more than the rtol first at trace row %s of '
        '%d; %.1f s' % (
            *VIDEO_PIPE_HW, diff, *VIDEO_PARITY_HW, VIDEO_FIRST,
            VIDEO_ITERATIONS, VIDEO_DEVICE, parity['evaluations'],
            parity['worst_rel_err'], parity['worst_key'],
            parity['worst_evaluation'], parity['least_grad_over_terms'],
            PARITY_RTOL, parity['worst_grad_diff_over_terms'],
            parity['worst_grad_evaluation'], ', '.join(
                '%s: %.3g, %.3g' % (rel, *m)
                for rel, m in parity['cpu_moved_by_noise'].items()),
            VIDEO_DEVICE, parity['trajectory_parts_at_row'], parity['rows'],
            parity['seconds']))
    return diff, parity


def check_cli_profile():
    """The port's CLI with --profile in a subprocess (a profiler session
    leaves torch's host path slower for the rest of its process): its
    trace must exist and name the conv, style and image kernels. Returns
    {what: the kernel names found}."""
    prof = OUT_DIR / 'video' / 'profile'
    shutil.rmtree(prof, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, '-m', 'style_transfer2_tpu_torch.cli', str(CONTENT),
         str(STYLE), '-o', str(OUT_DIR / 'video' / 'profile.png'),
         '--size', str(VIDEO_PROFILE_SIZE), '--iterations', '5',
         '--model-weights', 'random', '--device', VIDEO_DEVICE,
         '--profile', str(prof)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, 'cli --profile exited %d: %s' % (
        proc.returncode, proc.stderr[-2000:]))
    traces = sorted(prof.glob('*.pt.trace.json'))
    require(len(traces) == 1, 'cli --profile wrote %s' % traces)
    events = json.loads(traces[0].read_text())['traceEvents']
    names = {e.get('name', '') for e in events
             if e.get('cat') == VIDEO_PROFILE_CATEGORY}
    found = {}
    for what, key in VIDEO_PROFILE_NAMES.items():
        found[what] = sorted({re.search(r'\w*%s\w*' % re.escape(key),
                                        n).group(0)
                              for n in names if key in n})
        require(found[what], 'cli --profile: no %s kernel (%r) among the '
                'trace\'s %d %s events' % (what, key, len(names),
                                           VIDEO_PROFILE_CATEGORY))
    say('video', 'cli --profile at --size %d: %s (%d events; %s)' % (
        VIDEO_PROFILE_SIZE, traces[0].name, len(events), '; '.join(
            '%s: %s' % (k, ', '.join(v)) for k, v in found.items())))
    return found


def phase_video(torch, smi):
    """Video style transfer on the card through video.main(): the pan's
    frames at 512px in float32 and bfloat16 with the temporal term and in
    float32 without it (the flicker baseline), then the small-size checks
    and the CLI's --profile. Returns the kernel counts of the three runs."""
    frames, size = video_frames()
    log = CliLog()
    logger = logging.getLogger('video')
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    launches = dict.fromkeys(KERNELS, 0)
    results = {}
    try:
        for precision, temporal in (('float32', VIDEO_TEMPORAL),
                                    ('bfloat16', VIDEO_TEMPORAL),
                                    ('float32', 0.0)):
            counts, result = video_run(torch, log, frames, size, precision,
                                       temporal)
            results['%s temporal %g' % (precision, temporal)] = result
            for name, n in counts.items():
                launches[name] += n
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    on, off = (results['float32 temporal %g' % t]['flicker']
               for t in (VIDEO_TEMPORAL, 0.0))
    say('video', '%s; flicker (mean over consecutive output pairs of '
        'mean((a - b)^2), 0-255 levels) float32 with --temporal %g %.4f, '
        'without %.4f (x%.4f)' % (smi, VIDEO_TEMPORAL, on, off, on / off))
    results['pipelined_max_diff'], results['parity'] = video_checks(frames)
    results['profile_kernels'] = check_cli_profile()
    (OUT_DIR / 'video.json').write_text(json.dumps(
        dict(results, device=smi), indent=1))
    return launches


# The shard phase: spatial sharding of one image over SHARD_N shards (the
# card's GPUs, cuda:0 repeated where it has fewer), float32 and bfloat16
# at --size SHARD_SIZE (a 768x1024 iterate), L-BFGS, SHARD_ITERATIONS
# steps in chunks of SHARD_CHUNK, each against an unsharded engine on the
# same inputs; a W-sharded run at SHARD_W_SIZE (510x680: H does not
# divide by 4); a SHARD_LANES-lane float32 batch at SHARD_BATCH_SIZE over
# a 2-way 'data' mesh against the unsharded batched engine; a sharded
# checkpoint resumed; the CLI's --mesh. SHARD_DEVICE: the engines' device
# (the CPU tests set cpu).
SHARD_N = 4
SHARD_SIZE = 1024
SHARD_ITERATIONS = 20
SHARD_CHUNK = 5
SHARD_W_SIZE = 680
SHARD_W_ITERATIONS = 5
SHARD_LANES = 4
SHARD_BATCH_SIZE = 512
SHARD_BATCH_ITERATIONS = 3
SHARD_CLI_SIZE = 256
SHARD_DEVICE = 'cuda'
# A factory of the graphed engines' capture backend, None for the engine's
# own (the CPU tests give a stand-in that replays without a card).
SHARD_BACKEND = None
# The 3840px run over the shards: the highres phase's grid and style size,
# bf16, a chunk of 2 (the prime and the step's warm-up, the step's
# capture), then SHARD_HIGHRES_STEPS replays timed.
SHARD_HIGHRES_HW = HIGHRES_HW
SHARD_HIGHRES_SIZE = HIGHRES_SIZE
SHARD_HIGHRES_STEPS = 8
# One-step enqueues timed behind a synced card, for each engine.
SHARD_HOST_TRIALS = 5
# Traces of a sharded step against the unsharded one: the golden rtol in
# float32, each step taken from the unsharded run's own state (two free
# fixed-step L-BFGS trajectories part exponentially: summed in another
# order, 768x1024 float32 traces 0.9% apart at step 7 of 20 on an H100,
# and on the CPU at 96x128 5e-7 at the prime, 7e-4 at step 7, 2% at 10);
# in bfloat16 the prime (the first evaluation, on the same iterate) at
# tests/test_parallel.py's bf16 rtol, then a finite, falling loss.
SHARD_RTOL = {'float32': PARITY_RTOL, 'bfloat16': 2e-2}
# The two-phase style entry points of style.cu (ops/style.py
# style_gram, style_grad), run once a shard for each style layer.
SHARD_KERNELS = ('style_gram', 'style_grad')
SOURCES['style_gram'] = SOURCES['style_grad'] = SOURCES['fused_style_branch']


def shard_devices(torch, n):
    """n devices for the shards: the card's GPUs in order, cuda:0 again for
    the rest where there are fewer than n (on the CPU: n CPU entries)."""
    if SHARD_DEVICE != 'cuda':
        return [torch.device(SHARD_DEVICE)] * n
    count = torch.cuda.device_count()
    return [torch.device('cuda', i if i < count else 0) for i in range(n)]


def shard_inputs():
    """(params, weights document, style image, content PIL) of the shard
    phase: random_params(0), initial_weights.yaml, the example images."""
    from PIL import Image
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.utils import resize_to_fit
    with Image.open(STYLE) as img:
        style_img = np.uint8(resize_to_fit(img.convert('RGB'), SHARD_SIZE))
    with Image.open(CONTENT) as img:
        content = img.convert('RGB')
    return random_params(0), cli.load_weights_doc(None), style_img, content


def shard_hw(content, size):
    from style_transfer2_tpu_torch.utils import fit_into_square
    wh = fit_into_square(content.size, size, scale_up=True)
    return (wh[1], wh[0])


def shard_engine(inputs, precision, hw, placement, graphed=True):
    """A started L-BFGS StyleTransfer of the shard phase's objective at hw
    over `placement` (None: unsharded), from a seed-0 random iterate; its
    steps replay graphs (graphed=False: run eagerly, for the A/B)."""
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.engine.graphs import StepGraphs
    params, (weights, scalars), style_img, content = inputs
    st = StyleTransfer(params, precision=precision, device=SHARD_DEVICE,
                       placement=placement)
    if not graphed:
        eager(st)
    elif SHARD_BACKEND is not None:
        st._graphs = StepGraphs(SHARD_BACKEND())
    st.set_weights(weights, scalars)
    st.set_optimizer('lbfgs')
    st.set_step_size(1.0)
    st.set_style(style_img)
    st.set_content(cli.fit_content(content, hw))
    st.set_input(np.random.RandomState(0).uniform(0, 255, hw + (3,))
                 .astype(np.uint8))
    require(st.start(), 'shard engine did not start at %dx%d' % hw)
    return st


def shard_chunks(torch, st, iterations):
    """iterations steps in chunks of SHARD_CHUNK, each collected (images
    not fetched) and synced. Returns (every trace row so far, the prime's
    included; ms a step over the chunks after the first)."""
    spans = []
    for done in range(0, iterations, SHARD_CHUNK):
        n = min(SHARD_CHUNK, iterations - done)
        t0 = time.perf_counter()
        st.collect_steps(st.begin_steps(n), fetch_image=False)
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0, n))
    later = spans[1:] or spans
    return ([t.data for t in st.traces],
            1e3 * sum(s for s, _ in later) / sum(n for _, n in later))


def sharded_style_layers(spec, rows):
    """The style layers of spec whose maps stay sharded when each shard
    holds `rows` rows of the iterate: those above the first pool whose
    shards would pool unevenly (models/vgg19.py gathers from there)."""
    return [l for l in spec.style_layers
            if rows % 2 ** (int(l[4]) - 1) == 0]


def take_state(src, dst):
    """dst continues from src's state: a copy of src's optimizer state
    (placed as dst places it), norms and priming flag. src's are a step
    graph's static buffers on the card: copied, not shared."""
    import torch

    def copy(t):
        return t.clone() if torch.is_tensor(t) else t
    dst.opt_state = dst._place_state({k: copy(v)
                                      for k, v in src.opt_state.items()})
    dst._input = dst.opt_state['x']
    dst.norm_vals = {k: copy(v) for k, v in src.norm_vals.items()}
    dst.norm_set = {k: copy(v) for k, v in src.norm_set.items()}
    dst._needs_init = src._needs_init


def shard_forced(inputs, precision, hw, placement, iterations, what):
    """Each of `iterations` steps of an unsharded engine, and a sharded
    engine's step from that engine's state before it (take_state): every
    trace key of each pair of rows (the primes' too) within SHARD_RTOL.
    Returns the worst relative difference."""
    lead = shard_engine(inputs, precision, hw, None)
    follow = shard_engine(inputs, precision, hw, placement)
    worst = 0.0
    for _ in range(iterations):
        take_state(lead, follow)
        n = len(lead.traces)
        lead.step(fetch_image=False)
        follow.step(fetch_image=False)
        want = [t.data for t in lead.traces[n:]]
        got = [t.data for t in follow.traces[len(follow.traces)
                                             - len(want):]]
        worst = max(worst, shard_compare(got, want, SHARD_RTOL[precision],
                                         what))
    return worst


def shard_compare(got, want, rtol, what, rows=None):
    """The worst relative difference over every trace key of `rows` (all)
    of two runs' trace rows; raises above rtol."""
    require(len(got) == len(want), '%s: %d trace rows, unsharded %d'
            % (what, len(got), len(want)))
    worst = 0.0
    for i in (range(len(want)) if rows is None else rows):
        for key, value in want[i].items():
            if key in ('time', 'fevals'):
                continue
            err = abs(got[i][key] - value) / max(abs(value), 1e-30)
            worst = max(worst, err)
            require(err <= rtol, '%s: trace %s at row %d: sharded %.6g, '
                    'unsharded %.6g' % (what, key, i, got[i][key], value))
    return worst


def shard_planned(torch, precision, hw, n):
    """The (direction, path) pairs the planners pick for the trunk's convs
    on one shard of an hw iterate cut n ways on H: h / n rows and the two
    halo rows."""
    from style_transfer2_tpu_torch.ops import conv
    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[precision]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = set()
    for h, w, cin, cout in trunk_convs(*hw):
        rows = h // n + 2
        want.add(('fwd', conv.fwd_plan(1, rows, w, cin, cout, dtype,
                                       sms)[0]))
        want.add(('bwd', conv.bwd_plan(1, rows, w, cout, cin, dtype,
                                       sms)[0]))
    return sorted(want)


class Exchanges:
    """Counts the bytes the port's halo and roll exchanges move while the
    block runs: the neighbours' rows each halo call takes (forward,
    recomputes included), the gradients that flow back to them (a hook on
    each padded shard), and the rows a roll along the sharded dim takes
    across shards. The program keeps no counter: this wraps ops/conv.py's
    halo and parallel/spatial.py's roll for the block's duration."""

    def __init__(self):
        self.forward = self.backward = self.rolls = 0

    def __enter__(self):
        from style_transfer2_tpu_torch.ops import conv
        from style_transfer2_tpu_torch.parallel import spatial
        real_halo, real_roll = conv.halo, spatial.roll

        def halo(x):
            out = real_halo(x)
            d, n = x.axis, len(x.shards)
            for i, padded in enumerate(out):
                for j in (i - 1, i + 1):
                    if 0 <= j < n:
                        row = x.shards[j].narrow(d, 0, 1)
                        self.forward += row.numel() * row.element_size()
                if padded.requires_grad:
                    padded.register_hook(self._back(d, i, n))
            return out

        def roll(x, shifts, dims):
            if dims % x.ndim == x.axis:
                for shard in x.shards:
                    row = shard.narrow(x.axis, 0, 1)
                    self.rolls += row.numel() * row.element_size()
            return real_roll(x, shifts, dims)

        conv.halo, spatial.roll = halo, roll
        self._restore = lambda: (setattr(conv, 'halo', real_halo),
                                 setattr(spatial, 'roll', real_roll))
        return self

    def __exit__(self, *exc):
        self._restore()

    def _back(self, d, i, n):
        def hook(g):
            rows = [0] if i > 0 else []
            if i < n - 1:
                rows.append(g.shape[d] - 1)
            for r in rows:
                row = g.narrow(d, r, 1)
                self.backward += row.numel() * row.element_size()
        return hook

    def total(self):
        return self.forward + self.backward + self.rolls


def shard_launch_counts():
    """The shard path's launches: counters()' and the two style phases'."""
    from style_transfer2_tpu_torch.ops import style
    return dict(counters(), style_gram=style.gram_launches,
                style_grad=style.grad_launches)


def shard_run(torch, inputs, precision, placement, hw):
    """One precision's sharded and unsharded runs of SHARD_ITERATIONS steps
    at hw. Returns (sharded engine, its traces, the unsharded traces,
    the sharded path's launch counts, a result dict)."""
    from style_transfer2_tpu_torch.engine import graphs
    result = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = shard_engine(inputs, precision, hw, None)
    want, result['unsharded_ms_step'] = shard_chunks(torch, st,
                                                     SHARD_ITERATIONS)
    result['unsharded_peak_mib'] = (torch.cuda.max_memory_allocated()
                                    - base) / 2 ** 20
    del st
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    st = shard_engine(inputs, precision, hw, placement)
    got, result['sharded_ms_step'] = shard_chunks(torch, st,
                                                  SHARD_ITERATIONS)
    counts = shard_launch_counts()
    result['sharded_peak_mib'] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 20
    REPLAYS['shard ' + precision] = graphs.replays
    require(graphs.replays > 0, 'shard %s: the sharded steps replayed no '
            'graph' % precision)
    losses = [t['loss'] for t in got]
    require(all(math.isfinite(v) for v in losses), 'shard %s: non-finite '
            'loss' % precision)
    require(losses[-1] < losses[0], 'shard %s: loss did not fall: %.6g -> '
            '%.6g' % (precision, losses[0], losses[-1]))
    # The free runs share their first row, the prime, from one iterate;
    # in float32 every later step is held from the unsharded run's state.
    result['prime_rel_err'] = shard_compare(
        got, want, SHARD_RTOL[precision], 'shard %s prime' % precision, [0])
    result['worst_rel_err'] = result['prime_rel_err']
    if precision == 'float32':
        result['worst_rel_err'] = max(result['prime_rel_err'], shard_forced(
            inputs, precision, hw, placement, SHARD_ITERATIONS,
            'shard float32 step'))
    result['losses'] = [losses[0], losses[-1]]
    result['launches'] = counts
    return st, got, want, counts, result


def shard_bits(inputs, precision, hw, placement, graphed):
    """single_bits on a sharded engine at hw: step, a chunk, an objective
    change, two chunks in flight, step; the state gathered."""
    import torch
    from style_transfer2_tpu_torch.parallel.spatial import Sharded, gather
    st = shard_engine(inputs, precision, hw, placement, graphed)
    weights, scalars = inputs[1]
    images = [st.step()[0], st.run_steps(4)[0]]
    st.set_weights(weights, dict(scalars, tv=scalars.get('tv', 1.0) * 0.8))
    a, b = st.begin_steps(3), st.begin_steps(2)
    images += [img for img, _ in st.collect_steps_many([a, b])]
    images.append(st.step()[0])
    rows = [{k: v for k, v in t.data.items() if k != 'time'}
            for t in st.traces]
    state = {k: gather(v).clone() if isinstance(v, Sharded)
             or torch.is_tensor(v) else v for k, v in st.opt_state.items()}
    norms = {k: float(v) for k, v in st.norm_vals.items()}
    return rows, images, state, norms


def shard_nodes(torch, inputs, precision, hw, placement):
    """Node counts of the sharded L-BFGS step and prime graphs at hw, or
    None where this torch keeps no graph to count."""
    from style_transfer2_tpu_torch.engine.graphs import StepGraphs
    backend = CountingGraphs(torch)
    st = shard_engine(inputs, precision, hw, placement)
    st._graphs = StepGraphs(backend)
    try:
        st.run_steps(2)              # prime and step warm, step captured
        st.objective_changed()
        st.run_steps(1)              # prime captured
    except (TypeError, AttributeError) as e:    # no keep_graph here
        say('shard', 'node count not measured: %s' % e)
        return None
    torch.cuda.synchronize()
    return dict(zip(('step', 'prime'), backend.nodes))


def shard_graph(torch, inputs, precision, hw, placement, model):
    """The sharded step's graphs at hw in one precision: graphed against
    eager bit for bit (shard_bits; fails where a bit differs), then
    GRAPH_CHUNK-step chunks in turns (time_chunks: ms a step, host us a
    step, memory), each read against the 4 shards' floor on one card
    (model.one_card), the node counts and the capture seconds."""
    from style_transfer2_tpu_torch.engine import graphs
    graphs.captures.clear()
    same_bits('shard graphed %s %dx%d' % ((precision,) + tuple(hw)),
              shard_bits(inputs, precision, hw, placement, True),
              shard_bits(inputs, precision, hw, placement, False))

    def warm(graphed):
        def build():
            st = shard_engine(inputs, precision, hw, placement, graphed)
            st.run_steps(2)
            st.run_steps(2)
            return st
        return resident(torch, build)

    def chunk(st):
        def run(n):
            handle = st.begin_steps(n)
            return lambda: st.collect_steps(handle, fetch_image=False)
        return run

    engines, memory = {}, {}
    for name, graphed in (('eager', False), ('graphed', True)):
        engines[name], memory[name] = warm(graphed)
    rates = time_chunks(torch, {n: chunk(e) for n, e in engines.items()},
                        '%d shards %s' % (SHARD_N, precision), 'shard')
    for name, row in rates.items():
        # The host's enqueue of one step behind a synced card, where no
        # launch waits for room in the card's queue.
        row['host_us_one_step'] = []
        for _ in range(SHARD_HOST_TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collect = chunk(engines[name])(1)
            row['host_us_one_step'].append(
                (time.perf_counter() - t0) * 1e6)
            collect()
        row['median_host_us_one_step'] = float(np.median(
            row['host_us_one_step']))
    del engines
    for name, row in rates.items():
        row['memory'] = memory[name]
        row['host_share'] = row['median_host_us'] / (1e3 * row['median_ms'])
        row['roofline'] = roofline(
            'shard %d shards on one card %s %s' % (SHARD_N, precision, name),
            hw, precision, row['median_ms'], model=model.one_card)
    out = {'bitwise': True, 'rates': rates,
           'nodes': shard_nodes(torch, inputs, precision, hw, placement),
           'capture_s': [dict(c, hw=list(c['hw'])) for c in graphs.captures
                         if c['shards'] == SHARD_N]}
    say('shard', '%s %dx%d over %d shards, graphed against eager: equal bit '
        'for bit (traces, images, state, norms); ms a step graphed %.3f, '
        'eager %.3f (x%.2f); host us a step graphed %.1f (%.1f%% of the '
        'step), eager %.1f; a step enqueued behind a synced card: graphed '
        '%.1f us, eager %.1f; graph nodes %s; capture s %s; held after '
        'warm-up, allocated / reserved MiB: graphed %.0f / %.0f, eager %.0f '
        '/ %.0f; floor %.3f ms one card, %.1f%% of it graphed' % (
            precision, hw[0], hw[1], SHARD_N, rates['graphed']['median_ms'],
            rates['eager']['median_ms'], rates['eager']['median_ms']
            / rates['graphed']['median_ms'],
            rates['graphed']['median_host_us'],
            100 * rates['graphed']['host_share'],
            rates['eager']['median_host_us'],
            rates['graphed']['median_host_us_one_step'],
            rates['eager']['median_host_us_one_step'], out['nodes'],
            ', '.join('%s %.3f' % (c['kind'], c['seconds'])
                      for c in out['capture_s']),
            memory['graphed']['allocated'] / 2 ** 20,
            memory['graphed']['reserved'] / 2 ** 20,
            memory['eager']['allocated'] / 2 ** 20,
            memory['eager']['reserved'] / 2 ** 20,
            rates['graphed']['roofline']['floor_ms'],
            100 * rates['graphed']['roofline']['share_of_floor']))
    return out


def shard_highres(torch, inputs, placement):
    """bf16 at SHARD_HIGHRES_HW over the shards, graphed: a 2-step chunk
    (the prime and the step's warm-up, the step's capture), then
    SHARD_HIGHRES_STEPS replays timed on the host clock at a synced
    collect; beside the highres phase's unsharded bf16 run where this run
    has one (highres.json)."""
    import gc
    from PIL import Image
    from style_transfer2_tpu_torch.engine import graphs
    from style_transfer2_tpu_torch.utils import perfmodel, resize_to_fit
    hw = SHARD_HIGHRES_HW
    with Image.open(STYLE) as img:
        style_img = np.uint8(resize_to_fit(img.convert('RGB'),
                                           SHARD_HIGHRES_SIZE))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    graphs.captures.clear()
    replays = graphs.replays
    st = shard_engine(inputs[:2] + (style_img,) + inputs[3:], 'bfloat16',
                      hw, placement)
    t0 = time.perf_counter()
    st.collect_steps(st.begin_steps(2), fetch_image=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st.collect_steps(st.begin_steps(SHARD_HIGHRES_STEPS), fetch_image=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / SHARD_HIGHRES_STEPS
    losses = [t.data['loss'] for t in st.traces]
    what = 'shard %dx%d bfloat16' % hw
    require(all(math.isfinite(v) for v in losses), '%s: non-finite loss'
            % what)
    require(losses[-1] < losses[0], '%s: loss did not fall: %.6g -> %.6g'
            % (what, losses[0], losses[-1]))
    require(graphs.replays - replays >= SHARD_HIGHRES_STEPS + 1,
            '%s: %d replays' % (what, graphs.replays - replays))
    spec = st.spec()
    model = perfmodel.model_step_sharded(
        hw, SHARD_N, 'bfloat16', False, content_layers=spec.content_layers,
        style_layers=spec.style_layers)
    out = {'hw': list(hw), 'ms_step': ms, 'it_s': 1e3 / ms,
           'first_chunk_s': t1 - t0,
           'capture_s': [c['seconds'] for c in graphs.captures],
           'peak_bytes': torch.cuda.max_memory_allocated() - base,
           'max_memory_reserved': torch.cuda.max_memory_reserved(),
           'losses': [losses[0], losses[-1]],
           'replays': graphs.replays - replays}
    del st
    gc.collect()
    torch.cuda.empty_cache()
    unsharded = OUT_DIR / 'highres.json'
    out['unsharded_ms_step'] = (
        json.loads(unsharded.read_text())['runs']['bfloat16 no remat'][
            'ms_step'] if unsharded.exists() else None)
    out['roofline'] = roofline('%s %d shards on one card graphed'
                               % (what, SHARD_N), hw, 'bfloat16', ms,
                               model=model.one_card)
    say('shard', '%s over %d shards, graphed: %.1f ms a step over %d '
        'replays (%.3f it/s) against %s unsharded (the highres phase); '
        'first chunk (prime, warm-up, capture) %.1f s, capture s %s; peak '
        'allocated %.0f MiB, reserved %.0f MiB; loss %.6g -> %.6g; floor '
        '%.2f ms one card, %.1f%% of it' % (
            what, SHARD_N, ms, SHARD_HIGHRES_STEPS, out['it_s'],
            'not measured' if out['unsharded_ms_step'] is None
            else '%.1f ms' % out['unsharded_ms_step'], out['first_chunk_s'],
            ', '.join('%.3f' % c for c in out['capture_s']),
            out['peak_bytes'] / 2 ** 20, out['max_memory_reserved'] / 2 ** 20,
            losses[0], losses[-1], out['roofline']['floor_ms'],
            100 * out['roofline']['share_of_floor']))
    return out


def shard_runs(torch, smi, log):
    """The shard phase's engine runs (shard docstring), with every kernel
    of the sharded path launched in the float32 run, the conv paths
    planned at the shards' shapes (halo rows included) among its
    launches and both style phases once a shard a style layer an
    evaluation, the sharded steps replayed from graphs; each precision's
    graphed sharded step against the eager one (shard_graph), the
    W-fallback's too, and the 3840px run (shard_highres). Writes
    shard.json; returns (the float32 sharded run's launch counts, the
    result dict)."""
    from style_transfer2_tpu_torch.ops import conv
    from style_transfer2_tpu_torch.parallel import (Mesh, Sharded,
                                                    SpatialPlacement)
    from style_transfer2_tpu_torch.utils import perfmodel
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    devices = shard_devices(torch, SHARD_N)
    say('shard', '%d shards on %s%s' % (
        SHARD_N, ', '.join(str(d) for d in devices),
        ' (cuda:0 repeated: the machine has %d card(s))'
        % torch.cuda.device_count()
        if SHARD_DEVICE == 'cuda' and torch.cuda.device_count() < SHARD_N
        else ''))
    placement = SpatialPlacement(Mesh(devices, ('space',)))
    inputs = shard_inputs()
    hw = shard_hw(inputs[3], SHARD_SIZE)
    results = {'device': smi, 'devices': [str(d) for d in devices],
               'hw': list(hw), 'n_shards': SHARD_N}
    launches = None
    for precision in ('float32', 'bfloat16'):
        st, got, want, counts, result = shard_run(torch, inputs, precision,
                                                  placement, hw)
        require(isinstance(st._input, Sharded) and st._input.axis == 1,
                'shard %s: the iterate is not H-sharded' % precision)
        n_style = len(st.spec().style_layers)
        n_sharded = len(sharded_style_layers(st.spec(), hw[0] // SHARD_N))
        evals = len(got)
        # float32: each sharded style layer's two float32 phases once a
        # shard, the fused branch once for each gathered one; bfloat16:
        # the feed's two bf16 phases once a shard of a sharded layer and
        # once for a gathered one, and no float32 style kernel.
        f32 = precision == 'float32'
        want = {'style_gram': SHARD_N * n_sharded * evals if f32 else 0,
                'fused_style_branch': (n_style - n_sharded) * evals
                if f32 else 0,
                'style_gram_bf16': 0 if f32 else (
                    SHARD_N * n_sharded + n_style - n_sharded) * evals}
        want['style_grad'] = want['style_gram']
        want['style_grad_bf16'] = want['style_gram_bf16']
        for name, n in counts.items():
            if name in want:
                require(n == want[name], 'shard %s: %s launched %d times, '
                        'not %d (%d shards, %d of %d style layers sharded, '
                        '%d evaluations)' % (precision, name, n, want[name],
                                             SHARD_N, n_sharded, n_style,
                                             evals))
            elif name in PRECISION_KERNELS[precision]:
                require(n > 0, 'shard %s: kernel %s never launched'
                        % (precision, name))
        if SHARD_DEVICE == 'cuda':
            for key in shard_planned(torch, precision, hw, SHARD_N):
                require(conv.path_launches.get(key, 0) > 0, 'shard %s: no '
                        '%s launches on the %s path planned for a shard'
                        % (precision, key[0], key[1]))
        # The port's roofline of the sharded step: its halo count must be
        # what one more step's exchanges move on the card; its floor of
        # the whole sharded step on one card (the n shards' work, halo
        # rows in) reads the sharded ms, and the unsharded floor the
        # unsharded ms. A share across cards needs more cards.
        spec = st.spec()
        model = perfmodel.model_step_sharded(
            hw, SHARD_N, precision, False,
            content_layers=spec.content_layers,
            style_layers=spec.style_layers)
        # Counted over one eager step: a replay calls no Python, so the
        # wrappers Exchanges counts in run only where the step does.
        graphed = st._graphs
        eager(st)
        with Exchanges() as moved:
            st.collect_steps(st.begin_steps(1), fetch_image=False)
        st._graphs = graphed
        result['halo_bytes_step'] = moved.total()
        require(model.halo_bytes == result['halo_bytes_step'], 'shard %s: '
                'the roofline counts %d halo bytes a step, the exchanges '
                'moved %d' % (precision, model.halo_bytes,
                              result['halo_bytes_step']))
        result['model_halo_bytes_step'] = model.halo_bytes
        result['jax_halo_bytes_device'] = model.jax_halo_bytes
        result['unsharded_roofline'] = roofline(
            'shard unsharded %s' % precision, hw, precision,
            result['unsharded_ms_step'])
        result['one_card_roofline'] = roofline(
            'shard %d shards on one card %s' % (SHARD_N, precision), hw,
            precision, result['sharded_ms_step'], model=model.one_card)
        result['conv_paths'] = path_counts()
        say('shard', '%s %dx%d over %d shards: %d L-BFGS steps in chunks '
            'of %d, %.2f ms a step sharded against %.2f unsharded, both '
            'graphed (x%.2f, '
            'the one-card cost of sharding on %s), worst trace rel err '
            '%.3g (%s, rtol %g), loss %.6g -> %.6g; halo %.2f MiB a step '
            '(the roofline\'s too; JAX-style %.2f MiB a device); floor '
            '%.3f ms one card sharded (%.1f%%), %.3f unsharded (%.1f%%); '
            'peak %.0f MiB sharded, %.0f unsharded; launches %s' % (
                precision, hw[0], hw[1], SHARD_N, SHARD_ITERATIONS,
                SHARD_CHUNK, result['sharded_ms_step'],
                result['unsharded_ms_step'], result['sharded_ms_step']
                / result['unsharded_ms_step'], smi, result['worst_rel_err'],
                'every step from the unsharded state' if precision
                == 'float32' else 'the prime',
                SHARD_RTOL[precision], *result['losses'],
                result['halo_bytes_step'] / 2 ** 20,
                model.jax_halo_bytes / 2 ** 20,
                result['one_card_roofline']['floor_ms'],
                100 * result['one_card_roofline']['share_of_floor'],
                result['unsharded_roofline']['floor_ms'],
                100 * result['unsharded_roofline']['share_of_floor'],
                result['sharded_peak_mib'], result['unsharded_peak_mib'],
                counts))
        results[precision] = result
        if precision == 'float32':
            launches = counts
            results['checkpoint'] = shard_checkpoint(st, placement)
        del st
        torch.cuda.empty_cache()
        result['graph'] = shard_graph(torch, inputs, precision, hw,
                                      placement, model)

    w_hw = shard_hw(inputs[3], SHARD_W_SIZE)
    require(w_hw[0] % SHARD_N and not w_hw[1] % SHARD_N,
            'shard: %dx%d is no W-fallback grid' % w_hw)
    st = shard_engine(inputs, 'float32', w_hw, placement)
    require(isinstance(st._input, Sharded) and st._input.axis == 2,
            'shard: %dx%d is not W-sharded' % w_hw)
    del st
    results['w_fallback'] = {'hw': list(w_hw), 'worst_rel_err': shard_forced(
        inputs, 'float32', w_hw, placement, SHARD_W_ITERATIONS,
        'shard W-fallback')}
    for precision in ('float32', 'bfloat16'):
        same_bits('shard W-fallback graphed %s' % precision,
                  shard_bits(inputs, precision, w_hw, placement, True),
                  shard_bits(inputs, precision, w_hw, placement, False))
    results['w_fallback']['bitwise'] = True
    say('shard', 'float32 %dx%d (H %% %d != 0: W-sharded), %d steps, each '
        'from the unsharded state: worst trace rel err %.3g; graphed equal '
        'to eager bit for bit in float32 and bfloat16' % (
            w_hw[0], w_hw[1], SHARD_N, SHARD_W_ITERATIONS,
            results['w_fallback']['worst_rel_err']))
    results['highres'] = shard_highres(torch, inputs, placement)

    results['batch'] = shard_batch(torch, inputs, devices)
    results['cli'] = shard_cli(torch, log)
    (OUT_DIR / 'shard.json').write_text(json.dumps(results, indent=1))
    return launches, results


def shard_checkpoint(st, placement):
    """A sharded checkpoint of st saved and loaded into a new sharded
    engine: its next chunk equals st's, bit for bit. The checkpoint goes
    to a temporary directory (a 768x1024 L-BFGS history is 180 MiB)."""
    import tempfile
    from style_transfer2_tpu_torch.engine import (StyleTransfer,
                                                  load_checkpoint,
                                                  save_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(st, Path(tmp) / 'ck')
        resumed = StyleTransfer(shard_inputs()[0], device=SHARD_DEVICE,
                                placement=placement)
        load_checkpoint(resumed, Path(tmp) / 'ck')
    want = st.collect_steps(st.begin_steps(SHARD_CHUNK))
    got = resumed.collect_steps(resumed.begin_steps(SHARD_CHUNK))
    same = (np.array_equal(got[0], want[0])
            and [{k: v for k, v in t.data.items() if k != 'time'}
                 for t in got[1]]
            == [{k: v for k, v in t.data.items() if k != 'time'}
                for t in want[1]])
    require(same, 'shard: the resumed chunk differs from the '
            'uninterrupted one')
    say('shard', 'checkpoint saved at iterate %d and resumed into a new '
        'sharded engine: the next %d steps equal the uninterrupted ones '
        'bit for bit' % (st.t - SHARD_CHUNK, SHARD_CHUNK))
    return {'resumed_equal': True, 'at': st.t - SHARD_CHUNK}


def shard_batch(torch, inputs, devices):
    """SHARD_LANES float32 lanes at SHARD_BATCH_SIZE over a 2-way 'data'
    mesh against the unsharded batched engine: golden_gate and its flips,
    L-BFGS, SHARD_BATCH_ITERATIONS steps one a dispatch; every trace key
    of each lane within the golden rtol."""
    from PIL import Image
    from style_transfer2_tpu_torch import cli
    from style_transfer2_tpu_torch.engine.batched import batched_engine
    from style_transfer2_tpu_torch.parallel import DataPlacement, Mesh
    from style_transfer2_tpu_torch.utils import resize_to_fit
    params, (weights, scalars), _, content = inputs
    hw = shard_hw(content, SHARD_BATCH_SIZE)
    with Image.open(STYLE) as img:
        style_img = np.uint8(resize_to_fit(img.convert('RGB'),
                                           SHARD_BATCH_SIZE))
    pixels = cli.fit_content(content, hw)
    jobs = [np.ascontiguousarray(p) for p in (
        pixels, pixels[:, ::-1], pixels[::-1], pixels[::-1, ::-1])]
    rng = np.random.RandomState(0)
    inits = [rng.uniform(0, 255, hw + (3,)).astype(np.uint8)
             for _ in jobs]
    data = [devices[0], devices[1]]
    runs = []
    for placement in (DataPlacement(Mesh(data, ('data',))), None):
        engine = batched_engine(params, weights, scalars, hw, SHARD_LANES,
                                placement=placement, optimizer='lbfgs',
                                precision='float32', device=SHARD_DEVICE)
        for job, init in zip(jobs, inits):
            engine.add_job(job, style_img, init)
        runs.append([engine.step_all()
                     for _ in range(SHARD_BATCH_ITERATIONS)])
        del engine
    worst = 0.0
    for lane in range(SHARD_LANES):
        worst = max(worst, shard_compare(
            [s[lane] for s in runs[0]], [s[lane] for s in runs[1]],
            SHARD_RTOL['float32'], 'shard batch lane %d' % lane))
    say('shard', '%d float32 lanes at %dx%d over a 2-way data mesh (%s), '
        '%d L-BFGS steps: worst trace rel err %.3g against the unsharded '
        'batched engine' % (SHARD_LANES, hw[0], hw[1],
                            ', '.join(str(d) for d in data),
                            SHARD_BATCH_ITERATIONS, worst))
    return {'hw': list(hw), 'devices': [str(d) for d in data],
            'worst_rel_err': worst}


def shard_cli(torch, log):
    """cli.main with --mesh 1 (a PNG, the placement logged), and on the
    card --mesh N for N above the card count, which exits with
    make_mesh's message."""
    from style_transfer2_tpu_torch import cli
    png = OUT_DIR / 'shard_cli.png'
    png.unlink(missing_ok=True)
    start = len(log.records)
    rc = cli.main([str(CONTENT), str(STYLE), '-o', str(png), '--size',
                   str(SHARD_CLI_SIZE), '--iterations', '5', '--device',
                   SHARD_DEVICE, '--mesh', '1'])
    require(rc == 0 and png.exists(), 'cli --mesh 1: rc %r' % (rc,))
    require(any(r.getMessage().startswith('spatial sharding over 1 devices')
                for r in log.records[start:]), 'cli --mesh 1: no placement')
    png.unlink()
    out = {'mesh_1': 'ok'}
    if SHARD_DEVICE == 'cuda':
        n = torch.cuda.device_count() + 1
        want = "Mesh '%d' needs %d devices, have %d" % (n, n, n - 1)
        try:
            cli.main([str(CONTENT), str(STYLE), '-o', str(png), '--size',
                      str(SHARD_CLI_SIZE), '--iterations', '1', '--mesh',
                      str(n)])
            message = None
        except SystemExit as e:
            message = str(e)
        require(message == want, 'cli --mesh %d: %r, not %r'
                % (n, message, want))
        require(not png.exists(), 'cli --mesh %d wrote a PNG' % n)
        out['mesh_too_many'] = message
    say('shard', 'cli --mesh 1 at --size %d: a PNG%s' % (
        SHARD_CLI_SIZE, '' if 'mesh_too_many' not in out else
        '; --mesh %d exits: %s' % (torch.cuda.device_count() + 1,
                                   out['mesh_too_many'])))
    return out


def check_style_phases(torch, rng, tap, n, pending, timing=(15, 3)):
    """The two-phase style entry points (style_gram, style_grad) at one
    shard's tap (h, w, c) of a map cut n ways, against their plain
    versions, each with its time, bound and library call (torch.mm of
    X^T X; of X G_diff), the fused branch's time at the same tap beside.
    Returns the two rows."""
    from style_transfer2_tpu_torch.ops import style
    from style_transfer2_tpu_torch.utils import perfmodel
    h, w, c = tap
    m = h * w
    size = n * m * c

    def timed(fn):
        return median_ms(fn, torch, *timing)

    feat = torch.relu(draw(torch, rng, (1, h, w, c)))
    other = torch.relu(draw(torch, rng, (m, c)))
    gram_style = other.T @ other / (m * c)
    flat = feat.reshape(m, c)
    g_k = style.style_gram(feat, size)
    g_p = style.style_gram_plain(feat, size)
    gd = (g_p * n - gram_style).contiguous()
    s_k = style.style_grad(feat, gd, size)
    s_p = style.style_grad_plain(feat, gd, size)
    require(torch.equal(g_k, style.style_gram(feat, size))
            and torch.equal(s_k, style.style_grad(feat, gd, size)),
            'style phases %s: two calls differ' % (tap,))
    torch.cuda.synchronize()
    rows = []
    for name, got, want, kernel, plain, lib, flops, nbytes in (
            ('style_gram', g_k, g_p, lambda: style.style_gram(feat, size),
             lambda: style.style_gram_plain(feat, size),
             lambda: torch.mm(flat.T, flat),
             *perfmodel.style_cost(m, c, phase='gram')),
            ('style_grad', s_k, s_p, lambda: style.style_grad(feat, gd, size),
             lambda: style.style_grad_plain(feat, gd, size),
             lambda: torch.mm(flat, gd),
             *perfmodel.style_cost(m, c, phase='grad'))):
        # s_grad is ~1e-9 in magnitude: errors relative to each output's
        # own max, as check_style's.
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        require(math.isfinite(rel) and rel <= STYLE_TOL, '%s %s: rel err '
                '%.3g' % (name, tap, rel))
        t_b, t_by = bound(flops, nbytes)
        row = {'kernel': name, 'dtype': 'float32', 'where': 'shard',
               'shape': list(tap), 'ms': timed(kernel),
               'plain_ms': timed(plain), 'library_ms': timed(lib),
               'bound_ms': t_b, 'bound_by': t_by, 'abs_err': err,
               'rel_err': rel}
        pending.append((row, '', kernel))
        pending.append((row, 'library_', lib))
        rows.append(row)
    fused = timed(lambda: style._launch(feat, gram_style))
    for row in rows:
        row['fused_ms'] = fused
    say('kernels', 'style phases float32 shard %-16s gram %.3f ms (plain '
        '%.3f, torch.mm %.3f; %.0f%% of bound %.3f) err %.2g, grad %.3f ms '
        '(plain %.3f, torch.mm %.3f; %.0f%% of bound %.3f) err %.2g; the '
        'fused branch %.3f; bitwise repeatable' % (
            tap, rows[0]['ms'], rows[0]['plain_ms'], rows[0]['library_ms'],
            100 * rows[0]['bound_ms'] / rows[0]['ms'], rows[0]['bound_ms'],
            rows[0]['rel_err'], rows[1]['ms'], rows[1]['plain_ms'],
            rows[1]['library_ms'], 100 * rows[1]['bound_ms'] / rows[1]['ms'],
            rows[1]['bound_ms'], rows[1]['rel_err'], fused))
    return rows


def shard_kernels(torch, rows, pending, parts, worst):
    """The kernels at the shard path's shapes: the convs at each trunk
    shape of one 768x1024 shard with its halo rows (h / SHARD_N + 2 rows),
    float32 and bfloat16, and the style phases at the shard's four taps;
    their rows join kernels.json and the costs phase's calls, and the
    style phases' rows make their summary entries."""
    rng = np.random.RandomState(SHARD_N)
    hw = shard_hw(shard_inputs()[3], SHARD_SIZE)
    shapes = []
    for h, w, cin, cout in trunk_convs(*hw):
        shape = (h // SHARD_N + 2, w, cin, cout)
        if shape not in shapes:
            shapes.append(shape)
    for dtype_name in ('float32', 'bfloat16'):
        for shape in shapes:
            # Held and timed; not profiled (no summary entry sums them).
            row = check_conv(torch, rng, shape, dtype_name, 'shard', [],
                             timing=(5, 1))
            rows.append(row)
            for direction in ('fwd', 'bwd'):
                key = 'conv3x3_bias_relu_' + direction
                worst[key] = max(worst[key], row[direction + '_abs_err'])
    for name in SHARD_KERNELS:
        parts[name] = []
        worst[name] = 0.0
    for tap in style_taps(hw[0] // SHARD_N, hw[1]):
        for row in check_style_phases(torch, rng, tap, SHARD_N, pending,
                                      timing=(5, 1)):
            rows.append(row)
            parts[row['kernel']].append((row, ''))
            worst[row['kernel']] = max(worst[row['kernel']], row['abs_err'])
    # The bf16 feed's phases and sumsq at the shard's taps (held and
    # timed; not profiled).
    rows += check_feed(torch, rng, hw, 'shard', [], worst, n=SHARD_N,
                       timing=(5, 1))
    write_kernels_json(rows)


def phase_shard(torch, smi, log, rows, pending, parts, worst):
    """Spatial and data sharding on the card (shard docstring): the kernels
    at the shards' shapes, then the engine runs. Returns the float32
    sharded run's launch counts."""
    from style_transfer2_tpu_torch.utils import tf32
    t0 = time.perf_counter()
    with tf32(False):
        shard_kernels(torch, rows, pending, parts, worst)
    launches, _ = shard_runs(torch, smi, log)
    say('shard', 'phase done in %.1f s' % (time.perf_counter() - t0))
    return launches



def phase_roofline(smi):
    """Every measured step against its floor (ROOFLINE), in one object for
    the roofline line, beside the card's name and power limit; fails where
    a share of the floor exceeds MAX_SHARE, since no card beats its
    floor."""
    for row in ROOFLINE:
        say('roofline', '%-44s %9.3f ms, floor %8.3f ms (%s): %5.1f%% of '
            'it, MFU %5.1f%%' % (row['path'], row['ms'], row['floor_ms'],
                                 row['bound_by'],
                                 100 * row['share_of_floor'],
                                 100 * row['mfu']))
        require(row['share_of_floor'] <= MAX_SHARE, 'roofline %s: %.3f ms '
                'measured against a floor of %.3f ms' % (
                    row['path'], row['ms'], row['floor_ms']))
    return {'roofline': [{k: row[k] for k in (
        'path', 'hw', 'precision', 'remat', 'lanes', 'floor_ms', 'ms', 'mfu',
        'share_of_floor', 'bound_by')} for row in ROOFLINE], 'device': smi}


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
    for name, n in phase_highres(torch, log, smi, worst).items():
        launches[name] += n
    phase_parity(torch)
    phase_graph(torch, smi)
    counts, batch_it_s = phase_batch(torch, log, rates, smi)
    for name, n in counts.items():
        launches[name] += n
    for name, n in phase_serve(torch, smi).items():
        launches[name] += n
    for name, n in phase_pool(torch, smi, batch_it_s).items():
        launches[name] += n
    for name, n in phase_video(torch, smi).items():
        launches[name] += n
    for name, n in phase_shard(torch, smi, log, rows, pending, parts,
                               worst).items():
        launches[name] = launches.get(name, 0) + n
    with tf32(False):
        phase_costs(torch, rows, parts, pending, steps)
    step = summarize(parts)

    kernels = [dict({'name': name, 'route': 'cuda',
                     'source': SOURCES[name][0][0],
                     'sources': list(SOURCES[name][0]),
                     'replaces': SOURCES[name][1],
                     'launches': launches[name], 'max_abs_err': worst[name]},
                    **step[name]) for name in KERNELS + SHARD_KERNELS]
    say('summary', 'ms / plain_ms / bound_ms / library_ms, float32: the '
        'convs and the style branch summed over one 512px step\'s shapes '
        '(library: cuDNN conv, cuDNN dgrad), the image kernels (uint8 '
        'preprocess, deprocess) over the 7 rungs of the 1024px ladder '
        '(library: torch.sub, torch.add); device_ms: the kernels\' own '
        'time (torch.profiler); host_us: the host\'s enqueue cost a call; '
        'launches over the main, ladder, highres, batch, serve, pool, '
        'video and shard runs (style_gram, style_grad: the shard run\'s '
        'two style phases, summed over the four taps of one 768x1024 '
        'shard; style_gram_bf16, style_grad_bf16, sumsq: the bf16 loss '
        'feed\'s kernels, which every bfloat16 run launches, summed over '
        'the 512px step\'s four style taps, sumsq over its five calls, '
        'library: cuBLAS bf16 GEMM); pool_fwd, pool_bwd: float32, summed '
        'over the 512px step\'s three pools (library: '
        'F.max_pool2d(ceil_mode=True) for the forward, none for the '
        'backward); tap_epilogue: float32, summed over the 512px step\'s '
        'five taps (no library call); '
        '512px it/s float32 '
        '%.3f, bfloat16 %.3f; step graph replays by run: %s' % (
            rates['float32'], rates['bfloat16'],
            ', '.join('%s %d' % kv for kv in REPLAYS.items())))
    print(json.dumps(phase_roofline(smi)), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
