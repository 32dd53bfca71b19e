"""Analytic roofline of one optimization step on the H100
(style_transfer2_tpu/utils/perfmodel.py, for the port's card).

The least time the card could take for one step: compute time from the
step's analytic conv and Gram FLOPs, memory time from its modeled HBM
traffic, and the floor max(compute, memory). A measured step divided into
it is the step's share of the floor (sol_at); the model FLOPs over the
card's peak over the measured time is its MFU (mfu_at). The per-kernel
costs (conv_cost, style_cost, image_cost, kernel_bound) are the bounds
chip_smoke.py holds each hand-written kernel against.

Counts (the JAX model's, unchanged, so that the two packages' floors are
one number; they do not depend on the card):
  * Convs dominate: forward and input-gradient backward are each one
    9*Cin*Cout matmul per pixel (no weight gradients in this workload).
    The Gram and style-gradient matmuls count in full, 2*2*M*C^2 a style
    layer (the kernel computes the symmetric Gram's upper triangle, so
    style_cost counts M*C*(C+1) + 2*M*C^2: over a step's taps the two
    differ by exactly sum(M*C^2 - M*C)). Elementwise work (ReLU, pooling,
    the TV and content losses, the L-BFGS two-loop) is counted as HBM
    traffic only.
  * HBM traffic: each conv reads its input and weights and writes its
    output; the backward reads the output cotangent and the activation
    for the ReLU mask, the weights, and writes the input cotangent.
    Residuals: without remat every conv output is written in the forward
    and read in the backward; 'conv' remat saves each conv INPUT and
    recomputes the conv in the backward (+1x forward FLOPs); 'block' remat
    saves block inputs (pool boundaries) and recomputes the block forward
    once inside the backward. The biases are not counted (conv_cost counts
    them: Cout elements a forward).
  * The step state (iterate in and out, the L-BFGS history): 24 H*W*3
    arrays of the step's dtype. The port keeps the history in float32
    below 160k pixels in bfloat16 mode (optim/lbfgs.py), so there the
    count is low; it is kept for parity with the JAX model.
  * The TPU model assumed elementwise work fuses into its neighbours.
    PyTorch launches its own elementwise kernels, so the port moves more
    bytes than this: the floor stays what the work needs, and the gap is
    the port's unfused traffic, which PERF.md reads from profile_step.

The card (the H100 constants below): which unit runs each piece sets its
peak. The trunk's convs run the port's own kernels: in float32 and
float32_fast the SIMT FMA kernels of csrc/conv3x3.cu (TF32 reaches only
cuBLAS and cuDNN calls off the trunk), 67 TFLOP/s; in bfloat16 the tensor
cores (wgmma, mma.sync), 989. The style branch (csrc/style.cu) follows the
taps: float32 SIMT in float32 and float32_fast, and in bfloat16, whose
loss feed keeps the taps bf16, the bf16 phases' mma.sync kernels on the
tensor cores (989), the taps counted at 2 bytes a value. SIMT has no tile;
on the tensor cores the tile term (conv_unit) is the share of each MMA the
kernel keeps useful, from the padding its staging imposes. t_compute is
tile-aware; mfu_at is raw (FLOPs over the precision's peak), as in the
JAX model.

So the floor, and share_of_floor (sol_at) with it, are read against the
port's CURRENT routing: conv_unit takes each conv's path from the
planners (ops/conv.py fwd_plan, bwd_plan) and its padding from the
kernels' staging (ops/conv.py mma_staging). A change of route (conv1_1's
bf16 forward off the mma.sync tile, its dx onto the tensor cores) moves
the floor with no change in the work done. mfu_at depends on the counts
and the peak alone: it is the figure to compare across routes.
"""

from dataclasses import dataclass, replace

import torch

from ..models.vgg19 import (BLOB_NAMES, CONV_SPECS, IN_CHANNELS, blob_index,
                            layer_channels)
from ..ops import conv

# NVIDIA's H100 SXM data sheet at 700 W, dense rates: FP32 outside the
# tensor cores, bf16 on them, HBM3; its 132 SMs (the planners' `sms`). The
# L2 replaces the JAX model's VMEM in fits_l2. The NVLink 4 rate (18
# links, 900 GB/s both ways together, so 450e9 B/s each way a card) and
# the latency of one peer copy are calibration constants: one card cannot
# measure either.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
SMS = 132
L2_BYTES = 50 * 2 ** 20
LINK_BYTES_S = 450e9
LINK_LATENCY = 5e-6

DTYPE_BYTES = {'float32': 4, 'float32_fast': 4, 'bfloat16': 2}

# The peak of the unit that runs each precision's convs, and its style
# branch (the bf16 feed's phases on the tensor cores).
_CONV_PEAK = {'float32': F32_FLOPS, 'float32_fast': F32_FLOPS,
              'bfloat16': BF16_FLOPS}

# The benchmark objective's taps (the JAX model's defaults, bench.py
# WEIGHTS): deepest is conv5_1. The port's main path takes the engine's
# own (initial_weights.yaml: content conv4_2, style conv1_1-conv4_1).
DEFAULT_CONTENT = ('conv4_2',)
DEFAULT_STYLE = ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1', 'conv5_1')


def _padded(n, unit):
    return unit * -(-n // unit)


def conv_unit(k, n, direction, precision):
    """(peak FLOP/s, tile efficiency) of the kernel that runs one conv
    direction summing k channels into n (forward: k = Cin, n = Cout;
    backward: k = Cout, the cotangent's, n = Cin, dx's), on the path
    ops/conv.py routes it to (a split changes the path's grid, not its
    unit):

      * float32, float32_fast: SIMT FMAs, no tile (1.0);
      * bfloat16 narrow (conv1_1's dx): float32 FMAs at the SIMT peak;
      * bfloat16 tile (mma.sync: conv1_1's forward) and wgmma: the bf16
        peak, K = 9*k with each tap's k padded and N = n padded to the
        kernel's staging (mma_staging; conv1_1's forward 3 of 32 and 64 of
        64, 0.094; 1.0 at every VGG-19 layer past conv1_1)."""
    if precision != 'bfloat16':
        return _CONV_PEAK[precision], 1.0
    plan = conv.fwd_plan if direction == 'fwd' else conv.bwd_plan
    path = plan(1, 16, 16, k, n, torch.bfloat16, SMS)[0]
    if path == conv.NARROW:
        return F32_FLOPS, 1.0
    k_unit, n_unit = conv.mma_staging(path, n)
    return BF16_FLOPS, k / _padded(k, k_unit) * n / _padded(n, n_unit)


@dataclass
class StepModel:
    flops: float          # model FLOPs of one optimizer step
    peak_flops: float     # the card's peak at this precision (its convs')
    hbm_bytes: float      # modeled HBM traffic of one step
    t_compute: float      # s, tile-aware: sum of FLOPs / (unit peak * tile)
    t_memory: float       # s, bytes / bandwidth
    t_floor: float        # s, max of the two
    bound: str            # 'compute' | 'memory'
    working_bytes: float  # peak single-layer working set
    fits_l2: bool         # working_bytes < the card's L2

    def mfu_at(self, step_seconds):
        """Raw model-FLOPs utilization of the card's peak (no tiles)."""
        return self.flops / self.peak_flops / step_seconds

    def sol_at(self, step_seconds):
        """Fraction of the roofline floor reached (1.0 = speed of light)."""
        return self.t_floor / step_seconds

    def fields_at(self, step_seconds):
        """The fields a measured step's record keeps: model_flops,
        floor_ms, bound_by, mfu and share_of_floor at step_seconds."""
        return {'model_flops': self.flops, 'floor_ms': self.t_floor * 1e3,
                'bound_by': self.bound, 'mfu': self.mfu_at(step_seconds),
                'share_of_floor': self.sol_at(step_seconds)}

    def lanes(self, n):
        """The model of n independent images in one step (the batched
        engine's lanes): every count n times one image's."""
        t_c, t_m = n * self.t_compute, n * self.t_memory
        return replace(self, flops=n * self.flops,
                       hbm_bytes=n * self.hbm_bytes, t_compute=t_c,
                       t_memory=t_m, t_floor=max(t_c, t_m),
                       bound='compute' if t_c >= t_m else 'memory',
                       working_bytes=n * self.working_bytes,
                       fits_l2=n * self.working_bytes < L2_BYTES)


def _grid_walk(hw):
    """Yields (blob, h, w, c_in, c_out) for convs and (blob, h, w, c, c)
    for pools, tracking the Caffe ceil-pool grid."""
    h, w = hw
    specs = dict(CONV_SPECS)
    for name in BLOB_NAMES[1:]:
        if name.startswith('conv'):
            yield name, h, w, IN_CHANNELS[name], specs[name]
        else:
            c = specs['conv%s_1' % name[4]]
            yield name, h, w, c, c
            h, w = -(-h // 2), -(-w // 2)


def _deepest(content_layers, style_layers):
    return max(blob_index(l) for l in
               tuple(content_layers) + tuple(style_layers))


def _tap_grids(hw):
    """{blob: (h, w)}: each blob's grid (ceil pools)."""
    grids = {'data': tuple(hw)}
    hh, ww = hw
    for name in BLOB_NAMES[1:]:
        if name.startswith('pool'):
            hh, ww = -(-hh // 2), -(-ww // 2)
        grids[name] = (hh, ww)
    return grids


def _step(hw, precision, remat, content_layers, style_layers,
          extra_rows=None):
    """The StepModel of one step; extra_rows: {conv name: rows} the convs
    also run on (the halo rows of a sharded step's shards)."""
    b = DTYPE_BYTES[precision]
    peak = _CONV_PEAK[precision]
    deepest = _deepest(content_layers, style_layers)
    extra_rows = extra_rows or {}

    flops = 0.0
    seconds = 0.0    # tile-aware: each piece at its unit's peak and tile
    hbm = 0.0
    max_working = 0

    passes_fwd = 2 if remat else 1   # forward + backward recompute
    for name, h, w, c_in, c_out in _grid_walk(hw):
        if blob_index(name) > deepest:
            break
        pix = (h + extra_rows.get(name, 0)) * w
        if name.startswith('conv'):
            conv_flops = 2.0 * pix * 9 * c_in * c_out
            flops += conv_flops * (passes_fwd + 1)   # fwd(s) + input-grad
            unit, eff = conv_unit(c_in, c_out, 'fwd', precision)
            seconds += passes_fwd * conv_flops / (unit * eff)
            unit, eff = conv_unit(c_out, c_in, 'bwd', precision)
            seconds += conv_flops / (unit * eff)
            w_bytes = 9 * c_in * c_out * b
            act_in, act_out = pix * c_in * b, pix * c_out * b
            # forward pass(es): read in, read weights, write out.
            hbm += passes_fwd * (act_in + w_bytes + act_out)
            # backward: read cotangent + ReLU activation, read weights,
            # write input cotangent.
            hbm += 2 * act_out + w_bytes + act_in
            if remat == 'conv':
                hbm += 2 * act_in          # save + reload each conv input
            max_working = max(max_working, act_in + act_out + w_bytes)
        else:   # pool: fwd read+write, bwd read+write (mask via recompute)
            act = h * w * c_in * b
            hbm += passes_fwd * (act + act // 4) + (act // 4 + act)
            if remat == 'block':
                hbm += 2 * (act // 4)      # block boundary save + reload

    # Gram + style-gradient matmuls on the taps' grids: float32 SIMT, or in
    # bfloat16 the feed's tensor-core phases.
    grids = _tap_grids(hw)
    for layer in style_layers:
        hh, ww = grids[layer]
        c = layer_channels(layer)
        gram_flops = 2 * 2.0 * hh * ww * c * c   # gram + grad matmuls
        flops += gram_flops
        seconds += gram_flops / _CONV_PEAK[precision]
        hbm += 2 * (hh * ww * c * b) + 2 * c * c * b

    # The step state: iterate in and out, the L-BFGS history (n_corr 10).
    hbm += 24 * hw[0] * hw[1] * 3 * b

    t_m = hbm / HBM_BYTES_S
    return StepModel(flops=flops, peak_flops=peak, hbm_bytes=hbm,
                     t_compute=seconds, t_memory=t_m,
                     t_floor=max(seconds, t_m),
                     bound='compute' if seconds >= t_m else 'memory',
                     working_bytes=max_working,
                     fits_l2=max_working < L2_BYTES)


def model_step(hw, precision='bfloat16', remat=False,
               content_layers=DEFAULT_CONTENT, style_layers=DEFAULT_STYLE):
    """The roofline StepModel of one optimizer step at the iterate grid
    hw = (H, W): FLOPs and bytes the JAX model's, t_compute and the floor
    the H100's."""
    return _step(hw, precision, remat, content_layers, style_layers)


# -- spatial sharding (parallel/spatial.py) ----------------------------------
#
# The port cuts the iterate along H into n equal shards, one a device, and
# moves what GSPMD moved for the JAX package by hand, each a peer copy
# (Tensor.to) that autograd carries back:
#
#   * halo rows: every 3x3 conv pads each shard with one row of each
#     neighbour (zero rows at the image edge): 2 (n - 1) rows of (W, Cin)
#     a forward, over the n - 1 boundaries, and in the backward the
#     gradients of those rows go back to the shard they came from: 2 (n -
#     1) rows of (W, Cin) again. Under 'block' remat the forward, halo
#     included, runs again inside the backward, except at a conv whose
#     output is a tap (a part of its own, not checkpointed:
#     models/vgg19.py _segments); 'conv' remat checkpoints the conv alone,
#     after its halo. The JAX model counted, per device, 2 rows of Cin a
#     forward and 2 rows of Cout of cotangent a backward.
#   * a level stays sharded while its shards pool evenly; the first pool
#     over an odd shard gathers the map onto the first device, and the
#     rest of the trunk runs there (models/vgg19.py _pool);
#   * TV's two circular rolls of the float32 iterate along H: one row
#     across each of the n boundaries each;
#   * the Gram: each shard's partial (C, C) float32 Gram to the first
#     device, and the Gram difference back to every shard: 2 (n - 1) C^2
#     floats a sharded style layer.
#
# The peer copies of one boundary run one after another on the layer
# chain (conv N+1 needs its halo), so the link time adds to the local
# floor rather than overlapping it.


def _sharded_convs(hw, n, deepest):
    """The conv names whose level is sharded n ways on H, with their shard
    rows, as the port runs the trunk: a level stays sharded while its
    shards' rows are even at each pool."""
    if n < 2:
        return {}
    rows = hw[0] // n
    out = {}
    for name, _, _, _, _ in _grid_walk(hw):
        if blob_index(name) > deepest or rows is None:
            break
        if name.startswith('conv'):
            out[name] = rows
        elif rows % 2:
            rows = None              # gathered onto the first device
        else:
            rows //= 2
    return out


@dataclass
class ShardedStepModel:
    """One H-sharded step over n devices.

    halo_bytes is the PORT's count: every byte its halo and roll exchanges
    move in a step, over all boundaries (chip_smoke.py's shard phase holds
    it to what one step's exchanges move on the card).
    jax_halo_bytes is the JAX model's figure, per device: 2 rows of Cin a
    forward (twice under remat), 2 rows of Cout of cotangent a backward,
    and a ring all-reduce of each style Gram. The two differ in kind: the
    port returns the halo rows' gradients (Cin channels) through
    autograd, the JAX model counted cotangent rows (Cout channels), and
    one is a total, the other per device."""
    n_shards: int
    per_chip: StepModel      # one device's share: the step at (H/n, W)
    one_card: StepModel      # the n shards' work, halo rows in, on one card
    halo_bytes: float        # port: halo rows and gradients, TV's rolls
    gram_bytes: float        # port: partial Grams in, Gram differences out
    device_bytes: float      # port: the most one device receives a step
    jax_halo_bytes: float    # JAX model: per device (class docstring)
    n_exchanges: int         # peer copies the busiest device waits on
    t_link: float            # s, device_bytes / link + n_exchanges * latency
    t_floor: float           # s, max(compute, memory) of per_chip + t_link
    bound: str               # 'compute' | 'memory' | 'link'

    def sol_at(self, step_seconds):
        return self.t_floor / step_seconds


def model_step_sharded(hw, n_shards, precision='bfloat16', remat='block',
                       content_layers=DEFAULT_CONTENT,
                       style_layers=DEFAULT_STYLE):
    """Roofline of one step with the iterate cut n ways on H (H a multiple
    of n, as SpatialPlacement.snap_hw gives), per the notes above."""
    b = DTYPE_BYTES[precision]
    n = n_shards
    deepest = _deepest(content_layers, style_layers)
    h, w = hw
    per_chip = model_step((max(1, h // n), w), precision, remat,
                          content_layers, style_layers)
    sharded = _sharded_convs(hw, n, deepest)
    one_card = _step(hw, precision, remat, content_layers, style_layers,
                     {name: 2 * n for name in sharded})

    taps = set(content_layers) | set(style_layers)
    jax_fwd = 2 if remat else 1
    halo = gram = jax_halo = 0.0
    received = [0.0] * n
    copies = [0] * n
    if n > 1:
        for name, _, ww, c_in, c_out in _grid_walk(hw):
            if name not in sharded:
                continue
            own_part = name in taps
            halo_fwd = 2 if remat == 'block' and not own_part else 1
            row = ww * c_in * b
            halo += (halo_fwd + 1) * 2 * (n - 1) * row
            jax_halo += 2 * ww * b * (jax_fwd * c_in + c_out)
            for i in range(n):
                neighbours = (i > 0) + (i < n - 1)
                received[i] += (halo_fwd + 1) * neighbours * row
                copies[i] += (halo_fwd + 1) * neighbours
        tv_row = w * 3 * 4
        halo += 2 * n * tv_row
        for i in range(n):
            received[i] += 2 * tv_row
            copies[i] += 2
        for layer in style_layers:
            c = layer_channels(layer)
            jax_halo += 2.0 * (n - 1) / n * c * c * 4
            if layer not in sharded:
                continue
            gram += 2 * (n - 1) * c * c * 4
            received[0] += (n - 1) * c * c * 4
            copies[0] += n - 1
            for i in range(1, n):
                received[i] += c * c * 4
                copies[i] += 1
    busiest = max(range(n), key=lambda i: (received[i], copies[i]))
    device_bytes, n_exchanges = received[busiest], copies[busiest]
    t_link = device_bytes / LINK_BYTES_S + n_exchanges * LINK_LATENCY
    t_local = max(per_chip.t_compute, per_chip.t_memory)
    return ShardedStepModel(
        n_shards=n, per_chip=per_chip, one_card=one_card, halo_bytes=halo,
        gram_bytes=gram, device_bytes=device_bytes,
        jax_halo_bytes=jax_halo, n_exchanges=n_exchanges, t_link=t_link,
        t_floor=t_local + t_link,
        bound=per_chip.bound if t_local >= t_link else 'link')


# -- per-kernel costs: what chip_smoke.py holds each kernel against --------

def conv_cost(n, h, w, cin, cout, direction, precision):
    """(FLOPs, bytes) of one conv kernel call over n images of h x w: 2*9
    FLOPs a multiply-add of every output; the forward moves x, w, the bias
    and y, the masked backward g, y, w and dx, each once. precision:
    'float32' or 'bfloat16' (the operands' dtype)."""
    px = n * h * w
    size = DTYPE_BYTES[precision]
    flops = 2 * 9 * px * cin * cout
    if direction == 'fwd':
        return flops, size * (px * (cin + cout) + 9 * cin * cout + cout)
    return flops, size * (px * (2 * cout + cin) + 9 * cin * cout)


def style_cost(m, c, lanes=1, phase=None, precision='float32'):
    """(FLOPs, bytes) of the style branch at a (M, C) float32 map, each
    lane: the symmetric Gram (its upper triangle with the diagonal, M*C*(C
    + 1)) and the gradient product (2*M*C^2); X and G_style read, G_diff
    and s_grad written, once. phase 'gram' or 'grad': one of the two
    phases (ops/style.py style_gram: X read, the float32 Gram written;
    style_grad, style_product: X and D read, the product written), whose
    map, D and product are in `precision`'s dtype (bfloat16: the feed's
    phases, 2 bytes a value)."""
    b = DTYPE_BYTES[precision]
    if phase == 'gram':
        return lanes * m * c * (c + 1), lanes * (b * m * c + 4 * c * c)
    if phase == 'grad':
        return lanes * 2 * m * c * c, lanes * b * (2 * m * c + c * c)
    return (lanes * (m * c * (c + 1) + 2 * m * c * c),
            lanes * 4 * (2 * m * c + 2 * c * c))


def sumsq_cost(n, precision='bfloat16'):
    """(FLOPs, bytes) of ops/reduce.py sumsq over n values of `precision`'s
    dtype: a float32 multiply and add a value (SIMT: bound them at
    'float32'), the values read once and one float32 written."""
    return 2 * n, DTYPE_BYTES[precision] * n + 4


def pool_cost(n, h, w, c, precision='float32'):
    """(FLOPs, bytes) of each of ops/pool.py's two kernels at an (n, h, w,
    c) map of `precision`'s dtype: the forward reads the map and writes
    the pooled map and a byte of tie mask a pooled value, the backward
    reads the cotangent and the mask and writes the map's gradient. The
    compares are counted as bytes only."""
    b = DTYPE_BYTES[precision]
    pooled = n * ((h + 1) // 2) * ((w + 1) // 2) * c
    return 0, b * n * h * w * c + (b + 1) * pooled


def epilogue_cost(n, terms):
    """(FLOPs, bytes) of ops/epilogue.py's tap epilogue over n float32
    values with the terms named in `terms` ('c', 's', 'd'): the tap read
    where a content or deepdream term needs it, the content target and
    s_grad where present, the cotangent written, 4 bytes each. Elementwise
    work is counted as bytes only."""
    arrays = 1 + bool(set(terms) & {'c', 'd'}) + ('c' in terms) + (
        's' in terms)
    return 0, 4 * n * arrays


def image_cost(px, src_itemsize, kind):
    """(FLOPs, bytes) of an image kernel over px pixels: preprocess reads
    3 channels of src_itemsize bytes and writes 3 float32 (15 bytes a
    pixel from uint8, 24 from float32); deprocess reads and writes 3
    float32 (24). Elementwise work is counted as bytes only."""
    if kind == 'preprocess':
        return 0, px * (3 * src_itemsize + 12)
    if kind == 'deprocess':
        return 0, px * 24
    raise ValueError('image_cost: kind %r' % (kind,))


def kernel_bound(flops, nbytes, precision='float32'):
    """(seconds, 'operations' or 'bytes'): the least time the card could
    take for a kernel, the larger of its FLOPs over the peak of its
    operands' type (float32: SIMT; bfloat16: the tensor cores) and its
    bytes over the memory rate."""
    t_ops = flops / _CONV_PEAK[precision]
    t_mem = nbytes / HBM_BYTES_S
    return (t_ops, 'operations') if t_ops >= t_mem else (t_mem, 'bytes')
