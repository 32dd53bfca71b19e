#!/usr/bin/env python3
"""Command-line style transfer with the PyTorch/CUDA port
(style_transfer2_tpu/cli.py). Single-scale runs, the coarse-to-fine
sqrt(2) ladder with warm-started optimizer state (--multi-scale), a
full-precision polish tail (--polish), K-step chunks kept --pipeline-depth
deep, in-progress snapshots, checkpoint/resume and the trace CSV; and
--batch, which styles a directory of images as lanes of one batched step
(engine/batched.py).

Examples:
  python -m style_transfer2_tpu_torch.cli content.jpg style.jpg -o out.png \\
      --size 1024 --multi-scale --iterations 150 --precision bfloat16 \\
      --polish 50
  python -m style_transfer2_tpu_torch.cli photos/ style.jpg --batch \\
      -o styled/ --lanes 4 --size 512 --skip-existing

--device cuda (the default) runs the hand-written kernels on the card and
raises if CUDA is not available; --device cpu runs their plain PyTorch
versions. --profile DIR writes a torch.profiler trace of the run
(utils/profiling.py). --remat [conv|block] rematerializes the backward of
the main and the polish engine (models/vgg19.py): less memory held between
the forward and the backward for a second forward, the same trace. --pallas, --platform and --prewarm-ladder
are accepted, logged and ignored, so that a JAX command line runs here:
the kernels are always on, --device picks the device, and the port
compiles nothing a rung that a prewarm could hide; --batch ignores
--remat, as the JAX CLI's batch mode does.

--mesh N (or 'auto', 'AxB') shards one image's H axis over N devices
(parallel/spatial.py): every ladder rung snaps to a grid whose sides
divide by N, and the polish engine takes the same placement. --data-mesh
N splits --batch lanes over N devices (parallel/batch.py DataPlacement);
--lanes must divide by N. On --device cuda a mesh takes the first N cards
and exits if there are fewer; on --device cpu it is N entries of the CPU,
one process standing in for N devices.
"""

import argparse
import contextlib
import logging
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch
import yaml
from PIL import Image

from . import utils as im
from .utils.profiling import device_trace

logger = logging.getLogger('cli')

ROOT_DIR = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('content', help='content image path')
    p.add_argument('style', help='style image path')
    p.add_argument('--output', '-o', default='out.png',
                   help='output image path')
    p.add_argument('--size', type=int, default=512,
                   help='output size (largest dimension)')
    p.add_argument('--style-size', type=int, default=None,
                   help='style image size (defaults to --size)')
    p.add_argument('--iterations', '-i', type=int, default=200,
                   help='iterations (per scale when --multi-scale)')
    p.add_argument('--optimizer', choices=('adam', 'lbfgs'), default='lbfgs')
    p.add_argument('--step-size', type=float, default=None,
                   help='optimizer step size (defaults: adam 10, lbfgs 1)')
    p.add_argument('--weights', default=None,
                   help='loss-weights YAML (initial_weights.yaml format)')
    p.add_argument('--model-weights', default='auto',
                   help="VGG-19 weights: 'auto', 'random', or an .npz path")
    p.add_argument('--multi-scale', action='store_true',
                   help='coarse-to-fine: optimize up the sqrt(2) size ladder '
                        'with warm-started optimizer state')
    p.add_argument('--min-scale', type=int, default=96,
                   help='smallest rung of the multi-scale ladder')
    p.add_argument('--batch', action='store_true',
                   help='content is a directory (or glob): style every '
                        'image, batched as lanes of one step (--output '
                        'becomes a directory)')
    p.add_argument('--lanes', type=int, default=4,
                   help='concurrent images per dispatch in --batch mode')
    p.add_argument('--skip-existing', action='store_true',
                   help='--batch: skip inputs whose styled output already '
                        'exists, so an interrupted batch restarts where '
                        'it died (images are independent jobs)')
    p.add_argument('--data-mesh', default='',
                   help="split --batch lanes over a 'data' mesh ('auto', "
                        "or a device count)")
    p.add_argument('--mesh', default='',
                   help="spatial sharding mesh for high-res (e.g. '4' or "
                        "'auto'); empty = single device")
    p.add_argument('--init', choices=('random', 'content'), default='random',
                   help='initial iterate')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--precision',
                   choices=('float32', 'float32_fast', 'bfloat16'),
                   default='float32',
                   help='float32 = reference-exact (TF32 off); float32_fast '
                        '= TF32 allowed in cuBLAS/cuDNN; bfloat16 = the '
                        'trunk in bf16')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (hand-written kernels; raises without a "
                        "GPU) or 'cpu' (their plain PyTorch versions)")
    p.add_argument('--steps-per-dispatch', type=int, default=60,
                   help='iterations enqueued per chunk before a host read')
    p.add_argument('--pipeline-depth', type=int, default=2,
                   help='chunks in flight at once: the next chunk is '
                        'enqueued before the current one is collected; '
                        '1 = synchronous')
    p.add_argument('--polish', type=int, default=0, metavar='N',
                   help='after the main run, refine with N iterations at '
                        '--polish-precision, warm-started from the final '
                        'iterate (only when that raises --precision)')
    p.add_argument('--polish-precision',
                   choices=('float32', 'float32_fast'), default='float32',
                   help='precision of the --polish phase')
    p.add_argument('--trace-csv', default=None, help='write the trace here')
    p.add_argument('--checkpoint', default=None,
                   help='save a resumable checkpoint directory at the end')
    p.add_argument('--resume', default=None,
                   help='resume from a checkpoint directory')
    p.add_argument('--save-every', type=int, default=0,
                   help='write the in-progress image every N iterations')
    p.add_argument('--profile', default=None,
                   help='write a torch.profiler trace (Chrome JSON: host '
                        'activity, and the card\'s kernels on CUDA) of the '
                        'run into this directory')
    p.add_argument('--remat', nargs='?', const='conv', default=False,
                   choices=('conv', 'block'),
                   help='rematerialize in the backward pass: a second '
                        'forward for less memory held between the forward '
                        'and the backward; the peak of a step stays where '
                        'it was (PERF.md). "conv" (the bare-flag default) '
                        'checkpoints each conv, "block" the trunk between '
                        'pools. Ignored with --batch')
    p.add_argument('--pallas', action='store_true',
                   help='ignored: the kernels are always on')
    p.add_argument('--platform', default='',
                   help='ignored (the JAX backend); see --device')
    p.add_argument('--prewarm-ladder', action='store_true',
                   help='ignored: nothing is compiled per rung')
    p.add_argument('--debug', '-d', action='count', default=0)
    return p.parse_args(argv)


def load_weights_doc(path):
    if path is None:
        path = ROOT_DIR / 'initial_weights.yaml'
    with open(path) as f:
        doc = yaml.safe_load(f)
    return doc[0], doc[1]


def load_inputs(args):
    """The model weights, the loss-weights document, the content image (PIL)
    and the fitted style image (uint8 array) for parsed CLI args."""
    from .models.weights import resolve_params
    params = resolve_params(args.model_weights, ROOT_DIR)
    with Image.open(args.content) as img:
        content_pil = img.convert('RGB')
    with Image.open(args.style) as img:
        style_pil = img.convert('RGB')
    style_np = np.uint8(im.resize_to_fit(style_pil,
                                         args.style_size or args.size))
    return params, load_weights_doc(args.weights), content_pil, style_np


def build_engine(args, inputs, precision, device, placement=None):
    """An engine at the given precision (and spatial placement) with the
    objective, optimizer and style image set."""
    from .engine import StyleTransfer
    from .optim import STEP_SIZES
    params, (weights, scalar_params), _, style_np = inputs
    st = StyleTransfer(params, precision=precision, device=device,
                       remat=args.remat, placement=placement)
    st.set_weights(weights, scalar_params)
    st.set_optimizer(args.optimizer)
    st.set_step_size(args.step_size if args.step_size is not None
                     else STEP_SIZES[args.optimizer])
    st.set_style(style_np)
    return st


def fit_content(content_pil, hw):
    """The content image resized (PIL LANCZOS) to an (h, w) grid."""
    return np.uint8(content_pil.resize((hw[1], hw[0]), Image.LANCZOS))


def start_first_rung(st, args, content, hw, rng):
    """Sets the content and the initial iterate on an (h, w) grid and
    starts the engine."""
    st.set_content(content)
    if args.init == 'random':
        st.set_input(rng.uniform(0, 255, hw + (3,)).astype(np.uint8))
    else:
        st.set_input(content)
    if not st.start():
        raise RuntimeError('engine failed to start (inconsistent state?)')


def mesh_of(spec, axis, device):
    """make_mesh(spec) over one named axis on --device; exits with
    make_mesh's message where the devices are too few."""
    from .parallel import make_mesh
    try:
        return make_mesh(spec, axis_names=(axis,), device=device)
    except ValueError as e:
        raise SystemExit(str(e))


def spatial_placement(args):
    """The SpatialPlacement of --mesh, or None."""
    if not args.mesh:
        return None
    from .parallel import SpatialPlacement
    placement = SpatialPlacement(mesh_of(args.mesh, 'space', args.device),
                                 axis='space')
    logger.info('spatial sharding over %d devices: %s', placement.n_shards,
                ', '.join(str(d) for d in placement.devices))
    return placement


def setup(args):
    """For parsed CLI args: an engine at --precision on --device (over the
    --mesh placement) with the objective, optimizer and style set (not
    started), the inputs of load_inputs, and the (h, w) grid of the full
    --size."""
    from .engine import resolve_device
    device = resolve_device(args.device)
    placement = spatial_placement(args)
    inputs = load_inputs(args)
    st = build_engine(args, inputs, args.precision, device, placement)
    wh = im.fit_into_square(inputs[2].size, args.size, scale_up=True)
    return st, inputs, (wh[1], wh[0])


def dispatch_chunks(st, iterations, chunk, depth, begin=None):
    """Enqueues `iterations` steps in chunks of at most `chunk`, keeping up
    to `depth` chunks in flight, and yields each handle in dispatch order
    for the caller to collect; the next chunk is enqueued before the
    collect of the one yielded, so the device never waits on the host's
    read-back. The chunk plan is fixed up front. A chunk is st.begin_steps,
    or `begin` where given (the batched engine's begin_steps_all)."""
    begin = begin or st.begin_steps
    handles = deque()
    remaining = iterations
    while remaining > 0 or handles:
        while remaining > 0 and len(handles) < max(1, depth):
            n = min(chunk, remaining)
            handles.append(begin(n))
            remaining -= n
        yield handles.popleft()


IMAGE_SUFFIXES = ('.png', '.jpg', '.jpeg', '.webp', '.bmp')


def batch_paths(args):
    """The --batch inputs still to style: every image of the content
    directory (or glob), less, with --skip-existing, those whose output
    exists and is a whole PNG."""
    src = Path(args.content)
    if src.is_dir():
        paths = sorted(p for p in src.iterdir()
                       if p.suffix.lower() in IMAGE_SUFFIXES)
    else:
        import glob
        paths = [Path(p) for p in sorted(glob.glob(args.content))]
    if not paths:
        raise SystemExit('--batch: no images match %r' % args.content)
    if not args.skip_existing:
        return paths

    def styled_ok(p):
        """A half-written PNG (the run died mid-save) is NOT done: verify()
        catches truncation without a full decode."""
        out = Path(args.output) / (p.stem + '_styled.png')
        if not out.exists():
            return False
        try:
            with Image.open(out) as img:
                img.verify()
            return True
        except Exception:
            logger.warning('--skip-existing: %s is corrupt; redoing',
                           out.name)
            return False

    todo = [p for p in paths if not styled_ok(p)]
    if len(todo) < len(paths):
        logger.info('--skip-existing: %d of %d already styled',
                    len(paths) - len(todo), len(paths))
    return todo


def run_batch(args):
    """Batch mode: every content image under `content` is styled against
    one style image, the images as lanes of one batched step (one chain of
    launches a step for the whole wave, the trunk at N = lanes). Images
    group by their fitted grid so that nothing is distorted; each grid's
    images run in lane-sized waves, each wave's chunks --pipeline-depth
    deep."""
    from .engine import resolve_device
    from .engine.batched import batched_engine
    from .models.weights import resolve_params

    outdir = Path(args.output)
    if outdir.suffix:
        raise SystemExit('--batch: --output must be a directory')
    if args.multi_scale or args.mesh:
        raise SystemExit('--batch does not combine with --multi-scale or '
                         'the spatial --mesh')
    device = resolve_device(args.device)
    placement = None
    if args.data_mesh:
        from .parallel import DataPlacement
        placement = DataPlacement(mesh_of(args.data_mesh, 'data',
                                          args.device))
        if args.lanes % placement.n_groups:
            raise SystemExit('--lanes (%d) must divide by the data mesh '
                             '(%d devices)' % (args.lanes,
                                               placement.n_groups))
        logger.info('lane axis sharded over %d devices',
                    placement.n_groups)
    if args.remat:
        logger.info('--remat %s: ignored by --batch (the batched engine '
                    'has no remat, as in the JAX CLI)', args.remat)
    outdir.mkdir(parents=True, exist_ok=True)
    paths = batch_paths(args)
    if not paths:
        logger.info('--skip-existing: nothing to do')
        return 0

    params = resolve_params(args.model_weights, ROOT_DIR)
    weights, scalar_params = load_weights_doc(args.weights)
    with Image.open(args.style) as img:
        style_pil = img.convert('RGB')
    style_np = np.uint8(im.resize_to_fit(style_pil,
                                         args.style_size or args.size))
    rng = np.random.RandomState(args.seed)

    groups = {}
    for path in paths:
        with Image.open(path) as img:
            wh = im.fit_into_square(img.size, args.size, scale_up=True)
        groups.setdefault((wh[1], wh[0]), []).append(path)
    logger.info('%d images in %d grid group(s): %s', len(paths),
                len(groups), {hw: len(g) for hw, g in groups.items()})

    total_t0 = time.perf_counter()
    n_done = 0
    for hw, group in sorted(groups.items()):
        engine = batched_engine(
            params, weights, scalar_params, hw, max_lanes=args.lanes,
            placement=placement, optimizer=args.optimizer,
            precision=args.precision, device=device)
        for wave_start in range(0, len(group), args.lanes):
            wave = group[wave_start:wave_start + args.lanes]
            lanes = {}
            for path in wave:
                with Image.open(path) as img:
                    content = fit_content(img.convert('RGB'), hw)
                init = (content if args.init == 'content' else
                        rng.uniform(0, 255, hw + (3,)).astype(np.uint8))
                lane = engine.add_job(content, style_np, init,
                                      step_size=args.step_size)
                lanes[lane] = path
            t0 = time.perf_counter()
            first = {}
            for handle in dispatch_chunks(
                    engine, args.iterations, args.steps_per_dispatch,
                    args.pipeline_depth, engine.begin_steps_all):
                traces = engine.collect_steps_all(handle)
                for lane, lane_traces in traces.items():
                    first.setdefault(lane, lane_traces[0]['loss'])
                logger.info('wave at %dx%d iterate %d loss %s', hw[0], hw[1],
                            max(t[-1]['fevals'] for t in traces.values()),
                            ' '.join('%.6g' % traces[lane][-1]['loss']
                                     for lane in sorted(traces)))
            dt = time.perf_counter() - t0
            for lane, path in lanes.items():
                out = outdir / (path.stem + '_styled.png')
                im.as_pil(engine.lane_image(lane)).save(out)
                logger.info('%s -> %s (loss %.6g -> %.6g)', path.name, out,
                            first[lane], traces[lane][-1]['loss'])
                engine.remove_job(lane)
            n_done += len(wave)
            logger.info('wave of %d at %dx%d: %d iters in %.2fs '
                        '(%.2f aggregate it/s)', len(wave), hw[0], hw[1],
                        args.iterations, dt,
                        len(wave) * args.iterations / dt)
    logger.info('styled %d images in %.1fs', n_done,
                time.perf_counter() - total_t0)
    return 0


def optimize(args, st, inputs, ladder, rng):
    """Runs the ladder's rungs (one rung without --multi-scale) on st, then
    the --polish tail where it raises the precision. Returns the engine
    that holds the result (the polish engine where one ran) and the
    iterations run."""
    device, content_pil = st.device, inputs[2]
    first = not args.resume
    chunk = min(args.steps_per_dispatch,
                args.save_every or args.steps_per_dispatch)
    for hw in ladder:
        content = fit_content(content_pil, hw)
        if first:
            start_first_rung(st, args, content, hw, rng)
            first = False
        else:
            # Warm start: resample the iterate and the optimizer state up
            # the ladder (reference worker.py:154-160).
            st.resample_input(hw)
            st.set_content(content)
            if not st.start():
                raise RuntimeError('engine failed to start at %dx%d' % hw)
        t0 = time.perf_counter()
        for handle in dispatch_chunks(st, args.iterations, chunk,
                                      args.pipeline_depth):
            image, traces = st.collect_steps(
                handle, fetch_image=bool(args.save_every))
            if args.save_every and (handle.t_end % args.save_every
                                    < handle.n_steps):
                im.as_pil(image).save(args.output)
            logger.info('scale %dx%d iterate %d loss %.6g', hw[0], hw[1],
                        handle.t_end, traces[-1].data['loss'])
        dt = time.perf_counter() - t0
        logger.info('scale %dx%d: %d iters in %.2fs (%.2f it/s)',
                    hw[0], hw[1], args.iterations, dt, args.iterations / dt)

    # Polish only ever raises precision: --precision float32 with
    # --polish-precision float32_fast would downgrade the exact result.
    polish_raises = (im.PRECISION_RANK.get(args.polish_precision, -1)
                     > im.PRECISION_RANK.get(args.precision, 99))
    total_iterations = st.t
    if args.polish and polish_raises:
        # Refine the result at the polish precision, warm-started from the
        # final iterate (snapshot -> preprocess is an exact mean-shift round
        # trip; the optimizer re-primes). The polish engine's first trace
        # row is the full-precision loss of the main run's result.
        logger.info('polish: %d iterations at %s', args.polish,
                    args.polish_precision)
        stp = build_engine(args, inputs, args.polish_precision, device,
                           st.placement)
        stp.set_content(fit_content(content_pil, st.input_hw))
        stp.set_input(st.snapshot())
        # The polish continues the same optimization, so it inherits the
        # main run's first-eval gradient-RMS norms and optimizes the same
        # normalized objective (norms persist across everything but reset,
        # worker.py:137,172-175).
        stp.norm_vals.update(st.norm_vals)
        stp.norm_set.update(st.norm_set)
        if not stp.start():
            raise RuntimeError('polish engine failed to start')
        t0 = time.perf_counter()
        for handle in dispatch_chunks(stp, args.polish,
                                      args.steps_per_dispatch,
                                      args.pipeline_depth):
            _, traces = stp.collect_steps(handle, fetch_image=False)
            logger.info('polish iterate %d loss %.6g', handle.t_end,
                        traces[-1].data['loss'])
        logger.info('polish: %d iters in %.2fs', args.polish,
                    time.perf_counter() - t0)
        if args.trace_csv:
            # The main run's trace goes to --trace-csv, the polish
            # engine's beside it.
            st.write_trace(args.trace_csv)
            logger.info('wrote %s', args.trace_csv)
            polish_csv = str(Path(args.trace_csv).with_suffix('')) \
                + '.polish.csv'
            stp.write_trace(polish_csv)
            logger.info('wrote %s', polish_csv)
            args.trace_csv = None
        total_iterations += stp.t
        st = stp
    elif args.polish:
        logger.info('polish skipped: --polish-precision %s does not raise '
                    '--precision %s', args.polish_precision, args.precision)

    return st, total_iterations


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format='%(asctime)s.%(msecs)03d %(process)d %(name)s %(levelname)s: '
               '%(message)s', datefmt='%H:%M:%S')
    ignored = [flag for flag, on in (('--pallas', args.pallas),
                                     ('--platform', args.platform),
                                     ('--prewarm-ladder', args.prewarm_ladder))
               if on]
    if ignored:
        logger.info('%s mean nothing here: ignored (the device is --device '
                    '%s)', ', '.join(ignored), args.device)
    if args.batch:
        return run_batch(args)

    from .engine import load_checkpoint, save_checkpoint
    st, inputs, target_hw = setup(args)
    device = st.device
    logger.info('device: %s%s', device,
                ' (%s)' % torch.cuda.get_device_name(device)
                if device.type == 'cuda' else '')
    rng = np.random.RandomState(args.seed)

    ladder = (im.scales(target_hw, min_size=args.min_scale)
              if args.multi_scale else [target_hw])
    if st.placement is not None:
        # Snap every rung to a mesh-divisible grid: an awkward aspect
        # would otherwise replicate at the sizes sharding exists for. The
        # content squashes by less than one shard's worth of pixels.
        snapped = []
        for hw in ladder:
            s = st.placement.snap_hw(hw)
            if s != hw:
                logger.info('snapped %dx%d -> %dx%d for the %d-way mesh',
                            *hw, *s, st.placement.n_shards)
            if s not in snapped:
                snapped.append(s)
        ladder = snapped
    if args.resume:
        load_checkpoint(st, args.resume)
        logger.info('resumed from %s at iterate %d, %dx%d', args.resume,
                    st.t, *st.input_hw)
        # Continue the ladder from the restored resolution upward.
        ladder = [hw for hw in ladder if hw > st.input_hw]

    total_t0 = time.perf_counter()
    # --profile traces the span the JAX CLI traces: the rungs, the polish
    # and the final image.
    with (device_trace(args.profile, device) if args.profile
          else contextlib.nullcontext()) as trace_path:
        st, total_iterations = optimize(args, st, inputs, ladder, rng)
        im.as_pil(st.snapshot()).save(args.output)
        logger.info('wrote %s after %d iterations in %.1fs', args.output,
                    total_iterations, time.perf_counter() - total_t0)
    if args.profile:
        logger.info('profiler trace written to %s', trace_path)
    if args.trace_csv:
        st.write_trace(args.trace_csv)
        logger.info('wrote %s', args.trace_csv)
    if args.checkpoint:
        save_checkpoint(st, args.checkpoint)
        logger.info('checkpoint saved to %s', args.checkpoint)
    return 0


if __name__ == '__main__':
    sys.exit(main())
