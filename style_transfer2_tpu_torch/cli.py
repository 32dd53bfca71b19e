#!/usr/bin/env python3
"""Command-line style transfer with the PyTorch/CUDA port: the single-image
path of style_transfer2_tpu/cli.py. Single-scale runs, the coarse-to-fine
sqrt(2) ladder with warm-started optimizer state (--multi-scale), a
full-precision polish tail (--polish), K-step chunks kept --pipeline-depth
deep, in-progress snapshots, checkpoint/resume and the trace CSV.

Example:
  python -m style_transfer2_tpu_torch.cli content.jpg style.jpg -o out.png \\
      --size 1024 --multi-scale --iterations 150 --precision bfloat16 \\
      --polish 50

--device cuda (the default) runs the hand-written kernels on the card and
raises if CUDA is not available; --device cpu runs their plain PyTorch
versions. Not ported yet: --batch, --mesh, --data-mesh, --remat,
--prewarm-ladder, --pallas (the kernels are always on), --profile and
--platform.
"""

import argparse
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


def build_engine(args, inputs, precision, device):
    """An engine at the given precision with the objective, optimizer and
    style image set."""
    from .engine import StyleTransfer
    from .optim import STEP_SIZES
    params, (weights, scalar_params), _, style_np = inputs
    st = StyleTransfer(params, precision=precision, device=device)
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


def setup(args):
    """For parsed CLI args: an engine at --precision on --device with the
    objective, optimizer and style set (not started), the inputs of
    load_inputs, and the (h, w) grid of the full --size."""
    from .engine import resolve_device
    device = resolve_device(args.device)
    inputs = load_inputs(args)
    st = build_engine(args, inputs, args.precision, device)
    wh = im.fit_into_square(inputs[2].size, args.size, scale_up=True)
    return st, inputs, (wh[1], wh[0])


def dispatch_chunks(st, iterations, chunk, depth):
    """Enqueues `iterations` steps in chunks of at most `chunk`, keeping up
    to `depth` chunks in flight, and yields each handle in dispatch order
    for the caller to collect; the next chunk is enqueued before the
    collect of the one yielded, so the device never waits on the host's
    read-back. The chunk plan is fixed up front."""
    handles = deque()
    remaining = iterations
    while remaining > 0 or handles:
        while remaining > 0 and len(handles) < max(1, depth):
            n = min(chunk, remaining)
            handles.append(st.begin_steps(n))
            remaining -= n
        yield handles.popleft()


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format='%(asctime)s.%(msecs)03d %(process)d %(name)s %(levelname)s: '
               '%(message)s', datefmt='%H:%M:%S')

    from .engine import load_checkpoint, save_checkpoint
    st, inputs, target_hw = setup(args)
    device, content_pil = st.device, inputs[2]
    logger.info('device: %s%s', device,
                ' (%s)' % torch.cuda.get_device_name(device)
                if device.type == 'cuda' else '')
    rng = np.random.RandomState(args.seed)

    ladder = (im.scales(target_hw, min_size=args.min_scale)
              if args.multi_scale else [target_hw])
    if args.resume:
        load_checkpoint(st, args.resume)
        logger.info('resumed from %s at iterate %d, %dx%d', args.resume,
                    st.t, *st.input_hw)
        # Continue the ladder from the restored resolution upward.
        ladder = [hw for hw in ladder if hw > st.input_hw]

    total_t0 = time.perf_counter()
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
        stp = build_engine(args, inputs, args.polish_precision, device)
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

    im.as_pil(st.snapshot()).save(args.output)
    logger.info('wrote %s after %d iterations in %.1fs', args.output,
                total_iterations, time.perf_counter() - total_t0)
    if args.trace_csv:
        st.write_trace(args.trace_csv)
        logger.info('wrote %s', args.trace_csv)
    if args.checkpoint:
        save_checkpoint(st, args.checkpoint)
        logger.info('checkpoint saved to %s', args.checkpoint)
    return 0


if __name__ == '__main__':
    sys.exit(main())
