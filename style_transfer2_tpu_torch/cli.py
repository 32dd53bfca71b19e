#!/usr/bin/env python3
"""Command-line style transfer with the PyTorch/CUDA port: one image at one
scale (the single-scale path of style_transfer2_tpu/cli.py).

Example:
  python -m style_transfer2_tpu_torch.cli content.jpg style.jpg -o out.png \\
      --size 512 --iterations 200 --optimizer lbfgs --precision bfloat16

--device cuda (the default) runs the hand-written kernels on the card and
raises if CUDA is not available; --device cpu runs their plain PyTorch
versions. Multi-scale, polish, batch, mesh, checkpoint and resume are not
ported yet.
"""

import argparse
import logging
import sys
import time
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
    p.add_argument('--iterations', '-i', type=int, default=200)
    p.add_argument('--optimizer', choices=('adam', 'lbfgs'), default='lbfgs')
    p.add_argument('--step-size', type=float, default=None,
                   help='optimizer step size (defaults: adam 10, lbfgs 1)')
    p.add_argument('--weights', default=None,
                   help='loss-weights YAML (initial_weights.yaml format)')
    p.add_argument('--model-weights', default='auto',
                   help="VGG-19 weights: 'auto', 'random', or an .npz path")
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
    p.add_argument('--trace-csv', default=None, help='write the trace here')
    p.add_argument('--debug', '-d', action='count', default=0)
    return p.parse_args(argv)


def load_weights_doc(path):
    if path is None:
        path = ROOT_DIR / 'initial_weights.yaml'
    with open(path) as f:
        doc = yaml.safe_load(f)
    return doc[0], doc[1]


def setup(args):
    """Builds and starts the engine for parsed CLI args: weights, objective,
    optimizer, style, content and initial iterate. Returns (engine, (h, w))."""
    from .engine import StyleTransfer, resolve_device
    from .models.weights import resolve_params
    from .optim import STEP_SIZES

    device = resolve_device(args.device)
    logger.info('device: %s%s', device,
                ' (%s)' % torch.cuda.get_device_name(device)
                if device.type == 'cuda' else '')

    params = resolve_params(args.model_weights, ROOT_DIR)
    weights, scalar_params = load_weights_doc(args.weights)
    st = StyleTransfer(params, precision=args.precision, device=device)
    st.set_weights(weights, scalar_params)
    st.set_optimizer(args.optimizer)
    st.set_step_size(args.step_size if args.step_size is not None
                     else STEP_SIZES[args.optimizer])

    with Image.open(args.content) as img:
        content_pil = img.convert('RGB')
    with Image.open(args.style) as img:
        style_pil = img.convert('RGB')
    st.set_style(np.uint8(im.resize_to_fit(style_pil,
                                           args.style_size or args.size)))

    target_wh = im.fit_into_square(content_pil.size, args.size, scale_up=True)
    hw = (target_wh[1], target_wh[0])
    content = np.uint8(content_pil.resize(target_wh, Image.LANCZOS))
    st.set_content(content)
    if args.init == 'random':
        rng = np.random.RandomState(args.seed)
        st.set_input(rng.uniform(0, 255, hw + (3,)).astype(np.uint8))
    else:
        st.set_input(content)
    if not st.start():
        raise RuntimeError('engine failed to start (inconsistent state?)')
    return st, hw


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format='%(asctime)s.%(msecs)03d %(process)d %(name)s %(levelname)s: '
               '%(message)s', datefmt='%H:%M:%S')

    total_t0 = time.perf_counter()
    st, hw = setup(args)
    t0 = time.perf_counter()
    _, trace = st.run_steps(args.iterations, fetch_image=False)
    dt = time.perf_counter() - t0
    logger.info('scale %dx%d: %d iters in %.2fs (%.2f it/s), loss %.6g',
                hw[0], hw[1], args.iterations, dt, args.iterations / dt,
                trace['loss'])

    im.as_pil(st.snapshot()).save(args.output)
    logger.info('wrote %s after %d iterations in %.1fs', args.output, st.t,
                time.perf_counter() - total_t0)
    if args.trace_csv:
        st.write_trace(args.trace_csv)
        logger.info('wrote %s', args.trace_csv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
