#!/usr/bin/env python3
"""Video style transfer with the PyTorch/CUDA port
(style_transfer2_tpu/video.py): per-frame warm-started optimization with a
temporal-consistency term.

Each frame re-uses the previous frame's stylized result twice: as the warm
start of the iterate (so far fewer iterations converge) and as the target
of a temporal-consistency term tw * mean(((x - prev)/255)^2) added to the
objective (engine/objective.py), which damps frame-to-frame flicker. The
first frame runs a full optimization from a random start.

Frame I/O is a directory of numbered images in, a directory of PNGs out.

Example:
  python -m style_transfer2_tpu_torch.video frames/ style.jpg out/ \\
      --size 512 --first-iterations 150 --iterations 40 --temporal 1000

--device cuda (the default) runs the hand-written kernels on the card and
raises if CUDA is not available; --device cpu runs their plain PyTorch
versions. --pallas and --platform are logged and ignored.
"""

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from . import utils as im
from .ops.image import preprocess_on_device

logger = logging.getLogger('video')

ROOT_DIR = Path(__file__).resolve().parents[1]

IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.bmp', '.webp')


class VideoStylizer:
    """Drives a StyleTransfer engine across a frame sequence, pipelined:

      * one begin_steps chunk per frame (video has no mid-run control to
        stay responsive to);
      * the previous frame's stylized result chains on the device into the
        next frame's warm start and temporal target (a clamp to [0, 255]
        and the preprocess kernel enqueued on the chunk's end image, with
        no host round trip in the chain);
      * begin_frame enqueues everything and returns at once, so the host
        collects earlier frames and writes their PNGs while the device
        works on later ones (collect_frame, collect_frames).

    stylize_frame() is the serial API."""

    def __init__(self, params, weights, scalar_params, optimizer='lbfgs',
                 step_size=None, first_iterations=150, iterations=40,
                 temporal_weight=1000.0, precision='float32', seed=0,
                 steps_per_dispatch=20, use_pallas=False, device='cuda'):
        """The JAX VideoStylizer's arguments, and device ('cuda' or 'cpu').
        steps_per_dispatch and use_pallas are accepted and unused: each
        frame is one chunk, and the kernels are always on."""
        from .engine import StyleTransfer
        from .optim import STEP_SIZES
        self.st = StyleTransfer(params, precision=precision, device=device)
        self.st.set_weights(weights, scalar_params)
        self.st.set_optimizer(optimizer)
        self.st.set_step_size(step_size if step_size is not None
                              else STEP_SIZES[optimizer])
        self.first_iterations = first_iterations
        self.iterations = iterations
        self.temporal_weight = float(temporal_weight)
        self.rng = np.random.RandomState(seed)
        self.prev_stylized = None
        self._prev_pre = None    # (warm start, temporal target) on the device

    def set_style(self, style_image):
        self.st.set_style(style_image)

    def begin_frame(self, frame):
        """Enqueues the whole stylization of one HxWx3 uint8 frame without
        blocking: the content upload and forward, the warm start and
        temporal target from the (possibly still running) previous frame,
        and the frame's steps. Returns a handle for collect_frame; collect
        handles in order."""
        st = self.st
        st.set_content(frame)
        if self._prev_pre is None:
            init = self.rng.uniform(0, 255, frame.shape).astype(np.uint8)
            st.set_input(init)
            n = self.first_iterations
        else:
            pre, target = self._prev_pre
            st.set_input(pre, preprocessed=True)
            st.set_temporal(target, self.temporal_weight, preprocessed=True)
            n = self.iterations
        st.is_starting = True
        st._start()
        if not st.is_running:
            raise RuntimeError('engine failed to start')
        dispatch = st.begin_steps(n)
        self._prev_pre = self._prepare(dispatch.image)
        return dispatch

    @staticmethod
    def _prepare(image):
        """The next frame's (warm start, temporal target) from a stylized
        (H, W, 3) float32 image on the device: clipped to [0, 255] as the
        serial path's PNG would be, mean subtracted, and the same values in
        two tensors, so that no write to the iterate can reach the
        target."""
        pre = preprocess_on_device(torch.clamp(image, 0, 255))
        return pre, pre.clone()

    def seed_from(self, stylized_image):
        """Resume: seeds the warm-start and temporal chain from a previously
        stylized frame (the last PNG an interrupted run wrote), as if it
        had just been collected, so the next begin_frame takes the temporal
        branch. The PNG's uint8 rounding (at most half a level) is well
        under the frame-to-frame motion the temporal term absorbs."""
        image = torch.as_tensor(
            np.ascontiguousarray(stylized_image, np.float32),
            device=self.st.device)
        self._prev_pre = self._prepare(image)
        self.prev_stylized = np.float32(stylized_image)

    def collect_frame(self, dispatch):
        """Waits for a begin_frame handle; returns (stylized HxWx3 float32
        array, last trace dict)."""
        image, traces = self.st.collect_steps(dispatch, fetch_image=True)
        self.prev_stylized = image
        return image, traces[-1].data

    def collect_frames(self, dispatches):
        """Waits for several begin_frame handles with one host copy of
        their traces and one of their images (collect_steps_many). Returns
        [(image, last trace dict), ...]."""
        out = []
        for image, traces in self.st.collect_steps_many(dispatches,
                                                        fetch_image=True):
            self.prev_stylized = image
            out.append((image, traces[-1].data))
        return out

    def stylize_frame(self, frame):
        """Serial API: stylizes one frame and waits for its result."""
        return self.collect_frame(self.begin_frame(frame))


def list_frames(path):
    path = Path(path)
    frames = sorted(p for p in path.iterdir()
                    if p.suffix.lower() in IMAGE_EXTS)
    if not frames:
        raise FileNotFoundError('no frames found under %s' % path)
    return frames


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('frames', help='directory of input frames')
    p.add_argument('style', help='style image path')
    p.add_argument('output', help='output directory')
    p.add_argument('--size', type=int, default=512)
    p.add_argument('--style-size', type=int, default=None)
    p.add_argument('--first-iterations', type=int, default=150,
                   help='iterations for the first frame')
    p.add_argument('--iterations', '-i', type=int, default=40,
                   help='iterations per subsequent frame')
    p.add_argument('--temporal', type=float, default=1000.0,
                   help='temporal-consistency loss weight')
    p.add_argument('--optimizer', choices=('adam', 'lbfgs'), default='lbfgs')
    p.add_argument('--step-size', type=float, default=None)
    p.add_argument('--weights', default=None,
                   help='loss-weights YAML (initial_weights.yaml format)')
    p.add_argument('--model-weights', default='auto',
                   help="VGG-19 weights: 'auto', 'random', or a path")
    p.add_argument('--precision',
                   choices=('float32', 'float32_fast', 'bfloat16'),
                   default='float32')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (hand-written kernels; raises without a "
                        "GPU) or 'cpu' (their plain PyTorch versions)")
    p.add_argument('--platform', default='',
                   help='ignored (the JAX backend); see --device')
    p.add_argument('--steps-per-dispatch', type=int, default=20,
                   help='accepted; each frame is one chunk')
    p.add_argument('--resume', action='store_true',
                   help='skip frames whose stylized output already exists '
                        '(contiguous prefix) and continue the temporal '
                        'chain from the last written frame')
    p.add_argument('--pallas', action='store_true',
                   help='ignored: the kernels are always on')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--debug', '-d', action='count', default=0)
    return p.parse_args(argv)


def main(argv=None, on_frame=None):
    """The video CLI. on_frame(stylizer, index), where given, is called
    after each frame's work is enqueued (begin_frame), before anything of
    it is collected."""
    args = parse_args(argv)
    im.setup_logging(args.debug)
    if args.pallas or args.platform:
        logger.info('--pallas and --platform mean nothing here: ignored '
                    '(the device is --device %s)', args.device)

    from .cli import load_weights_doc
    from .engine import resolve_device
    from .models.weights import resolve_params

    device = resolve_device(args.device)
    params = resolve_params(args.model_weights, ROOT_DIR)
    weights, scalar_params = load_weights_doc(args.weights)

    stylizer = VideoStylizer(
        params, weights, scalar_params, optimizer=args.optimizer,
        step_size=args.step_size, first_iterations=args.first_iterations,
        iterations=args.iterations, temporal_weight=args.temporal,
        precision=args.precision, seed=args.seed,
        steps_per_dispatch=args.steps_per_dispatch, device=device)

    with Image.open(args.style) as img:
        style = np.uint8(im.resize_to_fit(img.convert('RGB'),
                                          args.style_size or args.size))
    stylizer.set_style(style)

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = list_frames(args.frames)
    logger.info('%d frames -> %s', len(frames), out_dir)

    def load_frame(path, size_wh):
        with Image.open(path) as img:
            img = img.convert('RGB')
            if size_wh is None:
                size_wh = im.fit_into_square(img.size, args.size,
                                             scale_up=True)
            return np.uint8(img.resize(size_wh, Image.LANCZOS)), size_wh

    # Pipelined loop: later frames' device work is enqueued before earlier
    # frames' pixels are fetched, so PNG writes and frame loads overlap the
    # device's work, and frames are collected in threes (collect_frames).
    size_wh = None
    start_idx = 0
    if args.resume:
        # The contiguous prefix of existing outputs is done; the chain
        # reseeds from the last of them (a gap would break the chain).
        while (start_idx < len(frames) and
               (out_dir / ('%s_stylized.png'
                           % frames[start_idx].stem)).exists()):
            start_idx += 1
        prev = None
        while start_idx:
            # An interruption can leave the last file half-written: walk
            # back until one loads.
            last = out_dir / ('%s_stylized.png' % frames[start_idx - 1].stem)
            try:
                with Image.open(last) as img:
                    prev = np.uint8(img.convert('RGB'))
                break
            except Exception:
                logger.warning('resume: %s is corrupt; redoing it',
                               last.name)
                start_idx -= 1
        if start_idx:
            size_wh = (prev.shape[1], prev.shape[0])
            stylizer.seed_from(prev)
            logger.info('resume: %d frame(s) already stylized; chain '
                        'reseeded from %s', start_idx, last.name)
        if start_idx >= len(frames):
            logger.info('resume: all %d frames already stylized',
                        len(frames))
            return 0

    t0 = time.perf_counter()
    t_first = None
    pending = []  # (dispatch, out_path, index)
    collect_batch = 3

    def drain(batch):
        nonlocal t_first
        results = stylizer.collect_frames([d for d, _, _ in batch])
        for (d, path0, i0), (image, trace) in zip(batch, results):
            im.as_pil(image).save(path0)
            logger.info('frame %d/%d -> %s (loss %.5g)', i0 + 1,
                        len(frames), path0.name, trace['loss'])
            if i0 == 0:
                t_first = time.perf_counter() - t0

    for idx, frame_path in enumerate(frames):
        if idx < start_idx:
            continue
        frame, size_wh = load_frame(frame_path, size_wh)
        dispatch = stylizer.begin_frame(frame)
        if on_frame is not None:
            on_frame(stylizer, idx)
        pending.append(
            (dispatch, out_dir / ('%s_stylized.png' % frame_path.stem), idx))
        if len(pending) > collect_batch:   # keep the newest in flight
            batch, pending = pending[:collect_batch], pending[collect_batch:]
            drain(batch)
    if pending:
        drain(pending)
    dt = time.perf_counter() - t0
    n_done = len(frames) - start_idx
    if t_first is not None:
        steady = (dt - t_first) / max(n_done - 1, 1)
        logger.info('stylized %d frames in %.1fs (first frame %.1fs, '
                    '%.2f s/frame steady-state)', n_done, dt, t_first,
                    steady)
    else:
        # A resumed run has no first frame to subtract: the plain average.
        logger.info('stylized %d resumed frames in %.1fs (%.2f s/frame)',
                    n_done, dt, dt / max(n_done, 1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
