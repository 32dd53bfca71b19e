"""The StyleTransfer state machine (style_transfer2_tpu/engine/transfer.py;
reference worker.py:117-315): host orchestration over device state.

The same image-slot lifecycle (input/content/style), start gating, reset
semantics, warm-started resolution changes and per-step traces as the JAX
engine. The tensors live on one explicit device: 'cuda' runs the
hand-written kernels, 'cpu' their plain versions. The first-eval norm cache
is 0-d tensors threaded through each step. step() brings its trace to the
host in one transfer; begin_steps() enqueues a K-step chunk with no host
read-back at all, and collect_steps() brings the chunk's traces over in one
transfer (collect_steps_many: several chunks' in one). step(),
begin_steps() and the L-BFGS prime run through engine/steps.py
build_scan_fn: on the card, from each key's second step on, replays of a
captured CUDA graph of one step (engine/graphs.py), whose static buffers
then hold the optimizer state and the norms (copy what must outlive the
next step); on the CPU the eager loop. set_temporal() adds the video
temporal-consistency term toward a previous frame. Each engine holds its
precision mode's TF32 switches only around the device work it launches
(engine/steps.py precision_scope), so engines of different precisions can
share a process.

placement: a parallel.SpatialPlacement shards the iterate, the content,
their features and the optimizer state over a mesh axis (the JAX engine's
_place_image, _place_state and _place_replicated); the Grams, norms and
trace scalars live on the mesh's first device, and the images and `input`
are gathered there. Every step is then the same step over Sharded arrays
(parallel/spatial.py), with the same one host sync a chunk, and on the
card the same graphs: one capture over the placement's cards, each shard's
static buffers on its own device (engine/graphs.py).
"""

import csv
import time

import numpy as np
import torch

from ..models import vgg19
from ..models.weights import params_from_numpy
from ..ops.gram import gram_matrix
from ..ops.image import deprocess_on_device
from ..ops.resample import resize_nhwc
from ..optim import OPTIMIZERS, STEP_SIZES, lbfgs
from ..parallel.spatial import gather, gather_tree
from ..utils import Trace
from ..utils.profiling import RECORDER
from .objective import (
    LOSS_NAMES,
    SCALAR_LOSS_NAMES,
    ObjectiveSpec,
    content_store_dtype,
    scalars_to_arrays,
    weights_to_arrays,
)
from .graphs import CudaGraphs, StepGraphs, tally, tally_since
from .steps import build_scan_fn, precision_config, precision_scope


def _to_host(parts):
    """1-D device tensors as one host numpy array, in one copy, which
    waits for the work that writes them (span 'engine.collect.wait')."""
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    with RECORDER.span('engine.collect.wait'):
        return flat.cpu().numpy()


def resolve_device(device):
    """torch.device for 'cuda' or 'cpu'. Raises when CUDA is asked for and
    not available: the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('device %s requested, but CUDA is not '
                               'available (use --device cpu for the plain '
                               'PyTorch path)' % device)
    elif device.type != 'cpu':
        raise ValueError('unsupported device %s' % device)
    return device


class StepsDispatch:
    """Handle for an enqueued begin_steps chunk: its per-step trace scalars
    as one (n_steps, n_keys) device tensor, the deprocessed iterate at the
    chunk's end as a fresh device tensor (later chunks in flight never
    touch it), and what labels them at collect.

    prime is (spec, trace tensor) of the stale L-BFGS cache's evaluation
    run at the head of the chunk. It rides the handle, so with several
    chunks in flight each prime trace lands at its own chunk's collect,
    just before that chunk's steps (JAX engine/steps.py:201-206)."""

    __slots__ = ('spec', 'traces', 'n_steps', 't_end', 'image', 'prime')

    def __init__(self, spec, traces, n_steps, t_end, image, prime=None):
        self.spec = spec
        self.traces = traces
        self.n_steps = n_steps
        self.t_end = t_end
        self.image = image
        self.prime = prime


class StyleTransfer:
    """Image stylization by minimizing the objective with an optimizer
    state dict. API of reference worker.py:117-315."""

    def __init__(self, params, precision='float32', n_corr=10,
                 device='cuda', remat=False, placement=None):
        """params: the JAX package's params dict of HWIO numpy arrays
        (models.weights). precision: 'float32', 'float32_fast' or
        'bfloat16'; its TF32 switches hold inside this engine's device work
        only (engine/steps.py precision_scope). device: 'cuda' or 'cpu'.
        remat: the backward's rematerialization policy, False, True/'conv'
        or 'block' (models/vgg19.py), fixed for the engine's life; it
        trades memory for a second forward and changes no value.
        placement: None, or a parallel.SpatialPlacement (module docstring)
        over devices of device's type; the engine's own device is then the
        mesh's first."""
        self.placement = placement
        if placement is None:
            self.device = resolve_device(device)
        else:
            for d in placement.devices:
                resolve_device(d)
            if placement.device.type != torch.device(device).type:
                raise ValueError('placement over %s devices for an engine '
                                 'on %s' % (placement.device.type, device))
            self.device = placement.device
        self.precision = precision
        self.compute_dtype = precision_config(precision)[0]
        self.n_corr = n_corr
        self.remat = remat
        self.model = vgg19.VGG19Features(
            params_from_numpy(params, self.device), self.compute_dtype,
            remat)

        self.is_running = False
        self.is_starting = False
        self.t = 0
        self._input = None          # (1, H, W, 3) float32
        self.content = None         # (1, H, W, 3) float32
        # Content features for the current objective's content layers only,
        # recomputed from self.content when the objective needs more.
        self.features = None
        self.grams = None           # blob -> (c, c)
        self.temporal_target = None  # (1, H, W, 3) previous frame (video)

        # Until SetWeights arrives the reference weights every (layer, loss)
        # at 1 (worker.py:130-133).
        self.weights = {name: {layer: 1.0 for layer in vgg19.BLOB_NAMES}
                        for name in LOSS_NAMES}
        self.scalar_params = {name: 1.0 for name in SCALAR_LOSS_NAMES}

        self.optimizer_name = 'lbfgs'
        self.step_size = STEP_SIZES['lbfgs']
        self.opt_state = None
        self._needs_init = False    # L-BFGS (loss, grad) cache unprimed

        # First-eval gradient-RMS norms, kept across weight and size
        # changes, cleared only by reset (worker.py:137,172-175).
        self.norm_vals = {}
        self.norm_set = {}

        self.traces = []
        self._weights_cache = None   # (spec, layer_weights, scalars)
        # The captured steps on the card (engine/graphs.py), over every
        # card of the placement; eager on the CPU.
        self._graphs = StepGraphs(
            CudaGraphs(self.device, () if placement is None
                       else placement.devices)
            if self.device.type == 'cuda' else None)

    # -- properties ---------------------------------------------------------

    @property
    def input(self):
        """The iterate, (1, H, W, 3) float32 (after a step on the card, a
        static buffer of the step's graph: clone what must outlive the
        next step; under a placement, gathered on the first device)."""
        return gather(self._input)

    @property
    def input_hw(self):
        return None if self._input is None else tuple(self._input.shape[1:3])

    def layers(self):
        """The model's blob names, which a weights document may name."""
        return list(vgg19.BLOB_NAMES)

    def spec(self):
        return ObjectiveSpec.from_weights(self.weights, self.scalar_params)

    def _tensor(self, value):
        return torch.as_tensor(value, device=self.device)

    def _place_image(self, x):
        return x if self.placement is None else self.placement.image(x)

    def _place_state(self, tree):
        return tree if self.placement is None else self.placement.state(tree)

    def _image_tensor(self, image):
        """A (1, H, W, 3) float32 mean-subtracted image (a tensor, or a
        Sharded one) as a tensor on this engine's device."""
        return torch.as_tensor(gather(image), dtype=torch.float32,
                               device=self.device)

    def _zeros_image(self, size):
        return self._place_image(torch.zeros(
            (1,) + size + (3,), dtype=torch.float32, device=self.device))

    # -- state machine (reference worker.py:140-229) -------------------------

    def check_consistency(self):
        return bool(self._input is not None and self.content is not None
                    and self.grams
                    and self._input.shape == self.content.shape)

    def objective_changed(self):
        if self.opt_state is not None:
            mod = OPTIMIZERS[self.optimizer_name]
            self.opt_state = mod.objective_changed(self.opt_state)
            if self.optimizer_name == 'lbfgs':
                self._needs_init = True

    def pause(self):
        self.is_running = False
        self.is_starting = False

    def _warm_start(self, size, new_x=None):
        """Moves the optimizer state to a new grid: the iterate resized to
        size, or new_x, with the state cleared. An L-BFGS history keeps
        its dtype, as in the JAX engine, except that bfloat16 pairs
        restart in float32 on a grid below lbfgs.BF16_HISTORY_MIN_PIXELS:
        bf16 pairs diverge on small grids (the gate of history_dtype_for),
        and a history carried down from a larger grid, as a serving
        ladder's first rung is after the session's first grid, went to NaN
        within 30 steps on an H100. The old grid's graphs go: a ladder
        never comes back to a rung. Recorded as the span
        'engine.warm_start', the graphs' release inside it."""
        with RECORDER.span('engine.warm_start') as span:
            self._graphs.clear()
            with precision_scope(self.precision):
                state = OPTIMIZERS[self.optimizer_name].resample(
                    gather_tree(self.opt_state), size, new_x=gather(new_x))
            if self.optimizer_name == 'lbfgs':
                if (state['sk'].dtype != torch.float32
                        and lbfgs.history_dtype_for(
                            self.compute_dtype,
                            state['x'].shape[1:3]) is None):
                    state = lbfgs.init(state['x'], state['sk'].shape[0])
                self._needs_init = True
            self.opt_state = state = self._place_state(state)
            self._input = state['x']
            span.attrs['hw'] = tuple(state['x'].shape[1:3])

    def resample_input(self, size):
        """Resizes the iterate to size and warm-starts the optimizer state
        there (reference worker.py:154-160)."""
        size = tuple(int(s) for s in size)
        if self._input is not None and self.opt_state is not None:
            self._warm_start(size)
        else:
            self._input = self._zeros_image(size)
        self._start()
        self.objective_changed()

    def resample_content(self, size):
        """Resizes the stored content image (lanczos3) and recomputes its
        features."""
        size = tuple(int(s) for s in size)
        with precision_scope(self.precision):
            if self.content is not None:
                self.content = self._place_image(resize_nhwc(
                    gather(self.content), size, 'lanczos3'))
            else:
                self.content = self._zeros_image(size)
            self.features = self._content_features()
        self._start()
        self.objective_changed()

    def reset(self):
        RECORDER.new_job()
        self.norm_vals = {}
        self.norm_set = {}
        self.t = 0
        if self._input is None:
            self.opt_state = None
        elif self.optimizer_name == 'lbfgs':
            self.opt_state = lbfgs.init(
                self._input, self.n_corr,
                history_dtype=lbfgs.history_dtype_for(self.compute_dtype,
                                                      self.input_hw))
            self._needs_init = True
        else:
            self.opt_state = OPTIMIZERS[self.optimizer_name].init(self._input)
            self._needs_init = False

    def start(self):
        self.is_starting = True
        self._start()
        return self.is_running

    def _start(self):
        if self.is_starting and self.check_consistency():
            if self.opt_state is None:
                self.reset()
            self.is_starting = False
            self.is_running = True

    def set_input(self, image, preprocessed=False):
        """Sets the optimization iterate from an HxWx3 RGB image, or with
        preprocessed=True from a (1, H, W, 3) float32 mean-subtracted
        tensor. An image of another size warm-starts the optimizer state
        there."""
        if preprocessed:
            image = self._image_tensor(image)
        else:
            image = vgg19.preprocess(image, self.device)
        image = self._place_image(image)
        if self._input is not None and self._input.shape == image.shape:
            self._input = image
            if self.opt_state is not None:
                self.opt_state = dict(self.opt_state, x=image)
            self.objective_changed()
        elif self.opt_state is not None:
            self._warm_start(None, new_x=image)
            self._start()
        else:
            self._input = image
            self.reset()
            self._start()

    def set_content(self, image):
        self.content = self._place_image(vgg19.preprocess(image,
                                                          self.device))
        with precision_scope(self.precision):
            self.features = self._content_features()
        self._start()
        self.objective_changed()

    def _content_features(self, layers=None):
        """Content features for the given blobs (default: the objective's
        content layers), stored in content_store_dtype: bf16 in bfloat16
        mode, so that the loss feed's `feat - content` stays bf16 (one cast
        here, not one a step), float32 otherwise. Recorded as the span
        'engine.content'."""
        if layers is None:
            layers = self.spec().content_layers
        if not layers:
            return {}
        dtype = content_store_dtype(self.compute_dtype)
        with RECORDER.span('engine.content',
                           hw=tuple(self.content.shape[1:3])):
            return {l: f.to(dtype) for l, f in
                    self.model(self.content, tuple(layers)).items()}

    def set_style(self, image):
        """Sets the style image: runs the whole net and keeps the Gram of
        every blob, so a later set_weights that adds a style layer finds
        its target."""
        with precision_scope(self.precision):
            features = self.model(self._place_image(
                vgg19.preprocess(image, self.device)))
            self.grams = {layer: gram_matrix(feat)
                          for layer, feat in features.items()}
        self._start()
        self.objective_changed()

    def set_optimizer(self, name):
        """Swaps the optimizer; the caller decides whether to reset
        (worker.py:387-391)."""
        if name not in OPTIMIZERS:
            raise ValueError('Invalid optimizer type: %r' % (name,))
        self.optimizer_name = name

    def set_step_size(self, step_size):
        self.step_size = float(step_size)

    def set_weights(self, weights, params):
        """Sets the loss weights and the scalar params; a temporal weight
        set by set_temporal stays unless params names its own."""
        self.weights = {name: dict(weights.get(name, {}))
                        for name in LOSS_NAMES}
        temporal = self.scalar_params.get('temporal')
        self.scalar_params = dict(params)
        if temporal and 'temporal' not in self.scalar_params:
            self.scalar_params['temporal'] = temporal
        self._weights_cache = None
        self.objective_changed()

    def set_temporal(self, image, weight, preprocessed=False):
        """Enables the video temporal-consistency term toward a previous
        stylized frame: an HxWx3 RGB image, or with preprocessed=True a
        (1, H, W, 3) float32 mean-subtracted tensor, kept as it is given
        (the caller hands over a tensor no one else writes). The weight
        cache is cleared, since from the second frame on the spec does not
        change while the weight may."""
        if preprocessed:
            target = self._image_tensor(image)
        else:
            target = vgg19.preprocess(image, self.device)
        self.temporal_target = self._place_image(target)
        self.scalar_params['temporal'] = float(weight)
        self._weights_cache = None
        self.objective_changed()

    def clear_temporal(self):
        if self.scalar_params.pop('temporal', None) is not None:
            self._weights_cache = None
            self.objective_changed()
        self.temporal_target = None

    def seed_norms(self, vals, set_):
        """Seeds first-eval norm state from host values (key -> float, key
        -> bool), as 0-d tensors on this engine's device: a respawned engine
        continues the normalized objective its session was anchored at."""
        self.norm_vals.update({k: self._tensor(np.float32(v))
                               for k, v in vals.items()})
        self.norm_set.update({k: self._tensor(np.bool_(bool(v)))
                              for k, v in set_.items()})

    # -- stepping -------------------------------------------------------------

    def _gather_inputs(self, spec):
        if self._weights_cache is None or self._weights_cache[0] != spec:
            layer_weights = {l: self._tensor(v) for l, v in
                             weights_to_arrays(self.weights, spec).items()}
            scalars = {k: self._tensor(v) for k, v in
                       scalars_to_arrays(self.scalar_params).items()}
            self._weights_cache = (spec, layer_weights, scalars)
        _, layer_weights, scalars = self._weights_cache

        # Fresh norms are (0, unset): filled on the device, no host copy.
        norms_vals, norms_set = {}, {}
        for key in spec.norm_keys:
            if key in self.norm_vals:
                norms_vals[key] = self.norm_vals[key]
                norms_set[key] = self.norm_set[key]
            else:
                norms_vals[key] = torch.zeros((), dtype=torch.float32,
                                              device=self.device)
                norms_set[key] = torch.zeros((), dtype=torch.bool,
                                             device=self.device)
        missing = [l for l in spec.content_layers if l not in self.features]
        if missing:
            # A weight-structure change added content layers; their
            # features are a pure function of the stored content image.
            self.features.update(self._content_features(spec.content_layers))
        inputs = {
            'content_feats': {l: self.features[l]
                              for l in spec.content_layers},
            'grams': {l: self.grams[l] for l in spec.style_layers},
            'layer_weights': layer_weights,
            'scalars': scalars,
            'norms_vals': norms_vals,
            'norms_set': norms_set,
        }
        if spec.temporal:
            if (self.temporal_target is None
                    or self.temporal_target.shape != self._input.shape):
                raise ValueError('temporal loss enabled but no matching '
                                 'temporal target set (set_temporal)')
            inputs['temporal_target'] = self.temporal_target
        return inputs

    def _absorb_norms(self, spec, norms):
        norms_vals, norms_set = norms
        for key in spec.norm_keys:
            self.norm_vals[key] = norms_vals[key]
            self.norm_set[key] = norms_set[key]

    def _record_trace(self, spec, values, now):
        trace = Trace()
        for key, value in zip(spec.trace_keys, values):
            if key == 'loss':
                trace('time', now)
            trace(key, value)
        self.traces.append(trace)
        return trace

    def _scan(self, spec, n_steps):
        """n_steps iterations (after the prime when the L-BFGS cache is
        stale) through build_scan_fn and this engine's graphs. Returns
        (rows, prime row or None) as device tensors."""
        primed = self._needs_init and self.optimizer_name == 'lbfgs'
        scan_fn = build_scan_fn(spec, self.optimizer_name, primed)
        self.opt_state, norms, rows, prime_row = scan_fn(
            self.model, self.opt_state, self._gather_inputs(spec),
            self.step_size, n_steps, self._graphs)
        self._input = self.opt_state['x']
        self._absorb_norms(spec, norms)
        if primed:
            self._needs_init = False
        return rows, prime_row

    def step(self, fetch_image=True):
        """Runs one optimizer iteration. Returns (deprocessed HxWx3 float32
        RGB image or None, trace dict) like reference worker.py:303-310."""
        self.t += 1
        spec = self.spec()
        with precision_scope(self.precision):
            rows, prime_row = self._scan(spec, 1)
        # Each trace comes to the host in one transfer (.tolist()); the
        # priming evaluation's trace is kept too.
        if prime_row is not None:
            self._record_trace(spec, prime_row.tolist(), time.perf_counter())
        trace = self._record_trace(spec, rows[0].tolist(),
                                   time.perf_counter())
        trace('fevals', self.t)
        image = self.snapshot() if fetch_image else None
        return image, trace.data

    def begin_steps(self, n_steps):
        """Enqueues n_steps iterations with the weights and step size fixed
        and returns at once: nothing is read back to the host, so a later
        begin_steps queues behind this one on the device while the host
        collects an earlier chunk. A stale L-BFGS cache primes at the head
        of the chunk. Returns a StepsDispatch; collect handles in dispatch
        order. Recorded as the span 'engine.begin', with the chunk's
        replays, warm-ups, captures and replay host ns (graphs.tally)."""
        if n_steps < 1:
            raise ValueError('begin_steps needs at least one step')
        with RECORDER.span('engine.begin', steps=n_steps) as span:
            before = tally()
            spec = self.spec()
            with precision_scope(self.precision):
                rows, prime_row = self._scan(spec, n_steps)
                image = deprocess_on_device(gather(self._input))
            span.attrs.update(primed=prime_row is not None,
                              **tally_since(before))
        self.t += n_steps
        prime = None if prime_row is None else (spec, prime_row)
        return StepsDispatch(spec, rows, n_steps, self.t, image, prime)

    def collect_steps(self, dispatch, fetch_image=True):
        """Waits for a begin_steps chunk and records its traces: the prime
        trace first if the chunk primed, then one per iteration, all brought
        to the host in one transfer and stamped with the collect time.
        Returns (the chunk's end image as HxWx3 float32 numpy, or None; the
        chunk's step traces)."""
        return self.collect_steps_many([dispatch], fetch_image)[0]

    def collect_steps_many(self, dispatches, fetch_image=True):
        """collect_steps over several begin_steps handles of this engine,
        in dispatch order, with one device-to-host copy for all their trace
        rows (prime traces included; the chunks' specs, and so their row
        widths, may differ) and one for all their images. Each prime trace
        is recorded just before its own chunk's steps. Returns [(image or
        None, traces), ...]. Recorded as the span 'engine.collect', the
        copies' waits inside it (_to_host)."""
        with RECORDER.span('engine.collect', chunks=len(dispatches)):
            return self._collect_many(dispatches, fetch_image)

    def _collect_many(self, dispatches, fetch_image):
        parts = []
        for dispatch in dispatches:
            if dispatch.prime is not None:
                parts.append(dispatch.prime[1])
            parts.append(dispatch.traces.reshape(-1))
        flat = _to_host(parts)
        images = [None] * len(dispatches)
        if fetch_image:
            pixels = _to_host([d.image.reshape(-1) for d in dispatches])
            ends = np.cumsum([d.image.numel() for d in dispatches])
            images = [part.reshape(d.image.shape) for d, part in
                      zip(dispatches, np.split(pixels, ends[:-1]))]
        now = time.perf_counter()
        out, start = [], 0
        for dispatch, image in zip(dispatches, images):
            if dispatch.prime is not None:
                width = dispatch.prime[1].numel()
                self._record_trace(dispatch.prime[0],
                                   flat[start:start + width].tolist(), now)
                start += width
                dispatch.prime = None
            n_rows, width = dispatch.traces.shape
            rows = flat[start:start + n_rows * width].reshape(n_rows, width)
            start += n_rows * width
            traces = []
            for i, row in enumerate(rows.tolist()):
                trace = self._record_trace(dispatch.spec, row, now)
                trace('fevals', dispatch.t_end - dispatch.n_steps + 1 + i)
                traces.append(trace)
            out.append((image, traces))
        return out

    def run_steps(self, n_steps, fetch_image=True):
        """Runs n_steps iterations as one chunk with the weights and step
        size fixed. Appends one trace per iteration; returns (image or None,
        last trace dict)."""
        image, traces = self.collect_steps(self.begin_steps(n_steps),
                                           fetch_image)
        return image, traces[-1].data

    def snapshot(self):
        """The current iterate as a deprocessed HxWx3 float32 RGB array."""
        return vgg19.deprocess(gather(self._input))

    def write_trace(self, filename):
        """Writes the trace history as CSV, one row per trace with a 'step'
        index column (worker.py:312-315). An uncollected chunk's traces are
        not part of the history yet."""
        keys = []
        for trace in self.traces:
            keys += [k for k in trace.data if k not in keys]
        with open(filename, 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(['step'] + keys)
            for i, trace in enumerate(self.traces):
                writer.writerow([i] + [trace.data.get(k, '') for k in keys])
