"""The StyleTransfer state machine (style_transfer2_tpu/engine/transfer.py;
reference worker.py:117-315): host orchestration over device state.

The same image-slot lifecycle (input/content/style), start gating, reset
semantics, warm-started resolution changes and per-step traces as the JAX
engine. The tensors live on one explicit device: 'cuda' runs the
hand-written kernels, 'cpu' their plain versions. The first-eval norm cache
is 0-d tensors threaded through each step. step() brings its trace to the
host in one transfer; begin_steps() enqueues a K-step chunk with no host
read-back at all, and collect_steps() brings the chunk's traces over in one
transfer. Each engine holds its precision mode's TF32 switches only around
the device work it launches (engine/steps.py precision_scope), so engines
of different precisions can share a process.
"""

import csv
import time

import torch

from ..models import vgg19
from ..models.weights import params_from_numpy
from ..ops.gram import gram_matrix
from ..ops.image import deprocess_on_device
from ..ops.resample import resize_nhwc
from ..optim import OPTIMIZERS, STEP_SIZES, lbfgs
from ..utils import Trace
from .objective import (
    LOSS_NAMES,
    SCALAR_LOSS_NAMES,
    ObjectiveSpec,
    empty_norms,
    scalars_to_arrays,
    weights_to_arrays,
)
from .steps import build_step_core, precision_config, precision_scope


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
                 device='cuda'):
        """params: the JAX package's params dict of HWIO numpy arrays
        (models.weights). precision: 'float32', 'float32_fast' or
        'bfloat16'; its TF32 switches hold inside this engine's device work
        only (engine/steps.py precision_scope). device: 'cuda' or 'cpu'."""
        self.device = resolve_device(device)
        self.precision = precision
        self.compute_dtype = precision_config(precision)[0]
        self.n_corr = n_corr
        self.model = vgg19.VGG19Features(
            params_from_numpy(params, self.device), self.compute_dtype)

        self.is_running = False
        self.is_starting = False
        self.t = 0
        self._input = None          # (1, H, W, 3) float32
        self.content = None         # (1, H, W, 3) float32
        # Content features for the current objective's content layers only,
        # recomputed from self.content when the objective needs more.
        self.features = None
        self.grams = None           # blob -> (c, c)

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

    # -- properties ---------------------------------------------------------

    @property
    def input_hw(self):
        return None if self._input is None else tuple(self._input.shape[1:3])

    def spec(self):
        return ObjectiveSpec.from_weights(self.weights, self.scalar_params)

    def _tensor(self, value):
        return torch.as_tensor(value, device=self.device)

    def _zeros_image(self, size):
        return torch.zeros((1,) + size + (3,), dtype=torch.float32,
                           device=self.device)

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

    def resample_input(self, size):
        """Resizes the iterate to size and warm-starts the optimizer state
        there (reference worker.py:154-160)."""
        size = tuple(int(s) for s in size)
        if self._input is not None and self.opt_state is not None:
            mod = OPTIMIZERS[self.optimizer_name]
            with precision_scope(self.precision):
                self.opt_state = mod.resample(self.opt_state, size)
            self._input = self.opt_state['x']
            if self.optimizer_name == 'lbfgs':
                self._needs_init = True
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
                self.content = resize_nhwc(self.content, size, 'lanczos3')
            else:
                self.content = self._zeros_image(size)
            self.features = self._content_features()
        self._start()
        self.objective_changed()

    def reset(self):
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
            image = torch.as_tensor(image, dtype=torch.float32,
                                    device=self.device)
        else:
            image = vgg19.preprocess(image, self.device)
        if self._input is not None and self._input.shape == image.shape:
            self._input = image
            if self.opt_state is not None:
                self.opt_state = dict(self.opt_state, x=image)
            self.objective_changed()
        elif self.opt_state is not None:
            mod = OPTIMIZERS[self.optimizer_name]
            with precision_scope(self.precision):
                self.opt_state = mod.resample(self.opt_state, None,
                                              new_x=image)
            self._input = self.opt_state['x']
            if self.optimizer_name == 'lbfgs':
                self._needs_init = True
            self._start()
        else:
            self._input = image
            self.reset()
            self._start()

    def set_content(self, image):
        self.content = vgg19.preprocess(image, self.device)
        with precision_scope(self.precision):
            self.features = self._content_features()
        self._start()
        self.objective_changed()

    def _content_features(self, layers=None):
        """Content features for the given blobs (default: the objective's
        content layers), float32."""
        if layers is None:
            layers = self.spec().content_layers
        if not layers:
            return {}
        return dict(self.model(self.content, tuple(layers)))

    def set_style(self, image):
        """Sets the style image: runs the whole net and keeps the Gram of
        every blob, so a later set_weights that adds a style layer finds
        its target."""
        with precision_scope(self.precision):
            features = self.model(vgg19.preprocess(image, self.device))
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
        self.weights = {name: dict(weights.get(name, {}))
                        for name in LOSS_NAMES}
        self.scalar_params = dict(params)
        self._weights_cache = None
        self.objective_changed()

    # -- stepping -------------------------------------------------------------

    def _gather_inputs(self, spec):
        if self._weights_cache is None or self._weights_cache[0] != spec:
            layer_weights = {l: self._tensor(v) for l, v in
                             weights_to_arrays(self.weights, spec).items()}
            scalars = {k: self._tensor(v) for k, v in
                       scalars_to_arrays(self.scalar_params).items()}
            self._weights_cache = (spec, layer_weights, scalars)
        _, layer_weights, scalars = self._weights_cache

        fresh_vals, fresh_set = empty_norms(spec)
        norms_vals, norms_set = {}, {}
        for key in spec.norm_keys:
            if key in self.norm_vals:
                norms_vals[key] = self.norm_vals[key]
                norms_set[key] = self.norm_set[key]
            else:
                norms_vals[key] = self._tensor(fresh_vals[key])
                norms_set[key] = self._tensor(fresh_set[key])
        missing = [l for l in spec.content_layers if l not in self.features]
        if missing:
            # A weight-structure change added content layers; their
            # features are a pure function of the stored content image.
            self.features.update(self._content_features(spec.content_layers))
        return {
            'content_feats': {l: self.features[l]
                              for l in spec.content_layers},
            'grams': {l: self.grams[l] for l in spec.style_layers},
            'layer_weights': layer_weights,
            'scalars': scalars,
            'norms_vals': norms_vals,
            'norms_set': norms_set,
        }

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

    def _prime(self, spec, eval_fn):
        """Primes the L-BFGS (loss, grad) cache. Returns its trace as a
        stacked device tensor."""
        self.opt_state, norms, trace_vals = eval_fn(
            self.model, self.opt_state, self._gather_inputs(spec))
        self._absorb_norms(spec, norms)
        self._needs_init = False
        return torch.stack(trace_vals)

    def _advance(self, spec, step_fn):
        """One optimizer iteration. Returns its trace as a stacked device
        tensor."""
        self.opt_state, norms, trace_vals = step_fn(
            self.model, self.opt_state, self._gather_inputs(spec),
            self.step_size)
        self._input = self.opt_state['x']
        self._absorb_norms(spec, norms)
        return torch.stack(trace_vals)

    def step(self, fetch_image=True):
        """Runs one optimizer iteration. Returns (deprocessed HxWx3 float32
        RGB image or None, trace dict) like reference worker.py:303-310."""
        self.t += 1
        spec = self.spec()
        step_fn, eval_fn = build_step_core(spec, self.optimizer_name)
        # Each trace comes to the host in one transfer (.tolist()).
        with precision_scope(self.precision):
            if self._needs_init:
                # The priming evaluation's trace is kept too.
                self._record_trace(spec, self._prime(spec, eval_fn).tolist(),
                                   time.perf_counter())
            values = self._advance(spec, step_fn).tolist()
        trace = self._record_trace(spec, values, time.perf_counter())
        trace('fevals', self.t)
        image = self.snapshot() if fetch_image else None
        return image, trace.data

    def begin_steps(self, n_steps):
        """Enqueues n_steps iterations with the weights and step size fixed
        and returns at once: nothing is read back to the host, so a later
        begin_steps queues behind this one on the device while the host
        collects an earlier chunk. A stale L-BFGS cache primes at the head
        of the chunk. Returns a StepsDispatch; collect handles in dispatch
        order."""
        if n_steps < 1:
            raise ValueError('begin_steps needs at least one step')
        spec = self.spec()
        step_fn, eval_fn = build_step_core(spec, self.optimizer_name)
        prime = None
        with precision_scope(self.precision):
            if self._needs_init:
                prime = (spec, self._prime(spec, eval_fn))
            rows = torch.stack([self._advance(spec, step_fn)
                                for _ in range(n_steps)])
            image = deprocess_on_device(self._input)
        self.t += n_steps
        return StepsDispatch(spec, rows, n_steps, self.t, image, prime)

    def collect_steps(self, dispatch, fetch_image=True):
        """Waits for a begin_steps chunk and records its traces: the prime
        trace first if the chunk primed, then one per iteration, all brought
        to the host in one transfer and stamped with the collect time.
        Returns (the chunk's end image as HxWx3 float32 numpy, or None; the
        chunk's step traces)."""
        rows = dispatch.traces
        if dispatch.prime is not None:
            rows = torch.cat([dispatch.prime[1][None], rows])
        values = rows.cpu().tolist()
        now = time.perf_counter()
        if dispatch.prime is not None:
            self._record_trace(dispatch.prime[0], values.pop(0), now)
            dispatch.prime = None
        traces = []
        for i, row in enumerate(values):
            trace = self._record_trace(dispatch.spec, row, now)
            trace('fevals', dispatch.t_end - dispatch.n_steps + 1 + i)
            traces.append(trace)
        image = dispatch.image.cpu().numpy() if fetch_image else None
        return image, traces

    def run_steps(self, n_steps, fetch_image=True):
        """Runs n_steps iterations as one chunk with the weights and step
        size fixed. Appends one trace per iteration; returns (image or None,
        last trace dict)."""
        image, traces = self.collect_steps(self.begin_steps(n_steps),
                                           fetch_image)
        return image, traces[-1].data

    def snapshot(self):
        """The current iterate as a deprocessed HxWx3 float32 RGB array."""
        return vgg19.deprocess(self._input)

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
