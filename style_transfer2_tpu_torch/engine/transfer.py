"""The StyleTransfer state machine (style_transfer2_tpu/engine/transfer.py;
reference worker.py:117-315): host orchestration over device state.

The same image-slot lifecycle (input/content/style), start gating, reset
semantics and per-step traces as the JAX engine. The tensors live on one
explicit device: 'cuda' runs the hand-written kernels, 'cpu' their plain
versions. The first-eval norm cache is 0-d tensors threaded through each
step; each step's trace comes to the host in one transfer.
"""

import csv
import time

import torch

from ..models import vgg19
from ..models.weights import params_from_numpy
from ..ops.gram import gram_matrix
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
from .steps import apply_precision, build_step_core


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


class StyleTransfer:
    """Image stylization by minimizing the objective with an optimizer
    state dict. API of reference worker.py:117-315."""

    def __init__(self, params, precision='float32', n_corr=10,
                 device='cuda'):
        """params: the JAX package's params dict of HWIO numpy arrays
        (models.weights). precision: 'float32', 'float32_fast' or
        'bfloat16'; sets the process-wide TF32 switches (engine/steps.py).
        device: 'cuda' or 'cpu'."""
        self.device = resolve_device(device)
        self.precision = precision
        self.compute_dtype = apply_precision(precision)
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

    def set_input(self, image):
        """Sets the optimization iterate from an HxWx3 RGB image."""
        image = vgg19.preprocess(image, self.device)
        if self._input is not None and self._input.shape == image.shape:
            self._input = image
            if self.opt_state is not None:
                self.opt_state = dict(self.opt_state, x=image)
            self.objective_changed()
        elif self.opt_state is not None:
            mod = OPTIMIZERS[self.optimizer_name]
            self.opt_state = mod.resample(self.opt_state, None, new_x=image)
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

    def _absorb_trace(self, spec, trace_vals):
        # One host transfer for the whole trace, not one sync per scalar.
        values = torch.stack(trace_vals).cpu().tolist()
        trace = Trace()
        for key, value in zip(spec.trace_keys, values):
            if key == 'loss':
                trace('time', time.perf_counter())
            trace(key, value)
        self.traces.append(trace)
        return trace

    def step(self, fetch_image=True):
        """Runs one optimizer iteration. Returns (deprocessed HxWx3 float32
        RGB image or None, trace dict) like reference worker.py:303-310."""
        self.t += 1
        spec = self.spec()
        step_fn, eval_fn = build_step_core(spec, self.optimizer_name)
        if self._needs_init:
            # Prime the L-BFGS (loss, grad) cache; its trace is kept too.
            self.opt_state, norms, trace_vals = eval_fn(
                self.model, self.opt_state, self._gather_inputs(spec))
            self._absorb_norms(spec, norms)
            self._absorb_trace(spec, trace_vals)
            self._needs_init = False

        self.opt_state, norms, trace_vals = step_fn(
            self.model, self.opt_state, self._gather_inputs(spec),
            self.step_size)
        self._input = self.opt_state['x']
        self._absorb_norms(spec, norms)
        trace = self._absorb_trace(spec, trace_vals)
        trace('fevals', self.t)
        image = self.snapshot() if fetch_image else None
        return image, trace.data

    def run_steps(self, n_steps, fetch_image=True):
        """Runs n_steps iterations with the weights and step size fixed.
        Appends one trace per iteration; returns (image or None, last trace
        dict)."""
        trace = None
        for _ in range(n_steps):
            _, trace = self.step(fetch_image=False)
        image = self.snapshot() if fetch_image else None
        return image, trace

    def snapshot(self):
        """The current iterate as a deprocessed HxWx3 float32 RGB array."""
        return vgg19.deprocess(self._input)

    def write_trace(self, filename):
        """Writes the trace history as CSV, one row per trace with a 'step'
        index column (worker.py:312-315)."""
        keys = []
        for trace in self.traces:
            keys += [k for k in trace.data if k not in keys]
        with open(filename, 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(['step'] + keys)
            for i, trace in enumerate(self.traces):
                writer.writerow([i] + [trace.data.get(k, '') for k in keys])
