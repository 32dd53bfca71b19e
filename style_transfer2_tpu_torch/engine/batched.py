"""Batched multi-session engine: N independent style-transfer jobs as lanes
of one batched step (style_transfer2_tpu/engine/batched.py; BASELINE.json
config 3).

Jobs of one (resolution, objective structure, optimizer) bucket are
stacked on a leading lane axis and stepped together: each step is one
chain of launches, the trunk's convs at N = lanes and the style branch
with every lane in one call (parallel/batch.py), so the host's enqueue
cost of a step is paid once for all lanes. Per-lane state: iterate,
optimizer state, content features, style Grams, loss-weight VALUES, tv/p
scalars, step size, first-eval norms and iterate counters.

Inactive lanes carry zeros and are skipped in the results; they still
compute. Their first evaluation may divide by zero, and those NaNs stay in
their lane: nothing reduces across lanes, and the run mask keeps their
state frozen.

The tensors live on one explicit device, as in engine/transfer.py: 'cuda'
runs the hand-written kernels and raises without CUDA, 'cpu' their plain
versions. The precision mode's TF32 switches hold only around this
engine's device work (engine/steps.py precision_scope). The (B,) loss
weights, scalars and step sizes change only in add_job, set_lane_weights
and set_step_size, which upload them; a dispatch uploads its run mask and
reads nothing back.
"""

import numpy as np
import torch

from ..models import vgg19
from ..models.weights import params_from_numpy
from ..ops.gram import gram_matrix
from ..optim import OPTIMIZERS, STEP_SIZES, lbfgs
from ..parallel.batch import (build_masked_batched_scan_fn,
                              build_masked_batched_step_fns, stack_lanes,
                              unstack_lane)
from ..utils import Trace
from .objective import ObjectiveSpec, scalars_to_arrays, weights_to_arrays
from .steps import precision_config, precision_scope
from .transfer import resolve_device


def _lane_set(tree, lane, value_tree):
    """Writes a per-lane tree (tensors or numbers) into lane `lane` of a
    stacked tree, in place."""
    views = unstack_lane(tree, lane)

    def put(view, value):
        if isinstance(view, dict):
            for k in view:
                put(view[k], value[k])
        elif torch.is_tensor(value):
            view.copy_(value)
        else:
            view.fill_(value)

    put(views, value_tree)


class BatchedStyleTransfer:
    """Up to max_lanes concurrent jobs sharing (hw, spec, optimizer)."""

    def __init__(self, params, weights, scalar_params, hw, max_lanes,
                 optimizer='adam', precision='float32', n_corr=10,
                 device='cuda'):
        """params: the JAX package's params dict of HWIO numpy arrays
        (models.weights); weights, scalar_params: the bucket's objective
        structure and the default values of its lanes; hw: the bucket's
        (H, W) grid. device: 'cuda' (raises without CUDA) or 'cpu'."""
        self.device = resolve_device(device)
        self.spec = ObjectiveSpec.from_weights(weights, scalar_params)
        self.default_weights = weights
        self.default_scalars = scalar_params
        self.hw = tuple(int(s) for s in hw)
        self.max_lanes = int(max_lanes)
        self.optimizer_name = optimizer
        self.precision = precision
        self.n_corr = n_corr
        self.compute_dtype = precision_config(precision)[0]
        self.model = vgg19.VGG19Features(
            params_from_numpy(params, self.device), self.compute_dtype)

        self.active = [False] * self.max_lanes
        self.running = [False] * self.max_lanes
        self.t = [0] * self.max_lanes
        # Per-lane L-BFGS priming flag: lane i's (loss, grad) cache is stale
        # (new job or objective change) and must be re-evaluated before its
        # next step. Per lane: an engine-wide flag would lose the mark of a
        # PAUSED lane when a step primes only the running ones, and the lane
        # would resume with a zero gradient (reference semantics:
        # optimizers.py:62-65,121-125 always evaluate before first use).
        self._needs_prime = [False] * self.max_lanes

        self._history_dtype = None
        if optimizer == 'lbfgs':
            self._history_dtype = lbfgs.history_dtype_for(self.compute_dtype,
                                                          self.hw)
        zero_img = torch.zeros((1,) + self.hw + (3,), dtype=torch.float32,
                               device=self.device)
        with precision_scope(precision):
            feats = self.model(zero_img, self.spec.content_layers)
        lane_inputs = {
            'content_feats': {l: torch.zeros_like(feats[l])
                              for l in self.spec.content_layers},
            'grams': {l: torch.zeros((vgg19.layer_channels(l),) * 2,
                                     dtype=torch.float32, device=self.device)
                      for l in self.spec.style_layers},
            'norms_vals': {k: 0.0 for k in self.spec.norm_keys},
            'norms_set': {k: False for k in self.spec.norm_keys},
        }
        lanes = [self._init_state(zero_img)] * self.max_lanes
        self.states = stack_lanes(lanes, self.device)
        self.inputs = stack_lanes([lane_inputs] * self.max_lanes,
                                  self.device)
        # Host copies of the (B,) values, uploaded whole on each change.
        self._weights = np.stack([self._weight_row(weights)]
                                 * self.max_lanes)
        self._scalars = np.stack([self._scalar_row(scalar_params)]
                                 * self.max_lanes)
        self._step_sizes = np.full(self.max_lanes, STEP_SIZES[optimizer],
                                   np.float32)
        self._upload_weights()
        self.step_sizes = self._upload(self._step_sizes)

    # -- host values ---------------------------------------------------------

    def _upload(self, array):
        """A host numpy array as a device tensor, without waiting for the
        work already queued on the card (a pinned, asynchronous copy)."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == 'cuda':
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.clone()

    def _weight_row(self, weights):
        """(n_layers, 3) float32: each spec layer's [content, style,
        deepdream] weight."""
        arrays = weights_to_arrays(weights, self.spec)
        return np.stack([arrays[l] for l in self.spec.layers])

    @staticmethod
    def _scalar_row(scalar_params):
        arrays = scalars_to_arrays(scalar_params)
        return np.float32([arrays['tv'], arrays['p']])

    def _upload_weights(self):
        weights = self._upload(self._weights)
        scalars = self._upload(self._scalars)
        self.inputs['layer_weights'] = {
            l: weights[:, i] for i, l in enumerate(self.spec.layers)}
        self.inputs['scalars'] = {'tv': scalars[:, 0], 'p': scalars[:, 1]}

    def _check_spec(self, weights, scalar_params, what):
        spec = ObjectiveSpec.from_weights(weights, scalar_params)
        if spec != self.spec:
            raise ValueError('%s does not match this bucket (got %r, bucket '
                             '%r)' % (what, spec, self.spec))

    def _init_state(self, x):
        mod = OPTIMIZERS[self.optimizer_name]
        if self.optimizer_name == 'lbfgs':
            return mod.init(x, self.n_corr, history_dtype=self._history_dtype)
        return mod.init(x)

    # -- lane lifecycle -------------------------------------------------------

    def free_lane(self):
        """Index of a free lane, or None when the bucket is full."""
        for i, busy in enumerate(self.active):
            if not busy:
                return i
        return None

    def add_job(self, content, style, input_image, weights=None,
                scalar_params=None, step_size=None, lane=None,
                lane_state=None, t=0, norms=None):
        """Adds a job; returns its lane id. Images are HxWx3 RGB arrays at
        this bucket's resolution.

        lane_state, if given, is a per-lane optimizer state at this
        bucket's resolution in the single engine's layout (lane_state() of
        this or another bucket, optim resample of it for a warm start);
        input_image is then ignored in favour of the state's iterate. t
        carries the lane's iterate counter across a migration.

        norms, if given, is a (vals, set) pair from lane_norms(): the
        session's first-eval gradient-RMS norm state, carried across a
        requeue or migration so that the lane keeps optimizing the SAME
        normalized objective (norms persist across weight and size changes,
        cleared only by reset: worker.py:137,172-175). Omitted, the lane
        re-anchors at its first evaluation."""
        if lane is None:
            lane = self.free_lane()
        if lane is None:
            raise RuntimeError('no free lane (bucket of %d full)'
                               % self.max_lanes)
        weights = weights if weights is not None else self.default_weights
        scalar_params = (scalar_params if scalar_params is not None
                         else self.default_scalars)
        self._check_spec(weights, scalar_params, 'job objective structure')

        with precision_scope(self.precision):
            content_x = vgg19.preprocess(content, self.device)
            style_x = vgg19.preprocess(style, self.device)
            if lane_state is not None:
                input_x = lane_state['x']
            else:
                input_x = vgg19.preprocess(input_image, self.device)
            if (tuple(content_x.shape[1:3]) != self.hw
                    or tuple(input_x.shape[1:3]) != self.hw):
                raise ValueError('job resolution does not match bucket %s'
                                 % (self.hw,))
            feats = self.model(content_x, self.spec.content_layers)
            style_feats = self.model(style_x, self.spec.style_layers)
            keys = self.spec.norm_keys
            vals, set_ = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, False)
            if norms is not None:
                nv, ns = norms
                vals.update((k, nv[k]) for k in keys if k in nv)
                set_.update((k, ns[k]) for k in keys if k in ns)
            _lane_set({k: self.inputs[k] for k in (
                'content_feats', 'grams', 'norms_vals', 'norms_set')}, lane, {
                'content_feats': {l: feats[l]
                                  for l in self.spec.content_layers},
                'grams': {l: gram_matrix(style_feats[l])
                          for l in self.spec.style_layers},
                'norms_vals': vals, 'norms_set': set_})
            if lane_state is None:
                lane_state = self._init_state(input_x)
            _lane_set(self.states, lane, lane_state)

        self._weights[lane] = self._weight_row(weights)
        self._scalars[lane] = self._scalar_row(scalar_params)
        self._upload_weights()
        self.set_step_size(lane, STEP_SIZES[self.optimizer_name]
                           if step_size is None else step_size)
        self.active[lane] = True
        self.running[lane] = True
        self.t[lane] = int(t)
        if self.optimizer_name == 'lbfgs':
            self._needs_prime[lane] = True
        return lane

    def lane_state(self, lane):
        """One lane's optimizer state in the single engine's layout, as
        views into the stacked state (for warm-start migration to another
        bucket). The views hold until the lane is next written: add_job, an
        objective change of that lane, or a step that runs it."""
        return unstack_lane(self.states, lane)

    def lane_norms(self, lane):
        """One lane's first-eval norm state as a (vals, set) dict pair of
        0-d device tensors: the add_job norms= payload that carries a
        session's normalized objective across a requeue or migration.
        Copies on the device: nothing crosses to the host."""
        vals = {k: self.inputs['norms_vals'][k][lane].clone()
                for k in self.spec.norm_keys}
        set_ = {k: self.inputs['norms_set'][k][lane].clone()
                for k in self.spec.norm_keys}
        return vals, set_

    def norms_host(self):
        """EVERY lane's norm state in two host transfers: (keys, (n_keys,
        max_lanes) float32 vals, (n_keys, max_lanes) bool set)."""
        keys = list(self.spec.norm_keys)
        if not keys:
            return (keys, np.zeros((0, self.max_lanes), np.float32),
                    np.zeros((0, self.max_lanes), bool))
        vals = torch.stack([self.inputs['norms_vals'][k]
                            for k in keys]).cpu().numpy()
        set_ = torch.stack([self.inputs['norms_set'][k]
                            for k in keys]).cpu().numpy()
        return keys, vals, set_

    def remove_job(self, lane):
        self.active[lane] = False
        self.running[lane] = False
        self.t[lane] = 0
        self._needs_prime[lane] = False

    def set_running(self, lane, running):
        """Pauses or resumes one lane; a paused lane keeps its optimizer
        state and norms frozen (the batched step masks its writes)."""
        self.running[lane] = bool(running)

    def any_running(self):
        return any(r and a for r, a in zip(self.running, self.active))

    def _mask(self, flags):
        return self._upload(np.array(flags, dtype=bool))

    def _run_mask(self):
        return self._mask([bool(r and a) for r, a in
                           zip(self.running, self.active)])

    def set_step_size(self, lane, step_size):
        self._step_sizes[lane] = float(step_size)
        self.step_sizes = self._upload(self._step_sizes)

    def set_lane_weights(self, lane, weights, scalar_params):
        """Updates one lane's weight VALUES (the structure must match the
        bucket) and clears its transient optimizer state, as the
        reference's objective_changed does."""
        self._check_spec(weights, scalar_params, 'weight structure')
        self._weights[lane] = self._weight_row(weights)
        self._scalars[lane] = self._scalar_row(scalar_params)
        self._upload_weights()
        self._lane_objective_changed(lane)

    def _lane_objective_changed(self, lane):
        mod = OPTIMIZERS[self.optimizer_name]
        _lane_set(self.states, lane,
                  mod.objective_changed(self.lane_state(lane)))
        if self.optimizer_name == 'lbfgs':
            self._needs_prime[lane] = True

    def _prime_pending(self, eval_fn):
        """Re-evaluates (loss, grad) for the running lanes whose cache is
        stale, masked so that primed and paused lanes are untouched. A
        paused stale lane keeps its flag until it resumes."""
        if eval_fn is None:
            return
        prime = [p and r and a for p, r, a in
                 zip(self._needs_prime, self.running, self.active)]
        if not any(prime):
            return
        self.states, norms, _ = eval_fn(self.model, self.states, self.inputs,
                                        self._mask(prime))
        self.inputs['norms_vals'], self.inputs['norms_set'] = norms
        for lane, primed in enumerate(prime):
            if primed:
                self._needs_prime[lane] = False

    # -- stepping -------------------------------------------------------------

    def begin_steps_all(self, n_steps):
        """Enqueues n_steps optimizer steps for every running lane and
        returns at once: nothing is read back to the host, so a later
        dispatch queues behind this one on the device while the host
        collects an earlier handle. The trace rides the returned handle to
        collect_steps_all. Returns None when no lane runs."""
        running = [lane for lane, busy in enumerate(self.active)
                   if busy and self.running[lane]]
        if not running:
            return None
        step_fn, eval_fn = build_masked_batched_step_fns(
            self.spec, self.optimizer_name)
        with precision_scope(self.precision):
            self._prime_pending(eval_fn)
            mask = self._run_mask()
            if n_steps == 1:
                self.states, norms, traces = step_fn(
                    self.model, self.states, self.inputs, self.step_sizes,
                    mask)
                traces = traces[..., None]
            else:
                scan_fn = build_masked_batched_scan_fn(
                    self.spec, self.optimizer_name, n_steps)
                self.states, norms, traces = scan_fn(
                    self.model, self.states, self.inputs, self.step_sizes,
                    mask)
        self.inputs['norms_vals'], self.inputs['norms_set'] = norms
        t_end = {}
        for lane in running:
            self.t[lane] += n_steps
            t_end[lane] = self.t[lane]
        return {'traces': traces, 'k': n_steps, 'lanes': running,
                't_end': t_end}

    def collect_steps_all(self, handle):
        """Waits for a begin_steps_all handle; returns {lane: [trace dict
        per step]} for the lanes that ran in that dispatch, the traces
        brought to the host in one transfer."""
        if handle is None:
            return {}
        k = handle['k']
        columns = handle['traces'].cpu().tolist()   # [key][lane][step]
        out = {}
        for lane in handle['lanes']:
            lane_traces = []
            for j in range(k):
                trace = Trace()
                for key, col in zip(self.spec.trace_keys, columns):
                    trace(key, col[lane][j])
                trace('fevals', handle['t_end'][lane] - k + 1 + j)
                lane_traces.append(trace.data)
            out[lane] = lane_traces
        return out

    def step_all(self):
        """One optimizer step for every RUNNING lane (paused and inactive
        lanes' state is mask-frozen). Returns {lane: trace dict} for the
        running lanes."""
        return {lane: traces[0]
                for lane, traces in self.run_steps_all(1).items()}

    def run_steps_all(self, n_steps):
        """n_steps optimizer steps for every running lane in one dispatch.
        Returns {lane: [trace dict per step]} for the running lanes."""
        return self.collect_steps_all(self.begin_steps_all(n_steps))

    def lane_image(self, lane):
        """One lane's deprocessed iterate (HxWx3 float32 RGB numpy)."""
        return vgg19.deprocess(self.states['x'][lane:lane + 1])
