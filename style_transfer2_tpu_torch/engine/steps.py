"""Optimization steps and the precision modes (style_transfer2_tpu/engine/
steps.py).

One step = one optimizer iteration: the VGG forward, the losses, the
backward with injected cotangents and the update, all launched on the
device with no host read-back. build_step_core gives the pure cores (the
JAX package's build_step_core and, with nothing to compile, its
build_step_fns). build_scan_fn is the port of its build_scan_fn: K steps
with the weights and step size fixed, the first-eval norms threaded
through them, the stale L-BFGS cache primed at the head (primed=True).
Where the JAX package runs them as one XLA program, the port runs one
step K times through the engine's StepGraphs (engine/graphs.py): on the
card each is a replay of one captured CUDA graph of the step (and of the
prime), on the CPU the eager loop, which is the graphs' plain version.
"""

import functools

import torch

from ..optim import adam, lbfgs
from ..parallel.spatial import Sharded
from ..utils import tf32
from .graphs import GraphKey, StepGraphs
from .objective import make_objective

# name -> (compute dtype, TF32 allowed for cuBLAS/cuDNN). float32 is the
# reference-exact mode, so TF32 is off for both matmuls and convolutions;
# float32_fast turns it on; bfloat16 runs the trunk in bf16 and keeps the
# remaining float32 math (Gram targets, losses, optimizer) in full float32.
# The hand-written kernels never use TF32 in any mode.
_PRECISIONS = {
    'float32': (torch.float32, False),
    'float32_fast': (torch.float32, True),
    'bfloat16': (torch.bfloat16, False),
}


def precision_config(name):
    """Maps a precision name to (compute dtype, allow_tf32)."""
    return _PRECISIONS[name]


def precision_scope(name):
    """A context manager that holds a precision mode's TF32 switches for
    the work launched inside it and restores the caller's after, so that
    two engines of different precisions in one process never change each
    other's math (the JAX package binds precision to each program). Both
    torch.backends.cuda.matmul and torch.backends.cudnn are set: cuDNN's
    default is TF32 on, which would silently take float32 parity away on
    the card."""
    return tf32(precision_config(name)[1])


@functools.lru_cache(maxsize=64)
def build_step_core(spec, optimizer):
    """Returns (step_core, eval_core):

      step_core(model, state, inputs, step_size) -> (state', norms', trace)
      eval_core(model, state, inputs) -> (state', norms', trace)

    where inputs = dict(content_feats=..., grams=..., layer_weights=...,
    scalars=..., norms_vals=..., norms_set=...[, temporal_target=...][,
    corrections=(c1, c2)]), step_size a float or a 0-d device tensor and
    corrections Adam's two bias corrections as 0-d device tensors (absent:
    from the state's host counters). eval_core is None for Adam. An L-BFGS
    step_core takes the norms as set (make_objective's fresh_norms=False):
    its eval_core, the prime, runs first on a stale cache and sets them;
    an Adam step, which no prime precedes, computes fresh ones."""
    objective = make_objective(spec)

    def make_opfunc(model, inputs, fresh_norms=True):
        def opfunc(x):
            loss, grad, norms, trace = objective(
                model, x, inputs['content_feats'], inputs['grams'],
                inputs['layer_weights'], inputs['scalars'],
                inputs['norms_vals'], inputs['norms_set'],
                inputs.get('temporal_target'), fresh_norms)
            return loss, grad, (norms, trace)
        return opfunc

    if optimizer == 'adam':
        def step_core(model, state, inputs, step_size):
            state_new, _, (norms, trace) = adam.step(
                state, make_opfunc(model, inputs), step_size,
                corrections=inputs.get('corrections'))
            return state_new, norms, trace

        return step_core, None

    if optimizer == 'lbfgs':
        # A step follows a prime of its spec (the engines prime a stale
        # cache first), which set every norm: no fresh ones to compute.
        def step_core(model, state, inputs, step_size):
            state_new, _, (norms, trace) = lbfgs.step(
                state, make_opfunc(model, inputs, fresh_norms=False),
                step_size)
            return state_new, norms, trace

        def eval_core(model, state, inputs):
            state_new, _, (norms, trace) = lbfgs.initial_eval(
                state, make_opfunc(model, inputs))
            return state_new, norms, trace

        return step_core, eval_core

    raise ValueError('Unknown optimizer: %r' % (optimizer,))


def _is_array(v):
    """A tensor, or a Sharded one (parallel/spatial.py): device state, as
    opposed to the host counters of a state."""
    return torch.is_tensor(v) or isinstance(v, Sharded)


# The args of one step that the step rewrites: the graphs copy these back
# into their static buffers.
WRITES = ('state', 'norms_vals', 'norms_set')


def graph_body(core, model, extra=()):
    """core as a body for StepGraphs.run: body(args) -> ({'state',
    'norms_vals', 'norms_set'}, trace), calling core(model, args['state'],
    inputs, *(args[k] for k in extra)) with the norms (and Adam's
    'corrections', where args hold them) back in the inputs. args as
    step_args gives them, with the extra keys added ('step_size'; a
    batched step's 'step_sizes' and 'mask')."""
    def body(args):
        inputs = dict(args['inputs'], norms_vals=args['norms_vals'],
                      norms_set=args['norms_set'])
        if 'corrections' in args:
            inputs['corrections'] = args['corrections']
        state, norms, trace = core(model, args['state'], inputs,
                                   *(args[k] for k in extra))
        if isinstance(trace, tuple):
            trace = torch.stack(trace)
        return ({'state': state, 'norms_vals': norms[0],
                 'norms_set': norms[1]}, trace)
    return body


def step_args(state, inputs):
    """The args of a step for StepGraphs.run from the optimizer state's
    tensors and build_step_core's inputs: the norms, which the step
    rewrites (WRITES), apart from the read-only inputs."""
    return {'state': state,
            'inputs': {k: v for k, v in inputs.items()
                       if k not in ('norms_vals', 'norms_set')},
            'norms_vals': inputs['norms_vals'],
            'norms_set': inputs['norms_set']}


def graph_key(kind, spec, optimizer, state, lanes=1, dtype=torch.float32,
              n_corr=None):
    """The GraphKey of a step or prime over this (per-lane or stacked)
    optimizer state; a Sharded iterate's axis and devices are its
    layout."""
    x = state['x']
    hist = state['sk'].dtype if 'sk' in state else None
    layout = ((x.axis, tuple(x.devices)) if isinstance(x, Sharded)
              else None)
    return GraphKey(kind, spec, optimizer, tuple(x.shape[-3:-1]), lanes,
                    dtype, hist, n_corr, layout)


@functools.lru_cache(maxsize=64)
def build_scan_fn(spec, optimizer, primed=False):
    """K optimizer steps with the weights and step size fixed
    (style_transfer2_tpu/engine/steps.py build_scan_fn):

      scan_fn(model, state, inputs, step_size, n_steps, graphs=None)
        -> (state', (norms_vals', norms_set'), rows, prime_row)

    inputs as build_step_core's; step_size a float; rows a fresh
    (n_steps, n_keys) tensor of the steps' traces in spec.trace_keys order.
    primed=True (L-BFGS only) first runs the initial (loss, grad)
    evaluation and returns its trace as a fresh prime_row (else None). The
    norm state threads through the steps, so first-eval caching behaves as
    over K separate steps. graphs: the engine's StepGraphs (None: the
    eager loop), through which each step (and the prime) runs: on the card
    a replay of one captured graph, whose static buffers state' and the
    norms then are, until the engine's next step. Adam's host counters
    advance here, one a step, its bias corrections filled from them before
    each step."""
    step_core, eval_core = build_step_core(spec, optimizer)
    if primed and eval_core is None:
        raise ValueError('primed scan requires an optimizer with an '
                         'initial evaluation (lbfgs)')
    width = len(spec.trace_keys)

    def scan_fn(model, state, inputs, step_size, n_steps, graphs=None):
        if graphs is None:
            graphs = StepGraphs()
        device = state['x'].device
        host = {k: v for k, v in state.items() if not _is_array(v)}
        args = step_args({k: v for k, v in state.items() if _is_array(v)},
                         inputs)
        n_corr = state['sk'].shape[0] if 'sk' in state else None

        def run(kind, body, extra):
            key = graph_key(kind, spec, optimizer, state,
                            dtype=model.compute_dtype, n_corr=n_corr)
            new, row = graphs.run(key, body, dict(args, **extra), WRITES,
                                  (width,), device)
            args.update(new)
            return row

        prime_row = None
        if primed:
            prime_row = run('prime', graph_body(eval_core, model), {})
            prime_row = prime_row.clone()
        step_body = graph_body(step_core, model, ('step_size',))
        rows = torch.empty((n_steps, width), dtype=torch.float32,
                           device=device)
        for i in range(n_steps):
            extra = {'step_size': float(step_size)}
            if optimizer == 'adam':
                extra['corrections'] = adam.next_corrections(host)
                host = adam.advance_counters(host)
            rows[i].copy_(run('step', step_body, extra))
        return (dict(host, **args['state']),
                (args['norms_vals'], args['norms_set']), rows, prime_row)

    return scan_fn
