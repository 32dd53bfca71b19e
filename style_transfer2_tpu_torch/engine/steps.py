"""Optimization steps and the precision modes (style_transfer2_tpu/engine/
steps.py).

One step = one optimizer iteration: the VGG forward, the losses, the
backward with injected cotangents and the update, all launched on the
device with no host read-back. PyTorch runs eagerly, so a step is a plain
closure and a K-step chunk is a Python loop that enqueues K steps before
anything is read back (engine/transfer.py begin_steps); a CUDA graph over K
steps is later work. With nothing to compile, build_step_core stands for
both the JAX package's build_step_core (the pure cores) and its
build_step_fns (their jitted pair).
"""

import functools

import torch

from ..optim import adam, lbfgs
from ..utils import tf32
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
    scalars=..., norms_vals=..., norms_set=...[, temporal_target=...]).
    eval_core is None for Adam."""
    objective = make_objective(spec)

    def make_opfunc(model, inputs):
        def opfunc(x):
            loss, grad, norms, trace = objective(
                model, x, inputs['content_feats'], inputs['grams'],
                inputs['layer_weights'], inputs['scalars'],
                inputs['norms_vals'], inputs['norms_set'],
                inputs.get('temporal_target'))
            return loss, grad, (norms, trace)
        return opfunc

    if optimizer == 'adam':
        def step_core(model, state, inputs, step_size):
            state_new, _, (norms, trace) = adam.step(
                state, make_opfunc(model, inputs), step_size)
            return state_new, norms, trace

        return step_core, None

    if optimizer == 'lbfgs':
        def step_core(model, state, inputs, step_size):
            state_new, _, (norms, trace) = lbfgs.step(
                state, make_opfunc(model, inputs), step_size)
            return state_new, norms, trace

        def eval_core(model, state, inputs):
            state_new, _, (norms, trace) = lbfgs.initial_eval(
                state, make_opfunc(model, inputs))
            return state_new, norms, trace

        return step_core, eval_core

    raise ValueError('Unknown optimizer: %r' % (optimizer,))
