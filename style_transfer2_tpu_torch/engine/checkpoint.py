"""Checkpoint/resume of a StyleTransfer session
(style_transfer2_tpu/engine/checkpoint.py).

The same state tree and JSON sidecar as the JAX package: the iterate, the
optimizer state (the L-BFGS ring buffer and its cursors, or the Adam
moments and counters), the content image, the style Grams and the
first-eval norm cache go to `arrays.pt` through torch.save (in place of
orbax); the host-side config (weights document, optimizer, step size,
iterate count, precision) goes to `meta.json`. Content features are not
stored: they are recomputed from the content image on load. Tensors are
saved from the host and restored to the loading engine's device; a
spatially sharded engine's (parallel/spatial.py) are gathered to the host
on save and placed again on load, as the JAX package's checkpoint.py does.

The port reads only its own checkpoints, not the JAX package's, so the
JAX loader's migration of flat-history L-BFGS buffers has no counterpart.
"""

import json
from pathlib import Path

import torch

from ..parallel.spatial import Sharded
from .steps import precision_scope

ARRAYS = 'arrays.pt'
META = 'meta.json'


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        tree = tree.gather()
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return tree


def save_checkpoint(st, path):
    """Saves the session state of a StyleTransfer to `path` (a directory)."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    arrays = {
        'opt_state': st.opt_state,
        'input': st._input,
        'content': st.content,
        'grams': st.grams,
        'norm_vals': st.norm_vals,
        'norm_set': st.norm_set,
    }
    arrays = {k: v for k, v in arrays.items() if v is not None}
    torch.save(_to(arrays, 'cpu'), path / ARRAYS)
    meta = {
        't': st.t,
        'optimizer_name': st.optimizer_name,
        'step_size': st.step_size,
        'weights': st.weights,
        'scalar_params': st.scalar_params,
        'precision': st.precision,
        'n_corr': st.n_corr,
        'needs_init': st._needs_init,
        'has': sorted(arrays.keys()),
    }
    with open(path / META, 'w') as f:
        json.dump(meta, f)


def load_checkpoint(st, path):
    """Restores a checkpoint into a StyleTransfer, recomputing the content
    features from the restored content image."""
    path = Path(path).absolute()
    with open(path / META) as f:
        meta = json.load(f)
    arrays = _to(torch.load(path / ARRAYS, map_location='cpu',
                            weights_only=True), st.device)

    st.t = int(meta['t'])
    st.optimizer_name = meta['optimizer_name']
    st.step_size = float(meta['step_size'])
    st.weights = meta['weights']
    st.scalar_params = meta['scalar_params']
    st.n_corr = int(meta['n_corr'])
    st._needs_init = bool(meta['needs_init'])
    st._weights_cache = None

    st.opt_state = arrays.get('opt_state')
    st._input = arrays.get('input')
    st.content = arrays.get('content')
    if st.placement is not None:
        if st.opt_state is not None:
            st.opt_state = st._place_state(st.opt_state)
        if st._input is not None:
            st._input = st._place_image(st._input)
        if st.content is not None:
            st.content = st._place_image(st.content)
    if st.opt_state is not None and st._input is not None:
        st.opt_state['x'] = st._input
    st.grams = arrays.get('grams')
    st.norm_vals = arrays.get('norm_vals', {})
    st.norm_set = arrays.get('norm_set', {})
    if st.content is not None:
        with precision_scope(st.precision):
            st.features = st._content_features()
    return st
