"""VGG-19 weights for the port (style_transfer2_tpu/models/weights.py).

Params dicts have the JAX package's format, {conv_name: {'w': HWIO (3, 3,
in, out), 'b': (out,)}}, as float32 numpy arrays; params_from_numpy turns
one into tensors on a device. random_params draws the same numbers as the
JAX package's, so both packages run the same network from one seed.

The caffemodel and torchvision converters stay in the JAX package: convert
once to .npz there (models.weights.save_params) and load the .npz here.
"""

import logging
from pathlib import Path

import numpy as np
import torch

from .vgg19 import CONV_SPECS, IN_CHANNELS

logger = logging.getLogger('weights')


def random_params(seed=0):
    """Deterministic He-normal random weights, bit-identical to the JAX
    package's random_params(seed)."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, out_c in CONV_SPECS:
        in_c = IN_CHANNELS[name]
        fan_in = 3 * 3 * in_c
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), (3, 3, in_c, out_c))
        b = np.zeros((out_c,))
        params[name] = {'w': w.astype(np.float32), 'b': b.astype(np.float32)}
    return params


def load_params(path):
    """Loads a params dict saved by the JAX package's save_params()."""
    params = {}
    with np.load(path) as data:
        for key in data.files:
            name, kind = key.rsplit('/', 1)
            params.setdefault(name, {})[kind] = np.float32(data[key])
    return params


def resolve_params(spec='auto', root=None):
    """Resolves a weights spec to a numpy params dict.

    'auto': models/vgg19.npz under the repository root if it exists, else
    deterministic random weights (logged). 'random': random_params(0). A
    path: an .npz file."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    if spec in ('auto', '', None):
        npz = root / 'models' / 'vgg19.npz'
        if npz.exists():
            logger.info('Loading weights from %s', npz)
            return load_params(npz)
        logger.warning('No VGG-19 weights at %s; using deterministic random '
                       'weights', npz)
        return random_params(0)
    if str(spec) == 'random':
        return random_params(0)
    path = Path(spec)
    if not path.is_absolute():
        path = root / path
    if path.suffix == '.npz':
        return load_params(path)
    raise ValueError('Unsupported weights spec %r: convert it to .npz with '
                     'the JAX package (models.weights.save_params)' % (spec,))


def params_from_numpy(params_np, device, dtype=torch.float32):
    """The JAX package's params dict of HWIO numpy arrays -> the same dict
    of tensors in dtype on device."""
    return {name: {kind: torch.as_tensor(np.asarray(arr, np.float32),
                                         device=device).to(dtype)
                   for kind, arr in p.items()}
            for name, p in params_np.items()}
