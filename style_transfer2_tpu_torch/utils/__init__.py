"""Host-side helpers: the trace record, the precision ranks, a scoped TF32
switch, the 16-byte alignment the kernels' vector loads need and the
card's SM count that their launch plans take; with the submodules the
serving tier calls: the layered config (config), process setup
(logging), the it/s EWMA (meanvar) and the image fitting, resampling and
resolution ladder (images); and the H100 roofline of a step (perfmodel,
imported by name: it imports the model).

The same behaviour as style_transfer2_tpu/utils/ (tracing.py:Trace,
config.py, logging.py, meanvar.py, images.py) and
serve/session.py:PRECISION_RANK, kept here so that the port imports nothing
of the JAX package.
"""

import contextlib
import functools
from collections import OrderedDict

import torch

from .config import debug_level, parse_args, read_config
from .images import (as_pil, fit_into_square, resample_hwc, resample_nchw,
                     resize_to_fit, scales)
from .logging import setup_exceptions, setup_logging, setup_signals
from .meanvar import DecayingMean

__all__ = [
    'PRECISION_RANK', 'Trace', 'aligned', 'sm_count', 'tf32',
    'debug_level', 'parse_args', 'read_config',
    'setup_exceptions', 'setup_logging', 'setup_signals',
    'DecayingMean',
    'as_pil', 'fit_into_square', 'resample_hwc', 'resample_nchw',
    'resize_to_fit', 'scales',
]

# Precision modes ordered by exactness: a polish phase runs only when its
# precision ranks above the main run's (style_transfer2_tpu/cli.py:447-453).
PRECISION_RANK = {'bfloat16': 0, 'float32_fast': 1, 'float32': 2}


class Trace:
    """An ordered record of named scalars; a repeated name gets an
    underscore appended."""

    def __init__(self):
        self.data = OrderedDict()

    def __call__(self, name, value):
        while name in self.data:
            name += '_'
        self.data[name] = value
        return value


def aligned(t):
    """t contiguous and 16-byte aligned: the kernels copy 16 bytes at a
    time, and a view into a larger tensor may start at any element."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@contextlib.contextmanager
def tf32(allowed):
    """Sets the TF32 switches of cuBLAS and cuDNN for the duration of the
    block and restores them after. torch reads them at each launch, so work
    enqueued inside the block runs at the block's precision."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allowed
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
