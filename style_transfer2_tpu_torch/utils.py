"""Host-side helpers: the trace record, the image fitting and resolution
ladder the CLI uses, the precision ranks, a scoped TF32 switch, the
16-byte alignment the kernels' vector loads need, and the card's SM count
that their launch plans take.

The same behaviour as style_transfer2_tpu/utils/tracing.py:Trace,
utils/images.py (reference utils.py:193-223,257-282,307-309) and
serve/session.py:PRECISION_RANK, kept here so that the port imports nothing
of the JAX package.
"""

import contextlib
import functools
import math
from collections import OrderedDict

import numpy as np
import torch
from PIL import Image

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


def scales(size, min_size=1, factor=math.sqrt(2)):
    """(h, w) sizes increasing from about min_size up to size by the given
    factor: the coarse-to-fine resolution ladder (reference
    utils.py:193-207)."""
    size = np.float64(size)
    min_size = int(min_size)
    assert min_size >= 1

    sizes = [tuple(int(round(x)) for x in size)]
    while True:
        size = size / factor
        size_int = tuple(int(round(x)) for x in size)
        if max(size_int) < min_size or min(size_int) < 1:
            break
        sizes.append(size_int)
    sizes.reverse()
    return sizes


def fit_into_square(current_size, size, scale_up=False):
    """The aspect-preserving (w, h) that fits into a size-by-size square."""
    size = int(round(size))
    w, h = current_size
    if not scale_up and max(w, h) <= size:
        return current_size
    if w > h:
        return size, int(round(size * h / w))
    return int(round(size * w / h)), size


def resize_to_fit(image, size, scale_up=True):
    """Resizes a PIL image to fit into a size-by-size square (Lanczos)."""
    return image.resize(fit_into_square(image.size, size, scale_up),
                        Image.LANCZOS)


def as_pil(arr):
    """HxWx3 float array -> PIL image, clipped to [0, 255]."""
    return Image.fromarray(np.uint8(np.clip(arr, 0, 255)))
