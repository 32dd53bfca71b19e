"""Host-side helpers: the trace record and the image fitting the CLI uses.

The same behaviour as style_transfer2_tpu/utils/tracing.py:Trace and
utils/images.py (reference utils.py:210-223,257-282,307-309), kept here so
that the port imports nothing of the JAX package.
"""

from collections import OrderedDict

import numpy as np
from PIL import Image


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
