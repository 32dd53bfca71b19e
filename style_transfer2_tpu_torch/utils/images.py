"""Host-side image helpers (style_transfer2_tpu/utils/images.py; reference
utils.py:130-160,193-223,307-309): the image fitting and resolution ladder
the CLI and the serving tier use, and the PIL resamples of an HWC image
(the serving tier's user-paced resize of the iterate) and of an NCHW
stack, one float32 plane at a time. The JAX package prefers its native
resampler where that library is built; the port always takes PIL's path.
"""

import math

import numpy as np
from PIL import Image


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


def resample_hwc(a, hw):
    """Resamples an HxWxC image array to a new (h, w) with PIL's Lanczos,
    one float32 plane at a time. Float32 result."""
    a = np.float32(a)
    b = np.zeros((hw[0], hw[1], a.shape[-1]), np.float32)
    for i in range(a.shape[-1]):
        b[:, :, i] = Image.fromarray(a[:, :, i]).resize((hw[1], hw[0]),
                                                        Image.LANCZOS)
    return b


def _pil_method(method):
    if method in ('lanczos', Image.LANCZOS):
        return Image.LANCZOS
    if method in ('bilinear', Image.BILINEAR):
        return Image.BILINEAR
    raise ValueError('Unsupported resampling method: %r' % (method,))


def resample_nchw(a, hw, method='lanczos'):
    """Resamples an NxCxHxW array to a new (h, w) with PIL ('lanczos' or
    'bilinear'), one float32 plane at a time. Float32 result."""
    a = np.float32(a)
    pil_method = _pil_method(method)
    n, ch = a.shape[:2]
    b = np.zeros((n, ch, hw[0], hw[1]), np.float32)
    for i in range(n):
        for j in range(ch):
            b[i, j] = Image.fromarray(a[i, j]).resize((hw[1], hw[0]),
                                                      pil_method)
    return b


def as_pil(arr):
    """HxWx3 float array -> PIL image, clipped to [0, 255]."""
    return Image.fromarray(np.uint8(np.clip(arr, 0, 255)))
