"""Image resampling on the device (style_transfer2_tpu/ops/resample.py).

resize_nhwc is jax.image.resize(antialias=True) in 'lanczos3' (the PIL
LANCZOS analog, for the iterate and the Adam first moment at a warm start)
and 'bilinear' (the Adam second moment, which the optimizer then clamps at
0). The JAX function is XLA, not Pallas, so this is plain torch: for each
axis whose size changes, a separable (out x in) weight matrix built on the
host as jax/_src/image/scale.py:compute_weight_mat builds it (half-pixel
sample positions, the kernel widened by 1/scale when downsampling, each
output's weights normalised to sum 1, and outputs whose weights sum to
about 0 or whose sample falls outside the input set to 0), cached by
(in, out, method) and applied as one contraction on x's device.

jax.image.resize contracts at Precision.HIGHEST, so the contractions here
run with TF32 off in every precision mode, float32_fast included.
"""

import functools

import numpy as np
import torch

from ..utils import tf32

_METHODS = {'lanczos': 'lanczos3', 'lanczos3': 'lanczos3',
            'bilinear': 'bilinear'}
_EPS = np.float32(np.finfo(np.float32).eps)


def _lanczos3(x):
    """The radius-3 Lanczos kernel at distances x >= 0, float32."""
    radius = np.float32(3.0)
    pi = np.float32(np.pi)
    y = radius * np.sin(pi * x) * np.sin(pi * x / radius)
    with np.errstate(divide='ignore', invalid='ignore'):
        out = np.where(x > np.float32(1e-3),
                       y / np.where(x != 0, np.float32(np.pi ** 2) * (x * x),
                                    np.float32(1.0)),
                       np.float32(1.0))
    return np.where(x > radius, np.float32(0.0), out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


_KERNELS = {'lanczos3': _lanczos3, 'bilinear': _triangle}


@functools.lru_cache(maxsize=128)
def weight_matrix(in_size, out_size, method):
    """The (out_size, in_size) float32 CPU tensor that resamples one axis
    of length in_size to out_size (jax compute_weight_mat, transposed).
    Callers copy it to their device and never write to it."""
    kernel = _KERNELS[_METHODS[method]]
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))     # antialias
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[np.newaxis, :]
                - np.arange(in_size, dtype=np.float32)[:, np.newaxis])
         / kernel_scale)
    weights = kernel(x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > np.float32(1000.0) * _EPS,
                       weights / np.where(total != 0, total,
                                          np.float32(1.0)),
                       np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size - 0.5))
    weights = np.where(inside[np.newaxis, :], weights, np.float32(0.0))
    return torch.from_numpy(np.ascontiguousarray(weights.T,
                                                 dtype=np.float32))


def resize_nhwc(x, hw, method='lanczos3'):
    """Resizes an (n, h, w, c) tensor to (n, *hw, c) float32 on x's device.
    An axis whose size does not change is passed through untouched, as in
    jax.image.resize."""
    _, h, w, _ = x.shape
    out_h, out_w = int(hw[0]), int(hw[1])
    x = x.float()
    with tf32(False):
        if out_h != h:
            wh = weight_matrix(h, out_h, method).to(x.device)
            x = torch.einsum('oh,nhwc->nowc', wh, x)
        if out_w != w:
            ww = weight_matrix(w, out_w, method).to(x.device)
            x = torch.einsum('pw,nowc->nopc', ww, x)
    return x.contiguous()
