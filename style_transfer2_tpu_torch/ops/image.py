"""The image boundaries: preprocess and deprocess.

Counterpart of style_transfer2_tpu/ops/pallas/preprocess.py
(preprocess_pallas, deprocess_pallas), which compute exactly what the JAX
package's models/vgg19.py preprocess and deprocess compute:

    preprocess: HxWx3 RGB (uint8 or float) -> (1, H, W, 3) float32, mean
                subtracted, RGB order kept (no channel swap)
    deprocess:  (1, H, W, 3) float32 -> (H, W, 3) float32 RGB, mean added

On a CUDA device the wrappers launch the kernels in csrc/image.cu: a host
image crosses to the card in its own dtype (3 bytes a pixel for uint8) and
one kernel casts and subtracts; preprocess_on_device takes a float32 image
already on the device (video's chained warm start) with no host round
trip; deprocess writes a fresh device tensor (not a view of the iterate)
before any host copy. On the CPU they run the plain
versions, preprocess_plain and deprocess_plain. Any other device raises.
Both kernels do one float32 subtract or add per element, as the plain
versions do, so the two agree bit for bit.

A launch costs host time that, at these sizes, exceeds the kernel's own:
the wrappers keep to a few tensor calls, the launch plan (image_plan) is
built once per size and crosses as one pointer (ctypes converts each
argument on every call), and the means are compiled into the kernel.
"""

import ctypes
import functools

import numpy as np
import torch

from .. import _build

# RGB channel means (reference worker.py:34).
MEAN_RGB = np.float32([123.68, 116.779, 103.939])

# Launches of each kernel through the wrappers below (chip_smoke.py resets
# and reads these).
preprocess_launches = 0
deprocess_launches = 0

# Host dtypes that cross to the card as they are, and their kernel codes.
_IN_CODES = {np.dtype(np.float32): 0, np.dtype(np.uint8): 1}
_TORCH_IN_CODES = {torch.float32: 0, torch.uint8: 1}

# The kernels' launch geometry (csrc/image.cu): threads a block, elements a
# thread owns per step (4 RGB pixels), and the blocks 132 SMs hold at once
# (2048 threads each).
_THREADS = 256
_GROUP = 12
_RESIDENT_BLOCKS = 132 * 2048 // _THREADS
_MAX_N = 2 ** 31 - 1    # the kernels index in 32 bits (C int n)


def image_plan(n, aligned):
    """(blocks, groups, tail) of a launch over n elements: `groups` groups
    of 12 elements (4 pixels) a thread as vectors where both pointers are
    16-byte `aligned` (else none), then the elements from `tail` to n one at
    a time; one thread for each group or tail element, at most the blocks
    132 SMs hold at once (a grid-stride loop covers the rest)."""
    groups = n // _GROUP if aligned else 0
    tail = groups * _GROUP
    work = max(groups, n - tail)
    return max(1, min(-(-work // _THREADS), _RESIDENT_BLOCKS)), groups, tail


def preprocess_plain(image, device):
    """The plain version: HxWx3 (or 1xHxWx3) RGB uint8/float -> (1, H, W, 3)
    float32 on device, mean subtracted."""
    arr = torch.as_tensor(np.asarray(image, np.float32), device=device)
    if arr.dim() == 3:
        arr = arr[None]
    return arr - torch.as_tensor(MEAN_RGB, device=device)


def deprocess_plain(x):
    """The plain version: (1, H, W, 3) or (H, W, 3) tensor -> a fresh
    (H, W, 3) float32 tensor on x's device, mean added."""
    arr = x.detach().float()
    if arr.dim() == 4:
        arr = arr[0]
    return arr + torch.as_tensor(MEAN_RGB, device=arr.device)


def _host_image(image):
    """An HxWx3 (or 1xHxWx3) host image as a C-contiguous (H, W, 3) array,
    uint8 and float32 kept as they are, anything else cast to float32.
    Writable too: torch.from_numpy warns on a read-only array, such as
    numpy's view of a PIL image."""
    arr = np.asarray(image)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError('preprocess: expected an HxWx3 RGB image, got '
                         'shape %s' % (arr.shape,))
    if arr.dtype not in _IN_CODES:
        arr = arr.astype(np.float32)
    return np.require(arr, requirements=('C', 'W'))


@functools.lru_cache(maxsize=64)
def _plan_arg(n, aligned, in_code=0):
    """(plan, its address): image_plan as the kernels take it, a C
    {in_dtype, n, blocks, groups, tail} (csrc/image.cu: Plan) built once
    per size and kept alive here, so that a launch passes one pointer."""
    plan = (ctypes.c_int * 5)(in_code, n, *image_plan(n, aligned))
    return plan, ctypes.addressof(plan)


def _launch_preprocess(src):
    """src: an (H, W, 3) or (1, H, W, 3) uint8 or float32 CUDA tensor; the
    result has its shape, in float32."""
    global preprocess_launches
    code = _TORCH_IN_CODES.get(src.dtype)
    if code is None:
        raise TypeError('preprocess: the kernel takes uint8 or float32, got '
                        '%s' % src.dtype)
    shape = src.shape
    n = shape.numel()
    if len(shape) != 3 and (len(shape) != 4 or shape[0] != 1) \
            or shape[-1] != 3 or n > _MAX_N:
        raise ValueError('preprocess: expected (H, W, 3) or (1, H, W, 3) '
                         'with at most %d elements, got %s'
                         % (_MAX_N, tuple(shape)))
    if not src.is_contiguous():
        src = src.contiguous()
    out = torch.empty_like(src, dtype=torch.float32)
    src_ptr, out_ptr = src.data_ptr(), out.data_ptr()
    err = _build.lib().st2_preprocess(
        src_ptr, out_ptr, _plan_arg(n, not (src_ptr | out_ptr) & 15, code)[1],
        _build.stream(src))
    _build.check(err, 'st2_preprocess')
    preprocess_launches += 1
    return out


def _launch_deprocess(x):
    """x: a (1, H, W, 3) or (H, W, 3) float32 CUDA tensor."""
    global deprocess_launches
    if x.dtype is not torch.float32:
        raise TypeError('deprocess: the kernel takes float32, got %s'
                        % x.dtype)
    dim = x.dim()
    if dim == 4:
        one, h, w, c = x.shape
    elif dim == 3:
        one, (h, w, c) = 1, x.shape
    if dim not in (3, 4) or one != 1 or c != 3:
        raise ValueError('deprocess: expected (1, H, W, 3), got %s'
                         % (tuple(x.shape),))
    n = h * w * 3
    if n > _MAX_N:
        raise ValueError('deprocess: %d elements, the kernel takes at most '
                         '%d' % (n, _MAX_N))
    if not x.is_contiguous():
        x = x.contiguous()
    out = x.new_empty(h, w, 3)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    err = _build.lib().st2_deprocess(
        x_ptr, out_ptr, _plan_arg(n, not (x_ptr | out_ptr) & 15)[1],
        _build.stream(x))
    _build.check(err, 'st2_deprocess')
    deprocess_launches += 1
    return out


def preprocess(image, device):
    """HxWx3 (or 1xHxWx3) RGB host image, uint8 or float -> (1, H, W, 3)
    float32 on device, mean subtracted. Launches the kernel for a CUDA
    device; the plain version for the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return _launch_preprocess(torch.from_numpy(
            _host_image(image)[None]).to(device))
    if device.type == 'cpu':
        return preprocess_plain(image, device)
    raise RuntimeError('preprocess: no kernel for device %s' % device)


def preprocess_on_device(x):
    """An (H, W, 3) or (1, H, W, 3) float32 RGB tensor already on its
    device -> a fresh (1, H, W, 3) float32 tensor there, mean subtracted.
    Launches the kernel for a CUDA x (no host copy); the plain version for
    a CPU x."""
    if x.dtype is not torch.float32:
        raise TypeError('preprocess_on_device: expected float32, got %s'
                        % x.dtype)
    if x.is_cuda:
        out = _launch_preprocess(x)
        return out if out.dim() == 4 else out[None]
    if x.device.type == 'cpu':
        return preprocess_plain(x, x.device)
    raise RuntimeError('preprocess: no kernel for device %s' % x.device)


def deprocess_on_device(x):
    """(1, H, W, 3) iterate -> a fresh (H, W, 3) float32 RGB tensor on x's
    device. Launches the kernel for a CUDA x; the plain version for a CPU
    x."""
    if x.is_cuda:
        return _launch_deprocess(x.float())
    if x.device.type == 'cpu':
        return deprocess_plain(x)
    raise RuntimeError('deprocess: no kernel for device %s' % x.device)


def deprocess(x):
    """Inverse of preprocess: (1, H, W, 3) tensor -> HxWx3 float32 numpy
    (the device result, then one host copy)."""
    return deprocess_on_device(x).cpu().numpy()
