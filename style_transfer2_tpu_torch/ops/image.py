"""The image boundaries: preprocess and deprocess.

Counterpart of style_transfer2_tpu/ops/pallas/preprocess.py
(preprocess_pallas, deprocess_pallas), which compute exactly what the JAX
package's models/vgg19.py preprocess and deprocess compute:

    preprocess: HxWx3 RGB (uint8 or float) -> (1, H, W, 3) float32, mean
                subtracted, RGB order kept (no channel swap)
    deprocess:  (1, H, W, 3) float32 -> (H, W, 3) float32 RGB, mean added

On a CUDA device the wrappers launch the kernels in csrc/image.cu: a host
image crosses to the card in its own dtype (3 bytes a pixel for uint8) and
one kernel casts and subtracts; deprocess writes a fresh device tensor (not
a view of the iterate) before any host copy. On the CPU they run the plain
versions, preprocess_plain and deprocess_plain. Any other device raises.
Both kernels do one float32 subtract or add per element, as the plain
versions do, so the two agree bit for bit.
"""

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


def _mean_args():
    return tuple(float(m) for m in MEAN_RGB)


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


def _launch_preprocess(src):
    """src: an (H, W, 3) uint8 or float32 CUDA tensor."""
    global preprocess_launches
    if src.dtype not in _TORCH_IN_CODES:
        raise TypeError('preprocess: the kernel takes uint8 or float32, got '
                        '%s' % src.dtype)
    if src.dim() != 3 or src.shape[-1] != 3:
        raise ValueError('preprocess: expected (H, W, 3), got %s'
                         % (tuple(src.shape),))
    src = src.contiguous()
    out = torch.empty((1,) + tuple(src.shape), dtype=torch.float32,
                      device=src.device)
    err = _build.lib().st2_preprocess(
        _TORCH_IN_CODES[src.dtype], src.data_ptr(), out.data_ptr(),
        src.numel(), *_mean_args(),
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, 'st2_preprocess')
    preprocess_launches += 1
    return out


def _launch_deprocess(x):
    """x: a (1, H, W, 3) or (H, W, 3) float32 CUDA tensor."""
    global deprocess_launches
    if x.dtype != torch.float32:
        raise TypeError('deprocess: the kernel takes float32, got %s'
                        % x.dtype)
    if x.dim() == 4 and x.shape[0] == 1:
        x = x[0]
    if x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError('deprocess: expected (1, H, W, 3), got %s'
                         % (tuple(x.shape),))
    x = x.detach().contiguous()
    out = torch.empty(tuple(x.shape), dtype=torch.float32, device=x.device)
    err = _build.lib().st2_deprocess(
        x.data_ptr(), out.data_ptr(), x.numel(), *_mean_args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'st2_deprocess')
    deprocess_launches += 1
    return out


def preprocess(image, device):
    """HxWx3 (or 1xHxWx3) RGB host image, uint8 or float -> (1, H, W, 3)
    float32 on device, mean subtracted. Launches the kernel for a CUDA
    device; the plain version for the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return _launch_preprocess(torch.from_numpy(_host_image(image)).to(
            device))
    if device.type == 'cpu':
        return preprocess_plain(image, device)
    raise RuntimeError('preprocess: no kernel for device %s' % device)


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
