"""Device meshes (style_transfer2_tpu/parallel/mesh.py).

Axis convention: ('data', 'space'): batch lanes ride 'data' (one user job
per lane, parallel/batch.py DataPlacement), the image height axis shards
over 'space' for high-resolution jobs (parallel/spatial.py
SpatialPlacement). The JAX package's Mesh is a grid of devices that GSPMD
places collectives over; the port's is the same grid of torch.devices,
which one process drives with explicit per-device shards.
"""

import numpy as np
import torch


class Mesh:
    """A grid of torch.devices with named axes. devices: a numpy object
    array of torch.device, shaped (n,) or (A, B); axis_names: one name an
    axis; shape: {axis name: size}, as the JAX Mesh's. A device may appear
    more than once (several shards on one card)."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError('a %d-D mesh needs %d axis names, got %r'
                             % (devices.ndim, devices.ndim, axis_names))
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis):
        """The devices along `axis`, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, -1).reshape(
            -1, self.devices.shape[i])[0])


def _shape_of(spec, n_available):
    if spec in ('auto', '', None):
        return (n_available,)
    if isinstance(spec, int) or (isinstance(spec, str) and spec.isdigit()):
        return (int(spec),)
    if isinstance(spec, (tuple, list)):
        return tuple(int(s) for s in spec)
    return tuple(int(s) for s in str(spec).lower().split('x'))


def available_devices(device='cuda', n=1):
    """The devices a mesh may take on `device`: every CUDA device on
    'cuda' (raising without CUDA, as engine.resolve_device does), or n
    entries of torch.device('cpu') on 'cpu', where one process stands in
    for n devices (the CPU counterpart of the virtual host devices that
    the JAX package's tests create)."""
    kind = torch.device(device).type
    if kind == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('device %s requested, but CUDA is not '
                               'available (use --device cpu for the plain '
                               'PyTorch path)' % device)
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    if kind != 'cpu':
        raise ValueError('unsupported device %s' % device)
    return [torch.device('cpu')] * max(1, int(n))


def make_mesh(spec='auto', axis_names=('data', 'space'), devices=None,
              device='cuda'):
    """Builds a Mesh from a config-style spec: 'auto' (every device on the
    first axis), an int N or 'N' (the first N devices, 1-D), 'AxB' (2-D,
    A*B devices over (data, space)) or a tuple of axis sizes.

    devices: an explicit list (a device may repeat, as several shards on
    one card); else available_devices(device): on 'cuda' every card, and
    a spec that needs more raises ValueError('Mesh %r needs %d devices,
    have %d'); on 'cpu' the spec's count of torch.device('cpu') entries,
    so that 'auto' is ONE entry there."""
    if devices is None:
        want = int(np.prod(_shape_of(spec, 1)))
        devices = available_devices(device, want)
    devices = [torch.device(d) for d in devices]
    shape = _shape_of(spec, len(devices))
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError('Mesh %r needs %d devices, have %d'
                         % (spec, n, len(devices)))
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names[:len(shape)])
