"""Spatial sharding for high-resolution outputs
(style_transfer2_tpu/parallel/spatial.py).

The JAX package annotates the engine's arrays with a sharding over the
mesh's 'space' axis and lets GSPMD place the collectives. The port is one
process that drives a list of devices with explicit per-device shards: a
placed array is a Sharded, its shards cut along H (W where H does not
divide), one a device of the axis. A device may repeat (several shards on
one card). What GSPMD inserted, the port does by hand, each a plain
differentiable function, so that autograd carries every gradient back to
the shard it came from:

  * 3x3 convs: a 1-row halo exchange (halo; zero rows at the image edge),
    then the kernel's SAME conv on the padded shard, cropped (ops/conv.py
    conv3x3_bias_relu_sharded);
  * Gram matrices: per-shard X^T X partials summed onto the mesh's first
    device (reduce_sum), the Gram difference broadcast back to each shard
    (ops/style.py style_branch_sharded);
  * TV's circular rolls: the first and last rows exchanged across the
    shards, the last shard's wrapping to the first (roll);
  * loss and trace scalars: sums of per-shard sums on the first device;
  * gather: the shards concatenated on one device.

Every exchange goes through Tensor.to(device), between shards of one card
too, where .to returns the tensor itself: each exchange reads its rows
into a new tensor (torch.cat), so nothing written in place aliases a
neighbour's rows.

Elementwise math on a Sharded runs shard by shard through
__torch_function__ (a whitelist: the optimizers' and the objective's
arithmetic, where, sqrt, square, abs, sign, and the like), with 0-d and
1-D tensors moved to each shard's device; a full sum or mean is a sum of
per-shard sums on the first device; torch.roll along the sharded axis is
the circular exchange. Anything else raises rather than compute per shard
what must see the whole array. So the optimizers (optim/) and the losses
(ops/losses.py) run on a Sharded as they are, and the few places that
must know, know: the L-BFGS dots and history (optim/lbfgs.py), the trunk
(models/vgg19.py), the style branch and the Gram.

Divisibility: the shards are equal, so the sharded dim must divide by the
axis size. Callers snap their grids with snap_hw() so that H divides; when
it does not, the placement shards W, and only replicates (a plain tensor
on the first device), LOUDLY, when neither divides and the array is large
enough that replication defeats the memory scaling. Small deep-pool
features replicate silently by design: in the trunk, a level whose shards
would pool unevenly is gathered onto the first device, and the rest of the
trunk runs there (models/vgg19.py).
"""

import contextlib
import logging

import numpy as np
import torch

logger = logging.getLogger('parallel')

# Replicating arrays below this size is free (deep pyramid levels at any
# resolution); above it, a silent fallback would quietly forfeit the memory
# scaling that spatial sharding exists to provide.
_WARN_BYTES = 64 * 1024 * 1024

# torch functions and Tensor methods (by name, without underscores at the
# ends) that act element by element: a Sharded runs them shard by shard.
_ELEMENTWISE = frozenset((
    'add', 'sub', 'mul', 'div', 'pow', 'sqrt', 'square', 'abs', 'sign',
    'where', 'zeros_like', 'index_select'))


def _name(func):
    return getattr(func, '__name__', '').strip('_')


class Sharded:
    """An array cut along `axis` into per-device shards of equal size, in
    mesh order. shape is the whole array's; dtype and device (the first
    shard's, where the mesh's scalars live) stand for the shards'."""

    __slots__ = ('shards', 'axis')

    def __init__(self, shards, axis):
        self.shards = list(shards)
        self.axis = int(axis)

    # -- what a tensor offers -------------------------------------------------

    @property
    def shape(self):
        shape = list(self.shards[0].shape)
        shape[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return torch.Size(shape)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    @property
    def devices(self):
        return [s.device for s in self.shards]

    @property
    def ndim(self):
        return self.shards[0].dim()

    def dim(self):
        return self.ndim

    def numel(self):
        return sum(s.numel() for s in self.shards)

    def map(self, fn, axis=None):
        """Sharded(fn(shard) for each shard), sharded along axis (default:
        this one's)."""
        return Sharded([fn(s) for s in self.shards],
                       self.axis if axis is None else axis)

    def gather(self, device=None):
        """The whole array on `device` (default: the first shard's), one
        differentiable concatenation."""
        device = self.device if device is None else torch.device(device)
        return torch.cat([s.to(device) for s in self.shards], self.axis)

    def float(self):
        return self.map(lambda s: s.float())

    def to(self, *args, **kwargs):
        """Each shard .to(*args): a dtype, where the shards stay."""
        return self.map(lambda s: s.to(*args, **kwargs))

    def detach(self):
        return self.map(torch.Tensor.detach)

    def requires_grad_(self, flag=True):
        for s in self.shards:
            s.requires_grad_(flag)
        return self

    def index_copy_(self, dim, index, source):
        """In place along a dim before the sharded one."""
        if dim % self.ndim >= self.axis:
            raise ValueError('Sharded: index_copy_ along the sharded dim')
        for s, src in zip(self.shards, _like(self, source).shards):
            s.index_copy_(dim, index.to(s.device), src)
        return self

    def __getitem__(self, key):
        """Indexing of the dims before the sharded one: ints, None and
        full slices."""
        key = key if isinstance(key, tuple) else (key,)
        axis, src = self.axis, 0
        for k in key:
            if k is None:
                axis += 1
            elif src == self.axis:
                raise IndexError('Sharded: cannot index the sharded dim %d'
                                 % self.axis)
            elif isinstance(k, int):
                axis -= 1
                src += 1
            elif k == slice(None):
                src += 1
            else:
                raise IndexError('Sharded: unsupported index %r' % (k,))
        return Sharded([s[key] for s in self.shards], axis)

    def __repr__(self):
        return 'Sharded(%s, axis=%d, %s, %d shards on %s)' % (
            tuple(self.shape), self.axis, self.dtype, len(self.shards),
            [str(d) for d in self.devices])

    # Arithmetic goes through torch, and so through __torch_function__.
    def __add__(self, o):
        return torch.add(self, o)

    def __radd__(self, o):
        return torch.add(o, self)

    def __sub__(self, o):
        return torch.sub(self, o)

    def __rsub__(self, o):
        return torch.sub(o, self)

    def __mul__(self, o):
        return torch.mul(self, o)

    def __rmul__(self, o):
        return torch.mul(o, self)

    def __truediv__(self, o):
        return torch.div(self, o)

    def __rtruediv__(self, o):
        return torch.div(o, self)

    def __pow__(self, o):
        return torch.pow(self, o)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in ('sum', 'mean') and len(args) == 1 and not kwargs:
            return _reduce(args[0], name)
        if name == 'roll':
            return roll(*args, **kwargs)
        if name in _ELEMENTWISE:
            return _per_shard(func, name, args, kwargs)
        raise TypeError('Sharded: %s is not defined on a sharded array '
                        '(parallel/spatial.py)' % (name or func,))


def _like(ref, other):
    """other as a Sharded laid out as ref is (raises if it is not)."""
    if not isinstance(other, Sharded):
        raise TypeError('Sharded: expected a sharded operand, got %s'
                        % type(other).__name__)
    _check_layout(ref, other, 'index_copy_')
    return other


def _check_layout(ref, other, what):
    if (other.ndim - other.axis != ref.ndim - ref.axis
            or [s.shape[other.axis] for s in other.shards]
            != [s.shape[ref.axis] for s in ref.shards]
            or other.devices != ref.devices):
        raise ValueError('Sharded: %s of differently sharded arrays '
                         '(%r, %r)' % (what, ref, other))


def _sharded_args(tree):
    if isinstance(tree, Sharded):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from _sharded_args(leaf)


def _pick(tree, i, device):
    """tree with each Sharded as its i-th shard and each other tensor (at
    most 1-D: scalars, indices) on that shard's device."""
    if isinstance(tree, Sharded):
        return tree.shards[i]
    if torch.is_tensor(tree):
        if tree.dim() > 1:
            raise TypeError('Sharded: a %s tensor beside a sharded array '
                            'is ambiguous' % (tuple(tree.shape),))
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_pick(leaf, i, device) for leaf in tree)
    return tree


def _per_shard(func, name, args, kwargs):
    operands = list(_sharded_args(list(args) + list(kwargs.values())))
    ref = operands[0]
    for other in operands[1:]:
        _check_layout(ref, other, name)
    if name == 'index_select':
        dim = args[1] if len(args) > 1 else kwargs['dim']
        if dim % ref.ndim >= ref.axis:
            raise ValueError('Sharded: index_select along the sharded dim')
    outs = []
    for i, device in enumerate(ref.devices):
        outs.append(func(*_pick(args, i, device),
                         **{k: _pick(v, i, device)
                            for k, v in kwargs.items()}))
    # The sharded dim keeps its place counted from the end (broadcasting
    # aligns dims from the end).
    return Sharded(outs, outs[0].dim() - (ref.ndim - ref.axis))


def _reduce(x, name):
    """torch.sum or torch.mean of the whole sharded array: the per-shard
    sums, in shard order, summed on the first device."""
    total = reduce_sum([torch.sum(s) for s in x.shards], x.device)
    return total / x.numel() if name == 'mean' else total


def reduce_sum(parts, device):
    """The sum of per-shard tensors on `device`, added in shard order."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def on_device(t):
    """torch.cuda.device(t.device) for a CUDA t, else a no-op context: a
    shard's kernels launch under its own device."""
    return (torch.cuda.device(t.device) if t.is_cuda
            else contextlib.nullcontext())


def broadcast(t, devices):
    """t on each of `devices` (the tensor itself on its own device)."""
    return [t.to(d) for d in devices]


def halo(x):
    """Each shard of x with one row (along x.axis) of each neighbour on
    either side, zero rows at the image edge: the padded shards a 3x3
    SAME conv needs. Differentiable: the gradient of a halo row flows back
    to the neighbour it came from."""
    d, shards = x.axis, x.shards
    out = []
    for i, s in enumerate(shards):
        edge = s.narrow(d, 0, 1)
        top = (shards[i - 1].narrow(d, shards[i - 1].shape[d] - 1, 1)
               .to(s.device) if i > 0 else torch.zeros_like(edge))
        bottom = (shards[i + 1].narrow(d, 0, 1).to(s.device)
                  if i + 1 < len(shards) else torch.zeros_like(edge))
        out.append(torch.cat([top, s, bottom], d))
    return out


def roll(x, shifts, dims):
    """torch.roll of a Sharded by one step: along another dim shard by
    shard, along the sharded dim with the circular exchange of the first
    and last rows (the last shard's -1 roll takes the first shard's first
    row, the first shard's +1 roll the last shard's last row)."""
    if isinstance(dims, (tuple, list)) or isinstance(shifts, (tuple, list)):
        raise ValueError('Sharded roll: one dim at a time')
    dims = dims % x.ndim
    if dims != x.axis:
        return x.map(lambda s: torch.roll(s, shifts, dims))
    if shifts not in (1, -1):
        raise ValueError('Sharded roll: only by one row across shards')
    d, shards, n = x.axis, x.shards, len(x.shards)
    out = []
    for i, s in enumerate(shards):
        if shifts == -1:
            nxt = shards[(i + 1) % n]
            out.append(torch.cat([s.narrow(d, 1, s.shape[d] - 1),
                                  nxt.narrow(d, 0, 1).to(s.device)], d))
        else:
            prv = shards[i - 1]
            out.append(torch.cat([prv.narrow(d, prv.shape[d] - 1, 1)
                                  .to(s.device),
                                  s.narrow(d, 0, s.shape[d] - 1)], d))
    return Sharded(out, d)


def gather(x, device=None):
    """x on one device: a Sharded gathered (Sharded.gather), anything else
    as it is."""
    return x.gather(device) if isinstance(x, Sharded) else x


def gather_tree(tree, device=None):
    """A dict tree with every Sharded leaf gathered."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return gather(tree, device)


def shard(x, dim, devices):
    """x cut along dim into len(devices) equal shards, each a copy of its
    own on its device."""
    size = x.shape[dim] // len(devices)
    return Sharded([x.narrow(dim, i * size, size).to(
        d, copy=True, memory_format=torch.contiguous_format)
        for i, d in enumerate(devices)], dim)


class SpatialPlacement:
    """Places engine arrays so the image H axis shards over a mesh axis.

    Array-rank conventions in the engine:
      4-D (1, H, W, C)          — iterate / content / feature maps / moments
      5-D (n_corr, 1, H, W, C)  — L-BFGS history buffers (sharded on the
                                  same H axis as the iterate)
      2-D (C, C)                — Gram matrices (replicated: placed via
                                  replicated(), never state())
      scalars                   — replicated
    A replicated array is a plain tensor on the mesh's first device."""

    def __init__(self, mesh, axis='space'):
        if axis not in mesh.axis_names:
            # Fall back to the first axis of a 1-D mesh.
            axis = mesh.axis_names[0]
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self._warned_shapes = set()

    @property
    def n_shards(self):
        return self.mesh.shape[self.axis]

    @property
    def device(self):
        """The first device: where replicated arrays and scalars live."""
        return self.devices[0]

    def snap_hw(self, hw):
        """The nearest grid at/above `hw` whose H (the preferred sharding
        axis) divides by the mesh axis — what sizing layers (CLI ladder,
        serving size_snap) should feed the engine so placements never
        silently degrade. W is snapped too so width-fallback sharding of
        aspect-flipped jobs also lands."""
        n = self.n_shards
        return tuple(-(-int(d) // n) * n for d in hw)

    def sharded_dim(self, shape):
        """H-axis sharding for image-like ranks (dim 1 of 4-D, 2 of 5-D),
        W when H does not divide, else None (replicated)."""
        ndim = len(shape)
        n = self.n_shards
        for d in ((1, 2) if ndim == 4 else (2, 3) if ndim == 5 else ()):
            if shape[d] % n == 0:
                return d
        self._note_replication(tuple(shape))
        return None

    def _note_replication(self, shape):
        """A big array replicating is the failure mode to shout about: a
        3840px job at an awkward aspect ratio would run unsharded and run
        out of memory with no hint why. Make it loud (once per shape)."""
        if len(shape) < 4 or shape in self._warned_shapes:
            return
        if int(np.prod(shape)) * 4 < _WARN_BYTES:
            return
        self._warned_shapes.add(shape)
        logger.warning(
            'spatial sharding FELL BACK TO REPLICATION for shape %s: '
            'neither H nor W divides by the %d-way %r mesh axis — this '
            'array occupies full memory on EVERY device. Snap the job '
            'size with SpatialPlacement.snap_hw() (CLI/serving do when a '
            'mesh is configured).', shape, self.n_shards, self.axis)

    def image(self, x):
        """Places a (1, H, W, C) tensor sharded on H (W as fallback)."""
        return self._place(x)

    def _place(self, x):
        if not (torch.is_tensor(x) or isinstance(x, Sharded)):
            return x
        axis = self.sharded_dim(tuple(x.shape))
        if isinstance(x, Sharded):
            if x.axis == axis and x.devices == self.devices:
                return x
            x = x.gather(self.device)
        if axis is None:
            return x.to(self.device)
        return shard(x, axis, self.devices)

    def replicated(self, tree):
        """A tree of tensors, each whole on the first device."""
        if isinstance(tree, dict):
            return {k: self.replicated(v) for k, v in tree.items()}
        if isinstance(tree, Sharded):
            return tree.gather(self.device)
        return tree.to(self.device) if torch.is_tensor(tree) else tree

    def state(self, tree):
        """Places an optimizer-state / feature tree leaf by leaf by shape."""
        if isinstance(tree, dict):
            return {k: self.state(v) for k, v in tree.items()}
        return self._place(tree)
