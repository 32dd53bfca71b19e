"""Truncated VGG-19 feature extractor (style_transfer2_tpu/models/vgg19.py).

The reference's Caffe network (worker.py:32-106) as a PyTorch module:

  * 16 conv layers (3x3, pad 1) each with an in-place ReLU, 5 max-pools
    (2x2, stride 2), no FC layers. Blob order: data, conv1_1, conv1_2,
    pool1, ..., pool5.
  * A tap at "convX_Y" is the activation AFTER the ReLU; "poolN" is the pool
    output; "data" is the preprocessed input itself.
  * Max pooling has Caffe's ceil-mode output size (out = ceil(H/2)), and
    its backward splits the gradient evenly among ties, like the JAX
    reference's jnp.max (F.max_pool2d would send it to one): ops/pool.py,
    the hand-written kernels on the card, on the CPU the plain version (the
    bottom/right edge padded with -inf, the 2x2 windows reduced with
    torch.amax).
  * Preprocessing subtracts the RGB mean with NO channel reversal:
    preprocess and deprocess are ops.image's (the hand-written kernels on
    the card, the plain versions on the CPU), re-exported here.

Layout is NHWC throughout, with (1, H, W, 3) images and HWIO weights, as in
the JAX package. Every 3x3 conv goes through ops.conv.conv3x3_bias_relu:
the hand-written kernels on the card, the plain version on the CPU. The
JAX package's TPU layout rewrites (block-1 space-to-depth, the Mosaic
gates) have no counterpart here.

Rematerialization (`remat`, the JAX package's policies, fixed per model):
False saves what autograd saves; True or 'conv' checkpoints each conv;
'block' checkpoints each segment of the trunk that ends at a pool (the
last one at the deepest tap), so that only the segments' inputs and the
requested taps outlive the forward. A checkpointed part runs its forward
again inside the backward, with the same kernels on the same inputs, so
the taps and the gradient keep their bits. Each conv's autograd function
already saves only its output (the next conv's input) and its backward
weights, so 'conv' trades one saved activation for another and saves
little here. Under 'block', where a tap is the conv's output itself (in
features_and_vjp, whose taps are in the compute dtype; in float32
everywhere), a tapped conv runs outside the checkpoints (it saves only
that tap, which the caller keeps anyway; inside, the backward would
recompute a second copy of it), so the forward leaves only the taps saved.
No policy
lowers the peak of a forward and its vjp with the style taps: it falls in
conv1_2's backward, which under every policy holds the taps, the caller's
cotangents, conv1_2's output and two gradients of its size.

Spatial sharding (parallel/spatial.py): x may be a Sharded, its H (or W)
cut into per-device shards. Each conv then runs shard by shard on the
shard and its halo rows (ops/conv.py conv3x3_bias_relu_sharded), and each
2x2 ceil pool shard by shard while every shard holds an even number of
rows (columns); the first level whose shards would pool unevenly is
gathered onto the first shard's device, and the rest of the trunk runs
there, unsharded (the small deep maps the JAX package replicates by
design). The taps come back Sharded down to that level, plain below it.
Every remat policy holds: a checkpointed part takes the shards as its
tensors.
"""

import functools

import torch
# torch.utils.checkpoint imports torch._dynamo at its first call, and that
# import leaves the calling frames (the caller's tensors, an engine and its
# step graphs with their memory pool) in a reference cycle until the
# garbage collector runs; imported here, it holds no engine's frame.
import torch._dynamo  # noqa: F401
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv import (backward_weights, conv3x3_bias_relu,
                        conv3x3_bias_relu_sharded)
from ..ops.image import MEAN_RGB, deprocess, preprocess  # noqa: F401
from ..ops.pool import max_pool_ceil
from ..parallel.spatial import Sharded, on_device

# (name, out_channels) for each conv layer, in network order.
CONV_SPECS = (
    ('conv1_1', 64), ('conv1_2', 64),
    ('conv2_1', 128), ('conv2_2', 128),
    ('conv3_1', 256), ('conv3_2', 256), ('conv3_3', 256), ('conv3_4', 256),
    ('conv4_1', 512), ('conv4_2', 512), ('conv4_3', 512), ('conv4_4', 512),
    ('conv5_1', 512), ('conv5_2', 512), ('conv5_3', 512), ('conv5_4', 512),
)
CONV_NAMES = tuple(name for name, _ in CONV_SPECS)

# All blob names in forward order (reference worker.py:73-75).
BLOB_NAMES = ('data',)
for _block in range(1, 6):
    _n_convs = 2 if _block <= 2 else 4
    BLOB_NAMES = BLOB_NAMES + tuple(
        'conv%d_%d' % (_block, i) for i in range(1, _n_convs + 1))
    BLOB_NAMES = BLOB_NAMES + ('pool%d' % _block,)

# Input channel count of each conv layer.
IN_CHANNELS = {}
_prev = 3
for _name, _out in CONV_SPECS:
    IN_CHANNELS[_name] = _prev
    _prev = _out


def blob_index(name):
    """Position of a blob in forward order; raises ValueError if unknown."""
    return BLOB_NAMES.index(name)


def layer_channels(name):
    """Channel count of a blob (a pool blob has its block's conv width)."""
    if name == 'data':
        return 3
    if name.startswith('conv'):
        return dict(CONV_SPECS)[name]
    return dict(CONV_SPECS)['conv%s_1' % name[4:]]


def _max_pool_ceil(x):
    """2x2 stride-2 max pool over NHWC with Caffe's ceil-mode output size
    (ops/pool.py max_pool_ceil)."""
    return max_pool_ceil(x)


def remat_policy(remat):
    """False, 'conv' or 'block' for a remat argument: False, True (which
    means 'conv'), 'conv' or 'block'. Raises ValueError for anything
    else."""
    if remat is False:
        return False
    if remat is True or remat == 'conv':
        return 'conv'
    if remat == 'block':
        return 'block'
    raise ValueError("remat must be False, True, 'conv' or 'block': %r"
                     % (remat,))


def _checkpoint(fn, *args):
    """fn(*args) with its saved tensors dropped after the forward and
    recomputed in the backward. Non-reentrant, so that a caller may take
    the gradient of intermediate taps (features_and_vjp); no RNG state is
    saved, since the trunk draws none and a CUDA graph capture may not
    read it."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _checkpoint_part(fn, h):
    """_checkpoint(fn, h) for fn(h) -> a tuple of tensors and Shardeds,
    with h a tensor or a Sharded: a Sharded goes in, and comes out, as its
    shards, the tensors the checkpoint tracks."""
    if not isinstance(h, Sharded):
        return _checkpoint(fn, h)
    layout = []

    def flat_fn(*shards):
        out = fn(Sharded(shards, h.axis))
        layout[:] = [(o.axis, len(o.shards)) if isinstance(o, Sharded)
                     else None for o in out]
        flat = []
        for o in out:
            flat += o.shards if isinstance(o, Sharded) else [o]
        return tuple(flat)

    flat = list(_checkpoint(flat_fn, *h.shards))
    out = []
    for part in layout:
        if part is None:
            out.append(flat.pop(0))
        else:
            out.append(Sharded(flat[:part[1]], part[0]))
            del flat[:part[1]]
    return tuple(out)


def _pool(h):
    """_max_pool_ceil of a tensor, or of a Sharded shard by shard (each
    under its own device) while its shards' extent along the sharded dim is
    even (the local pools are then the global one's); else of the gathered
    map."""
    if isinstance(h, Sharded):
        if h.shards[0].shape[h.axis] % 2 == 0:
            def pool_shard(s):
                with on_device(s):
                    return _max_pool_ceil(s)
            return h.map(pool_shard)
        h = h.gather()
    return _max_pool_ceil(h)


def _segments(names, policy, own_taps=()):
    """The blob names of the trunk cut into (names, checkpointed) parts,
    run in order: one part, not checkpointed, without block remat; else a
    checkpointed part ending at each pool and the last at the deepest tap,
    except that each conv in `own_taps` (whose tap is its output itself)
    is a part of its own, not checkpointed."""
    if policy != 'block':
        return [(names, False)] if names else []
    parts, cur = [], []
    for name in names:
        if name in own_taps:
            if cur:
                parts.append((tuple(cur), True))
                cur = []
            parts.append(((name,), False))
            continue
        cur.append(name)
        if name.startswith('pool'):
            parts.append((tuple(cur), True))
            cur = []
    if cur:
        parts.append((tuple(cur), True))
    return parts


def extract_features(params, x, layers=None, compute_dtype=torch.float32,
                     remat=False, params_on=None, tap_dtype=torch.float32):
    """Runs the network forward and returns {blob: tap} for the requested
    blob names (default: all), stopping at the deepest one.

    params: {conv_name: {'w': (3, 3, in, out), 'b': (out,)}} tensors in
    compute_dtype on x's device (models.weights.params_from_numpy), each
    with 'wt', ops.conv.backward_weights(w), as VGG19Features keeps them;
    where a layer lacks 'wt' it is computed here, once per call. x: the
    preprocessed (1, H, W, 3) float32 input. The trunk runs in
    compute_dtype; the conv and pool taps come back as tap_dtype (float32
    by default; the compute dtype gives each tap as the trunk's own
    tensor), the 'data' tap as x. remat: the policy of the module
    docstring (remat_policy); it changes no value. x may be a
    Sharded (module docstring); params_on(device) then gives the params on
    a shard's device (default: params, for shards on their device)."""
    policy = remat_policy(remat)
    if layers is None:
        layers = BLOB_NAMES
    layers = tuple(layers)
    unknown = set(layers) - set(BLOB_NAMES)
    if unknown:
        raise ValueError('Unknown blob names: %s' % sorted(unknown))
    wanted = frozenset(layers)
    deepest = max(blob_index(name) for name in layers) if layers else 0

    if params_on is None:
        def params_on(device):
            return params

    def weights(p):
        return p['w'], p['b'], p['wt'] if 'wt' in p else backward_weights(
            p['w'])

    def one_conv(*args):
        if policy == 'conv':
            return _checkpoint(conv3x3_bias_relu, *args)
        return conv3x3_bias_relu(*args)

    def conv(h, name):
        # The tap is post-ReLU.
        if isinstance(h, Sharded):
            return conv3x3_bias_relu_sharded(
                h, lambda device: weights(params_on(device)[name]), one_conv)
        return one_conv(h, *weights(params[name]))

    def run(names, h):
        """h through the blobs `names`: (h, the taps among them)."""
        taps = []
        for name in names:
            h = conv(h, name) if name.startswith('conv') else _pool(h)
            if name in wanted:
                taps.append(h.to(tap_dtype))
        return (h,) + tuple(taps)

    feats = {}
    if 'data' in wanted:
        feats['data'] = x
    h = x.to(compute_dtype)
    own_taps = (() if tap_dtype != compute_dtype else
                tuple(n for n in wanted if n.startswith('conv')))
    for names, checkpointed in _segments(BLOB_NAMES[1:deepest + 1], policy,
                                         own_taps):
        out = (_checkpoint_part(functools.partial(run, names), h)
               if checkpointed else run(names, h))
        h = out[0]
        feats.update(zip([n for n in names if n in wanted], out[1:]))
    return {name: feats[name] for name in layers}


class VGG19Features(nn.Module):
    """The truncated VGG-19 as a module over fixed weights, playing the role
    of the reference's CaffeModel (worker.py:32-106). The weights are
    buffers: nothing here trains them. Beside each layer's forward weights
    it keeps the backward's (`_wt`, flipped and transposed once here).
    remat: the rematerialization policy of features_and_vjp (module
    docstring), fixed here as in the JAX package."""

    def __init__(self, params, compute_dtype=torch.float32, remat=False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat_policy(remat)
        for name, p in params.items():
            w = p['w'].to(compute_dtype)
            self.register_buffer(name + '_w', w)
            self.register_buffer(name + '_b', p['b'].to(compute_dtype))
            self.register_buffer(name + '_wt', backward_weights(w))
        # Copies of the weights on the other devices of a spatial mesh.
        self._replicas = {}

    def params_on(self, device):
        """params on `device`: the buffers on their own device, else a copy
        kept for the model's life (a shard on another card)."""
        device = torch.device(device)
        if device == self.conv1_1_w.device:
            return self.params
        if device not in self._replicas:
            self._replicas[device] = {
                name: {k: t.to(device) for k, t in p.items()}
                for name, p in self.params.items()}
        return self._replicas[device]

    @property
    def params(self):
        return {name: {'w': getattr(self, name + '_w'),
                       'b': getattr(self, name + '_b'),
                       'wt': getattr(self, name + '_wt')}
                for name in CONV_NAMES if hasattr(self, name + '_w')}

    def forward(self, x, layers=None):
        with torch.no_grad():
            return extract_features(self.params, x, layers,
                                    self.compute_dtype,
                                    params_on=self.params_on)

    def features_and_vjp(self, x, layers):
        """Returns (features dict, vjp function): one forward that records
        the graph, and vjp(cotangents) = torch.autograd.grad of the taps
        with those cotangents injected, w.r.t. x — the moral equivalent of
        CaffeModel.backward's sectioned backward (worker.py:88-106). The
        features are detached; the vjp may be called once. The conv and
        pool taps are in the compute dtype (the JAX package's tap_dtype
        under its bf16 loss feed: in bfloat16 the bf16 conv outputs
        themselves, with bf16 cotangents), the 'data' tap float32 as x;
        forward() keeps float32 taps (content features, style Grams), as
        the JAX engine's model does. For a Sharded x
        the taps are Sharded down to the gathered level, each cotangent
        laid out as its tap, and the gradient is a Sharded laid out as x:
        one autograd pass over every shard's graph, which carries the halo
        rows' gradients back across the shards."""
        layers = tuple(layers)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            feats = extract_features(self.params, x, layers,
                                     self.compute_dtype, self.remat,
                                     self.params_on, self.compute_dtype)

        if isinstance(x, Sharded):
            def vjp(diffs):
                outs, grads = [], []
                for name in layers:
                    feat, diff = feats[name], diffs[name]
                    if isinstance(feat, Sharded):
                        outs += feat.shards
                        grads += diff.shards
                    else:
                        outs.append(feat)
                        grads.append(diff)
                return Sharded(torch.autograd.grad(outs, x.shards,
                                                   grad_outputs=grads),
                               x.axis)
        else:
            def vjp(diffs):
                outs = [feats[name] for name in layers]
                return torch.autograd.grad(
                    outs, x, grad_outputs=[diffs[name] for name in layers])[0]

        return {name: f.detach() for name, f in feats.items()}, vjp
