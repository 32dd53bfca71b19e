"""Truncated VGG-19 feature extractor (style_transfer2_tpu/models/vgg19.py).

The reference's Caffe network (worker.py:32-106) as a PyTorch module:

  * 16 conv layers (3x3, pad 1) each with an in-place ReLU, 5 max-pools
    (2x2, stride 2), no FC layers. Blob order: data, conv1_1, conv1_2,
    pool1, ..., pool5.
  * A tap at "convX_Y" is the activation AFTER the ReLU; "poolN" is the pool
    output; "data" is the preprocessed input itself.
  * Max pooling has Caffe's ceil-mode output size (out = ceil(H/2)): the
    bottom/right edge is padded with -inf and the 2x2 windows are reduced
    with torch.amax, whose backward splits the gradient evenly among ties,
    like the JAX reference's jnp.max (F.max_pool2d would send it to one).
  * Preprocessing subtracts the RGB mean with NO channel reversal:
    preprocess and deprocess are ops.image's (the hand-written kernels on
    the card, the plain versions on the CPU), re-exported here.

Layout is NHWC throughout, with (1, H, W, 3) images and HWIO weights, as in
the JAX package. Every 3x3 conv goes through ops.conv.conv3x3_bias_relu:
the hand-written kernels on the card, the plain version on the CPU. The
JAX package's TPU layout rewrites (block-1 space-to-depth, the Mosaic
gates) have no counterpart here.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import backward_weights, conv3x3_bias_relu
from ..ops.image import MEAN_RGB, deprocess, preprocess  # noqa: F401

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
    """2x2 stride-2 max pool over NHWC with Caffe's ceil-mode output size."""
    n, h, w, c = x.shape
    pad_h, pad_w = h % 2, w % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h), value=float('-inf'))
    h2, w2 = (h + pad_h) // 2, (w + pad_w) // 2
    return torch.amax(x.reshape(n, h2, 2, w2, 2, c), dim=(2, 4))


def extract_features(params, x, layers=None, compute_dtype=torch.float32):
    """Runs the network forward and returns {blob: tap} for the requested
    blob names (default: all), stopping at the deepest one.

    params: {conv_name: {'w': (3, 3, in, out), 'b': (out,)}} tensors in
    compute_dtype on x's device (models.weights.params_from_numpy), each
    with 'wt', ops.conv.backward_weights(w), as VGG19Features keeps them;
    where a layer lacks 'wt' it is computed here, once per call. x: the
    preprocessed (1, H, W, 3) float32 input. The trunk runs in
    compute_dtype; the taps come back as float32."""
    if layers is None:
        layers = BLOB_NAMES
    layers = tuple(layers)
    unknown = set(layers) - set(BLOB_NAMES)
    if unknown:
        raise ValueError('Unknown blob names: %s' % sorted(unknown))
    wanted = frozenset(layers)
    deepest = max(blob_index(name) for name in layers) if layers else 0

    feats = {}
    if 'data' in wanted:
        feats['data'] = x
    h = x.to(compute_dtype)
    for name in BLOB_NAMES[1:deepest + 1]:
        if name.startswith('conv'):
            p = params[name]
            wt = p['wt'] if 'wt' in p else backward_weights(p['w'])
            # The tap is post-ReLU.
            h = conv3x3_bias_relu(h, p['w'], p['b'], wt)
        else:
            h = _max_pool_ceil(h)
        if name in wanted:
            feats[name] = h.float()
    return {name: feats[name] for name in layers}


class VGG19Features(nn.Module):
    """The truncated VGG-19 as a module over fixed weights, playing the role
    of the reference's CaffeModel (worker.py:32-106). The weights are
    buffers: nothing here trains them. Beside each layer's forward weights
    it keeps the backward's (`_wt`, flipped and transposed once here)."""

    def __init__(self, params, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        for name, p in params.items():
            w = p['w'].to(compute_dtype)
            self.register_buffer(name + '_w', w)
            self.register_buffer(name + '_b', p['b'].to(compute_dtype))
            self.register_buffer(name + '_wt', backward_weights(w))

    @property
    def params(self):
        return {name: {'w': getattr(self, name + '_w'),
                       'b': getattr(self, name + '_b'),
                       'wt': getattr(self, name + '_wt')}
                for name in CONV_NAMES if hasattr(self, name + '_w')}

    def forward(self, x, layers=None):
        with torch.no_grad():
            return extract_features(self.params, x, layers,
                                    self.compute_dtype)

    def features_and_vjp(self, x, layers):
        """Returns (features dict, vjp function): one forward that records
        the graph, and vjp(cotangents) = torch.autograd.grad of the taps
        with those cotangents injected, w.r.t. x — the moral equivalent of
        CaffeModel.backward's sectioned backward (worker.py:88-106). The
        features are detached; the vjp may be called once."""
        layers = tuple(layers)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            feats = extract_features(self.params, x, layers,
                                     self.compute_dtype)

        def vjp(diffs):
            outs = [feats[name] for name in layers]
            return torch.autograd.grad(
                outs, x, grad_outputs=[diffs[name] for name in layers])[0]

        return {name: f.detach() for name, f in feats.items()}, vjp
