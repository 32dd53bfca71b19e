"""VGG-19 weights for the port (style_transfer2_tpu/models/weights.py).

Params dicts have the JAX package's format, {conv_name: {'w': HWIO (3, 3,
in, out), 'b': (out,)}}, as float32 numpy arrays; params_from_numpy turns
one into tensors on a device. random_params draws the same numbers as the
JAX package's, so both packages run the same network from one seed.

resolve_params loads what the JAX package's does, in the same order: an
.npz saved by save_params, or the Caffe .caffemodel that
download_models.sh fetches, parsed here from the protobuf wire format with
numpy alone. write_caffemodel writes that format (the legacy V1 encoding
of the real file, or the modern one), and params_from_torchvision converts
a torchvision VGG-19 state dict (numpy arrays or torch tensors). All are
copies of the JAX package's, byte for byte the same files, so that the
port imports nothing of it.
"""

import io
import logging
from pathlib import Path

import numpy as np
import torch

from ..ops.image import MEAN_RGB
from .vgg19 import CONV_SPECS, IN_CHANNELS

logger = logging.getLogger('weights')


def random_params(seed=0):
    """Deterministic He-normal random weights, bit-identical to the JAX
    package's random_params(seed)."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, out_c in CONV_SPECS:
        in_c = IN_CHANNELS[name]
        fan_in = 3 * 3 * in_c
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), (3, 3, in_c, out_c))
        b = np.zeros((out_c,))
        params[name] = {'w': w.astype(np.float32), 'b': b.astype(np.float32)}
    return params


def save_params(params, path):
    """Saves a params dict to an .npz file, one array a 'conv/w' or
    'conv/b' key (the JAX package's format)."""
    flat = {}
    for name, p in params.items():
        flat[name + '/w'] = np.asarray(p['w'])
        flat[name + '/b'] = np.asarray(p['b'])
    np.savez(path, **flat)


def load_params(path):
    """Loads a params dict saved by save_params() (either package's)."""
    params = {}
    with np.load(path) as data:
        for key in data.files:
            name, kind = key.rsplit('/', 1)
            params.setdefault(name, {})[kind] = np.float32(data[key])
    return params


def resolve_params(spec='auto', root=None):
    """Resolves a weights spec to a numpy params dict, as the JAX package's
    resolve_params does.

    'auto': models/vgg19.npz under the repository root, else
    models/vgg19.caffemodel, else deterministic random weights (logged).
    'random': random_params(0). A path loads by its extension, '.npz' or
    '.caffemodel'."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    if spec in ('auto', '', None):
        npz = root / 'models' / 'vgg19.npz'
        caffemodel = root / 'models' / 'vgg19.caffemodel'
        if npz.exists():
            logger.info('Loading weights from %s', npz)
            return load_params(npz)
        if caffemodel.exists():
            logger.info('Converting weights from %s', caffemodel)
            return params_from_caffemodel(caffemodel)
        logger.warning('No VGG-19 weights found under %s; using '
                       'deterministic random weights (see '
                       'download_models.sh)', root / 'models')
        return random_params(0)
    if str(spec) == 'random':
        return random_params(0)
    path = Path(spec)
    if not path.is_absolute():
        path = root / path
    if path.suffix == '.npz':
        return load_params(path)
    if path.suffix == '.caffemodel':
        return params_from_caffemodel(path)
    raise ValueError('Unsupported weights spec: %r' % (spec,))


# Caffemodel (protobuf wire format) parsing, no Caffe required: the JAX
# package's reader (style_transfer2_tpu/models/weights.py), kept here.

def _read_varint(buf):
    result = 0
    shift = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError('Truncated varint')
        b = b[0]
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result
        shift += 7


def _iter_fields(data):
    """Yields (field_number, wire_type, value) over a serialized message.
    Length-delimited values come back as bytes; varints as ints; fixed32 as
    raw 4 bytes; fixed64 as raw 8 bytes."""
    buf = io.BytesIO(data)
    end = len(data)
    while buf.tell() < end:
        key = _read_varint(buf)
        field, wire_type = key >> 3, key & 7
        if wire_type == 0:
            yield field, wire_type, _read_varint(buf)
        elif wire_type == 1:
            yield field, wire_type, buf.read(8)
        elif wire_type == 2:
            length = _read_varint(buf)
            yield field, wire_type, buf.read(length)
        elif wire_type == 5:
            yield field, wire_type, buf.read(4)
        else:
            raise ValueError('Unsupported wire type %d' % wire_type)


def _parse_blob(data):
    """Parses a BlobProto: returns (shape tuple, float32 data array)."""
    num = channels = height = width = None
    shape = None
    values = []
    for field, wire_type, value in _iter_fields(data):
        if field == 1 and wire_type == 0:
            num = value
        elif field == 2 and wire_type == 0:
            channels = value
        elif field == 3 and wire_type == 0:
            height = value
        elif field == 4 and wire_type == 0:
            width = value
        elif field == 5 and wire_type in (2, 5):
            # Packed floats, or one unpacked float.
            values.append(np.frombuffer(value, dtype='<f4'))
        elif field == 7 and wire_type == 2:  # BlobShape
            dims = []
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1:
                    if w2 == 0:
                        dims.append(v2)
                    elif w2 == 2:  # packed varints
                        sub = io.BytesIO(v2)
                        while sub.tell() < len(v2):
                            dims.append(_read_varint(sub))
            shape = tuple(dims)
    data_arr = np.concatenate(values) if values else np.zeros(0, np.float32)
    if shape is None and num is not None:
        shape = tuple(d for d in (num, channels, height, width)
                      if d is not None)
    return shape, np.float32(data_arr)


def _parse_layer(data, name_field, blobs_field):
    """Parses a (V1)LayerParameter: returns (name, [(shape, data), ...])."""
    name = None
    blobs = []
    for field, wire_type, value in _iter_fields(data):
        if field == name_field and wire_type == 2:
            name = value.decode('utf-8', 'replace')
        elif field == blobs_field and wire_type == 2:
            blobs.append(_parse_blob(value))
    return name, blobs


def params_from_caffemodel(path):
    """Parses a Caffe NetParameter binary and returns the params dict for the
    truncated VGG-19's conv layers (HWIO weights, per-channel biases).

    Handles both the modern ``layer`` (field 100: LayerParameter, name=1,
    blobs=7) and legacy ``layers`` (field 2: V1LayerParameter, name=4,
    blobs=6) encodings. The blobs are used as stored (the reference feeds
    RGB-ordered data to them; see the JAX package's module note)."""
    with open(path, 'rb') as f:
        data = f.read()

    specs = dict(CONV_SPECS)
    params = {}
    for field, wire_type, value in _iter_fields(data):
        if wire_type != 2:
            continue
        if field == 100:  # modern LayerParameter
            name, blobs = _parse_layer(value, name_field=1, blobs_field=7)
        elif field == 2:  # legacy V1LayerParameter
            name, blobs = _parse_layer(value, name_field=4, blobs_field=6)
        else:
            continue
        if name in specs and len(blobs) >= 2:
            (_, w_data), (_, b_data) = blobs[0], blobs[1]
            out_c, in_c = specs[name], IN_CHANNELS[name]
            w = w_data.reshape((out_c, in_c, 3, 3))            # Caffe OIHW
            w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # -> HWIO
            params[name] = {'w': w, 'b': b_data.reshape((out_c,))}

    missing = set(specs) - set(params)
    if missing:
        raise ValueError('caffemodel is missing conv layers: %s'
                         % sorted(missing))
    return params


# Caffemodel (protobuf wire format) writing: the inverse of
# params_from_caffemodel, genuine NetParameter bytes faithful to the file
# download_models.sh fetches (legacy V1LayerParameter entries with
# num/channels/height/width blob dims and the parameter-free relu and pool
# layers between the convs), or modern LayerParameter entries with
# BlobShape dims.

def _write_varint(value):
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        out.append(bits | 0x80 if value else bits)
        if not value:
            return bytes(out)


def _write_field(field, wire_type):
    return _write_varint((field << 3) | wire_type)


def _write_delim(field, payload):
    return _write_field(field, 2) + _write_varint(len(payload)) + payload


def _write_blob(arr, shape, modern):
    """BlobProto: packed float32 data (field 5) plus either BlobShape
    (field 7, modern) or legacy num/channels/height/width (fields 1-4)."""
    out = b''
    if modern:
        dims = b''.join(_write_varint(d) for d in shape)
        out += _write_delim(7, _write_delim(1, dims))
    else:
        legacy = (shape if len(shape) == 4
                  else (1,) * (4 - len(shape)) + tuple(shape))
        for field, dim in zip((1, 2, 3, 4), legacy):
            out += _write_field(field, 0) + _write_varint(dim)
    out += _write_delim(5, np.ascontiguousarray(arr, '<f4').tobytes())
    return out


def _write_layer(name, type_str, type_enum, blobs, modern):
    if modern:  # LayerParameter (field 100): name=1, type=2, blobs=7
        payload = _write_delim(1, name.encode())
        payload += _write_delim(2, type_str.encode())
        for blob in blobs:
            payload += _write_delim(7, blob)
        return _write_delim(100, payload)
    # V1LayerParameter (field 2): name=4, type=5 (enum), blobs=6
    payload = _write_delim(4, name.encode())
    payload += _write_field(5, 0) + _write_varint(type_enum)
    for blob in blobs:
        payload += _write_delim(6, blob)
    return _write_delim(2, payload)


# V1LayerParameter.LayerType enum values (caffe.proto).
_V1_CONVOLUTION, _V1_RELU, _V1_POOLING = 4, 18, 17


def write_caffemodel(params, path, net_name='VGG_ILSVRC_19_layers',
                     modern=False):
    """Serializes a params dict to Caffe NetParameter wire bytes at path.

    modern=False (default) writes the legacy V1 encoding the real
    truncated VGG-19 caffemodel uses; modern=True writes LayerParameter
    entries with BlobShape dims. Both read back bit for bit through
    params_from_caffemodel."""
    out = _write_delim(1, net_name.encode())
    blocks = {}
    for conv, _ in CONV_SPECS:
        blocks.setdefault(conv[4], []).append(conv)
    for block in sorted(blocks):
        for conv in blocks[block]:
            w = np.asarray(params[conv]['w'], np.float32)   # HWIO
            b = np.asarray(params[conv]['b'], np.float32)
            oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
            out += _write_layer(conv, 'Convolution', _V1_CONVOLUTION, [
                _write_blob(oihw.ravel(), oihw.shape, modern),
                _write_blob(b, b.shape, modern)], modern)
            out += _write_layer('relu' + conv[4:], 'ReLU', _V1_RELU, [],
                                modern)
        out += _write_layer('pool%s' % block, 'Pooling', _V1_POOLING, [],
                            modern)
    with open(path, 'wb') as f:
        f.write(out)


# torchvision vgg19 "features" module indices of each conv layer.
_TORCHVISION_INDEX = {
    'conv1_1': 0, 'conv1_2': 2,
    'conv2_1': 5, 'conv2_2': 7,
    'conv3_1': 10, 'conv3_2': 12, 'conv3_3': 14, 'conv3_4': 16,
    'conv4_1': 19, 'conv4_2': 21, 'conv4_3': 23, 'conv4_4': 25,
    'conv5_1': 28, 'conv5_2': 30, 'conv5_3': 32, 'conv5_4': 34,
}

# torchvision's input normalization (the vgg19 weights card): p =
# raw/255, then per channel (p - mean) / std.
_TORCHVISION_MEAN = np.float32([0.485, 0.456, 0.406])
_TORCHVISION_STD = np.float32([0.229, 0.224, 0.225])


def _as_numpy(value):
    """A state dict entry (a numpy array or a torch tensor on any
    device) as a float32 numpy array."""
    if torch.is_tensor(value):
        value = value.detach().to('cpu', torch.float32).numpy()
    return np.float32(np.asarray(value))


def params_from_torchvision(state_dict, caffe_scale=False):
    """Converts a torchvision ``vgg19().state_dict()`` (keys
    ``features.N.weight``) or its ``features`` submodule's (``N.weight``)
    to a params dict; the values may be numpy arrays or torch tensors.
    Only the key layout is read: nothing of torchvision is imported.
    Raises KeyError where a conv layer is missing.

    caffe_scale=False returns the blobs verbatim: torchvision weights
    expect 0-1-normalized RGB input, so the engine's Caffe-style 0-255
    mean-subtracted preprocessing drives them at a 255x larger input
    scale. caffe_scale=True folds torchvision's input normalization into
    conv1_1: with t = (raw/255 - mean)/std (torch input) and c = raw -
    MEAN_RGB (ours), conv1_1 is affine in its input, so scaling its
    weights per input channel by 1/(255*std) and folding the offset
    (MEAN_RGB - 255*mean)/(255*std) into the bias makes W'c + b' == Wt + b.
    Interior pixels then match torchvision's pipeline to float precision;
    a 1-pixel border differs, since SAME padding's zeros mean different
    raw values in the two input spaces."""
    params = {}
    for name, idx in _TORCHVISION_INDEX.items():
        for prefix in ('features.%d.' % idx, '%d.' % idx):
            wk, bk = prefix + 'weight', prefix + 'bias'
            if wk in state_dict:
                w = _as_numpy(state_dict[wk])                 # OIHW
                params[name] = {
                    'w': np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                    'b': _as_numpy(state_dict[bk]),
                }
                break
        else:
            raise KeyError('State dict is missing weights for %s' % name)
    if caffe_scale:
        w = params['conv1_1']['w']                       # (3, 3, 3, out)
        w = w / (255.0 * _TORCHVISION_STD)[None, None, :, None]
        delta = MEAN_RGB - 255.0 * _TORCHVISION_MEAN     # per channel
        b = params['conv1_1']['b'] + np.einsum('ijco,c->o',
                                               np.float64(w), delta)
        params['conv1_1'] = {'w': np.float32(w), 'b': np.float32(b)}
    return params


def params_from_numpy(params_np, device, dtype=torch.float32):
    """The JAX package's params dict of HWIO numpy arrays -> the same dict
    of tensors in dtype on device."""
    return {name: {kind: torch.as_tensor(np.asarray(arr, np.float32),
                                         device=device).to(dtype)
                   for kind, arr in p.items()}
            for name, p in params_np.items()}
