"""VGG-19 weights for the port (style_transfer2_tpu/models/weights.py).

Params dicts have the JAX package's format, {conv_name: {'w': HWIO (3, 3,
in, out), 'b': (out,)}}, as float32 numpy arrays; params_from_numpy turns
one into tensors on a device. random_params draws the same numbers as the
JAX package's, so both packages run the same network from one seed.

resolve_params loads what the JAX package's does, in the same order: an
.npz saved by its save_params, or the Caffe .caffemodel that
download_models.sh fetches, parsed here from the protobuf wire format with
numpy alone (a copy of the JAX package's reader, so that the port imports
nothing of it). The torchvision converter stays in the JAX package.
"""

import io
import logging
from pathlib import Path

import numpy as np
import torch

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


def load_params(path):
    """Loads a params dict saved by the JAX package's save_params()."""
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


def params_from_numpy(params_np, device, dtype=torch.float32):
    """The JAX package's params dict of HWIO numpy arrays -> the same dict
    of tensors in dtype on device."""
    return {name: {kind: torch.as_tensor(np.asarray(arr, np.float32),
                                         device=device).to(dtype)
                   for kind, arr in p.items()}
            for name, p in params_np.items()}
