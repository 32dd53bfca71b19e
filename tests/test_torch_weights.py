"""The port's weight loading and writing (style_transfer2_tpu_torch/
models/weights.py) against the JAX package's (style_transfer2_tpu/models/
weights.py), on the CPU: the same params dict, bit for bit, from the same
files, in the order the JAX package's resolve_params tries them; the same
.npz and .caffemodel files written, each package reading the other's; the
same torchvision conversion; and the same trace from converted weights."""

import numpy as np
import pytest
import torch

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.models import weights as jweights
from style_transfer2_tpu_torch.engine import StyleTransfer
from style_transfer2_tpu_torch.models import weights


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == {'w', 'b'}
        for kind in ('w', 'b'):
            assert got[name][kind].dtype == np.float32
            np.testing.assert_array_equal(got[name][kind], want[name][kind])


def _write_caffemodel(root, seed, modern):
    """models/vgg19.caffemodel under root, written by the JAX package from
    its random_params(seed), in the modern or the legacy encoding."""
    models = root / 'models'
    models.mkdir(exist_ok=True)
    path = models / 'vgg19.caffemodel'
    jweights.write_caffemodel(jweights.random_params(seed), path,
                              modern=modern)
    return path


@pytest.mark.parametrize('modern', [True, False])
def test_auto_loads_the_caffemodel_as_the_jax_package_does(tmp_path, modern):
    _write_caffemodel(tmp_path, 1, modern)
    got = weights.resolve_params('auto', tmp_path)
    want = jweights.resolve_params('auto', tmp_path)
    _assert_params_equal(got, want)
    _assert_params_equal(got, jweights.random_params(1))


@pytest.mark.parametrize('modern', [True, False])
@pytest.mark.parametrize('relative', [True, False])
def test_explicit_caffemodel_path_loads_bitwise(tmp_path, modern, relative):
    path = _write_caffemodel(tmp_path, 2, modern)
    spec = 'models/vgg19.caffemodel' if relative else str(path)
    got = weights.resolve_params(spec, tmp_path)
    _assert_params_equal(got, jweights.resolve_params(spec, tmp_path))
    _assert_params_equal(got, weights.params_from_caffemodel(path))


def test_auto_prefers_the_npz_to_the_caffemodel(tmp_path):
    _write_caffemodel(tmp_path, 1, False)
    jweights.save_params(jweights.random_params(3),
                         tmp_path / 'models' / 'vgg19.npz')
    got = weights.resolve_params('auto', tmp_path)
    _assert_params_equal(got, jweights.resolve_params('auto', tmp_path))
    _assert_params_equal(got, jweights.random_params(3))


def test_auto_without_files_gives_random_weights(tmp_path, caplog):
    with caplog.at_level('WARNING', logger='weights'):
        got = weights.resolve_params('auto', tmp_path)
    _assert_params_equal(got, jweights.random_params(0))
    assert 'random weights' in caplog.text


def test_caffemodel_missing_a_layer_raises(tmp_path):
    """conv3_2 renamed (to a name of the same length) in the file: both
    readers find it missing."""
    path = _write_caffemodel(tmp_path, 0, False)
    data = path.read_bytes()
    assert data.count(b'conv3_2') == 1
    path.write_bytes(data.replace(b'conv3_2', b'conv3_x'))
    for reader in (weights.params_from_caffemodel,
                   jweights.params_from_caffemodel):
        with pytest.raises(ValueError, match='conv3_2'):
            reader(path)


@pytest.mark.parametrize('spec', ['w.h5', 'weights.pth', 'models/vgg19'])
def test_unknown_extension_raises(tmp_path, spec):
    with pytest.raises(ValueError, match='Unsupported weights spec'):
        weights.resolve_params(spec, tmp_path)


def test_save_params_is_read_by_either_package(tmp_path):
    ours, theirs = tmp_path / 'ours.npz', tmp_path / 'theirs.npz'
    weights.save_params(weights.random_params(4), ours)
    jweights.save_params(jweights.random_params(5), theirs)
    _assert_params_equal(jweights.load_params(ours),
                         jweights.random_params(4))
    _assert_params_equal(weights.load_params(theirs),
                         jweights.random_params(5))
    _assert_params_equal(weights.load_params(ours),
                         jweights.load_params(ours))


@pytest.mark.parametrize('modern', [True, False])
def test_write_caffemodel_bytes_equal_the_jax_writer(tmp_path, modern):
    """The port's writer gives the JAX writer's bytes exactly; the JAX
    reader reads the port's file, the port's reader the JAX one's."""
    params = weights.random_params(6)
    ours, theirs = tmp_path / 'ours.caffemodel', tmp_path / 'theirs.caffemodel'
    weights.write_caffemodel(params, ours, modern=modern)
    jweights.write_caffemodel(jweights.random_params(6), theirs,
                              modern=modern)
    assert ours.read_bytes() == theirs.read_bytes()
    _assert_params_equal(jweights.params_from_caffemodel(ours), params)
    _assert_params_equal(weights.params_from_caffemodel(theirs), params)
    # A differently named net, and params given as torch tensors.
    as_torch = {name: {k: torch.from_numpy(v) for k, v in p.items()}
                for name, p in params.items()}
    weights.write_caffemodel(as_torch, ours, net_name='net', modern=modern)
    jweights.write_caffemodel(params, theirs, net_name='net', modern=modern)
    assert ours.read_bytes() == theirs.read_bytes()


def test_write_caffemodel_helpers_match():
    for value in (0, 1, 127, 128, 300, 2 ** 21 + 5, 2 ** 35):
        assert weights._write_varint(value) == jweights._write_varint(value)
    blob = np.arange(6, dtype=np.float32)
    for shape, modern in (((2, 3), True), ((2, 3), False), ((6,), False),
                          ((1, 1, 2, 3), False)):
        assert weights._write_blob(blob, shape, modern) == \
            jweights._write_blob(blob, shape, modern)
    for modern in (True, False):
        assert weights._write_layer('relu1_1', 'ReLU', 18, [], modern) == \
            jweights._write_layer('relu1_1', 'ReLU', 18, [], modern)


def _state_dict(params, prefix, as_torch):
    """params as a torchvision vgg19 state dict (OIHW), keys 'features.N.'
    (the whole model's) or 'N.' (its features module's), numpy arrays or
    torch tensors; N from the JAX package's index table."""
    state = {}
    for name, idx in jweights._TORCHVISION_INDEX.items():
        w = np.ascontiguousarray(params[name]['w'].transpose(3, 2, 0, 1))
        b = params[name]['b']
        if as_torch:
            w, b = torch.from_numpy(w), torch.from_numpy(b)
        state['%s%d.weight' % (prefix, idx)] = w
        state['%s%d.bias' % (prefix, idx)] = b
    return state


@pytest.mark.parametrize('caffe_scale', [False, True])
@pytest.mark.parametrize('as_torch', [False, True])
@pytest.mark.parametrize('prefix', ['features.', ''])
def test_params_from_torchvision_equals_the_jax_conversion(prefix, as_torch,
                                                           caffe_scale):
    params = jweights.random_params(8)
    params['conv1_1']['b'] = np.float32(
        np.random.RandomState(1).normal(size=64))
    state = _state_dict(params, prefix, as_torch)
    got = weights.params_from_torchvision(state, caffe_scale=caffe_scale)
    want = jweights.params_from_torchvision(
        _state_dict(params, prefix, False), caffe_scale=caffe_scale)
    _assert_params_equal(got, want)
    if not caffe_scale:
        _assert_params_equal(got, params)
    assert weights._TORCHVISION_INDEX == jweights._TORCHVISION_INDEX


def test_params_from_torchvision_takes_tensors_in_any_dtype():
    """bf16 or float64 tensors, with gradients: float32 numpy out."""
    params = jweights.random_params(3)
    state = _state_dict(params, 'features.', True)
    for key in list(state):
        state[key] = state[key].double().requires_grad_()
    got = weights.params_from_torchvision(state)
    _assert_params_equal(got, params)


@pytest.mark.parametrize('missing', ['features.0.weight', 'features.34.weight',
                                     'features.21.weight'])
def test_params_from_torchvision_missing_layer_raises(missing):
    state = _state_dict(jweights.random_params(0), 'features.', True)
    del state[missing]
    for convert in (weights.params_from_torchvision,
                    jweights.params_from_torchvision):
        with pytest.raises(KeyError, match='missing weights'):
            convert(state)


def test_converted_weights_trace_matches_jax():
    """A 32px float32 L-BFGS run from torchvision-converted weights
    (caffe_scale=True), the port's engine on the CPU against the JAX
    engine: every trace key at the golden rtol 5e-3."""
    params = jweights.random_params(11)
    state = _state_dict(params, 'features.', True)
    rng = np.random.RandomState(2)
    content, style, start = (rng.randint(0, 256, (32, 32, 3)).astype(
        np.uint8) for _ in range(3))
    runs = []
    for engine in (
            StyleTransfer(weights.params_from_torchvision(
                state, caffe_scale=True), device='cpu'),
            JaxStyleTransfer(jweights.params_from_torchvision(
                state, caffe_scale=True), use_pallas=True)):
        engine.set_weights({'content': {'conv4_2': 0.08},
                            'style': {'conv1_1': 1.0, 'conv2_1': 1.0,
                                      'conv3_1': 1.0, 'conv4_1': 1.0}},
                           {'p': 50.0, 'p_power': 6.0, 'tv': 5.0,
                            'tv_power': 2.0})
        engine.set_content(content)
        engine.set_style(style)
        engine.set_input(start)
        assert engine.start()
        for _ in range(4):
            engine.step()
        runs.append([t.data for t in engine.traces])
    got, want = runs
    assert len(got) == len(want) == 5
    for row, (a, b) in enumerate(zip(got, want)):
        keys = [k for k in b if k not in ('time', 'fevals')]
        assert [k for k in a if k not in ('time', 'fevals')] == keys
        for key in keys:
            np.testing.assert_allclose(a[key], b[key], rtol=5e-3,
                                       err_msg='row %d %s' % (row, key))
