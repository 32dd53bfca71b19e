"""The port's weight loading (style_transfer2_tpu_torch/models/weights.py)
against the JAX package's (style_transfer2_tpu/models/weights.py), on the
CPU: the same params dict, bit for bit, from the same files, in the order
the JAX package's resolve_params tries them."""

import numpy as np
import pytest

from style_transfer2_tpu.models import weights as jweights
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
