"""The port's truncated VGG-19 and weights against the JAX package's, on the
CPU: the same numpy inputs through both, float32, rtol 1e-4 (with an atol of
1e-4 of the largest magnitude, for the post-ReLU entries near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.models import vgg19 as jvgg
from style_transfer2_tpu.models import weights as jweights
from style_transfer2_tpu_torch.models import vgg19, weights

SIZES = [(32, 32), (30, 22)]   # 30x22 runs odd grids through the ceil pool


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope='module')
def params_np():
    return jweights.random_params(3)


@pytest.fixture(scope='module')
def model(params_np):
    return vgg19.VGG19Features(weights.params_from_numpy(params_np, 'cpu'))


@pytest.mark.parametrize('seed', [0, 7])
def test_random_params_bit_identical(seed):
    ours = weights.random_params(seed)
    ref = jweights.random_params(seed)
    assert list(ours) == list(ref)
    for name in ref:
        for kind in ('w', 'b'):
            assert ours[name][kind].dtype == ref[name][kind].dtype
            np.testing.assert_array_equal(ours[name][kind], ref[name][kind])


def test_net_tables_match():
    assert vgg19.BLOB_NAMES == jvgg.BLOB_NAMES
    assert vgg19.CONV_SPECS == jvgg.CONV_SPECS
    np.testing.assert_array_equal(vgg19.MEAN_RGB, jvgg.MEAN_RGB)
    for name in jvgg.BLOB_NAMES:
        assert vgg19.blob_index(name) == jvgg.blob_index(name)
        assert vgg19.layer_channels(name) == jvgg.layer_channels(name)


def test_preprocess_deprocess_match(rng):
    image = rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    x = vgg19.preprocess(image, 'cpu')
    assert x.shape == (1, 9, 7, 3) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(),
                                  np.asarray(jvgg.preprocess(image)))
    np.testing.assert_allclose(vgg19.deprocess(x), image, atol=1e-4)


@pytest.mark.parametrize('hw', SIZES)
def test_all_taps_match_jax(params_np, model, hw):
    x = np.random.RandomState(1).uniform(-120, 130, (1,) + hw + (3,))
    x = np.float32(x)
    want = jvgg.extract_features(params_np, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    # (jit returns the dict with its keys sorted.)
    assert list(got) == list(vgg19.BLOB_NAMES) and set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert got[name].dtype == torch.float32
        _close(got[name], want[name])


@pytest.mark.parametrize('hw', SIZES)
def test_features_and_vjp_match_jax(params_np, model, hw):
    layers = ('data', 'conv1_1', 'pool1', 'conv2_1', 'conv3_1', 'pool3',
              'conv4_2')
    rng = np.random.RandomState(2)
    x = np.float32(rng.uniform(-120, 130, (1,) + hw + (3,)))
    jmodel = jvgg.VGG19Features(params_np)
    jfeats, jvjp = jmodel.features_and_vjp(jnp.asarray(x), layers)
    feats, vjp = model.features_and_vjp(torch.from_numpy(x), layers)
    cot = {name: np.float32(rng.randn(*jfeats[name].shape)) for name in layers}
    for name in layers:
        _close(feats[name], jfeats[name])
    want = jvjp({k: jnp.asarray(v) for k, v in cot.items()})
    got = vjp({k: torch.from_numpy(v) for k, v in cot.items()})
    _close(got, want)


def test_deepest_tap_stops_the_forward(model):
    x = torch.zeros(1, 8, 8, 3)
    assert list(model(x, ('conv1_2', 'data'))) == ['conv1_2', 'data']
    with pytest.raises(ValueError):
        model(x, ('conv6_1',))


def test_pool_splits_gradient_among_ties_like_jax():
    # A constant map: every 2x2 window is a four-way tie.
    x = np.ones((1, 4, 6, 2), np.float32)
    want = jax.grad(lambda a: jnp.sum(jvgg._max_pool_ceil(a)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    vgg19._max_pool_ceil(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), 0.25)


def test_params_from_numpy_dtype_and_layout(params_np):
    p = weights.params_from_numpy(params_np, 'cpu', torch.bfloat16)
    assert p['conv2_1']['w'].shape == (3, 3, 64, 128)
    assert p['conv2_1']['w'].dtype == torch.bfloat16
    assert p['conv2_1']['b'].shape == (128,)


def test_resolve_params(tmp_path):
    auto = weights.resolve_params('auto', tmp_path)
    np.testing.assert_array_equal(auto['conv1_1']['w'],
                                  jweights.random_params(0)['conv1_1']['w'])
    path = tmp_path / 'w.npz'
    jweights.save_params(jweights.random_params(4), path)
    loaded = weights.resolve_params(str(path), tmp_path)
    np.testing.assert_array_equal(loaded['conv5_4']['w'],
                                  jweights.random_params(4)['conv5_4']['w'])
    caffemodel = tmp_path / 'w.caffemodel'
    jweights.write_caffemodel(jweights.random_params(5), caffemodel)
    loaded = weights.resolve_params('w.caffemodel', tmp_path)
    np.testing.assert_array_equal(loaded['conv3_1']['w'],
                                  jweights.random_params(5)['conv3_1']['w'])
    with pytest.raises(ValueError):
        weights.resolve_params('w.pth', tmp_path)
