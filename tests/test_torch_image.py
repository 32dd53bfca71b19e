"""The image boundaries (ops/image.py): the plain versions of preprocess and
deprocess against the JAX package's Pallas kernels (preprocess_pallas and
deprocess_pallas, in interpret mode on the CPU, as tests/test_pallas.py runs
them), and the wrappers' dispatch rules. The CUDA kernels themselves are
held against the plain versions on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.models import vgg19 as jvgg
from style_transfer2_tpu.ops.pallas.preprocess import (deprocess_pallas,
                                                       preprocess_pallas)
from style_transfer2_tpu_torch.models import vgg19
from style_transfer2_tpu_torch.ops import image

SIZE = (37, 41)     # odd H and odd W*3 (123 elements a row)


def _image(dtype, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, SIZE + (3,)).astype(np.uint8)
    return np.float32(rng.uniform(-20.0, 275.0, SIZE + (3,)))


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_preprocess_plain_equals_pallas_bitwise(dtype):
    img = _image(dtype)
    got = image.preprocess_plain(img, 'cpu').numpy()
    want = np.asarray(preprocess_pallas(jnp.asarray(img)))
    assert got.shape == want.shape == (1,) + SIZE + (3,)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jvgg.preprocess(img)))


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_deprocess_plain_matches_pallas_and_round_trips(dtype):
    img = _image(dtype, seed=1)
    x = image.preprocess_plain(img, 'cpu')
    got = image.deprocess_plain(x).numpy()
    want = np.asarray(deprocess_pallas(jnp.asarray(x.numpy())))
    assert got.shape == want.shape == SIZE + (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.float32(img), atol=1e-4)
    np.testing.assert_array_equal(image.deprocess(x), got)


def test_cpu_takes_the_plain_versions_without_launching():
    before = (image.preprocess_launches, image.deprocess_launches)
    img = _image(np.uint8, seed=2)
    x = image.preprocess(img, 'cpu')
    np.testing.assert_array_equal(x.numpy(),
                                  image.preprocess_plain(img, 'cpu').numpy())
    np.testing.assert_array_equal(image.deprocess(x),
                                  image.deprocess_plain(x).numpy())
    assert (image.preprocess_launches, image.deprocess_launches) == before
    # The model's boundaries are these wrappers.
    assert vgg19.preprocess is image.preprocess
    assert vgg19.deprocess is image.deprocess
    assert vgg19.MEAN_RGB is image.MEAN_RGB


def test_batched_and_other_dtypes_preprocess_alike():
    img = _image(np.uint8, seed=3)
    one = image.preprocess(img, 'cpu')
    np.testing.assert_array_equal(image.preprocess(img[None], 'cpu'), one)
    np.testing.assert_array_equal(
        image.preprocess(np.float64(img), 'cpu'), one)


def test_deprocess_writes_a_fresh_tensor():
    x = image.preprocess(_image(np.float32, seed=4), 'cpu')
    kept = x.clone()
    out = image.deprocess_on_device(x)
    assert out.shape == SIZE + (3,) and out.device == x.device
    out += 1.0
    torch.testing.assert_close(x, kept, rtol=0, atol=0)


def test_host_image_keeps_uint8_and_float32():
    assert image._host_image(_image(np.uint8)).dtype == np.uint8
    assert image._host_image(_image(np.float32)).dtype == np.float32
    assert image._host_image(np.zeros((1, 4, 5, 3), np.float64)).dtype == \
        np.float32
    view = _image(np.uint8)[:, ::2]
    assert image._host_image(view).flags['C_CONTIGUOUS']
    with pytest.raises(ValueError):
        image._host_image(np.zeros((4, 5, 4), np.uint8))


def test_other_devices_raise():
    with pytest.raises(RuntimeError):
        image.preprocess(_image(np.uint8), 'meta')
    with pytest.raises(RuntimeError):
        image.deprocess(torch.empty(1, 4, 4, 3, device='meta'))
