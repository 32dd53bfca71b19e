"""The image boundaries (ops/image.py): the plain versions of preprocess and
deprocess against the JAX package's Pallas kernels (preprocess_pallas and
deprocess_pallas, in interpret mode on the CPU, as tests/test_pallas.py runs
them), and the wrappers' dispatch rules. The CUDA kernels themselves are
held against the plain versions on the card in test_torch_cuda.py; here
their launch plan (image_plan) is walked as the kernel walks it, and the
means compiled into csrc/image.cu are held against MEAN_RGB."""

import fractions
import re
from pathlib import Path

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


# The 1024px ladder's rungs (utils.scales((768, 1024), min_size=96)).
LADDER_1024 = [(96, 128), (136, 181), (192, 256), (272, 362), (384, 512),
               (543, 724), (768, 1024)]


def _covered(n, plan):
    """How many times the kernel's two loops (csrc/image.cu) write each of
    the n elements under the plan (blocks, groups, tail)."""
    blocks, groups, tail = plan
    count = np.zeros(n, np.int32)
    threads = blocks * image._THREADS
    # Thread t takes groups t, t + threads, ... and tail elements
    # tail + t, tail + t + threads, ...: together every index below the
    # bound once.
    for t in range(min(threads, max(groups, n - tail, 0))):
        for k in range(t, groups, threads):
            count[k * 12:(k + 1) * 12] += 1
        for i in range(tail + t, n, threads):
            count[i] += 1
    return count


@pytest.mark.parametrize('hw', LADDER_1024 + [(37, 41), (1, 1), (3, 5),
                                              (1, 4), (5, 7)])
@pytest.mark.parametrize('aligned', [True, False])
def test_image_plan_covers_each_element_once(hw, aligned):
    n = hw[0] * hw[1] * 3
    blocks, groups, tail = plan = image.image_plan(n, aligned)
    assert 1 <= blocks <= image._RESIDENT_BLOCKS == 132 * 8
    assert tail == 12 * groups <= n
    assert groups == (n // 12 if aligned else 0)
    # One thread for each group or tail element, up to one full wave.
    work = max(groups, n - tail)
    assert blocks == min(-(-work // 256), 132 * 8) or work == 0
    if n <= 362 * 272 * 3:          # the Python walk stays quick
        assert (_covered(n, plan) == 1).all()


def _emulate_preprocess(img, aligned):
    """preprocess as csrc/image.cu computes it under image_plan: lane j of
    a group takes mean[j % 3], a tail element i takes mean[i % 3]."""
    flat = np.float32(img).ravel()
    _, groups, tail = image.image_plan(flat.size, aligned)
    out = np.empty_like(flat)
    lanes = flat[:12 * groups].reshape(groups, 12)
    out[:12 * groups] = (lanes - image.MEAN_RGB[np.arange(12) % 3]).ravel()
    out[tail:] = flat[tail:] - image.MEAN_RGB[np.arange(tail, flat.size) % 3]
    return out.reshape((1,) + img.shape)


@pytest.mark.parametrize('hw', [(136, 181), (543, 724), (37, 41), (5, 7)])
@pytest.mark.parametrize('aligned', [True, False])
def test_kernel_lanes_take_the_plain_versions_means(hw, aligned):
    """At odd widths (W*3 odd) a group still starts at channel 0: 12
    elements are 4 whole pixels, so the lanes' fixed means are right."""
    img = np.random.RandomState(hw[1]).randint(0, 256, hw + (3,)).astype(
        np.uint8)
    np.testing.assert_array_equal(_emulate_preprocess(img, aligned),
                                  image.preprocess_plain(img, 'cpu').numpy())


def _float32_of_decimal(text):
    """The float32 nearest the decimal `text` (ties to even), the value a
    C compiler gives the literal `text`f."""
    want = fractions.Fraction(text)
    near = np.float32(float(want))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(fractions.Fraction(float(c))
                                         - want),
                                     int(c.view(np.uint32)) & 1))


def test_kernel_means_equal_mean_rgb_bit_for_bit():
    src = (Path(image.__file__).resolve().parents[1] / 'csrc'
           / 'image.cu').read_text()
    literals = dict(re.findall(
        r'constexpr float MEAN_([RGB]) = ([0-9.]+)f;', src))
    assert sorted(literals) == ['B', 'G', 'R']
    got = np.float32([_float32_of_decimal(literals[c]) for c in 'RGB'])
    np.testing.assert_array_equal(got.view(np.uint32),
                                  image.MEAN_RGB.view(np.uint32))


def test_launch_wrappers_check_before_launching():
    """Wrong inputs raise before the library is loaded (meta tensors: no
    memory, no card)."""
    meta = 'meta'
    with pytest.raises(TypeError):
        image._launch_preprocess(torch.empty(4, 5, 3, dtype=torch.int16,
                                             device=meta))
    with pytest.raises(ValueError):
        image._launch_preprocess(torch.empty(4, 5, 4, dtype=torch.uint8,
                                             device=meta))
    with pytest.raises(ValueError):
        image._launch_preprocess(torch.empty(2, 4, 5, 3, dtype=torch.uint8,
                                             device=meta))
    with pytest.raises(ValueError, match='at most'):
        image._launch_preprocess(torch.empty(2 ** 16, 2 ** 15, 3,
                                             dtype=torch.uint8, device=meta))
    with pytest.raises(TypeError):
        image._launch_deprocess(torch.empty(1, 4, 5, 3, dtype=torch.float16,
                                            device=meta))
    with pytest.raises(ValueError):
        image._launch_deprocess(torch.empty(2, 4, 5, 3, device=meta))
    with pytest.raises(ValueError, match='at most'):
        image._launch_deprocess(torch.empty(1, 2 ** 16, 2 ** 14, 3,
                                            device=meta))
