"""The port's copies of the JAX package's host helpers resample_nchw
(utils/images.py) and debug_level (utils/config.py), held against the JAX
functions on the CPU."""

import numpy as np
import pytest

from style_transfer2_tpu import utils as jax_utils
from style_transfer2_tpu.utils import images as jax_images
from style_transfer2_tpu_torch import utils


@pytest.mark.parametrize('method', ['lanczos', 'bilinear'])
@pytest.mark.parametrize('hw', [(20, 28), (57, 77), (31, 31)])
def test_resample_nchw_matches_jax(monkeypatch, hw, method):
    """Against the JAX function's PIL path bit for bit, and against what it
    runs by default (its native resampler where that library is built)
    within tests/test_native.py's atol 0.05 (rtol 1e-4)."""
    rng = np.random.RandomState(0)
    a = rng.uniform(-20, 280, (2, 3, 40, 56)).astype(np.float32)
    ours = utils.resample_nchw(a, hw, method)
    assert ours.shape == (2, 3) + hw and ours.dtype == np.float32
    np.testing.assert_allclose(ours, jax_utils.resample_nchw(a, hw, method),
                               atol=0.05, rtol=1e-4)
    monkeypatch.setattr(jax_images, '_native_resample', None)
    np.testing.assert_array_equal(ours,
                                  jax_utils.resample_nchw(a, hw, method))
    # Each plane is the HWC resample's channel.
    if method == 'lanczos':
        hwc = utils.resample_hwc(a[1].transpose(1, 2, 0), hw)
        np.testing.assert_array_equal(ours[1], hwc.transpose(2, 0, 1))


def test_resample_nchw_takes_uint8_and_refuses_other_methods():
    u8 = np.random.RandomState(1).randint(0, 256, (1, 3, 24, 32)).astype(
        np.uint8)
    np.testing.assert_array_equal(utils.resample_nchw(u8, (36, 48)),
                                  utils.resample_nchw(np.float32(u8),
                                                      (36, 48)))
    with pytest.raises(ValueError, match='Unsupported resampling method'):
        utils.resample_nchw(u8, (36, 48), 'nearest')


@pytest.mark.parametrize('argv', [[], ['-d'], ['-ddd']])
@pytest.mark.parametrize('config_debug', [None, '0', '2'])
def test_debug_level_matches_jax(tmp_path, argv, config_debug):
    """The command line's --debug count plus the config's debug key, from
    the layered config as both packages read it."""
    extra = tmp_path / 'extra.ini'
    extra.write_text('[DEFAULT]\n' + ('' if config_debug is None
                                      else 'debug = %s\n' % config_debug))
    ours = utils.parse_args('x', [str(extra)] + argv)
    theirs = jax_utils.parse_args('x', [str(extra)] + argv)
    config = utils.read_config(ours)
    want = jax_utils.config.debug_level(theirs,
                                        jax_utils.read_config(theirs))
    assert utils.debug_level(ours, config) == want
    assert utils.debug_level(None, config) == \
        jax_utils.config.debug_level(None, config)
