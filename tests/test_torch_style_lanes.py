"""The style branch with a lane axis (ops/style.py: (B, h, w, C) maps with
(B, C, C) targets): its plain version against the JAX package's Pallas
fused_style_branch (interpret mode on the CPU) under jax.vmap, lane by
lane against the one-map form, and the lane-aware launch plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.ops.pallas.style_kernel import (
    fused_style_branch as jfused_style_branch)
from style_transfer2_tpu_torch.ops import style

# tests/test_torch_kernels.py's tolerance for the one-map form.
RTOL = 1e-4


def _lanes(seed, b, h, w, c):
    """B ReLU'd maps and B target Grams of other ReLU'd maps."""
    rng = np.random.RandomState(seed)
    feat = np.float32(np.maximum(rng.randn(b, h, w, c), 0))
    other = np.float32(np.maximum(rng.randn(b, h * w, c), 0))
    grams = np.float32(np.einsum('bmi,bmj->bij', other, other)
                       / (h * w * c))
    return feat, grams


@pytest.mark.parametrize('c', [64, 128])
@pytest.mark.parametrize('b', [1, 3])
def test_plain_lanes_match_vmapped_pallas_interpret(b, c):
    feat, grams = _lanes(b * c, b, 7, 9, c)
    s, gd = style.fused_style_branch(torch.from_numpy(feat),
                                     torch.from_numpy(grams))
    vmapped = jax.vmap(lambda f, g: jfused_style_branch(f[None], g))
    js, jgd = vmapped(jnp.asarray(feat), jnp.asarray(grams))
    js = np.asarray(js)[:, 0]
    assert s.shape == js.shape == (b, 7, 9, c)
    assert gd.shape == jgd.shape == (b, c, c)
    for lane in range(b):
        np.testing.assert_allclose(
            gd[lane].numpy(), np.asarray(jgd[lane]), rtol=RTOL,
            atol=RTOL * float(np.abs(grams[lane]).max()))
        np.testing.assert_allclose(
            s[lane].numpy(), js[lane], rtol=RTOL,
            atol=RTOL * float(np.abs(js[lane]).max()))


@pytest.mark.parametrize('c', [64, 128])
def test_each_lane_is_the_one_map_form(c):
    feat, grams = _lanes(c, 3, 5, 11, c)
    s, gd = style.fused_style_branch(torch.from_numpy(feat),
                                     torch.from_numpy(grams))
    for lane in range(3):
        s1, gd1 = style.fused_style_branch(
            torch.from_numpy(feat[lane:lane + 1]),
            torch.from_numpy(grams[lane]))
        np.testing.assert_allclose(gd[lane].numpy(), gd1.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(gd1.abs().max()))
        np.testing.assert_allclose(s[lane].numpy(), s1[0].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(s1.abs().max()))


def test_lanes_on_cpu_do_not_launch_and_other_devices_raise():
    before = style.launches
    style.fused_style_branch(torch.ones(2, 3, 5, 8), torch.zeros(2, 8, 8))
    assert style.launches == before
    with pytest.raises(RuntimeError):
        style.fused_style_branch(torch.empty(2, 4, 4, 8, device='meta'),
                                 torch.empty(2, 8, 8, device='meta'))


def _gram_plan_one_map(m, c, sms):
    """gram_plan as it was before the lane axis, for one map."""
    target = style._BLOCKS_PER_SM * sms
    n_chunks = max(1, min(-(-target // len(style.gram_tiles(c))),
                          -(-m // 16)))
    chunk = -(-m // n_chunks)
    chunk = -(-chunk // 16) * 16
    return chunk, -(-m // chunk)


TAPS_512 = [(384 * 512, 64), (192 * 256, 128), (96 * 128, 256),
            (48 * 64, 512)]


@pytest.mark.parametrize('m,c', TAPS_512 + [(63, 64), (6, 128), (1, 4)])
@pytest.mark.parametrize('sms', [132, 114])
def test_one_lane_keeps_the_one_map_plan(m, c, sms):
    assert style.gram_plan(m, c, sms) == style.gram_plan(m, c, sms, 1) \
        == _gram_plan_one_map(m, c, sms)
    blocks = -(-m // 64) * -(-c // 64)
    assert style.grad_tile_rows(m, c, sms, 1) == style.grad_tile_rows(
        m, c, sms) == (32 if 2 * blocks < style._BLOCKS_PER_SM * sms else 64)
    one = style._plan(m, c, sms)
    assert style._plan(m, c, sms, 1) == one


@pytest.mark.parametrize('m,c', TAPS_512 + [(63, 64), (6, 128)])
@pytest.mark.parametrize('lanes', [2, 4, 8])
def test_lane_plan_covers_each_map_in_order(m, c, lanes):
    sms = 132
    chunk, n_chunks = style.gram_plan(m, c, sms, lanes)
    assert chunk % 16 == 0 and n_chunks >= 1
    assert chunk * n_chunks >= m > chunk * (n_chunks - 1)
    # Lanes share the card: never more chunks a map than one map alone,
    # and the grid holds about as many blocks as one map's would.
    one = style.gram_plan(m, c, sms)[1]
    assert n_chunks <= one
    blocks = n_chunks * len(style.gram_tiles(c)) * lanes
    if n_chunks > 1:
        assert blocks <= 2 * style._BLOCKS_PER_SM * sms
    cp, _, _, n_partials, rows = style._plan(m, c, sms, lanes)
    assert n_partials == lanes * n_chunks * len(style.gram_tiles(cp)) * 64 * 64
    assert rows == style.grad_tile_rows(m, c, sms, lanes)


def test_four_lanes_at_the_512px_taps_need_fewer_chunks():
    for m, c in TAPS_512:
        one, four = (style.gram_plan(m, c, 132, n)[1] for n in (1, 4))
        assert four < one or one == 1
