"""The port's roofline (style_transfer2_tpu_torch/utils/perfmodel.py) on
the CPU: its FLOPs and HBM bytes against the JAX model's
(style_transfer2_tpu/utils/perfmodel.py) at every size, precision, remat
policy and tap set below; the H100's peaks and tile terms; the per-kernel
costs against the step's counts and PERF.md's bound column; and the
sharded model's halo bytes against what the port's Sharded exchanges move
in one forward and backward, counted by chip_smoke.py's Exchanges, which
wraps them."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer2_tpu.utils import perfmodel as jax_perfmodel
from style_transfer2_tpu_torch.engine import StyleTransfer
from style_transfer2_tpu_torch.models import random_params
from style_transfer2_tpu_torch.ops import conv
from style_transfer2_tpu_torch.parallel import (SpatialPlacement, make_mesh,
                                                spatial)
from style_transfer2_tpu_torch.utils import perfmodel

_SPEC = importlib.util.spec_from_file_location(
    'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

# initial_weights.yaml's taps (the port's main path), and the JAX model's
# defaults (bench.py's objective, down to conv5_1).
INITIAL = (('conv4_2',), ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1'))
DEFAULTS = (perfmodel.DEFAULT_CONTENT, perfmodel.DEFAULT_STYLE)
SIZES = [(32, 48), (96, 128), (384, 512), (768, 1024), (2880, 3840)]
PRECISIONS = ['float32', 'float32_fast', 'bfloat16']
REMATS = [False, 'conv', 'block']


def _grams(hw, style_layers):
    """(M, C) of each style tap on an hw iterate (ceil pools)."""
    grids = perfmodel._tap_grids(hw)
    return [(grids[l][0] * grids[l][1], perfmodel.layer_channels(l))
            for l in style_layers]


@pytest.mark.parametrize('taps', [INITIAL, DEFAULTS],
                         ids=['initial_weights', 'jax_defaults'])
@pytest.mark.parametrize('remat', REMATS)
@pytest.mark.parametrize('precision', PRECISIONS)
@pytest.mark.parametrize('hw', SIZES, ids=lambda hw: '%dx%d' % hw)
def test_counts_equal_the_jax_model(hw, precision, remat, taps):
    content, style = taps
    got = perfmodel.model_step(hw, precision, remat, content_layers=content,
                               style_layers=style)
    want = jax_perfmodel.model_step(hw, precision, remat,
                                    content_layers=content,
                                    style_layers=style)
    np.testing.assert_allclose(got.flops, want.flops, rtol=1e-12)
    np.testing.assert_allclose(got.hbm_bytes, want.hbm_bytes, rtol=1e-12)
    np.testing.assert_allclose(got.t_memory, got.hbm_bytes / 3.35e12,
                               rtol=1e-12)
    assert got.t_floor == max(got.t_compute, got.t_memory)
    assert got.bound == ('compute' if got.t_compute >= got.t_memory
                         else 'memory')
    if precision != 'bfloat16':
        # SIMT: every piece at 67 TFLOP/s, no tile.
        assert got.peak_flops == 67e12
        np.testing.assert_allclose(got.t_compute, got.flops / 67e12,
                                   rtol=1e-12)
    else:
        assert got.peak_flops == 989e12
        assert got.t_compute > got.flops / 989e12


def test_the_card_holds_the_h100_only():
    assert perfmodel.F32_FLOPS == 67e12 and perfmodel.BF16_FLOPS == 989e12
    assert perfmodel.HBM_BYTES_S == 3.35e12
    assert perfmodel.L2_BYTES == 50 * 2 ** 20
    assert perfmodel.LINK_BYTES_S == 450e9
    assert perfmodel.SMS == 132


@pytest.mark.parametrize('k,n,direction,want', [
    (3, 64, 'fwd', (989e12, 3 / 32)),         # conv1_1: mma.sync tile
    (64, 3, 'bwd', (67e12, 1.0)),             # conv1_1's dx: narrow
    (64, 64, 'fwd', (989e12, 1.0)),           # wgmma, BN 64
    (512, 512, 'fwd', (989e12, 1.0)),         # wgmma, BN 128
    (512, 256, 'bwd', (989e12, 1.0)),
    (24, 72, 'fwd', (989e12, 24 / 32 * 72 / 128)),  # wgmma padding
    (12, 20, 'fwd', (989e12, 12 / 32 * 20 / 64)),   # tile padding
    (12, 20, 'bwd', (989e12, 12 / 32 * 20 / 64)),
])
def test_tile_term(k, n, direction, want):
    assert perfmodel.conv_unit(k, n, direction, 'bfloat16') == want
    for precision in ('float32', 'float32_fast'):
        assert perfmodel.conv_unit(k, n, direction, precision) == (
            67e12, 1.0)


@pytest.mark.parametrize('k,n', [(3, 64), (64, 64), (64, 128), (128, 256),
                                 (256, 512), (512, 512), (12, 20),
                                 (24, 72)])
@pytest.mark.parametrize('direction', ['fwd', 'bwd'])
@pytest.mark.parametrize('hw', [(384, 512), (2880, 3840), (12, 16)],
                         ids=lambda hw: '%dx%d' % hw)
def test_tile_term_follows_the_planners(k, n, direction, hw):
    """conv_unit plans at a nominal 16x16 grid; at a step's real grids
    the planners may split the channels (wgmma_split, split), which
    changes neither the unit nor the padding: the narrow backward on the
    SIMT lanes, the mma.sync tile and the wgmma kernels on the tensor
    cores at the staging mma_staging gives."""
    plan = conv.fwd_plan if direction == 'fwd' else conv.bwd_plan
    path = plan(1, *hw, k, n, torch.bfloat16, 132)[0]
    peak, eff = perfmodel.conv_unit(k, n, direction, 'bfloat16')
    if path == conv.NARROW:
        assert (peak, eff) == (67e12, 1.0)
        return
    k_unit, n_unit = conv.mma_staging(path, n)
    assert peak == 989e12
    assert eff == (k / (k_unit * -(-k // k_unit))
                   * n / (n_unit * -(-n // n_unit)))


def test_bf16_step_by_hand_at_512px():
    """The 384x512 bf16 step at initial_weights.yaml's taps: conv1_1's
    forward at 3/32 of the tensor cores' peak, its dx at the SIMT peak,
    the style branch (the bf16 feed's phases) and every other conv at the
    tensor cores' full peak. Compute-bound, where the untiled model is
    nearly balanced."""
    hw = (384, 512)
    got = perfmodel.model_step(hw, 'bfloat16', content_layers=INITIAL[0],
                               style_layers=INITIAL[1])
    seconds, flops = 0.0, 0.0
    for h, w, cin, cout in chip_smoke.trunk_convs(*hw):
        f = 2.0 * h * w * 9 * cin * cout
        flops += 2 * f
        if cin == 3:
            seconds += f / (989e12 * 3 / 32) + f / 67e12
        else:
            seconds += 2 * f / 989e12
    for m, c in _grams(hw, INITIAL[1]):
        flops += 4.0 * m * c * c
        seconds += 4.0 * m * c * c / 989e12
    np.testing.assert_allclose(got.flops, flops, rtol=1e-12)
    np.testing.assert_allclose(got.t_compute, seconds, rtol=1e-12)
    assert got.bound == 'compute'
    assert got.flops / 989e12 < 1.1 * got.t_memory     # untiled: balanced
    # conv1_2's input, output and weights: just inside the 50 MiB L2 in
    # bf16, twice that in float32.
    assert got.working_bytes == 384 * 512 * 128 * 2 + 9 * 64 * 64 * 2
    assert got.fits_l2
    assert not perfmodel.model_step(hw, 'float32').fits_l2


@pytest.mark.parametrize('hw', [(384, 512), (2880, 3840)])
def test_bf16_style_route_and_tap_bytes(hw):
    """The bf16 feed moves the style branch to the tensor cores: a bf16
    step's style seconds are its Gram FLOPs at 989 TFLOP/s (float32's at
    67, unchanged), its counts the JAX model's in both; the bf16 phases'
    costs count the map, D and the product at 2 bytes a value (the Gram
    float32), and sumsq reads 2 bytes a bf16 value."""
    style_flops = sum(4.0 * m * c * c for m, c in _grams(hw, INITIAL[1]))
    steps = {p: perfmodel.model_step(hw, p, content_layers=INITIAL[0],
                                     style_layers=INITIAL[1])
             for p in ('float32', 'bfloat16')}
    no_style = {p: perfmodel.model_step(hw, p, content_layers=INITIAL[0],
                                        style_layers=())
                for p in steps}
    for p, peak in (('float32', 67e12), ('bfloat16', 989e12)):
        np.testing.assert_allclose(
            steps[p].t_compute - no_style[p].t_compute, style_flops / peak,
            rtol=1e-9)
        jax_model = jax_perfmodel.model_step(
            hw, p, content_layers=INITIAL[0], style_layers=INITIAL[1])
        assert steps[p].flops == jax_model.flops
        assert steps[p].hbm_bytes == jax_model.hbm_bytes
    for m, c in _grams(hw, INITIAL[1]):
        f32 = [perfmodel.style_cost(m, c, phase=ph) for ph in ('gram',
                                                                'grad')]
        bf16 = [perfmodel.style_cost(m, c, phase=ph, precision='bfloat16')
                for ph in ('gram', 'grad')]
        assert [f for f, _ in bf16] == [f for f, _ in f32]
        assert bf16[0][1] == 2 * m * c + 4 * c * c
        assert bf16[1][1] == 2 * (2 * m * c + c * c)
        assert perfmodel.sumsq_cost(m * c) == (2 * m * c, 2 * m * c + 4)
    assert perfmodel.sumsq_cost(10, 'float32') == (20, 44)


@pytest.mark.parametrize('shape,precision,want', [
    ((1, 384, 512, 64), 'float32',
     4 * 384 * 512 * 64 + 5 * 192 * 256 * 64),
    ((1, 543, 724, 64), 'bfloat16',
     2 * 543 * 724 * 64 + 3 * 272 * 362 * 64),
    ((4, 7, 9, 3), 'float32', 4 * 4 * 7 * 9 * 3 + 5 * 4 * 4 * 5 * 3)])
def test_pool_cost_counts_map_pooled_map_and_mask(shape, precision, want):
    """Each pool kernel moves the map once, and the pooled map with a byte
    of mask a pooled value once (ceil extents); the float32 512px pool1
    is bound at about 0.0197 ms."""
    assert perfmodel.pool_cost(*shape, precision) == (0, want)
    if shape == (1, 384, 512, 64):
        ms, by = chip_smoke.bound(*perfmodel.pool_cost(*shape, precision))
        assert by == 'bytes' and abs(ms - 0.0197) < 5e-4


@pytest.mark.parametrize('terms,arrays', [
    ('s', 2), ('c', 3), ('d', 2), ('cs', 4), ('sd', 3), ('csd', 4)])
def test_epilogue_cost_counts_the_arrays_a_tap_moves(terms, arrays):
    """The tap epilogue writes the cotangent and reads s_grad, the
    content target and the tap where its terms need them."""
    assert perfmodel.epilogue_cost(1000, terms) == (0, 4000 * arrays)


def test_mfu_and_share_of_floor_by_hand():
    m = perfmodel.model_step((384, 512), 'float32',
                             content_layers=INITIAL[0],
                             style_layers=INITIAL[1])
    np.testing.assert_allclose(m.mfu_at(8.3e-3),
                               m.flops / 67e12 / 8.3e-3, rtol=1e-12)
    np.testing.assert_allclose(m.sol_at(8.3e-3), m.t_floor / 8.3e-3,
                               rtol=1e-12)
    # 231.68 GFLOP at 67 TFLOP/s is 3.458 ms; an 8.3 ms step reaches 41.7%.
    assert round(m.flops / 1e9, 2) == 231.68
    assert round(m.t_floor * 1e3, 3) == 3.458
    assert round(m.sol_at(8.3e-3), 3) == 0.417
    # Compute-bound on SIMT with no tile: MFU is the share of the floor.
    np.testing.assert_allclose(m.mfu_at(8.3e-3), m.sol_at(8.3e-3),
                               rtol=1e-12)
    lanes = m.lanes(4)
    assert lanes.flops == 4 * m.flops and lanes.hbm_bytes == 4 * m.hbm_bytes
    np.testing.assert_allclose(lanes.mfu_at(4 * 8.3e-3), m.mfu_at(8.3e-3),
                               rtol=1e-12)
    assert lanes.t_floor == 4 * m.t_floor


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('hw', [(384, 512), (768, 1024)])
def test_kernel_costs_relate_to_the_step(hw, precision):
    """Summed over one step's shapes, the kernels' FLOPs fall short of the
    step's by exactly sum(M*C^2 - M*C) (the symmetric Gram), and in
    float32 their bytes exceed the step's convs' and Grams' by the biases
    alone."""
    step = perfmodel.model_step(hw, precision, content_layers=INITIAL[0],
                                style_layers=INITIAL[1])
    flops = nbytes = bias = 0
    for h, w, cin, cout in chip_smoke.trunk_convs(*hw):
        for direction in ('fwd', 'bwd'):
            f, b = perfmodel.conv_cost(1, h, w, cin, cout, direction,
                                       precision)
            flops, nbytes = flops + f, nbytes + b
        bias += cout * perfmodel.DTYPE_BYTES[precision]
    grams = _grams(hw, INITIAL[1])
    for m, c in grams:
        f, b = perfmodel.style_cost(m, c)
        flops, nbytes = flops + f, nbytes + b
    assert step.flops - flops == sum(m * c * c - m * c for m, c in grams)
    if precision == 'float32':
        # The step's other bytes: the pools and the step state.
        other = 24 * hw[0] * hw[1] * 3 * 4
        for name, h, w, c, _ in perfmodel._grid_walk(hw):
            if perfmodel.blob_index(name) > perfmodel.blob_index('conv4_2'):
                break
            if name.startswith('pool'):
                act = h * w * c * 4
                other += 2 * (act + act // 4)
        assert nbytes - bias == step.hbm_bytes - other


def test_bounds_give_perf_md_column():
    """PERF.md section 6's bound column at 512px and over the 1024px
    ladder's 7 rungs, through chip_smoke.py's bound functions, which now
    read the port's perfmodel: 1.638 / 1.653 / 0.145 / 0.0070 / 0.0112
    ms (rows 1-5); bf16 0.118 / 0.135 (rows 1-2)."""
    for dtype, want in (('float32', (1.638, 1.653)),
                        ('bfloat16', (0.118, 0.135))):
        fwd = bwd = 0.0
        for h, w, cin, cout in chip_smoke.ITERATE_CONVS:
            (f, by_f), (b, by_b) = chip_smoke.conv_bounds((h, w, cin, cout),
                                                          dtype)
            fwd, bwd = fwd + f, bwd + b
        assert (round(fwd, 3), round(bwd, 3)) == want
    style = sum(chip_smoke.bound(*perfmodel.style_cost(h * w, c))[0]
                for h, w, c in chip_smoke.STYLE_TAPS['512'])
    assert round(style, 3) == 0.145
    pre = sum(chip_smoke.bound(*perfmodel.image_cost(h * w, 1,
                                                     'preprocess'))[0]
              for h, w in chip_smoke.LADDER_1024)
    de = sum(chip_smoke.bound(*perfmodel.image_cost(h * w, 4,
                                                    'deprocess'))[0]
             for h, w in chip_smoke.LADDER_1024)
    assert (round(pre, 4), round(de, 4)) == (0.0070, 0.0112)
    # Each row's kind: the convs and the Gram by operations, the image
    # kernels by bytes.
    assert chip_smoke.conv_bounds((384, 512, 64, 64), 'float32')[0][1] == \
        'operations'
    assert chip_smoke.bound(*perfmodel.image_cost(10, 1, 'preprocess'))[1] \
        == 'bytes'
    assert perfmodel.image_cost(100, 1, 'preprocess') == (0, 1500)
    assert perfmodel.image_cost(100, 4, 'preprocess') == (0, 2400)
    with pytest.raises(ValueError):
        perfmodel.image_cost(100, 4, 'resize')


def test_style_phases_sum_to_the_fused_branch():
    m, c = 192 * 1024, 64
    gram = perfmodel.style_cost(m, c, phase='gram')
    grad = perfmodel.style_cost(m, c, phase='grad')
    fused = perfmodel.style_cost(m, c)
    assert gram[0] + grad[0] == fused[0]
    assert perfmodel.style_cost(m, c, lanes=4) == (4 * fused[0],
                                                   4 * fused[1])


# -- sharded ----------------------------------------------------------------

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('precision,remat', [
    ('float32', False), ('bfloat16', False), ('float32', 'block'),
    ('bfloat16', 'block'), ('bfloat16', 'conv')])
def test_sharded_halo_bytes_are_what_the_port_moves(precision, remat):
    """One Adam step (one forward and backward, TV's rolls included) of
    the port's engine at 96x128 over 4 shards on the CPU: the bytes its
    exchanges move equal model_step_sharded's halo_bytes."""
    hw = (96, 128)
    rng = np.random.RandomState(0)
    content, style_img, start = (rng.randint(0, 256, hw + (3,)).astype(
        np.uint8) for _ in range(3))
    placement = SpatialPlacement(make_mesh(4, axis_names=('space',),
                                           device='cpu'))
    st = StyleTransfer(random_params(0), precision=precision, device='cpu',
                       placement=placement, remat=remat)
    st.set_weights({'content': {'conv4_2': 0.08},
                    'style': dict.fromkeys(INITIAL[1], 1.0)},
                   {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0})
    st.set_optimizer('adam')
    st.set_content(content)
    st.set_style(style_img)
    st.set_input(start)
    assert st.start()
    with chip_smoke.Exchanges() as count:
        _, trace = st.step(fetch_image=False)
    assert np.isfinite(trace['loss'])
    model = perfmodel.model_step_sharded(hw, 4, precision, remat,
                                         content_layers=INITIAL[0],
                                         style_layers=INITIAL[1])
    assert count.backward > 0 and count.rolls > 0
    assert count.total() == model.halo_bytes
    assert count.rolls == 2 * 4 * hw[1] * 3 * 4


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('remat', REMATS)
@pytest.mark.parametrize('hw,taps', [
    ((768, 1024), INITIAL), ((96, 128), INITIAL), ((96, 128), DEFAULTS),
    ((2880, 3840), DEFAULTS), ((384, 512), INITIAL)])
def test_sharded_per_device_figure_is_the_jax_models(hw, taps, remat, n):
    """Where the port shards the same convs as the JAX model (its rule: a
    level's shards pool evenly; the JAX model's: H / n >= 2 rows), the
    port's JAX-style per-device figure is the JAX model's halo_bytes."""
    content, style = taps
    deepest = perfmodel._deepest(content, style)
    sharded = perfmodel._sharded_convs(hw, n, deepest)
    jax_sharded = [name for name, hh, _, _, _ in perfmodel._grid_walk(hw)
                   if name.startswith('conv') and hh // n >= 2
                   and perfmodel.blob_index(name) <= deepest]
    assert sorted(sharded) == sorted(jax_sharded)
    got = perfmodel.model_step_sharded(hw, n, 'bfloat16', remat,
                                       content_layers=content,
                                       style_layers=style)
    want = jax_perfmodel.model_step_sharded(hw, n, 'bfloat16', remat,
                                            chip='v5e',
                                            content_layers=content,
                                            style_layers=style)
    np.testing.assert_allclose(got.jax_halo_bytes, want.halo_bytes,
                               rtol=1e-12)
    # The per-device step is the JAX model's at (H / n, W).
    assert got.per_chip.flops == want.per_chip.flops
    assert got.per_chip.hbm_bytes == want.per_chip.hbm_bytes


def test_sharded_model_at_the_shard_phase():
    """chip_smoke.py's shard phase (768x1024, 4 shards, no remat): the
    port moves 22.73 MiB a step in float32 and 11.41 in bf16 (its own
    halo_bytes), the JAX model's per-device figure is 10.77 MiB; the
    whole sharded step on one card does the unsharded step's work plus
    its shards' halo rows; one shard degenerates to the one-card step."""
    hw = (768, 1024)
    for precision, mib in (('float32', 22.73), ('bfloat16', 11.41)):
        m = perfmodel.model_step_sharded(hw, 4, precision, False,
                                         content_layers=INITIAL[0],
                                         style_layers=INITIAL[1])
        assert round(m.halo_bytes / 2 ** 20, 2) == mib
        one = perfmodel.model_step(hw, precision, content_layers=INITIAL[0],
                                   style_layers=INITIAL[1])
        assert one.flops < m.one_card.flops < 1.1 * one.flops
        assert m.one_card.t_floor > one.t_floor
        assert m.bound in ('compute', 'memory', 'link')
        np.testing.assert_allclose(
            m.t_floor, max(m.per_chip.t_compute, m.per_chip.t_memory)
            + m.t_link, rtol=1e-12)
    f32 = perfmodel.model_step_sharded(hw, 4, 'float32', False,
                                       content_layers=INITIAL[0],
                                       style_layers=INITIAL[1])
    assert round(f32.jax_halo_bytes / 2 ** 20, 2) == 10.77
    # 4 style layers x 2 x 3 x C^2 floats, all sharded at 768x1024.
    assert f32.gram_bytes == sum(2 * 3 * c * c * 4
                                 for c in (64, 128, 256, 512))
    single = perfmodel.model_step_sharded(hw, 1, 'float32', False,
                                          content_layers=INITIAL[0],
                                          style_layers=INITIAL[1])
    one = perfmodel.model_step(hw, 'float32', content_layers=INITIAL[0],
                               style_layers=INITIAL[1])
    assert single.t_link == 0 and single.halo_bytes == 0
    assert single.one_card == one == single.per_chip


def test_sharded_levels_follow_the_trunks_gather():
    """A level stays sharded while its shards pool evenly (models/vgg19.py
    _pool): at 24x32 over 4 shards, 6 rows a shard pool to 3, which the
    next pool gathers."""
    got = perfmodel._sharded_convs((24, 32), 4,
                                   perfmodel.blob_index('conv4_2'))
    assert got == {'conv1_1': 6, 'conv1_2': 6, 'conv2_1': 3, 'conv2_2': 3}
    # Halo rows forward and their gradients back over 3 boundaries at
    # conv1_1 to conv2_2, and TV's two rolls across 4.
    assert perfmodel.model_step_sharded(
        (24, 32), 4, 'float32', False, content_layers=INITIAL[0],
        style_layers=INITIAL[1]).halo_bytes == (
            2 * 2 * 3 * (32 * (3 + 64) + 16 * (64 + 128)) * 4
            + 2 * 4 * 32 * 3 * 4)
