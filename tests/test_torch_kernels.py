"""The kernel modules of the port (ops/conv.py, ops/style.py, _build.py).

On the CPU: each wrapper's plain version against the JAX package's Pallas
kernel in interpret mode, at the shapes of tests/test_pallas_conv.py and
tests/test_pallas.py (float32 atol 1e-4), and the dispatch rules. The
kernels themselves are tested on the card in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.ops.pallas.conv import (
    conv3x3_bias_relu as jconv3x3_bias_relu)
from style_transfer2_tpu.ops.pallas.style_kernel import (
    fused_style_branch as jfused_style_branch)
from style_transfer2_tpu_torch import _build
from style_transfer2_tpu_torch.ops import conv, style

CONV_CASES = [
    ((1, 16, 32, 64), 128),
    ((1, 24, 16, 128), 128),
    ((2, 8, 16, 64), 256),
]


def _conv_case(seed, shape, cout):
    rng = np.random.RandomState(seed)
    x = np.float32(rng.randn(*shape))
    w = np.float32(rng.randn(3, 3, shape[-1], cout) * 0.1)
    b = np.float32(rng.randn(cout) * 0.1)
    g = np.float32(rng.randn(*shape[:3], cout))
    return x, w, b, g


def _plain_fwd_bwd(x, w, b, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = conv.conv3x3_bias_relu(xt, torch.from_numpy(w).to(dtype),
                               torch.from_numpy(b).to(dtype))
    dx = torch.autograd.grad(y, xt, torch.from_numpy(g).to(dtype))[0]
    return y.detach().float().numpy(), dx.float().numpy()


@pytest.mark.parametrize('shape,cout', CONV_CASES)
def test_plain_conv_matches_pallas_interpret(shape, cout):
    x, w, b, g = _conv_case(0, shape, cout)
    y, dx = _plain_fwd_bwd(x, w, b, g)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    jy = jconv3x3_bias_relu(jx, jw, jb)
    jdx = jax.grad(lambda a: jnp.vdot(jconv3x3_bias_relu(a, jw, jb),
                                      jnp.asarray(g)))(jx)
    assert y.shape == jy.shape and dx.shape == jdx.shape
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(jdx), atol=1e-4, rtol=1e-5)


def test_plain_conv_bf16_matches_pallas_interpret():
    x, w, b, g = _conv_case(2, (1, 16, 16, 128), 128)
    y, _ = _plain_fwd_bwd(x, w, b, g, torch.bfloat16)
    jy = np.float32(jconv3x3_bias_relu(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))))
    scale = max(1.0, float(np.abs(jy).max()))
    assert np.abs(y - jy).max() / scale < 0.03


def test_plain_conv_masks_the_cotangent():
    x, w, b, g = _conv_case(3, (1, 8, 8, 64), 128)
    _, dx = _plain_fwd_bwd(x, w, b, np.ones_like(g))
    _, dx0 = _plain_fwd_bwd(x, w, b - 1e3, np.ones_like(g))
    assert np.abs(dx).max() > 0 and np.abs(dx0).max() == 0


@pytest.mark.parametrize('shape', [(1, 24, 24, 64), (1, 7, 9, 128)])
def test_plain_style_matches_pallas_interpret(shape):
    rng = np.random.RandomState(4)
    feat = np.float32(np.maximum(rng.randn(*shape), 0))
    other = np.float32(np.maximum(rng.randn(*shape), 0)).reshape(-1,
                                                                 shape[-1])
    gram_style = np.float32(other.T @ other / other.size)
    s, gd = style.fused_style_branch(torch.from_numpy(feat),
                                     torch.from_numpy(gram_style))
    js, jgd = jfused_style_branch(jnp.asarray(feat), jnp.asarray(gram_style))
    assert s.shape == js.shape and gd.shape == jgd.shape
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-4,
                               atol=1e-4 * float(np.abs(gram_style).max()))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(js)).max()))


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = (conv.fwd_launches, conv.bwd_launches, style.launches)
    x, w, b, g = _conv_case(5, (1, 5, 7, 3), 64)
    _plain_fwd_bwd(x, w, b, g)
    style.fused_style_branch(torch.ones(1, 3, 5, 8), torch.zeros(8, 8))
    assert (conv.fwd_launches, conv.bwd_launches, style.launches) == before


def test_other_devices_raise():
    x = torch.empty(1, 4, 4, 3, device='meta')
    w = torch.empty(3, 3, 3, 8, device='meta')
    with pytest.raises(RuntimeError):
        conv.conv3x3_bias_relu(x, w, torch.empty(8, device='meta'))
    with pytest.raises(RuntimeError):
        style.fused_style_branch(torch.empty(1, 4, 4, 8, device='meta'),
                                 torch.empty(8, 8, device='meta'))


@pytest.mark.parametrize('m,c', [(63, 64), (196608, 64), (3072, 512),
                                 (1, 3), (6, 128)])
def test_style_chunking_covers_every_row(m, c):
    chunk, n_chunks = style._chunking(m, c)
    assert chunk % 16 == 0 and n_chunks >= 1
    assert chunk * n_chunks >= m > chunk * (n_chunks - 1)


def test_build_dir_is_keyed_by_sources():
    d = _build.build_dir()
    assert d == _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert {p.name for p in _build._sources()} == {'conv3x3.cu', 'style.cu'}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()
