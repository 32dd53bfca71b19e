"""Rematerialization in the port (models/vgg19.py `remat`), on the CPU.

  * features_and_vjp under each policy (True, 'conv', 'block') gives the
    taps and the gradient of remat=False bit for bit, in float32 and
    bfloat16, and agrees with JAX VGG19Features(remat=policy) on the same
    numpy inputs (tests/test_model.py's remat tests, ported).
  * The recompute happens: each conv up to the deepest tap runs twice an
    evaluation under 'conv' and 'block' (in float32 under 'block', each
    conv whose output is not a tap), once without remat.
  * StyleTransfer(remat=policy): 3 L-BFGS steps whose traces equal the
    remat=False engine's bit for bit in both precisions, and in float32
    JAX StyleTransfer(remat=policy)'s at the golden rtol
    (tests/test_bf16.py's remat test, ported); under a stand-in capture
    backend the graphed chunk gives the eager chunk's bits.
  * An unknown policy raises; a capture gives the allocator's cache back
    only where the card's free memory is short.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer2_tpu.engine import StyleTransfer as JaxStyleTransfer
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu.models import vgg19 as jvgg
from style_transfer2_tpu_torch.engine import StyleTransfer, graphs
from style_transfer2_tpu_torch.models import vgg19, weights
from style_transfer2_tpu_torch.ops import conv

from test_torch_scan import FakeGraphs

ROOT = Path(__file__).resolve().parents[1]
POLICIES = [True, 'conv', 'block']
PRECISIONS = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
LAYERS = ('conv1_1', 'conv2_1', 'conv3_1', 'conv4_1', 'conv4_2')
# An even grid, so that JAX's bfloat16 takes its block-1 space-to-depth
# path (the taps of block 1 come back in its layout, _depth_to_space'd
# here).
HW = (32, 40)
GOLDEN_RTOL = 5e-3
FEATURE_RTOL = 1e-4            # tests/test_torch_model.py's float32 bound
# bfloat16: each tap within 3e-2 of its largest magnitude, the bf16 conv
# tolerance of tests/test_torch_cuda.py and chip_smoke.py (measured
# 2e-3-4e-3 here). The gradient passes ten bf16 convs back, where the two
# packages round each layer's output and flip ReLUs near zero apart; so
# its distance from JAX's (relative L2, measured 0.024 at HW) is held to
# half of the distance bf16 itself puts between JAX's gradient and the
# port's float32 one (measured 0.115, so a ratio of 0.21).
BF16_TAP_TOL = 3e-2
BF16_GRAD_SHARE = 0.5
WEIGHTS = {
    'content': {'conv4_2': 0.08},
    'style': {'conv1_1': 1.0, 'conv2_1': 1.0, 'conv3_1': 1.0,
              'conv4_1': 1.0},
    'deepdream': {'conv2_2': 0.3},
}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
ENGINE_HW = (24, 24)
ENGINE_STEPS = 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the shapes are tiny, and the test runner runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def params_np():
    return random_params(2)


def _input(hw=HW):
    return np.float32(np.random.RandomState(0).uniform(-120, 130,
                                                       (1,) + hw + (3,)))


def _cotangents(feats):
    rng = np.random.RandomState(1)
    return {name: np.float32(rng.randn(*feats[name].shape))
            for name in LAYERS}


def _port_eval(params_np, precision, remat, x):
    """(taps, gradient) of the port's features_and_vjp on x."""
    dtype = PRECISIONS[precision]
    model = vgg19.VGG19Features(
        weights.params_from_numpy(params_np, 'cpu', dtype), dtype, remat)
    feats, vjp = model.features_and_vjp(torch.from_numpy(x), LAYERS)
    grad = vjp({name: torch.from_numpy(c)
                for name, c in _cotangents(feats).items()})
    return feats, grad


@pytest.mark.parametrize('precision', sorted(PRECISIONS))
@pytest.mark.parametrize('policy', POLICIES)
def test_remat_taps_and_gradient_equal_plain(params_np, policy, precision):
    x = _input()
    feats, grad = _port_eval(params_np, precision, False, x)
    feats_r, grad_r = _port_eval(params_np, precision, policy, x)
    assert list(feats_r) == list(LAYERS)
    for name in LAYERS:
        # The taps of features_and_vjp are in the compute dtype (the bf16
        # loss feed's taps in bfloat16).
        assert feats_r[name].dtype == PRECISIONS[precision]
        assert torch.equal(feats_r[name], feats[name]), name
    assert torch.equal(grad_r, grad)


def _jax_eval(params_np, precision, remat, x, shapes):
    """(taps, gradient) of JAX VGG19Features(remat=) on x, its block-1
    taps in the port's layout; the cotangents are the port's."""
    kw = ({} if precision == 'float32' else
          dict(compute_dtype=jnp.bfloat16,
               precision=jax.lax.Precision.DEFAULT))
    model = jvgg.VGG19Features(params_np, remat=remat, **kw)
    feats, vjp = model.features_and_vjp(jnp.asarray(x), LAYERS)
    cot = {}
    for name, c in _cotangents(shapes).items():
        c = jnp.asarray(c)
        cot[name] = (c if feats[name].shape == c.shape
                     else jvgg._space_to_depth(c))
    grad = np.asarray(vjp(cot))
    out = {}
    for name in LAYERS:
        f = feats[name]
        if f.shape != shapes[name].shape:
            f = jvgg._depth_to_space(f, shapes[name].shape[-1])
        out[name] = np.asarray(f, np.float32)
    return out, grad


@pytest.mark.parametrize('precision', sorted(PRECISIONS))
@pytest.mark.parametrize('policy', POLICIES)
def test_remat_matches_jax(params_np, policy, precision):
    x = _input()
    feats, grad = _port_eval(params_np, precision, policy, x)
    want, want_grad = _jax_eval(params_np, precision, policy, x, feats)
    grad = grad.numpy()
    if precision == 'float32':
        for name in LAYERS:
            scale = max(1.0, float(np.abs(want[name]).max()))
            np.testing.assert_allclose(feats[name].numpy(), want[name],
                                       rtol=FEATURE_RTOL,
                                       atol=FEATURE_RTOL * scale)
        scale = max(1.0, float(np.abs(want_grad).max()))
        np.testing.assert_allclose(grad, want_grad, rtol=FEATURE_RTOL,
                                   atol=FEATURE_RTOL * scale)
        return
    for name in LAYERS:
        err = np.abs(feats[name].float().numpy() - want[name]).max()
        assert err <= BF16_TAP_TOL * max(1.0, np.abs(want[name]).max()), name
    _, grad32 = _port_eval(params_np, 'float32', False, x)
    noise = np.linalg.norm(want_grad - grad32.numpy())
    assert np.linalg.norm(grad - want_grad) <= BF16_GRAD_SHARE * noise


# The convs (by their output width) that run again inside the vjp to
# conv4_2 with every style tap and conv4_2 requested: all ten under 'conv';
# under 'block' only the five untapped ones, since a tapped conv runs
# outside the checkpoints (its output is the tap: in bfloat16 too, whose
# loss feed keeps the taps bf16).
ALL_CONVS = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512]
UNTAPPED = [64, 128, 256, 256, 256]


@pytest.mark.parametrize('precision', sorted(PRECISIONS))
@pytest.mark.parametrize('policy', [False] + POLICIES)
def test_each_conv_runs_again_in_the_backward(params_np, monkeypatch,
                                              policy, precision):
    """The convs up to the deepest tap (conv4_2: ten) run once in the
    forward and, under remat, the checkpointed ones once more inside the
    vjp."""
    calls = []
    plain = conv.conv3x3_bias_relu_plain

    def counted(x, w, b):
        calls.append(w.shape[-1])
        return plain(x, w, b)

    monkeypatch.setattr(conv, 'conv3x3_bias_relu_plain', counted)
    dtype = PRECISIONS[precision]
    model = vgg19.VGG19Features(
        weights.params_from_numpy(params_np, 'cpu', dtype), dtype, policy)
    x = torch.from_numpy(_input((20, 28)))
    feats, vjp = model.features_and_vjp(x, LAYERS)
    assert calls == ALL_CONVS
    vjp({name: torch.ones_like(f) for name, f in feats.items()})
    again = ([] if policy is False else
             UNTAPPED if policy == 'block' else ALL_CONVS)
    assert sorted(calls[10:]) == again
    # A forward without autograd ignores the policy.
    calls.clear()
    model(x, LAYERS)
    assert calls == ALL_CONVS


@pytest.mark.parametrize('policy', ['all', 'Block', 'none', '', None, 1, 0])
def test_unknown_policy_raises(params_np, policy):
    params = weights.params_from_numpy(params_np, 'cpu')
    with pytest.raises(ValueError, match='remat'):
        vgg19.VGG19Features(params, remat=policy)
    with pytest.raises(ValueError, match='remat'):
        vgg19.extract_features(params, torch.zeros(1, 8, 8, 3), ('conv1_1',),
                               remat=policy)
    with pytest.raises(ValueError, match='remat'):
        StyleTransfer(params_np, device='cpu', remat=policy)


def _engine(cls, params, hw=ENGINE_HW, **kw):
    rng = np.random.RandomState(3)
    st = cls(params, **kw)
    st.set_weights(WEIGHTS, SCALARS)
    st.set_optimizer('lbfgs')
    st.set_step_size(1.0)
    for setter in (st.set_content, st.set_style, st.set_input):
        setter(rng.randint(0, 256, hw + (3,)).astype(np.uint8))
    assert st.start()
    return st


def _trace_rows(st):
    return [{k: v for k, v in t.data.items() if k != 'time'}
            for t in st.traces]


_PLAIN = {}


def _plain_run(precision):
    """The remat=False engine's trace rows and final image, once a
    precision."""
    if precision not in _PLAIN:
        st = _engine(StyleTransfer, random_params(4), precision=precision,
                     device='cpu')
        img, _ = st.run_steps(ENGINE_STEPS)
        _PLAIN[precision] = (_trace_rows(st), img)
    return _PLAIN[precision]


@pytest.mark.parametrize('precision', sorted(PRECISIONS))
@pytest.mark.parametrize('policy', POLICIES)
def test_engine_traces_equal_plain_and_track_jax(policy, precision):
    st = _engine(StyleTransfer, random_params(4), precision=precision,
                 device='cpu', remat=policy)
    assert st.remat == policy
    assert st.model.remat == ('block' if policy == 'block' else 'conv')
    img, _ = st.run_steps(ENGINE_STEPS)
    rows, plain_img = _plain_run(precision)
    assert _trace_rows(st) == rows
    np.testing.assert_array_equal(img, plain_img)
    if precision != 'float32':
        return
    jst = _engine(JaxStyleTransfer, random_params(4), remat=policy,
                  use_pallas=True)
    for _ in range(ENGINE_STEPS):
        jst.step()
    assert len(jst.traces) == len(rows)
    for got, want in zip(rows, jst.traces):
        keys = [k for k in want.data if k not in ('time', 'fevals')]
        assert [k for k in got if k not in ('time', 'fevals')] == keys
        for key in keys:
            np.testing.assert_allclose(got[key], want.data[key],
                                       rtol=GOLDEN_RTOL, err_msg=key)


@pytest.mark.parametrize('precision', sorted(PRECISIONS))
@pytest.mark.parametrize('policy', ['conv', 'block'])
def test_graphed_remat_chunk_gives_the_eager_bits(policy, precision):
    """Warm-up, capture and replays of a remat engine's step under the
    stand-in capture backend of tests/test_torch_scan.py."""
    eager = _engine(StyleTransfer, random_params(4), precision=precision,
                    device='cpu', remat=policy)
    graphed = _engine(StyleTransfer, random_params(4), precision=precision,
                      device='cpu', remat=policy)
    graphed._graphs = graphs.StepGraphs(FakeGraphs())
    replays = graphs.replays
    for st in (eager, graphed):
        st.run_steps(2)
        st.run_steps(3)
    assert graphs.replays - replays >= 3
    assert _trace_rows(eager) == _trace_rows(graphed)
    assert torch.equal(eager.input, graphed.input)
    for key, value in eager.opt_state.items():
        got = graphed.opt_state[key]
        assert (torch.equal(got, value) if torch.is_tensor(value)
                else got == value), key


def test_a_dropped_remat_engine_needs_no_garbage_collector(tmp_path):
    """In a fresh interpreter with the collector off, a remat engine's
    first steps (the process's first checkpoint) leave nothing that keeps
    the engine alive once it is dropped: on the card its step graphs, and
    their memory pool, go with it."""
    code = (
        'import gc, sys, weakref\n'
        'import numpy as np\n'
        'from style_transfer2_tpu_torch.engine import StyleTransfer\n'
        'from style_transfer2_tpu_torch.models import random_params\n'
        'gc.disable()\n'
        'st = StyleTransfer(random_params(4), device="cpu", remat="conv")\n'
        'rng = np.random.RandomState(3)\n'
        'st.set_content(rng.randint(0, 256, (24, 24, 3)).astype(np.uint8))\n'
        'st.set_style(rng.randint(0, 256, (24, 24, 3)).astype(np.uint8))\n'
        'st.set_input(rng.randint(0, 256, (24, 24, 3)).astype(np.uint8))\n'
        'assert st.start()\n'
        'st.run_steps(2)\n'
        'ref = weakref.ref(st)\n'
        'del st\n'
        'print(ref() is None)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == 'True'


class _Card:
    """What CudaGraphs.make_room reads of the card, without one."""

    def __init__(self, reserved, allocated, free):
        self.reserved, self.allocated, self.free = reserved, allocated, free
        self.emptied = 0

    def patch(self, monkeypatch):
        cuda = torch.cuda
        monkeypatch.setattr(cuda, 'memory_reserved', lambda d: self.reserved)
        monkeypatch.setattr(cuda, 'memory_allocated',
                            lambda d: self.allocated)
        monkeypatch.setattr(cuda, 'mem_get_info',
                            lambda d: (self.free, 80 << 30))
        monkeypatch.setattr(cuda, 'empty_cache', self.empty)

    def empty(self):
        self.emptied += 1


@pytest.mark.parametrize('reserved,allocated,free,empties', [
    (40 << 30, 10 << 30, 20 << 30, 1),    # 30 GiB cached, 20 free: short
    (40 << 30, 10 << 30, 40 << 30, 0),    # room for the capture
    (1 << 30, 1 << 29, 70 << 30, 0),      # a small grid
])
def test_capture_empties_the_cache_only_when_memory_is_short(
        monkeypatch, reserved, allocated, free, empties):
    card = _Card(reserved, allocated, free)
    card.patch(monkeypatch)
    before = graphs.emptied
    backend = graphs.CudaGraphs.__new__(graphs.CudaGraphs)
    backend.device = torch.device('cuda')
    backend.make_room()
    assert card.emptied == empties
    assert graphs.emptied - before == empties
