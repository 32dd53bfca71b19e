"""The port's BatchedStyleTransfer (engine/batched.py, on the CPU, so with
the kernels' plain versions) against the JAX package's
BatchedStyleTransfer and against the port's single StyleTransfer, lane by
lane, and its lane lifecycle.

Tolerances: against JAX, every trace key at rtol 5e-3 and lane_image at
atol 0.75 (tests/test_torch_golden.py); against the port's single engine
rtol 5e-4 (tests/test_batched.py holds the JAX lanes so); a lane against
the same lane of another batch, exactly where nothing but its own sums
differ."""

import numpy as np
import pytest
import torch

from style_transfer2_tpu.engine.batched import (
    BatchedStyleTransfer as JaxBatchedStyleTransfer)
from style_transfer2_tpu.models import random_params
from style_transfer2_tpu_torch.engine import StyleTransfer
from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
from style_transfer2_tpu_torch.parallel import (
    build_batched_step_fns, build_masked_batched_step_fns, stack_lanes,
    unstack_lane)

WEIGHTS = {'content': {'conv2_2': 0.1},
           'style': {'conv1_1': 1.0, 'conv2_1': 1.0}, 'deepdream': {}}
OTHER_WEIGHTS = {'content': {'conv2_2': 0.3},
                 'style': {'conv1_1': 2.0, 'conv2_1': 1.0}, 'deepdream': {}}
NEW_WEIGHTS = {'content': {'conv2_2': 0.4},
               'style': {'conv1_1': 1.5, 'conv2_1': 0.5}, 'deepdream': {}}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}
OTHER_SCALARS = {'p': 20.0, 'p_power': 6.0, 'tv': 8.0, 'tv_power': 2.0}
HW = (24, 24)
STEP_SIZES = {'adam': (10.0, 5.0), 'lbfgs': (1.0, 0.5)}
JAX_RTOL = 5e-3
JAX_IMAGE_ATOL = 0.75
SINGLE_RTOL = 5e-4
# bf16 lanes against the port's single bf16 engine, 6 L-BFGS steps at
# 24x24: the largest relative loss difference measured on the CPU was
# 0.0 (the plain bf16 conv gives each image of a batch the bits it gives
# it alone); the bound leaves room for another CPU's conv algorithm.
BF16_LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes are tiny, and where the test runner
    runs several workers at once, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, 256, HW + (3,)).astype(np.uint8)
            for k in ('content', 'style', 'input')}


def _add(bt, job, **kw):
    return bt.add_job(job['content'], job['style'], job['input'], **kw)


def _single(params, job, weights, step_size, optimizer, precision='float32'):
    st = StyleTransfer(params, precision=precision, device='cpu')
    st.set_weights(weights, SCALARS)
    st.set_optimizer(optimizer)
    st.set_step_size(step_size)
    st.set_content(job['content'])
    st.set_style(job['style'])
    st.set_input(job['input'])
    assert st.start()
    return st


def _assert_close(got, want, rtol, what, atol=0.0):
    for key, value in want.items():
        if key == 'time':
            continue
        np.testing.assert_allclose(got[key], value, rtol=rtol, atol=atol,
                                   err_msg='%s key %s' % (what, key))


def _script(bt, optimizer):
    """Lanes 0 and 2 active with their own weights, scalars and step sizes,
    lane 1 inactive between them: two single steps, a step with lane 0
    paused, then a 3-step chunk. Returns the traces of each dispatch."""
    ss = STEP_SIZES[optimizer]
    _add(bt, _job(0), step_size=ss[0])
    _add(bt, _job(1), lane=2, weights=OTHER_WEIGHTS,
         scalar_params=OTHER_SCALARS, step_size=ss[1])
    out = [bt.step_all(), bt.step_all()]
    bt.set_running(0, False)
    out.append(bt.step_all())
    bt.set_running(0, True)
    out.append({lane: traces[-1]
                for lane, traces in bt.run_steps_all(3).items()})
    return out


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_lanes_match_jax_batched_engine(optimizer):
    params = random_params(6)
    ours = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=3,
                                optimizer=optimizer, device='cpu')
    theirs = JaxBatchedStyleTransfer(params, WEIGHTS, SCALARS, HW,
                                     max_lanes=3, optimizer=optimizer)
    got, want = _script(ours, optimizer), _script(theirs, optimizer)
    assert [set(t) for t in got] == [set(t) for t in want] == [
        {0, 2}, {0, 2}, {2}, {0, 2}]
    for i, (g, w) in enumerate(zip(got, want)):
        for lane in w:
            assert list(g[lane]) == list(w[lane])
            _assert_close(g[lane], w[lane], JAX_RTOL,
                          '%s dispatch %d lane %d' % (optimizer, i, lane))
    assert ours.t == theirs.t == [5, 0, 6]
    for lane in (0, 2):
        np.testing.assert_allclose(ours.lane_image(lane),
                                   theirs.lane_image(lane),
                                   atol=JAX_IMAGE_ATOL)


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_lanes_match_single_engine(optimizer):
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=3,
                              optimizer=optimizer, device='cpu')
    jobs = [_job(i) for i in range(2)]
    weights = [WEIGHTS, OTHER_WEIGHTS]
    ss = STEP_SIZES[optimizer]
    assert [_add(bt, j, weights=w, step_size=s)
            for j, w, s in zip(jobs, weights, ss)] == [0, 1]
    traces = [bt.step_all() for _ in range(2)]
    traces.append({lane: t[-1] for lane, t in bt.run_steps_all(2).items()})
    for lane in (0, 1):
        st = _single(params, jobs[lane], weights[lane], ss[lane], optimizer)
        want = [st.step(fetch_image=False)[1] for _ in range(2)]
        want.append(st.run_steps(2, fetch_image=False)[1])
        for i, (got, ref) in enumerate(zip(traces, want)):
            _assert_close(got[lane], ref, SINGLE_RTOL,
                          'lane %d dispatch %d' % (lane, i), atol=1e-5)
        np.testing.assert_allclose(bt.lane_image(lane), st.snapshot(),
                                   rtol=1e-3, atol=0.1)


def test_bf16_lanes_beside_single_engine():
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                              optimizer='lbfgs', precision='bfloat16',
                              device='cpu')
    jobs = [_job(i) for i in range(2)]
    for job in jobs:
        _add(bt, job)
    losses = [[t[lane]['loss'] for lane in (0, 1)]
              for t in (bt.step_all() for _ in range(6))]
    for lane, job in enumerate(jobs):
        st = _single(params, job, WEIGHTS, 1.0, 'lbfgs', 'bfloat16')
        want = [st.step(fetch_image=False)[1]['loss'] for _ in range(6)]
        got = [row[lane] for row in losses]
        assert np.all(np.isfinite(got)) and got[-1] < got[0]
        np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)


def test_lane_lifecycle_and_weight_change():
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                              optimizer='adam', device='cpu')
    j0, j1 = _job(0), _job(1)
    l0, l1 = _add(bt, j0), _add(bt, j1)
    assert bt.free_lane() is None
    with pytest.raises(RuntimeError):
        _add(bt, j0)

    bt.step_all()
    bt.remove_job(l0)
    assert bt.free_lane() == l0 and bt.any_running()
    traces = bt.step_all()
    assert l0 not in traces and l1 in traces
    assert traces[l1]['fevals'] == 2

    bt.set_lane_weights(l1, NEW_WEIGHTS, SCALARS)
    assert np.isfinite(bt.step_all()[l1]['loss'])
    bad = {'content': {'conv3_2': 0.5}, 'style': {'conv1_1': 1.0},
           'deepdream': {}}
    with pytest.raises(ValueError):
        bt.set_lane_weights(l1, bad, SCALARS)

    assert _add(bt, j0) == l0
    assert bt.step_all()[l0]['fevals'] == 1
    bt.set_running(l0, False)
    bt.set_running(l1, False)
    assert not bt.any_running()
    assert bt.begin_steps_all(2) is None
    assert bt.collect_steps_all(None) == {}


def test_add_job_rejects_other_resolutions_and_structures():
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                              optimizer='lbfgs', device='cpu')
    job = _job(0)
    small = {k: v[:16] for k, v in job.items()}
    with pytest.raises(ValueError, match='resolution'):
        _add(bt, small)
    bad = {'content': {'conv2_2': 0.1}, 'style': {'conv1_1': 1.0},
           'deepdream': {}}
    with pytest.raises(ValueError, match='structure'):
        _add(bt, job, weights=bad)
    assert bt.free_lane() == 0 and bt.active == [False, False]


def test_run_steps_all_matches_step_all():
    params = random_params(6)
    jobs = [_job(i) for i in range(2)]

    def make():
        bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW,
                                  max_lanes=2, optimizer='adam',
                                  device='cpu')
        for job in jobs:
            _add(bt, job)
        return bt

    a, b = make(), make()
    a_traces = {0: [], 1: []}
    for _ in range(3):
        for lane, t in a.step_all().items():
            a_traces[lane].append(t)
    b_traces = b.run_steps_all(3)
    for lane in (0, 1):
        assert len(b_traces[lane]) == 3
        for ta, tb in zip(a_traces[lane], b_traces[lane]):
            assert ta == tb
    np.testing.assert_array_equal(a.lane_image(0), b.lane_image(0))


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_run_steps_all_respects_pause(optimizer):
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                              optimizer=optimizer, device='cpu')
    for i in range(2):
        _add(bt, _job(i))
    bt.set_running(0, False)
    before = unstack_lane({k: v.clone() for k, v in bt.states.items()}, 0)
    img0 = bt.lane_image(0)
    traces = bt.run_steps_all(2)
    assert 0 not in traces and 1 in traces
    assert bt.t == [0, 2]
    np.testing.assert_array_equal(bt.lane_image(0), img0)
    after = bt.lane_state(0)
    for key, value in before.items():
        assert torch.equal(torch.as_tensor(after[key]),
                           torch.as_tensor(value)), key


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_paused_lane_weight_change_reprimes_on_resume(optimizer):
    """A lane whose objective changes while paused resumes as the single
    engine does after the same change: L-BFGS re-primes its (loss, grad)
    cache then, not at a prime pass that ran while it was masked out;
    Adam's first moment and step count restart, its second moment and its
    counter carry on (optim/adam.py objective_changed), lane by lane."""
    params = random_params(6)
    j0, j1 = _job(0), _job(1)
    ss = STEP_SIZES[optimizer][0]
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                              optimizer=optimizer, device='cpu')
    l0, l1 = _add(bt, j0, step_size=ss), _add(bt, j1, step_size=ss)
    for _ in range(2):
        bt.step_all()
    bt.set_running(l1, False)
    bt.set_lane_weights(l1, NEW_WEIGHTS, SCALARS)
    if optimizer == 'lbfgs':
        assert bt._needs_prime[l1] and not bt._needs_prime[l0]
    for _ in range(2):
        assert l1 not in bt.step_all()
    if optimizer == 'lbfgs':
        assert bt._needs_prime[l1], 'paused lane lost its priming mark'
    else:
        counters = bt.lane_state(l1)
        assert (int(counters['g1_items']), int(counters['g2_items']),
                int(counters['t'])) == (0, 2, 0)
        assert int(bt.lane_state(l0)['g1_items']) == 4
    bt.set_running(l1, True)
    resumed = [bt.step_all()[l1] for _ in range(2)]

    st = _single(params, j1, WEIGHTS, ss, optimizer)
    for _ in range(2):
        st.step(fetch_image=False)
    st.set_weights(NEW_WEIGHTS, SCALARS)
    expected = [st.step(fetch_image=False)[1] for _ in range(2)]
    for got, ref in zip(resumed, expected):
        _assert_close(got, ref, SINGLE_RTOL, 'post-resume', atol=1e-5)


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_lane_state_and_norms_carry_into_add_job(optimizer):
    """lane_state and lane_norms, added to another bucket's lane with the
    iterate counter, continue the same optimization: the next step there
    is the next step here."""
    params = random_params(6)
    a = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                             optimizer=optimizer, device='cpu')
    b = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                             optimizer=optimizer, device='cpu')
    job = _job(3)
    _add(a, job)
    _add(b, _job(4))
    for _ in range(3):
        a.step_all()
    state, norms = a.lane_state(0), a.lane_norms(0)
    assert all(bool(v) for v in norms[1].values())
    lane = b.add_job(job['content'], job['style'], None, lane_state=state,
                     t=a.t[0], norms=norms)
    assert lane == 1
    want = a.step_all()[0]
    got = b.step_all()[1]
    assert got['fevals'] == want['fevals'] == 4
    _assert_close(got, want, 1e-5, 'carried lane')


def test_norms_host_reads_every_lane():
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=3,
                              optimizer='lbfgs', device='cpu')
    _add(bt, _job(0))
    _add(bt, _job(1), lane=2)
    bt.step_all()
    keys, vals, set_ = bt.norms_host()
    assert keys == list(bt.spec.norm_keys) == [
        'conv1_1:s', 'conv2_1:s', 'conv2_2:c']
    assert vals.shape == set_.shape == (3, 3)
    assert set_[:, [0, 2]].all() and not set_[:, 1].any()
    assert (vals[:, 1] == 0).all() and (vals[:, [0, 2]] > 0).all()
    for lane in (0, 2):
        lane_vals, _ = bt.lane_norms(lane)
        assert [float(lane_vals[k]) for k in keys] == list(vals[:, lane])


@pytest.mark.parametrize('optimizer', ['adam', 'lbfgs'])
def test_inactive_lane_nans_stay_in_their_lane(optimizer):
    """An inactive lane between two active ones, its iterate and norms NaN:
    its neighbours' traces and iterates are the ones they have beside a
    clean inactive lane, bit for bit, and its own state stays as it was."""
    params = random_params(6)
    runs = []
    for poison in (False, True):
        bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=3,
                                  optimizer=optimizer, device='cpu')
        _add(bt, _job(0))
        _add(bt, _job(1), lane=2)
        if poison:
            bt.states['x'][1] = float('nan')
            for k in bt.spec.norm_keys:
                bt.inputs['norms_vals'][k][1] = float('nan')
                bt.inputs['norms_set'][k][1] = True
        traces = [bt.step_all() for _ in range(2)] + [bt.run_steps_all(2)]
        runs.append((traces, bt))
    (clean, a), (dirty, b) = runs
    assert clean == dirty
    assert all(set(t) == {0, 2} for t in dirty)
    for lane in (0, 2):
        np.testing.assert_array_equal(a.lane_image(lane), b.lane_image(lane))
    assert torch.isnan(b.states['x'][1]).all()
    _, vals, _ = b.norms_host()
    assert np.isnan(vals[:, 1]).all() and np.isfinite(vals[:, [0, 2]]).all()


def test_stack_and_unstack_lanes_round_trip():
    x = torch.arange(2 * 4 * 5 * 3, dtype=torch.float32).reshape(2, 1, 4, 5,
                                                                 3)
    lanes = [{'x': x[i], 'sk': torch.stack([x[i], -x[i]]), 'n': i,
              'gram': torch.full((3, 3), float(i))} for i in range(2)]
    stacked = stack_lanes(lanes)
    assert stacked['x'].shape == (2, 4, 5, 3)
    assert stacked['sk'].shape == (2, 2, 4, 5, 3)
    assert stacked['gram'].shape == (2, 3, 3)
    assert stacked['n'].tolist() == [0, 1]
    for i in range(2):
        lane = unstack_lane(stacked, i)
        assert lane['x'].shape == (1, 4, 5, 3)
        assert lane['sk'].shape == (2, 1, 4, 5, 3)
        assert lane['x']._base is stacked['x']
        for key in ('x', 'sk', 'gram'):
            assert torch.equal(lane[key], lanes[i][key])
        assert int(lane['n']) == i


def test_unmasked_batched_step_equals_the_masked_one_with_every_lane():
    params = random_params(6)
    bt = BatchedStyleTransfer(params, WEIGHTS, SCALARS, HW, max_lanes=2,
                              optimizer='adam', device='cpu')
    _add(bt, _job(0))
    _add(bt, _job(1))
    step, evaluate = build_batched_step_fns(bt.spec, 'adam')
    masked, _ = build_masked_batched_step_fns(bt.spec, 'adam')
    assert evaluate is None
    everyone = torch.ones(2, dtype=torch.bool)
    a = step(bt.model, bt.states, bt.inputs, bt.step_sizes)
    b = masked(bt.model, bt.states, bt.inputs, bt.step_sizes, everyone)
    assert torch.equal(a[2], b[2]) and a[2].shape == (
        len(bt.spec.trace_keys), 2)
    for key in a[0]:
        assert torch.equal(a[0][key], b[0][key]), key


def test_cuda_engine_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        BatchedStyleTransfer(random_params(6), WEIGHTS, SCALARS, HW,
                             max_lanes=2)
