"""The port's serving driver on the CPU (device='cpu', the kernels' plain
versions): the driver protocol tests of tests/test_serve.py adapted to
style_transfer2_tpu_torch.serve.driver, the AdaptiveTuner's plans held
equal to the JAX tuner's, the driver's iterates 1-8 held against the JAX
Driver's, and the respawn order (a new driver's device work waits for the
driver it replaces)."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from style_transfer2_tpu.models import random_params as jax_random_params
from style_transfer2_tpu.serve import messages as jm
from style_transfer2_tpu.serve.driver import AdaptiveTuner as JaxTuner
from style_transfer2_tpu.serve.driver import Driver as JaxDriver
from style_transfer2_tpu_torch.models import random_params
from style_transfer2_tpu_torch.serve import messages as m
from style_transfer2_tpu_torch.serve.driver import (AdaptiveTuner,
                                                    DeviceTimeoutError,
                                                    Driver)

# tests/test_golden.py's trace tolerance. The iterate image is held at
# tests/test_torch_golden.py's: rtol 1e-2, atol 0.75 on the 0-255 scale.
RTOL = 5e-3
IMAGE_RTOL, IMAGE_ATOL = 1e-2, 0.75

WEIGHTS = {'content': {'conv2_2': 0.1},
           'style': {'conv1_1': 1.0, 'conv2_1': 1.0},
           'deepdream': {}}
SCALARS = {'p': 50.0, 'p_power': 6.0, 'tv': 5.0, 'tv_power': 2.0}


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def cpu_driver(**kw):
    return Driver(random_params(0), device='cpu', **kw)


def images(seed, hw=(24, 24)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
            for _ in range(3)]


async def _drain_until(driver, msg_type, limit=50):
    for _ in range(limit):
        msg = await asyncio.wait_for(driver.out_queue.get(), 240)
        if isinstance(msg, msg_type):
            return msg
    raise AssertionError('no %s received' % msg_type.__name__)


async def _feed(driver, imgs, optimizer='adam', msgs=m):
    await driver.in_queue.put(msgs.SetWeights(WEIGHTS, SCALARS))
    await driver.in_queue.put(msgs.SetImages(None, *imgs, False))
    await driver.in_queue.put(msgs.SetOptimizer(optimizer))
    await driver.in_queue.put(msgs.StartIteration())


# -- The driver protocol (tests/test_serve.py, adapted) -------------------------

def test_driver_bootstrap_handshake():
    """StartIteration with empty slots answers GetImages; after the app
    re-sends the images, iteration proceeds (reference worker.py:399-401)."""
    async def body():
        driver = cpu_driver()
        task = asyncio.ensure_future(driver.run())

        ready = await _drain_until(driver, m.WorkerReady)
        assert 'conv5_4' in ready.layers and 'data' in ready.layers

        await driver.in_queue.put(m.StartIteration())
        await _drain_until(driver, m.GetImages)

        content, style, inp = images(0)
        await driver.in_queue.put(m.SetWeights(WEIGHTS, SCALARS))
        await driver.in_queue.put(m.SetImages(None, inp, content, style,
                                              True))
        await driver.in_queue.put(m.SetOptimizer('adam'))
        await driver.in_queue.put(m.StartIteration())

        it = await _drain_until(driver, m.Iterate)
        assert it.i == 1
        assert np.isfinite(it.trace['loss'])
        assert it.image.shape == (24, 24, 3)
        assert driver.transfer.device.type == 'cpu'

        it2 = await _drain_until(driver, m.Iterate)
        assert it2.i == 2

        await driver.in_queue.put(m.PauseIteration())
        await driver.in_queue.put(m.Shutdown())
        await _drain_until(driver, m.Shutdown)
        await task
    run(body())


def test_driver_pause_and_weight_change():
    async def body():
        driver = cpu_driver()
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        await _feed(driver, images(1))
        await _drain_until(driver, m.Iterate)

        # Pause: no more Iterates after the queue drains.
        await driver.in_queue.put(m.PauseIteration())
        await asyncio.sleep(0.3)
        while not driver.out_queue.empty():
            driver.out_queue.get_nowait()
        assert not driver.transfer.is_running

        # Weight change applies and iteration resumes.
        new_weights = {'content': {'conv2_2': 0.5},
                       'style': {'conv1_1': 2.0}, 'deepdream': {}}
        await driver.in_queue.put(m.SetWeights(new_weights, SCALARS))
        await driver.in_queue.put(m.StartIteration())
        it = await _drain_until(driver, m.Iterate)
        assert it.trace['fevals'] > 0
        assert driver.transfer.weights['content']['conv2_2'] == 0.5

        await driver.in_queue.put(m.Shutdown())
        await task
    run(body())


def test_driver_fused_dispatch_emits_per_iteration():
    """steps_per_dispatch > 1: the driver fuses K steps per dispatch and
    still emits one Iterate per iteration with consecutive indices."""
    async def body():
        driver = cpu_driver(steps_per_dispatch=3)
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        await _feed(driver, images(2))
        seen = []
        for _ in range(6):
            it = await _drain_until(driver, m.Iterate)
            seen.append(it.i)
            assert np.isfinite(it.trace['loss'])
        assert seen == [1, 2, 3, 4, 5, 6]
        await driver.in_queue.put(m.Shutdown())
        await task
    run(body())


def test_driver_image_throttling():
    """image_every=3: iterate 1 and every 3rd iterate carry an image, the
    rest stream trace-only; after a reset, iterate 1 carries one again."""
    async def body():
        driver = cpu_driver(image_every=3)
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        imgs = images(3)
        await _feed(driver, imgs)
        carried = {}
        for _ in range(6):
            it = await _drain_until(driver, m.Iterate)
            carried[it.i] = it.image is not None
        assert carried[1] is True
        assert carried[2] is False and carried[4] is False
        assert carried[3] is True and carried[6] is True

        await driver.in_queue.put(m.SetImages(input_image=imgs[0],
                                              reset_state=True))
        it = await _drain_until(driver, m.Iterate)
        while it.i != 1:
            it = await _drain_until(driver, m.Iterate)
        assert it.image is not None
        await driver.in_queue.put(m.Shutdown())
        await task
    run(body())


def _spy_dispatches(driver):
    """Records the length of every dispatch: 1 for step, n for
    begin_steps(n)."""
    calls = []
    real_step = driver.transfer.step
    real_begin = driver.transfer.begin_steps

    def spy_step(*a, **kw):
        calls.append(1)
        return real_step(*a, **kw)

    def spy_begin(n, *a, **kw):
        calls.append(n)
        return real_begin(n, *a, **kw)

    driver.transfer.step = spy_step
    driver.transfer.begin_steps = spy_begin
    return calls


def test_driver_adaptive_dispatch():
    """adaptive_max_steps: the dispatch right after any control message is
    a single step; with a quiet queue, dispatches fuse K steps. A Prewarm
    (the JAX driver's compile hint, ignored here) is not control traffic:
    the dispatch after it stays fused."""
    async def body():
        driver = cpu_driver(adaptive_max_steps=4, pipeline_depth=1)
        calls = _spy_dispatches(driver)
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        await _feed(driver, images(5))
        while sum(calls) < 9:
            await _drain_until(driver, m.Iterate)
        assert calls[0] == 1, calls
        assert 4 in calls, calls

        # Pause, go idle, resume: the first dispatch after the control
        # burst is again a single step.
        await driver.in_queue.put(m.PauseIteration())
        while driver.transfer.is_running or not driver.in_queue.empty():
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.2)
        n0 = len(calls)
        await driver.in_queue.put(m.StartIteration())
        while len(calls) < n0 + 2:
            await _drain_until(driver, m.Iterate)
        assert calls[n0] == 1, calls[n0:]
        assert calls[n0 + 1] == 4, calls[n0:]

        n1 = len(calls)
        await driver.in_queue.put(m.Prewarm([(16, 16)]))
        while len(calls) < n1 + 2:
            await _drain_until(driver, m.Iterate)
        assert calls[n1:n1 + 2] == [4, 4], calls[n1:]
        assert driver.transfer.input_hw == (24, 24)

        await driver.in_queue.put(m.Shutdown())
        await task
    run(body())


def test_driver_pipelined_dispatch():
    """pipeline_depth=2: quiet-phase chunks are halved and two ride in
    flight together; iterate numbering stays strictly sequential."""
    async def body():
        driver = cpu_driver(adaptive_max_steps=4, pipeline_depth=2)
        begins = []
        real_begin = driver.transfer.begin_steps

        def spy_begin(n, *a, **kw):
            begins.append(n)
            return real_begin(n, *a, **kw)

        driver.transfer.begin_steps = spy_begin
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        await _feed(driver, images(5))

        seen = []
        while len(seen) < 12:
            it = await _drain_until(driver, m.Iterate)
            seen.append(it.i)
        assert seen == list(range(seen[0], seen[0] + len(seen))), seen
        assert 2 in begins and 4 not in begins, begins

        await driver.in_queue.put(m.SetWeights(WEIGHTS, dict(SCALARS,
                                                             tv=9.0)))
        await driver.in_queue.put(m.Shutdown())
        await task
    run(body())


def test_driver_latency_target_tunes_live():
    """With adaptive_latency_target the tuner's estimates populate from the
    driver's own dispatch stream and its plan stays on the ladder. The
    calibration skips samples that host noise makes inconsistent, so the
    driver gets up to 300 iterates (on a loaded CPU) to take one."""
    async def body():
        driver = cpu_driver(adaptive_max_steps=6, pipeline_depth=2,
                            adaptive_latency_target=0.5)
        assert driver.tuner is not None
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        await _feed(driver, images(3))
        last = None
        for n in range(300):
            last = await _drain_until(driver, m.Iterate)
            if n >= 40 and driver.tuner.step_s is not None:
                break
        assert np.isfinite(last.trace['loss'])
        assert driver.tuner.step_s is not None and driver.tuner.step_s > 0
        k, depth = driver.tuner.plan(3, 2)
        assert k in AdaptiveTuner.LADDER and depth in (1, 2)

        await driver.in_queue.put(m.Shutdown())
        await task
    run(body())


def test_driver_dispatch_watchdog():
    """A wedged device call raises DeviceTimeoutError out of the driver
    task within dispatch_timeout (the app's supervisor then respawns with
    backoff) instead of the session hanging silently."""
    async def body():
        driver = cpu_driver()
        task = asyncio.ensure_future(driver.run())
        await _drain_until(driver, m.WorkerReady)
        await _feed(driver, images(2))
        await _drain_until(driver, m.Iterate)

        driver.dispatch_timeout = 0.3
        driver.transfer.step = lambda fetch=True: time.sleep(10)
        t0 = asyncio.get_event_loop().time()
        await _drain_until(driver, m.Shutdown)
        with pytest.raises(DeviceTimeoutError):
            await task
        assert asyncio.get_event_loop().time() - t0 < 5.0
    run(body())


def test_driver_seeds_norms_as_device_tensors():
    """SetImages norms (host floats and bools, the app's capture) land in
    the engine as 0-d tensors on its device, and the engine keeps them:
    the first step normalizes by the seeded values."""
    async def body():
        first = cpu_driver()
        task = asyncio.ensure_future(first.run())
        await _drain_until(first, m.WorkerReady)
        imgs = images(4)
        await _feed(first, imgs, 'lbfgs')
        await _drain_until(first, m.Iterate)
        norms = await first.norms_host()
        await first.in_queue.put(m.Shutdown())
        await task
        vals, set_ = norms
        assert set(vals) == {'conv1_1:s', 'conv2_1:s', 'conv2_2:c'}
        assert all(isinstance(v, float) and v > 0 for v in vals.values())
        assert all(v is True for v in set_.values())

        seeded = {k: 2 * v for k, v in vals.items()}
        second = cpu_driver(after=first)
        task = asyncio.ensure_future(second.run())
        await _drain_until(second, m.WorkerReady)
        await second.in_queue.put(m.SetWeights(WEIGHTS, SCALARS))
        await second.in_queue.put(m.SetImages(None, *imgs, False, t0=5,
                                              norms=(seeded, set_)))
        await second.in_queue.put(m.SetOptimizer('lbfgs'))
        await second.in_queue.put(m.PauseIteration())
        while not second.in_queue.empty():
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.2)
        t = second.transfer
        for key, value in seeded.items():
            assert isinstance(t.norm_vals[key], torch.Tensor)
            assert t.norm_vals[key].device == t.device
            assert t.norm_vals[key].dtype == torch.float32
            assert float(t.norm_vals[key]) == pytest.approx(value)
            assert t.norm_set[key].dtype == torch.bool
        assert t.t == 5
        assert await second.norms_host() == (
            {k: pytest.approx(v) for k, v in seeded.items()}, set_)
        await second.in_queue.put(m.Shutdown())
        await task
    run(body())


# -- Respawn order -------------------------------------------------------------

def _record_device_calls(monkeypatch):
    """Logs (driver, 'start'/'end', time) around every function a driver
    runs on its device thread."""
    log = []
    real = Driver._device

    async def spy(self, fn, *args):
        def wrapped(*a):
            log.append((self, 'start', time.perf_counter()))
            try:
                return fn(*a)
            finally:
                log.append((self, 'end', time.perf_counter()))
        return await real(self, wrapped, *args)

    monkeypatch.setattr(Driver, '_device', spy)
    return log


def test_respawned_driver_waits_for_the_old_device_thread(monkeypatch):
    """A driver spawned while the one it replaces is still inside a device
    call (here a 1 s step) makes its first device call only after that
    call has returned: engines hold process-wide TF32 switches around their
    work, so two drivers' device threads must not overlap."""
    log = _record_device_calls(monkeypatch)

    async def body():
        old = cpu_driver()
        old_task = asyncio.ensure_future(old.run())
        await _drain_until(old, m.WorkerReady)
        await _feed(old, images(6))
        await _drain_until(old, m.Iterate)
        real_step = old.transfer.step
        in_step = threading.Event()

        def slow_step(fetch=True):
            in_step.set()
            time.sleep(1.0)
            return real_step(fetch)

        old.transfer.step = slow_step
        while not in_step.is_set():
            await asyncio.sleep(0.01)
        # The app's _respawn_driver: Shutdown to the old driver, then at
        # once a new driver that replaces it.
        await old.in_queue.put(m.Shutdown())
        new = cpu_driver(after=old)
        new_task = asyncio.ensure_future(new.run())
        await _drain_until(new, m.WorkerReady)
        await _feed(new, images(6))
        it = await _drain_until(new, m.Iterate)
        assert np.isfinite(it.trace['loss'])
        await new.in_queue.put(m.Shutdown())
        await asyncio.gather(old_task, new_task)
        return old, new

    old, new = run(body())
    old.executor.shutdown(wait=True)   # its last call has returned
    old_end = max(t for d, what, t in log if d is old and what == 'end')
    new_start = min(t for d, what, t in log if d is new and what == 'start')
    assert new_start >= old_end


# -- AdaptiveTuner: the JAX tuner's math ---------------------------------------

def _tuners(target):
    return AdaptiveTuner(target), JaxTuner(target)


def _same(tuners, *calls):
    """Applies each (method, args) call to both tuners; their plans and
    estimates must agree after each."""
    for name, args in calls:
        for t in tuners:
            getattr(t, name)(*args)
        ours, theirs = tuners
        assert ours.plan(30, 2) == theirs.plan(30, 2), name
        assert (ours.step_s, ours.rtt_s) == (theirs.step_s, theirs.rtt_s)


def test_adaptive_tuner_math():
    """Calibration from unpipelined differentials, chunks sized to the
    latency target net of the RTT and snapped to the ladder, pipelining
    dropped when a sub-chunk can't cover the RTT; every plan and estimate
    equal to the JAX tuner's."""
    tuners = _tuners(2.0)
    t = tuners[0]
    _same(tuners, ('note_grid', ((300, 300),)))
    assert t.plan(30, 2) == (1, 1)
    _same(tuners, ('note_single_wall', (90.0,)),
          ('note_single_wall', (0.46,)))
    assert t.plan(30, 2) == (30, 1)
    _same(tuners, ('note_chunk_wall', (30, 90.0)),
          ('note_chunk_wall', (30, 0.75)))
    assert abs(t.step_s - 0.01) < 1e-9
    assert abs(t.rtt_s - 0.45) < 1e-9
    assert t.plan(30, 2) == (60, 2)

    _same(tuners, ('note_grid', ((2048, 2048),)))
    assert t.step_s is None and t.rtt_s is not None
    assert t.plan(30, 2) == (30, 1)
    _same(tuners, ('note_chunk_wall', (30, 120.0)),
          ('note_chunk_wall', (30, 6.45)))
    assert abs(t.step_s - 0.2) < 1e-6
    assert t.plan(30, 2) == (4, 1)

    tight = _tuners(0.5)
    _same(tight, ('note_grid', ((256, 256),)),
          ('note_single_wall', (90.0,)), ('note_single_wall', (0.46,)),
          ('note_chunk_wall', (30, 90.0)), ('note_chunk_wall', (30, 0.75)))
    assert tight[0].plan(30, 2) == (8, 1)


def test_adaptive_tuner_rtt_never_contaminates_step():
    """RTT-dominated intervals are rejected without moving step_s; eight
    rejections in a row recalibrate with one unpipelined chunk; genuine
    drift still tracks; a spuriously short interval is rejected too. Plans
    and estimates equal the JAX tuner's throughout."""
    tuners = _tuners(2.0)
    t = tuners[0]
    _same(tuners, ('note_grid', ((300, 300),)),
          ('note_single_wall', (90.0,)), ('note_single_wall', (1.805,)),
          ('note_chunk_wall', (30, 90.0)), ('note_chunk_wall', (30, 1.95)))
    assert abs(t.step_s - 0.005) < 1e-9
    assert abs(t.rtt_s - 1.8) < 1e-9
    plan0 = t.plan(30, 2)
    assert plan0[0] >= 60

    _same(tuners, ('note_chunk_interval', (plan0[0], 1.8)))
    for _ in range(AdaptiveTuner.MAX_INTERVAL_REJECTS - 1):
        _same(tuners, ('note_chunk_interval', (plan0[0], 1.8)))
        assert abs(t.step_s - 0.005) < 1e-9
        assert t.plan(30, 2) == plan0
    _same(tuners, ('note_chunk_interval', (plan0[0], 1.8)))
    assert t.plan(30, 2) == (30, 1)
    _same(tuners, ('note_chunk_wall', (30, 1.95)))
    assert abs(t.step_s - 0.005) < 1e-9
    assert t.plan(30, 2) == plan0

    before = t.step_s
    _same(tuners, ('note_chunk_interval', (plan0[0], plan0[0] * 0.006)))
    assert t.step_s > before

    before = t.step_s
    plan_before = t.plan(30, 2)
    _same(tuners, ('note_chunk_interval',
                   (plan0[0], plan0[0] * before / 10.0)))
    assert t.step_s == before
    assert t.plan(30, 2) == plan_before
    for _ in range(AdaptiveTuner.MAX_INTERVAL_REJECTS):
        _same(tuners, ('note_chunk_interval',
                       (plan0[0], plan0[0] * before / 10.0)))
    assert t.plan(30, 2) == (30, 1)


# -- Driver parity with the JAX Driver -----------------------------------------

async def _iterates(make_driver, msgs, imgs, n=8):
    """Runs the bootstrap script (SetWeights, SetImages, SetOptimizer
    lbfgs, StartIteration) through a new driver and returns Iterates
    1..n."""
    driver = make_driver()
    task = asyncio.ensure_future(driver.run())
    await _drain_until(driver, msgs.WorkerReady)
    content, style, inp = imgs
    await driver.in_queue.put(msgs.SetWeights(WEIGHTS, SCALARS))
    await driver.in_queue.put(msgs.SetImages(None, inp, content, style,
                                             True))
    await driver.in_queue.put(msgs.SetOptimizer('lbfgs'))
    await driver.in_queue.put(msgs.StartIteration())
    out = []
    while len(out) < n:
        out.append(await _drain_until(driver, msgs.Iterate))
    await driver.in_queue.put(msgs.Shutdown())
    await task
    return out


@pytest.mark.parametrize('dispatch', [
    {'steps_per_dispatch': 1},
    {'adaptive_max_steps': 4, 'pipeline_depth': 2},
], ids=['per_step', 'adaptive'])
def test_driver_parity_with_jax(dispatch):
    """The same random_params(0) numpy weights, seeded images and script
    through the port's Driver (CPU) and the JAX Driver: iterates 1-8 carry
    the same numbers and every trace key agrees within rtol 5e-3; the
    last iterate's image within rtol 1e-2, atol 0.75."""
    params = jax_random_params(0)
    imgs = images(11)
    ours = run(_iterates(lambda: Driver(params, device='cpu', **dispatch),
                         m, imgs))
    theirs = run(_iterates(lambda: JaxDriver(params, **dispatch), jm, imgs))
    assert [it.i for it in ours] == list(range(1, 9))
    assert [it.i for it in theirs] == list(range(1, 9))
    for got, want in zip(ours, theirs):
        keys = [k for k in want.trace if k != 'time']
        assert [k for k in got.trace if k != 'time'] == keys
        assert got.trace['fevals'] == want.trace['fevals']
        for key in keys:
            np.testing.assert_allclose(
                got.trace[key], want.trace[key], rtol=RTOL,
                err_msg='iterate %d: %s' % (got.i, key))
    assert ours[-1].image.shape == (24, 24, 3)
    np.testing.assert_allclose(ours[-1].image, np.asarray(theirs[-1].image),
                               rtol=IMAGE_RTOL, atol=IMAGE_ATOL)


@pytest.mark.parametrize('move', ['set_input', 'resample_input'])
def test_bf16_history_restarts_in_float32_below_the_gate(move):
    """A bfloat16 session reset on a grid at or above
    BF16_HISTORY_MIN_PIXELS keeps its L-BFGS pairs in bf16; moved down to
    a serving ladder's first rung below it (a fresh input, or the iterate
    resampled) the history restarts in float32, and moved back up it stays
    float32, as the CLI's ladder keeps the dtype of its first rung."""
    from style_transfer2_tpu_torch.engine import StyleTransfer
    from style_transfer2_tpu_torch.optim import lbfgs
    big, small = (400, 400), (192, 256)
    assert big[0] * big[1] >= lbfgs.BF16_HISTORY_MIN_PIXELS
    assert small[0] * small[1] < lbfgs.BF16_HISTORY_MIN_PIXELS
    st = StyleTransfer(random_params(0), 'bfloat16', device='cpu')
    rng = np.random.RandomState(0)
    st.set_input(rng.randint(0, 256, big + (3,)).astype(np.uint8))
    assert st.opt_state['sk'].dtype == torch.bfloat16
    if move == 'set_input':
        st.set_input(rng.randint(0, 256, small + (3,)).astype(np.uint8))
    else:
        st.resample_input(small)
    assert st.input_hw == small
    assert st.opt_state['sk'].dtype == torch.float32
    assert st.opt_state['sk'].shape == (10, 1) + small + (3,)
    assert int(st.opt_state['count']) == 0 and st._needs_init
    st.resample_input(big)
    assert st.opt_state['sk'].dtype == torch.float32
