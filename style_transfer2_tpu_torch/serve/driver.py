"""The driver task — the reference's worker process, in-process
(style_transfer2_tpu/serve/driver.py, on the port's StyleTransfer).

Replicates Worker's control flow (reference worker.py:318-409): when
running, drain ALL pending messages first (control latency <= 1 iteration),
then take ONE optimizer step and emit an Iterate; when idle, block on the
queue. A fresh driver with incomplete state answers StartIteration with
GetImages so the app re-sends the slots (the bootstrap/crash-recovery
handshake, worker.py:399-401).

Device work (steps, feature forwards) runs on a single executor thread so
the aiohttp event loop never blocks; the driver task is the only mutator of
the StyleTransfer state, so there is no cross-task race by construction
(the same safety argument as the reference's single-threaded worker). That
thread launches on its own current CUDA stream (the default stream: nothing
sets another), and the engine sets the grad mode its model needs itself, so
nothing rests on state set on the event loop's thread.

A driver that replaces another (a respawn) makes no device call until the
old one's task has ended and its device thread has returned from its last
call: an engine holds its precision's TF32 switches, which are process-wide,
around its device work (engine/steps.py precision_scope), so two engines'
device threads must not overlap.
"""

import asyncio
import concurrent.futures
import logging
import time

import torch

from ..engine.transfer import StyleTransfer
from . import messages as m

logger = logging.getLogger('driver')


class DeviceTimeoutError(RuntimeError):
    """A device dispatch exceeded dispatch_timeout — the device is wedged,
    not merely slow. Raised out of the driver task
    so the app's supervisor respawns the driver with backoff instead of the
    session hanging silently forever."""


async def run_with_watchdog(fut, timeout, describe):
    """Awaits an executor future under the device-hang watchdog: exceeding
    `timeout` seconds raises DeviceTimeoutError. asyncio.shield is
    load-bearing — an executor future can't interrupt its thread, and
    wait_for's cancel would otherwise BLOCK until the wedged call returns;
    shielding lets the timeout fire while the thread is abandoned mid-call.
    timeout <= 0 disables. Shared by both serving tiers."""
    if timeout <= 0:
        return await fut
    try:
        return await asyncio.wait_for(asyncio.shield(fut), timeout)
    except asyncio.TimeoutError:
        logger.error('device call %s exceeded the %.1fs watchdog — '
                     'backend wedged', describe, timeout)
        raise DeviceTimeoutError(
            'device dispatch exceeded %.1fs' % timeout)


class AdaptiveTuner:
    """Sizes fused dispatch chunks from MEASURED step time and dispatch
    round-trip, so control latency tracks a wall-clock target across
    resolutions instead of a hand-tuned iteration count (a fixed chunk
    length holds many times more seconds of work at a large grid than at a
    small one). Encodes the pipelining rule as a live decision: a
    sub-chunk's device compute must cover the dispatch RTT, or depth-2
    pipelining LOSES to one big chunk.

    The math is the JAX driver's, unchanged: it measures the step time and
    the dispatch round trip, so a local card needs no re-fit (its RTT is a
    host sync). Estimation runs as an explicit per-grid CALIBRATION,
    because the only sample kind that cleanly separates step time from
    dispatch RTT is an UNpipelined differential: pipelined collect
    intervals equal pure chunk compute only while the device is genuinely
    busy, and over a slow link with small chunks they are collect-RTT, not
    compute (fed back, step_s ≈ RTT/k shrinks k, which makes intervals even
    more RTT-dominated — a spiral down to dispatch-bound 2-step chunks).

      phase 'single' — plan() forces 1-step dispatches until one clean
        single wall w1 = rtt + 1·step is recorded (the first dispatch of
        any (grid, k) is discarded: in the JAX package it pays an XLA
        compile, here the first use of its shapes).
      phase 'chunk' — plan() forces one UNpipelined default-k chunk;
        its wall = rtt + k·step paired with w1 yields both estimates
        (the RTT cancels in the difference). A grid change re-enters
        calibration at 'chunk': step_s is grid-bound and resets, rtt_s
        is link-bound and persists, so one chunk wall recalibrates.
      phase 'run' — normal planning. Pipelined collect intervals keep
        step_s tracking drift, but a sample is accepted only if it would
        not raise step_s by more than 50% — an idle-device interval
        (≈ RTT) can therefore never contaminate the estimate. Eight
        consecutive rejections force recalibration ('chunk'), so if the
        estimate ever goes stale the tuner heals itself with one
        unpipelined chunk instead of trusting poisoned samples.

    Chunk lengths are quantized to a fixed ladder (in the JAX package every
    distinct scan length is its own XLA program)."""

    LADDER = (1, 2, 4, 8, 15, 30, 60, 120, 240)
    MAX_INTERVAL_REJECTS = 8

    def __init__(self, latency_target, alpha=0.35):
        self.latency_target = float(latency_target)
        self.alpha = float(alpha)
        self.step_s = None
        self.rtt_s = None
        self._w1_last = None
        self._grid = None
        self._phase = 'single'
        self._rejects = 0
        # (grid, k) dispatches already run once: the FIRST one pays one-time
        # costs inside the measured wall, so that sample is discarded, not
        # averaged.
        self._seen = set()

    def _ewma(self, old, value):
        return value if old is None else old + self.alpha * (value - old)

    def _first_run(self, k):
        key = (self._grid, k)
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    def note_grid(self, hw):
        if hw != self._grid:
            self._grid = hw
            self.step_s = None
            self._w1_last = None
            self._rejects = 0
            # rtt persists across grids (a property of the link); with it
            # known, one unpipelined chunk wall recalibrates step directly.
            self._phase = 'chunk' if self.rtt_s is not None else 'single'

    def note_single_wall(self, wall):
        """A blocking single-step dispatch took `wall` = rtt + 1 step."""
        if self._first_run(1):
            return
        self._w1_last = wall
        if self.step_s is not None:
            self.rtt_s = self._ewma(self.rtt_s, max(0.0, wall - self.step_s))
        if self._phase == 'single':
            self._phase = 'chunk'

    def note_chunk_wall(self, k, wall):
        """An UNpipelined k-chunk dispatch-to-collect took `wall` =
        rtt + k steps: paired with a single-step wall (or a known rtt) it
        separates step from RTT — the calibration sample."""
        if self._first_run(k):
            return
        if k <= 1:
            return
        step = None
        if self._w1_last is not None:
            # Differential: the RTT cancels between the two walls. RTT
            # jitter can swamp the compute delta (negative step) — skip
            # the sample and wait for the next chunk wall.
            d = (wall - self._w1_last) / (k - 1)
            step = d if d > 0 else None
        elif self.rtt_s is not None:
            d = (wall - self.rtt_s) / k
            step = d if d > 0 else None
        if step is not None:
            self.step_s = self._ewma(self.step_s, step)
            if self._w1_last is not None:
                self.rtt_s = self._ewma(
                    self.rtt_s, max(0.0, self._w1_last - step))
            self._phase = 'run'
            self._rejects = 0

    def note_chunk_interval(self, k, interval):
        """Consecutive PIPELINED collections `interval` apart. Pure chunk
        compute only if the device stayed busy across the gap, so accept
        the sample only inside a symmetric plausibility band (within 1.5x
        of step_s either way): genuine drift tracks; an idle-device
        (RTT-dominated) interval cannot inflate the estimate; a spuriously
        SHORT interval (back-to-back collects after a queue stall) cannot
        deflate it and balloon planned chunks past the latency target.
        Persistent rejection on either side triggers recalibration."""
        if self._first_run(k):
            return
        if k <= 0 or interval <= 0 or self._phase != 'run':
            return
        cand = interval / k
        if self.step_s is not None and not (
                self.step_s / 1.5 <= cand <= 1.5 * self.step_s):
            self._rejects += 1
            if self._rejects >= self.MAX_INTERVAL_REJECTS:
                self._phase = 'chunk'   # heal via one unpipelined chunk
                self._rejects = 0
            return
        self._rejects = 0
        self.step_s = self._ewma(self.step_s, cand)

    @classmethod
    def _ladder_floor(cls, k):
        best = cls.LADDER[0]
        for v in cls.LADDER:
            if v <= k:
                best = v
        return best

    def plan(self, default_k, depth_cap):
        """(k, depth) for the next quiet-queue dispatch. During
        calibration the plan IS the measurement schedule: single-step
        dispatches until a clean w1, then one unpipelined default chunk."""
        if not self.latency_target:
            return default_k, depth_cap
        if self._phase == 'single':
            return 1, 1
        if self._phase == 'chunk':
            return (default_k if default_k > 1 else self.LADDER[5]), 1
        # The settle of an in-flight dispatch pays one collect RTT on top
        # of the compute, so that much comes off the latency budget —
        # floored at a quarter of the target so a link whose RTT exceeds
        # the target degrades to small-but-sane chunks instead of
        # collapsing to 1-step dispatches.
        budget = self.latency_target
        if self.rtt_s is not None:
            budget = max(self.latency_target - self.rtt_s,
                         0.25 * self.latency_target)
        total = max(1, int(budget / self.step_s))
        k = self._ladder_floor(max(1, total // max(1, depth_cap)))
        depth = depth_cap
        if depth > 1 and self.rtt_s is not None \
                and k * self.step_s <= self.rtt_s:
            # Sub-chunks too small to hide the RTT: one big chunk wins
            # (round-2 measured rule).
            depth = 1
            k = self._ladder_floor(total)
        return k, depth


class Driver:
    """Owns the device and the StyleTransfer engine; talks to the app over
    a pair of asyncio queues."""

    def __init__(self, params, precision='float32', device='cuda',
                 loop=None, steps_per_dispatch=1, image_every=1,
                 adaptive_max_steps=0, pipeline_depth=1,
                 dispatch_timeout=0.0, adaptive_latency_target=0.0,
                 after=None, remat=False, placement=None):
        """params: the numpy params dict (models.weights); device: 'cuda'
        (the default; raises without CUDA) or 'cpu' (the kernels' plain
        versions); remat (False / 'conv' / 'block') is the engine's
        rematerialization policy (models/vgg19.py); placement, a
        parallel.SpatialPlacement or None, shards the engine's image over
        a mesh (engine/transfer.py).
        steps_per_dispatch > 1 fuses K optimizer steps per device
        dispatch (begin_steps) for throughput; control latency grows to K
        iterations (the reference guarantee is 1, the default).
        image_every > 1 fetches the iterate snapshot from the device only
        every Nth iteration (Iterate.image is None in between) — the trace
        still streams per iteration, and the browser polls /output at 4 Hz
        regardless.
        adaptive_max_steps > 1 enables ADAPTIVE fusing: a dispatch right
        after any control message runs a single step (a user tweak shows
        its effect within one iteration, the reference's latency
        guarantee), and once the control queue goes quiet, dispatches fuse
        adaptive_max_steps iterations each.
        pipeline_depth > 1 splits each quiet-phase chunk into depth
        dispatches kept in flight together (begin_steps enqueues;
        collect_steps blocks): the host's collect of one sub-chunk hides
        behind the device work of the next, at identical worst-case control
        latency (still adaptive_max_steps iterations of in-flight work).
        Default 1: with adaptive off, depth 2 would silently double
        in-flight work (worst-case control latency) to
        2*steps_per_dispatch; app.py opts into depth 2 whenever adaptive
        mode is on.
        dispatch_timeout > 0 (seconds) is the device-hang watchdog: a
        single device call exceeding it raises DeviceTimeoutError out of
        the driver task, so a wedged device becomes a supervised driver
        restart (with backoff) instead of a silent hang; 0 disables.
        adaptive_latency_target > 0 (seconds, requires adaptive mode)
        AUTO-TUNES the quiet-phase chunking from measured step time and
        dispatch RTT (AdaptiveTuner): total in-flight work targets that
        many seconds of wall clock at the current resolution, and
        pipelining turns itself off when sub-chunk compute can't cover
        the RTT. adaptive_max_steps then only seeds the pre-measurement
        default; chunk lengths come from AdaptiveTuner.LADDER.
        after: the driver this one replaces, or None. Its task must end
        (the app sends it Shutdown); this driver's first device call waits
        for that and for its device thread."""
        self.in_queue = asyncio.Queue()
        self.out_queue = asyncio.Queue()
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.image_every = max(1, int(image_every))
        self.adaptive_max_steps = max(0, int(adaptive_max_steps))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.dispatch_timeout = float(dispatch_timeout)
        self._recent_control = False
        self.tuner = None
        if adaptive_latency_target > 0 and self.adaptive_max_steps > 1:
            self.tuner = AdaptiveTuner(adaptive_latency_target)
        self._last_collect_end = None
        self.transfer = StyleTransfer(params, precision=precision,
                                      device=device, remat=remat,
                                      placement=placement)
        self.loop = loop or asyncio.get_event_loop()
        # One thread owns all device calls; queue depth 1 keeps ordering.
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='cuda-driver')
        self.should_stop = False
        self._after = after
        self._ended = asyncio.Event()

    async def released(self):
        """Returns once this driver's task has ended and its device thread
        has returned from its last call (a call still running when the task
        ended, as after a chunk the watchdog gave up on, finishes first).
        The watchdog bounds the wait."""
        await self._ended.wait()
        fut = self.loop.run_in_executor(None, self.executor.shutdown, True)
        await run_with_watchdog(fut, self.dispatch_timeout,
                                'the previous driver\'s device thread')

    async def _device(self, fn, *args):
        """Runs a blocking device call off the event loop. With the
        watchdog armed, a call that outlives dispatch_timeout raises
        DeviceTimeoutError (the stuck executor thread is abandoned — a
        fresh Driver brings a fresh executor). The first call waits for
        the replaced driver's device thread."""
        if self._after is not None:
            await self._after.released()
            self._after = None
        fut = self.loop.run_in_executor(self.executor, fn, *args)
        return await run_with_watchdog(fut, self.dispatch_timeout,
                                       getattr(fn, '__name__', fn))

    async def start(self):
        await self.out_queue.put(m.WorkerReady(layers=self.transfer.layers()))

    async def norms_host(self):
        """The engine's first-eval norm state as host dicts (key -> float,
        key -> bool), read on the device thread behind the engine's own
        work: one stack and one transfer a dict of 0-d device tensors, not
        a sync per key. None while the engine has none."""
        t = self.transfer

        def fetch():
            if not t.norm_set:
                return None
            vkeys, skeys = list(t.norm_vals), list(t.norm_set)
            vals = torch.stack([t.norm_vals[k] for k in vkeys]).cpu()
            set_ = torch.stack([t.norm_set[k] for k in skeys]).cpu()
            return ({k: float(v) for k, v in zip(vkeys, vals.tolist())},
                    {k: bool(v) for k, v in zip(skeys, set_.tolist())})

        return await self._device(fetch)

    async def _collect(self, handle):
        """Materializes one in-flight dispatch and emits its Iterates (one
        per fused iteration, sharing the chunk-final snapshot)."""
        image, traces = await self._device(self.transfer.collect_steps,
                                           handle, True)
        for j, tr in enumerate(traces):
            await self.out_queue.put(m.Iterate(
                image, handle.t_end - handle.n_steps + 1 + j, tr.data))

    async def run(self):
        """Main loop, mirroring reference worker.py:338-364 — with the
        fused/pipelined dispatch policy layered on: control messages are
        only applied with no dispatch in flight (Iterate ordering follows
        engine-state ordering), and any control traffic forces the next
        dispatch down to a single step."""
        await self.start()
        in_flight = []   # (begin_steps handle, enqueue time), dispatch order

        async def flush():
            while in_flight:
                await self._collect(in_flight.pop(0)[0])
            self._last_collect_end = None

        try:
            while not self.should_stop:
                if self.transfer.is_running:
                    if not self.in_queue.empty():
                        # Settle in-flight work, then drain all pending
                        # control messages.
                        await flush()
                        while not self.in_queue.empty():
                            msg = self.in_queue.get_nowait()
                            if await self.process_message(msg):
                                self.should_stop = True
                                break
                        continue
                    if not self.transfer.check_consistency():
                        await flush()
                        await self.out_queue.put(m.GetImages())
                        # Wait for the app's reply instead of spinning.
                        msg = await self.in_queue.get()
                        if await self.process_message(msg):
                            break
                        continue
                    if self.adaptive_max_steps > 1:
                        # One-step dispatch right after control traffic;
                        # full fused chunks once the queue is quiet.
                        if self._recent_control:
                            k, depth = 1, 1
                            self._recent_control = False
                        else:
                            depth = self.pipeline_depth
                            k = max(1, self.adaptive_max_steps // depth)
                            if self.tuner is not None:
                                self.tuner.note_grid(self.transfer.input_hw)
                                k, depth = self.tuner.plan(k, depth)
                    else:
                        k = self.steps_per_dispatch
                        depth = self.pipeline_depth if k > 1 else 1
                    if k == 1:
                        await flush()
                        # Iterate 1 always carries an image: the app's
                        # input_was_reset guard clears only on an
                        # image-bearing first iterate (app.py parity).
                        t_next = self.transfer.t + 1
                        fetch = (t_next == 1
                                 or t_next % self.image_every == 0)
                        t0 = time.perf_counter()
                        image, trace = await self._device(
                            self.transfer.step, fetch)
                        if self.tuner is not None:
                            self.tuner.note_grid(self.transfer.input_hw)
                            self.tuner.note_single_wall(
                                time.perf_counter() - t0)
                        await self.out_queue.put(
                            m.Iterate(image, self.transfer.t, trace))
                    elif len(in_flight) < depth:
                        # Enqueue another chunk: the host launches its
                        # steps while the device runs the chunk ahead. The
                        # chunk's wall starts before the call, which holds
                        # the host's launch work (the JAX engine's returns
                        # at once).
                        t_begin = time.perf_counter()
                        handle = await self._device(
                            self.transfer.begin_steps, k)
                        in_flight.append((handle, t_begin))
                    else:
                        # Pipeline full: settle the oldest chunk.
                        handle, t_begin = in_flight.pop(0)
                        await self._collect(handle)
                        now = time.perf_counter()
                        if self.tuner is not None:
                            if in_flight and \
                                    self._last_collect_end is not None:
                                # Device saturated since the previous
                                # collect: the gap is pure chunk compute.
                                self.tuner.note_chunk_interval(
                                    handle.n_steps,
                                    now - self._last_collect_end)
                            elif not in_flight:
                                # Unpipelined: wall = RTT + k steps.
                                self.tuner.note_chunk_wall(
                                    handle.n_steps, now - t_begin)
                        self._last_collect_end = now
                    continue
                await flush()
                msg = await self.in_queue.get()
                if await self.process_message(msg):
                    break
        except asyncio.CancelledError:
            pass
        finally:
            await self.out_queue.put(m.Shutdown())
            self.executor.shutdown(wait=False)
            self._ended.set()

    async def process_message(self, msg):
        """Dispatches one message; returns True on Shutdown
        (reference worker.py:366-409)."""
        if isinstance(msg, m.Prewarm):
            # The JAX driver's background-compile request: nothing to
            # compile here. It doesn't touch engine state, so it must not
            # drop the next dispatch to a single step.
            return False
        self._recent_control = True
        t = self.transfer

        def is_image(obj):
            return obj is not None and not isinstance(obj, int)

        if isinstance(msg, m.SetImages):
            if is_image(msg.input_image):
                await self._device(t.set_input, msg.input_image)
            elif msg.input_image == m.SetImages.RESAMPLE:
                await self._device(t.resample_input, tuple(msg.size))

            if is_image(msg.content_image):
                await self._device(t.set_content, msg.content_image)
            elif msg.content_image == m.SetImages.RESAMPLE:
                await self._device(t.resample_content, tuple(msg.size))

            if is_image(msg.style_image):
                await self._device(t.set_style, msg.style_image)

            if msg.reset_state:
                await self._device(t.reset)
            elif msg.t0:
                # Continue the session's iterate numbering (a fresh engine's
                # first set_input resets t to 0; the user's counter should
                # survive an engine respawn just like the iterate does).
                t.t = int(msg.t0)
            if msg.norms and not msg.reset_state:
                # Seed the session's first-eval gradient-RMS norms so a
                # respawned engine continues the SAME normalized objective
                # instead of re-anchoring at the live iterate (norms are
                # write-once per reset epoch, so the app's capture is
                # always current). The engine turns the host floats into
                # 0-d tensors on its device.
                await self._device(t.seed_norms, *msg.norms)

        elif isinstance(msg, m.SetOptimizer):
            # The worker resets when the optimizer INSTANCE doesn't match the
            # class — i.e. on a type change or when none exists yet
            # (reference worker.py:387-391).
            changed = (msg.optimizer != t.optimizer_name
                       or t.opt_state is None)
            t.set_optimizer(msg.optimizer)
            t.set_step_size(msg.step_size)
            if changed:
                await self._device(t.reset)

        elif isinstance(msg, m.SetWeights):
            # Clears the optimizer's history on the device: a device call.
            await self._device(t.set_weights, msg.weights, msg.params)

        elif isinstance(msg, m.Shutdown):
            return True

        elif isinstance(msg, m.StartIteration):
            # A first start allocates the optimizer state: a device call.
            if not await self._device(t.start):
                await self.out_queue.put(m.GetImages())

        elif isinstance(msg, m.PauseIteration):
            t.pause()

        else:
            logger.error('Invalid message received: %r', msg)

        return False
