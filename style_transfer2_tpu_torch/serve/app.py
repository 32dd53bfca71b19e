#!/usr/bin/env python3
"""Single-session serving tier: one user, one dedicated engine on one
device (style_transfer2_tpu/serve/app.py, on the port's driver).

Speaks the reference's external protocol (app.py: GET /, GET /output,
POST /upload, GET /websocket + static; WS types applyParams/pause/reset/
restartWorker/start in, iterateInfo/newParams/newSize/state/thumbnails/
workerReady out), with the worker subprocess + ZeroMQ replaced by the
in-process driver task (serve/driver.py) and asyncio queues.

All protocol/session logic lives in serve/session.py; this module is the
glue between it and the driver: the per-slot upload policy, the
size-change flow, the ladder -> polish -> pause schedule, session
persistence, the driver supervisor (respawn on crash with backoff,
reference app.py:336-344), and the GetImages bootstrap handshake ("state
above, compute below": the engine is rebuildable at any time from the
Session's host state).

Config keys beyond the JAX app's: `device` ('cuda', the default, raises at
startup without CUDA; 'cpu' runs the kernels' plain versions). `remat`
('', conv or block; anything else raises when the driver spawns) is the
engine's rematerialization policy, as in the JAX app. `mesh` (e.g. '4',
'auto') shards the session's image over that many devices of `device`
(parallel/spatial.py: the first N cards, failing at startup where there
are fewer; N entries of the CPU on 'cpu'), and every grid the tier picks
snaps to multiples of N (_snap_grid), as in the JAX app. Keys that mean
nothing here (pallas, platform, prewarm_sizes) are logged once and
ignored.

    python -m style_transfer2_tpu_torch.serve.app [config.ini] [-d]
"""

import asyncio
import io
import logging
import os
import time
from pathlib import Path

from aiohttp import web
import numpy as np
from PIL import Image
import torch
import yaml

from .. import utils
from ..engine.objective import ObjectiveSpec
from ..engine.transfer import resolve_device
from ..models.weights import resolve_params
from . import messages as m
from . import persist
from . import phases
from . import session as sn
from .driver import Driver
from .error_pages import error_pages
from .render import add_static_routes, render

ROOT_DIR = Path(__file__).resolve().parents[2]

logger = logging.getLogger('app')

# Config keys of the JAX app with no meaning in the port: logged once at
# startup and ignored (platform never moves the port off its `device`).
IGNORED_KEYS = ('pallas', 'platform', 'prewarm_sizes')


def device_name(config):
    """The config's device for /stats: the card's name on CUDA."""
    device = resolve_device(config.get('device', 'cuda'))
    if device.type != 'cuda':
        return str(device)
    return torch.cuda.get_device_name(device)


def snap_size(size, snap):
    """Quantizes a requested size to a multiple of `snap`, so that user
    resizes land on a few grids. snap <= 0 disables (reference
    behavior)."""
    size = int(size)
    if snap <= 0:
        return size
    return max(snap, int(round(size / snap)) * snap)


class SingleSessionTier(sn.EngineActions):
    """One user session bound to one Driver (the in-process worker)."""

    def __init__(self, config, debug_level=0):
        self.config = config
        self.debug_level = debug_level
        self.sess = sn.Session()
        self.sess.worker_ready = False
        self.layers = []
        self.instance_id = os.urandom(8).hex()
        self.driver = None
        self.driver_task = None
        self.pump_task = None
        self.tasks = []
        self.model_params = None
        self.router = sn.RouterLink(
            config, self.instance_id,
            host=config['http_host'], port=config['http_port'])
        self.router.enabled_check = lambda: self.sess.worker_ready
        self.persist_path = config.get('persist_path', '')
        self._persist_sig = None
        # The `mesh` key's SpatialPlacement (on_startup), or None.
        self.placement = None
        # The automated session schedule (ladder -> polish -> pause): a
        # phases.Schedule or None. The tier's own transition mechanics ride
        # alongside: _await_grid is a pending rung advance (budgets anchor
        # when the new grid shows up in the iterate stream), _polish_waiting
        # a pending polish respawn (anchors when the polish driver reports
        # ready). The override redirects driver respawns to the polish
        # precision while set — it outlives the schedule, because a
        # finished tail leaves the session paused at the raised precision.
        self.sched = None
        self._await_grid = None
        self._polish_waiting = False
        self._precision_override = None
        # Cold-start metric: seconds from the session's first `start`
        # command to its first iterate.
        self.first_iterate_s = None
        self._first_start_t = None

    # `ladder` / `polish` expose the schedule by phase (tests and the
    # measurement tools check these for None-ness; assigning None abandons
    # that phase — the pre-phases.Schedule API, kept stable).

    @property
    def ladder(self):
        s = self.sched
        return s if (s is not None and s.laddering) else None

    @ladder.setter
    def ladder(self, value):
        if value is not None:
            raise AttributeError('ladder is schedule-managed; only None '
                                 '(abandon) may be assigned')
        if self.sched is not None and self.sched.laddering:
            self.sched = None
        self._await_grid = None

    @property
    def polish(self):
        s = self.sched
        return s if (s is not None and s.polishing) else None

    @polish.setter
    def polish(self, value):
        if value is not None:
            raise AttributeError('polish is schedule-managed; only None '
                                 '(abandon) may be assigned')
        if self.sched is not None and self.sched.polishing:
            self.sched = None
        self._polish_waiting = False

    # -- config helpers -----------------------------------------------------

    def _max_size(self):
        return self.config.getint('max_size', 9999)

    def _snap(self, size):
        return snap_size(size, self.config.getint('size_snap', 0))

    def _snap_grid(self, hw):
        """Ties the session grid to the mesh: under spatial sharding every
        (H, W) the tier picks must divide by the mesh axis, or the
        placement degrades to replication exactly at high resolution where
        it matters."""
        if self.placement is None:
            return tuple(hw)
        return self.placement.snap_hw(hw)

    def _dispatch_config(self):
        """(adaptive_max_steps, pipeline_depth, steps_per_dispatch) from the
        config."""
        # adaptive_dispatch default: 60, the JAX app's. A config that
        # explicitly sets steps_per_dispatch but not adaptive_dispatch
        # predates the adaptive mode and keeps its static behavior
        # (adaptive would silently override it).
        adaptive_default = (0 if 'steps_per_dispatch' in self.config
                            and 'adaptive_dispatch' not in self.config
                            else 60)
        adaptive = self.config.getint('adaptive_dispatch', adaptive_default)
        # Static-dispatch configs (adaptive off) keep their documented
        # K-iteration control latency unless they opt into pipelining —
        # depth 2 would silently double the in-flight work to 2K.
        pipeline_default = 2 if adaptive > 1 else 1
        depth = self.config.getint('pipeline_depth', pipeline_default)
        spd = self.config.getint('steps_per_dispatch', 1)
        return adaptive, depth, spd

    # -- driver lifecycle -----------------------------------------------------

    def _spawn_driver(self):
        """Replaces the driver. The new one makes no device call until the
        old one's device thread is done (Driver's `after`)."""
        self.sess.running = False
        self.sess.worker_ready = False
        adaptive, depth, spd = self._dispatch_config()
        remat = self.config.get('remat', '')
        if remat not in ('', 'conv', 'block'):
            raise ValueError('config remat must be conv or block: %r'
                             % remat)
        self.driver = Driver(
            self.model_params,
            precision=(self._precision_override
                       or self.config.get('precision', 'float32')),
            device=self.config.get('device', 'cuda'),
            remat=remat or False,
            placement=self.placement,
            after=self.driver,
            steps_per_dispatch=spd,
            image_every=self.config.getint('image_every', 1),
            adaptive_max_steps=adaptive,
            pipeline_depth=depth,
            adaptive_latency_target=self.config.getfloat(
                'adaptive_latency_target', 0.0),
            dispatch_timeout=self.config.getfloat('dispatch_timeout', 0.0))
        self.driver_task = asyncio.ensure_future(self.driver.run())
        if self.pump_task is not None:
            self.pump_task.cancel()
        self.pump_task = asyncio.ensure_future(self._pump_driver())

    async def _supervise_driver(self):
        """Respawns the driver when its task finishes (crash or a
        user-requested restart), re-feeding state from the Session.
        Repeated crashes back off exponentially (to 30 s) so an
        unavailable device doesn't spin."""
        backoff = 0.1
        while True:
            task = self.driver_task
            if task is None or task.done():
                crashed = False
                if task is not None and not task.cancelled():
                    exc = task.exception()
                    if exc:
                        logger.error('driver task died: %r', exc)
                        crashed = True
                if crashed:
                    backoff = min(backoff * 2, 30.0)
                    await asyncio.sleep(backoff)
                else:
                    backoff = 0.1
                self._spawn_driver()
                # A fresh driver boots with the default optimizer; the
                # params document is authoritative (the startup-restore
                # path already did this — a mid-session respawn must too,
                # or a crash silently reverts an adam session to lbfgs).
                # Sent before the images so the reset it triggers lands
                # before SetImages seeds the iterate counter.
                await self._to_driver(m.SetOptimizer(
                    self.sess.params['optimizer'],
                    self.sess.params.get('optimizer_step_size')))
                self.sess.push_state()
                await self.feed_engine_state()
            await asyncio.sleep(0.1)

    async def _pump_driver(self):
        """Consumes the driver's output queue: iterate bookkeeping, the
        ready/bootstrap handshake, resets from the router."""
        held = None  # non-coalescable message drained ahead of its turn
        while True:
            if held is not None:
                msg, held = held, None
            else:
                msg = await self.driver.out_queue.get()
            if isinstance(msg, m.Iterate):
                # Fused dispatches emit one Iterate per step back to back;
                # coalesce the consecutive run so the rate estimator sees
                # one K-step batch, not K zero-interval arrivals. Drained
                # messages that break the run are held for the next loop
                # turn (asyncio.Queue has no public peek).
                batch = [msg]
                queue = self.driver.out_queue
                while not queue.empty():
                    nxt = queue.get_nowait()
                    if (not isinstance(nxt, m.Iterate)
                            or nxt.i != batch[-1].i + 1):
                        held = nxt
                        break
                    batch.append(nxt)
                image = next((b.image for b in reversed(batch)
                              if b.image is not None), None)
                self.sess.note_iterates(batch[-1].i, image,
                                        [b.trace for b in batch])
                if (self.first_iterate_s is None
                        and self._first_start_t is not None):
                    self.first_iterate_s = round(
                        time.monotonic() - self._first_start_t, 2)
                    logger.info('first iterate %.2fs after start',
                                self.first_iterate_s)
                if self.sess.norms is None:
                    await self._capture_norms()
                await self._phase_tick()
            elif isinstance(msg, m.WorkerReady):
                self.sess.worker_ready = True
                self.layers = msg.layers
                self.sess.push('workerReady')
                await self.router.register_once()
                await self._polish_on_ready()
            elif isinstance(msg, m.GetImages):
                # The driver lacks state (fresh spawn): re-send everything.
                await self.feed_engine_state()
            elif isinstance(msg, m.Reset):
                await self.reset_session()
            elif isinstance(msg, m.Shutdown):
                pass  # driver exiting; the supervisor respawns it
            else:
                logger.error('unknown driver message %r', msg)

    async def _to_driver(self, msg):
        await self.driver.in_queue.put(msg)

    async def _capture_norms(self):
        """Pulls the live engine's first-eval gradient-RMS norm state up
        into the Session as host floats — one tiny device transfer, once
        per reset epoch (norms never change between resets), so respawns
        and restarts can re-seed the SAME normalized objective instead of
        re-anchoring at the live iterate. Any failure just leaves the next
        respawn to re-anchor."""
        try:
            if self.driver is not None:
                self.sess.norms = await self.driver.norms_host()
        except Exception:
            logger.debug('norm capture failed', exc_info=True)

    async def feed_engine_state(self):
        """Sends the driver a complete state snapshot derived from the
        Session (the GetImages handshake, reference app.py:244-262)."""
        sess = self.sess
        content = utils.resize_to_fit(sess.content_image,
                                      sess.params['size'])
        style = utils.resize_to_fit(sess.style_image, int(sess.style_size))

        reset_state = False
        grid = self._snap_grid((content.size[1], content.size[0]))
        if grid != (content.size[1], content.size[0]):
            content = sess.content_image.resize(grid[::-1], Image.LANCZOS)
        if sess.input_arr is None:
            sess.input_arr = sn.fresh_random_input(grid)
            sess.input_was_reset = True
            reset_state = True
        elif sess.input_arr.shape[:2] != grid:
            # Warm-resample the iterate onto the content grid. The
            # reference compared only max-size (app.py:249-252), which
            # wedges the session when an aspect-changing content upload
            # lands while paused: input and content grids then disagree
            # forever and the worker loops on GetImages. Reconciling the
            # full grid heals it (the engine's pending-start fires once
            # the shapes agree).
            sess.input_arr = utils.resample_hwc(sess.input_arr, grid)
            sess.input_was_reset = False

        if reset_state:
            sess.norms = None
        await self._to_driver(m.SetImages(None, sess.input_arr,
                                          np.uint8(content), np.uint8(style),
                                          reset_state,
                                          t0=0 if reset_state else sess.i,
                                          norms=sess.norms))
        await self._to_driver(m.SetWeights(*sess.params['weights']))

    # -- multi-scale serving ladder ---------------------------------------------
    #
    # The CLI's coarse-to-fine schedule offered to serving users: a fresh
    # session whose params document carries `ladder: <iters-per-rung>`
    # (seeded from config `serve_ladder`) optimizes up the scales() ladder
    # to its requested size, each rung warm-start-resampled on device (the
    # driver accepts and ignores the JAX driver's m.Prewarm compile hint).
    # The reference's user-paced resize (app.py:187-201), automated.

    def _ladder_iters(self):
        try:
            return max(0, int(self.sess.params.get('ladder', 0) or 0))
        except (TypeError, ValueError):
            return 0

    def _ladder_target_hw(self):
        """The ladder's TARGET grid: the params document's requested size at
        the content image's aspect (NOT the current input grid — mid-ladder
        the input sits at a rung, and a reset must still climb back to what
        the user asked for)."""
        sess = self.sess
        try:
            size = self._snap(int(sess.params.get('size')))
        except (TypeError, ValueError):
            return (None if sess.input_arr is None
                    else tuple(sess.input_arr.shape[:2]))
        img = sess.content_image
        if img is None:
            return (None if sess.input_arr is None
                    else tuple(sess.input_arr.shape[:2]))
        return self._snap_grid(
            utils.fit_into_square((img.height, img.width), size, True))

    async def _maybe_begin_ladder(self, force=False):
        per_rung = self._ladder_iters()
        sess = self.sess
        if (not per_rung or self.sched is not None
                or (sess.i > 1 and not force) or sess.input_arr is None):
            return
        target_hw = self._ladder_target_hw()
        if target_hw is None:
            return
        min_scale = self.config.getint('ladder_min_scale', 96)
        rungs = []
        for hw in utils.scales(target_hw, min_size=min_scale):
            s = self._snap_grid(hw)
            if s not in rungs:
                rungs.append(s)
        if len(rungs) < 2:
            return
        polish_n = (self._polish_iters() if self._polish_applicable()
                    else 0)
        self.sched = phases.Schedule(rungs, per_rung, polish_n)
        logger.info('serving ladder: %s at %d iters/rung', rungs, per_rung)
        await self._run_action(self.sched.begin())

    async def _phase_tick(self):
        """Drives the shared schedule from the iterate stream. A rung's
        iteration budget starts counting when its GRID takes effect
        (_await_grid): under pipelined dispatch, iterates from chunks
        dispatched at the previous grid keep arriving after the advance,
        and counting those would burn the new rung's budget on old-grid
        work (they also make a reset's stale in-flight iterates harmless —
        the schedule won't move until rung 0's grid shows up). The polish
        budget anchors in _polish_on_ready instead (driver event, not an
        iterate observation)."""
        sched = self.sched
        sess = self.sess
        if sched is None:
            return
        if self._await_grid is not None:
            if (sess.input_arr is None
                    or tuple(sess.input_arr.shape[:2]) != self._await_grid):
                return   # still draining old-grid in-flight iterates
            self._await_grid = None
            sched.transition_done(sess.i)
            return
        if self._polish_waiting:
            return   # budget anchors when the polish driver reports ready
        was_laddering = sched.laddering
        if was_laddering:
            # Polish applicability is decided when the ladder completes
            # (the user may toggle the params' polish key mid-ladder).
            sched.polish_n = (self._polish_iters()
                              if self._polish_applicable() else 0)
        action = sched.tick(sess.i)
        if was_laddering and not sched.laddering:
            logger.info('serving ladder complete at %s',
                        tuple(sess.input_arr.shape[:2]))
        await self._run_action(action)

    async def _run_action(self, action):
        """Executes one schedule action with this tier's mechanics: a rung
        advance is a device-side grid change, a polish begin is a driver
        respawn at the raised precision, a pause ends the tail."""
        if action is None:
            if self.sched is not None and self.sched.phase == 'done':
                self.sched = None
            return
        if action[0] == 'advance':
            _, hw, is_final = action
            hw = tuple(hw)
            self._await_grid = hw
            logger.info('serving ladder: advancing to %s', hw)
            await self._change_grid(hw)
            if not is_final:
                nxt = self.sched.rungs[self.sched.idx + 1]
                await self._to_driver(m.Prewarm([nxt]))
        elif action[0] == 'polish':
            precision = self._polish_precision()
            self._precision_override = precision
            self._polish_waiting = True
            logger.info('polish: respawning engine at %s for %d iterations',
                        precision, action[1])
            await self.restart_engine()
        elif action[0] == 'pause':
            self.sched = None
            logger.info('polish complete at iterate %d; pausing',
                        self.sess.i)
            await self.pause()
            self.sess.running = False
            self.sess.push_state()

    async def _change_grid(self, hw):
        """Moves the session to an explicit (H, W) grid with a DEVICE-side
        warm-start resample of the iterate (and Adam moments) — the
        ladder's rung advance. User-driven scalar resizes go through
        change_size (host resample, reference parity)."""
        sess = self.sess
        content = np.uint8(sess.content_image.resize(hw[::-1], Image.LANCZOS))
        sess.its_per_s.clear()
        if sess.i <= 1:
            sess.input_arr = sn.fresh_random_input(hw)
            await self._to_driver(m.SetImages(hw, sess.input_arr, content))
        else:
            await self._to_driver(m.SetImages(hw, m.SetImages.RESAMPLE,
                                              content))
        sess.push('newSize', height=hw[0], width=hw[1])

    # -- polish phase -------------------------------------------------------------
    #
    # The CLI's --polish offered to serving users: when the coarse-to-fine
    # ladder completes, a session whose params document carries
    # `polish: <iters>` (seeded from config serve_polish) runs that many
    # FULL-PRECISION iterations warm-started from the bfloat16 result, then
    # pauses — buying back part of bf16's quality delta while the bulk of
    # the optimization kept bf16 speed. Mechanics: the driver respawns at
    # `polish_precision` (config, default float32) through the supervisor +
    # GetImages bootstrap (the float32 iterate warm-starts; the optimizer
    # re-primes, same as the CLI); the new driver's device work starts once
    # the old driver's device thread is done. Any user-driven state change
    # abandons the phase and returns to the main precision.

    def _polish_iters(self):
        try:
            return max(0, int(self.sess.params.get('polish', 0) or 0))
        except (TypeError, ValueError):
            return 0

    def _polish_precision(self):
        return self.config.get('polish_precision', 'float32')

    def _polish_applicable(self):
        """Polish must strictly RAISE precision (a float32 session
        'polished' at float32_fast would be a downgrade)."""
        main = self.config.get('precision', 'float32')
        polish = self._polish_precision()
        return (self._polish_iters() > 0
                and sn.PRECISION_RANK.get(polish, -1)
                > sn.PRECISION_RANK.get(main, 99))

    async def _polish_on_ready(self):
        """The polish driver came up: resume iterating and anchor the
        budget at the current counter (the respawn seeded t0=sess.i)."""
        if not self._polish_waiting or self.sched is None:
            return
        self._polish_waiting = False
        self.sched.transition_done(self.sess.i)
        await self._to_driver(m.StartIteration())
        self.sess.running = True
        self.sess.push_state()

    async def _respawn_driver(self):
        """Synchronous driver replacement (Shutdown -> spawn -> re-feed).
        Unlike restart_engine — which leaves the respawn to the
        supervisor's next tick — the caller's subsequent driver messages
        land on the NEW driver, so state changes queued right after
        (a reset's SetImages, a restarted ladder's rung-0 grid) aren't
        lost with the old one."""
        await self._to_driver(m.Shutdown())
        self._spawn_driver()
        await self._to_driver(m.SetOptimizer(
            self.sess.params['optimizer'],
            self.sess.params.get('optimizer_step_size')))
        self.sess.push_state()
        await self.feed_engine_state()

    async def _exit_polish(self):
        """A user-driven state change abandons any polish phase: back to
        the configured main precision. Callers invoke this FIRST, so their
        own driver messages follow the respawn onto the new driver."""
        self.polish = None   # property setter: drops a polishing schedule
        if self._precision_override is not None:
            self._precision_override = None
            await self._respawn_driver()

    # -- EngineActions (WS inbound commands) -----------------------------------

    async def start(self):
        if self._first_start_t is None:
            self._first_start_t = time.monotonic()
        await self._maybe_begin_ladder()
        await self._to_driver(m.StartIteration())

    async def pause(self):
        await self._to_driver(m.PauseIteration())

    async def reset_input(self):
        await self._exit_polish()
        sess = self.sess
        image = sn.fresh_random_input(sess.input_arr.shape[:2])
        sess.input_arr = image
        sess.input_was_reset = True
        sess.norms = None   # the reset re-anchors the norms
        await self._to_driver(m.SetImages(input_image=image,
                                          reset_state=True))
        # A reset restarts the coarse-to-fine schedule from rung 0 toward
        # the params-requested size (force bypasses the fresh-session
        # check; the await_grid gate makes stale in-flight iterates from
        # before the reset harmless to the restarted schedule).
        self.ladder = None
        await self._maybe_begin_ladder(force=True)

    async def restart_engine(self):
        self.sess.running = False
        self.sess.push_state()
        await self._to_driver(m.Shutdown())

    async def change_size(self, size):
        sess = self.sess
        size = self._snap(size)
        if size == max(sess.input_arr.shape):
            return size
        # A user-driven resize overrides the automated schedule.
        self.ladder = None
        await self._exit_polish()
        hw = self._snap_grid(
            utils.fit_into_square(sess.input_arr.shape[:2], size, True))
        content = np.uint8(sess.content_image.resize(hw[::-1], Image.LANCZOS))
        sess.its_per_s.clear()
        if sess.i <= 1:
            sess.input_arr = sn.fresh_random_input(hw)
        else:
            sess.input_arr = utils.resample_hwc(sess.input_arr, hw)
        await self._to_driver(m.SetImages(hw, sess.input_arr, content))
        sess.push('newSize', height=hw[0], width=hw[1])
        return size

    async def set_optimizer(self, name, step_size):
        if name != self.sess.params.get('optimizer'):
            # An optimizer TYPE change resets the engine (reference
            # worker.py:387-391), clearing its norms — drop ours too so a
            # later respawn doesn't resurrect the pre-change anchoring.
            self.sess.norms = None
        await self._to_driver(m.SetOptimizer(name, step_size))

    async def set_weights(self, weights, scalars):
        old = self.sess.params.get('weights')
        if old is not None:
            try:
                changed = (ObjectiveSpec.from_weights(old[0], old[1])
                           != ObjectiveSpec.from_weights(weights, scalars))
            except Exception:
                changed = True
            if changed:
                # A structure change anchors NEW norm keys mid-epoch at
                # the live iterate, so the earlier capture no longer
                # matches the engine. Drop it: the next iterate
                # re-CAPTURES the engine's full norm state (old keys keep
                # their original anchors — this is not a re-anchoring).
                self.sess.norms = None
        await self._to_driver(m.SetWeights(weights, scalars))

    async def reset_session(self):
        """Full session reset (the router's Reset)."""
        await self.pause()
        self.ladder = None
        # Exit any polish WITHOUT _exit_polish's re-feed: the state it
        # would feed is discarded by load_defaults below, and this path
        # does its own feed — one Shutdown + spawn suffices (the fresh
        # driver boots the default optimizer, which load_defaults also
        # restores in the params document).
        self.polish = None
        if self._precision_override is not None:
            self._precision_override = None
            await self._to_driver(m.Shutdown())
            self._spawn_driver()
        self.sess.running = False
        self.sess.load_defaults(self.config, ROOT_DIR)
        self.sess.input_arr = None
        await self.feed_engine_state()
        self.sess.push_state()
        # A reset must not be undone by a crash restoring the pre-reset
        # snapshot: persist the defaults state immediately.
        self._maybe_persist()

    # -- session persistence -----------------------------------------------------

    def _phase_state(self):
        """The tier-level schedule state that should survive a process
        restart, as a YAML-able dict: the active ladder (with the current
        rung's REMAINING budget), the active polish tail (ditto), and the
        precision override — which outlives the polish dict, because a
        finished tail leaves the session paused at the raised precision."""
        state = {}
        sched = self.sched
        if sched is not None:
            state.update(sched.state(self.sess.i,
                                     awaiting=self._await_grid))
            if 'polish' in state:
                # Whether the tail should self-resume on restore: a crash
                # inside the respawn window persists running=False (the
                # respawn transiently clears it) even though the tail was
                # about to auto-run.
                state['polish']['auto'] = bool(self._polish_waiting
                                               or self.sess.running)
        if self._precision_override is not None:
            state['precision_override'] = self._precision_override
        return state

    def _restore_phase(self, extras):
        """Re-establishes persisted schedule state (see _phase_state) from
        a snapshot's extra entries. Runs BEFORE _spawn_driver so a restored
        precision override redirects the boot spawn; grid/prewarm re-issue
        happens later in _resume_phase (the driver must exist first). Any
        malformed phase blob restores nothing — the session itself already
        loaded fine, and a lost schedule is the old (pre-persistence)
        behavior, not an error."""
        blob = extras.get('app_phase_yaml')
        if blob is None:
            return {}
        try:
            phase = yaml.safe_load(str(blob)) or {}
            override = phase.get('precision_override')
            if override is not None:
                if override not in sn.PRECISION_RANK:
                    raise ValueError(f'unknown precision {override!r}')
                self._precision_override = override
            pol = phase.get('polish')
            if pol is not None and override is not None:
                remaining = max(1, int(pol['remaining']))
                # polish_n = remaining, so a re-persist before the anchor
                # lands still records the REMAINING budget, not a fresh n.
                self.sched = phases.Schedule.restore_polish(pol, remaining)
                if pol.get('auto', self.sess.running):
                    # Tail was iterating (or mid-respawn): re-anchor and
                    # resume via _polish_on_ready when the polish driver
                    # comes up.
                    self._polish_waiting = True
                else:
                    # User-paused mid-tail: anchor now and keep it dormant;
                    # a later start finishes the remaining budget and
                    # self-pauses.
                    self.sched.transition_done(self.sess.i)
            lad = phase.get('ladder')
            if lad is not None and self.sched is None:
                polish_n = (self._polish_iters()
                            if self._polish_applicable() else 0)
                self.sched = phases.Schedule.restore_ladder(lad, polish_n)
                # Re-affirm the restored rung's grid: the await-grid clear
                # (the restored iterate is already on this rung's grid)
                # re-anchors to the snapshot's REMAINING budget via the
                # schedule's budget override, not a fresh per_rung.
                self._await_grid = tuple(self.sched.current_rung)
            if self.sched is not None or override is not None:
                logger.info(
                    'restored schedule state: phase=%s rung=%s '
                    'precision_override=%s',
                    self.sched.phase if self.sched else None,
                    self.sched.current_rung if self.sched else None,
                    self._precision_override)
            return phase
        except Exception:
            logger.warning('unreadable phase state in snapshot; schedule '
                           'not restored', exc_info=True)
            self.sched = None
            self._await_grid = None
            self._polish_waiting = False
            self._precision_override = None
            return {}

    async def _resume_phase(self):
        """Post-boot schedule re-issue (driver up, engine state fed): a
        mid-advance ladder re-sends its pending grid change, and the
        restored rung's successor goes out as an m.Prewarm like a live
        advance's."""
        sched = self.sched
        if sched is None or not sched.laddering:
            return
        hw = self._await_grid
        if (hw and self.sess.input_arr is not None
                and tuple(self.sess.input_arr.shape[:2]) != tuple(hw)):
            # The snapshot caught an advance in flight: the persisted
            # iterate is still on the previous rung's grid.
            await self._change_grid(tuple(hw))
        if sched.idx + 1 < len(sched.rungs):
            await self._to_driver(m.Prewarm([sched.rungs[sched.idx + 1]]))

    def _maybe_persist(self):
        """Snapshots the session if anything observable changed since the
        last write (persist.signature covers every saved field; the phase
        state is folded into the signature so schedule transitions that
        don't move a session field — e.g. polish begin during a respawn —
        still trigger a write)."""
        if not self.persist_path:
            return
        phase = self._phase_state()
        phase_yaml = yaml.safe_dump(phase) if phase else ''
        sig = (persist.signature(self.sess), phase_yaml)
        if sig == self._persist_sig:
            return
        extra = ({'app_phase_yaml': np.str_(phase_yaml)}
                 if phase_yaml else None)
        try:
            persist.save_session(self.persist_path, self.sess, extra=extra)
            self._persist_sig = sig
        except OSError as err:
            logger.warning('session persist failed: %s', err)

    async def _persist_loop(self):
        interval = self.config.getfloat('persist_interval', 30.0)
        while True:
            await asyncio.sleep(interval)
            self._maybe_persist()

    # -- per-slot upload policy --------------------------------------------------

    async def accept_upload(self, post_msg):
        slot, image, size = sn.decode_upload(post_msg)
        sess = self.sess
        if slot == 'input':
            arr = np.uint8(image.resize(sess.input_arr.shape[:2][::-1],
                                        Image.LANCZOS))
            sess.input_arr = arr
            await self._to_driver(m.SetImages(input_image=arr))
        elif slot == 'style':
            arr = np.uint8(utils.resize_to_fit(image, int(size)))
            sess.style_size = size
            sess.set_slot_image('style', image)
            await self._to_driver(m.SetImages(style_image=arr))
            sess.push('thumbnails', style=sess.thumbnail('style'))
        elif slot == 'content':
            self.ladder = None   # new content grid overrides the schedule
            await self._exit_polish()
            arr = np.uint8(utils.resize_to_fit(image, self._snap(size)))
            hw = self._snap_grid(arr.shape[:2])
            if hw != arr.shape[:2]:
                arr = np.uint8(image.resize(hw[::-1], Image.LANCZOS))
            if sess.i <= 1:
                input_image = sn.fresh_random_input(hw)
                sess.input_arr = input_image
            else:
                input_image = m.SetImages.RESAMPLE
            sess.its_per_s.clear()
            sess.set_slot_image('content', image)
            await self._to_driver(m.SetImages(hw, input_image, arr))
            sess.push('newSize', height=hw[0], width=hw[1])
            sess.params['size'] = int(max(hw))
            sess.push_params()
            sess.push('thumbnails', content=sess.thumbnail('content'))
        else:
            raise web.HTTPBadRequest(reason='unknown slot')

    # -- HTTP handlers ---------------------------------------------------------------

    async def handle_index(self, request):
        top = ''
        top_path = self.config.get('top', '')
        if top_path and Path(top_path).exists():
            top = open(top_path).read()
        return render('index.html', {
            'max_size': self._max_size(),
            'ga_tracking_code': self.config.get('ga_tracking_code', ''),
            'top': top,
        })

    async def handle_output(self, request):
        buf = io.BytesIO()
        utils.as_pil(self.sess.input_arr).save(buf, format='png')
        return web.Response(content_type='image/png', body=buf.getvalue(),
                            headers={'Cache-Control': 'no-cache'})

    async def handle_upload(self, request):
        await self.accept_upload(await request.post())
        return web.Response()

    async def handle_stats(self, request):
        return render('stats.html', {
            'sessions': 1, 'instances': 1,
            'timestamp': time.asctime(time.gmtime()),
            'loadavg': os.getloadavg(),
            'devices': device_name(self.config),
            'first_iterate_s': self.first_iterate_s,
            'ga_tracking_code': self.config.get('ga_tracking_code', '')})

    async def handle_websocket(self, request):
        return await sn.pump_websocket(request, self.sess, self,
                                       lambda: self.layers,
                                       self._max_size())

    async def handle_control_reset(self, request):
        """POST /__control/reset — the router's Reset message as HTTP/JSON
        (replaces the reference's router->app ZMQ socket). Token- or
        loopback-gated: an open reset endpoint lets any client wipe the
        user's session when http_host binds beyond loopback."""
        sn.check_control_auth(request, self.config)
        await self.reset_session()
        return web.json_response({'ok': True})

    # -- lifecycle ----------------------------------------------------------------------

    async def on_startup(self, app):
        # No fallback: without CUDA the default device fails here, before
        # anything is served.
        device = self.config.get('device', 'cuda')
        resolve_device(device)
        mesh_spec = self.config.get('mesh', '')
        if mesh_spec:
            from ..parallel import SpatialPlacement, make_mesh
            self.placement = SpatialPlacement(
                make_mesh(mesh_spec, axis_names=('space',), device=device))
            logger.info('spatial sharding over %d devices; session grids '
                        'snap to multiples of %d',
                        self.placement.n_shards, self.placement.n_shards)
        for key in IGNORED_KEYS:
            if self.config.get(key, ''):
                logger.info('config key %s = %s has no meaning in the '
                            'port; ignored', key, self.config[key])
        self.model_params = resolve_params(
            self.config.get('weights', 'auto'), ROOT_DIR)
        self.sess.load_defaults(self.config, ROOT_DIR)
        extras = {}
        restored = (self.persist_path
                    and persist.load_session(self.persist_path, self.sess,
                                             extras))
        resume = restored and self.sess.running
        if restored:
            self._restore_phase(extras)
            phase = self._phase_state()
            self._persist_sig = (persist.signature(self.sess),
                                 yaml.safe_dump(phase) if phase else '')
        self._spawn_driver()   # forces running=False until resume below
        if restored:
            # A fresh engine boots with the default optimizer; the restored
            # params document is authoritative. Sent before the images so
            # the reset it triggers lands before SetImages seeds the
            # restored iterate counter (t0).
            await self._to_driver(m.SetOptimizer(
                self.sess.params['optimizer'],
                self.sess.params.get('optimizer_step_size')))
        await self.feed_engine_state()
        if restored:
            await self._resume_phase()
        if resume:
            # The process died (or was redeployed) mid-optimization:
            # resume where the snapshot left off. Costs only optimizer
            # momentum — the worker-restart contract, extended across
            # full process restarts.
            await self.start()
            self.sess.running = True
        self.tasks.append(asyncio.ensure_future(self._supervise_driver()))
        if self.persist_path:
            self.tasks.append(asyncio.ensure_future(self._persist_loop()))
        if self.router.configured:
            self.tasks.append(asyncio.ensure_future(self.router.heartbeat()))

    async def on_cleanup(self, app):
        self._maybe_persist()
        await self.router.unregister()
        for task in self.tasks:
            task.cancel()
        if self.pump_task is not None:
            self.pump_task.cancel()
        await self._to_driver(m.Shutdown())
        if self.driver_task is not None:
            try:
                await asyncio.wait_for(self.driver_task, timeout=5)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self.driver_task.cancel()


def init(args=None, config=None):
    if config is None:
        config = utils.read_config(args)
    debug_level = utils.debug_level(args, config)
    tier = SingleSessionTier(config, debug_level)

    template_vars = {'ga_tracking_code': config.get('ga_tracking_code', '')}
    app = web.Application(middlewares=[error_pages(template_vars)],
                          client_max_size=64 * 1024 ** 2)
    app['config'] = config
    app['debug_level'] = debug_level
    app['tier'] = tier

    app.router.add_route('GET', '/', tier.handle_index)
    app.router.add_route('GET', '/output', tier.handle_output)
    app.router.add_route('POST', '/upload', tier.handle_upload)
    app.router.add_route('GET', '/websocket', tier.handle_websocket)
    app.router.add_route('GET', '/stats', tier.handle_stats)
    app.router.add_route('POST', '/__control/reset',
                         tier.handle_control_reset)
    add_static_routes(app)

    app.on_startup.append(tier.on_startup)
    app.on_cleanup.append(tier.on_cleanup)
    return app


def main():
    """The main function."""
    utils.setup_exceptions()
    utils.setup_signals()
    args = utils.parse_args(__doc__)
    app = init(args)
    utils.setup_logging(app['debug_level'])

    try:
        web.run_app(app, host=app['config']['http_host'],
                    port=int(app['config']['http_port']),
                    shutdown_timeout=1)
    except KeyboardInterrupt:
        pass
    finally:
        logger.info('Shutting down app.')


if __name__ == '__main__':
    main()
