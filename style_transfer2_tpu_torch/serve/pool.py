#!/usr/bin/env python3
"""Pooled multi-session serving tier: many users on ONE device
(style_transfer2_tpu/serve/pool.py, on the port's batched engine).

The reference scales to N users with N (app + worker) OS-process pairs
behind the router — one whole device per user (router.py:73-83). This
tier collapses that design ("sessions -> batch lanes"): a single aiohttp
app hosts many cookie-identified sessions, each mapped to a lane of a
BatchedStyleTransfer bucket; one batched step advances every running
session per dispatch, so concurrent users share the card instead of
queueing for it.

Buckets are keyed by resolution and precision: sessions of one bucket
share its (H, W), objective structure, and optimizer. A user size change
migrates the session to the target bucket with WARM-STARTED state — the
iterate and optimizer moments resample exactly like the reference's
mid-run resize (optimizers.py:29-40) — so the pool supports the
reference's resolution-change flow. Buckets are created lazily (bounded by
the pool_sizes config) and dropped when they empty. Objective-structure
and optimizer changes remain bucket-fixed and are rejected with a readable
error (run the single-session app for fully heterogeneous sessions).

Protocol and session logic are shared with the single-session tier via
serve/session.py; this module supplies the lane mapping, the batched
stepping task, bucket migration, and session expiry. Every device call —
bucket creation, lane work, the session restore at startup — runs on the
tier's one executor thread (grad mode and the current CUDA stream are per
thread).

Config keys beyond the JAX pool's: `device` ('cuda', the default, raises
at startup without CUDA; 'cpu' runs the kernels' plain versions). The
port compiles nothing per shape, so there is no bucket prewarm:
`pool_prewarm`, like the single-session app's ignored keys, is logged once
and ignored, and so is `remat` (the batched engines have no remat, in the
JAX pool too). `pool_mesh` splits every bucket's lanes over that many
devices (parallel/batch.py DataPlacement; pool_lanes must divide by it),
and `pool_bucket_devices` ('256:0-5; 512:6-7', ranges or comma lists of
device indices) gives each listed bucket size a sub-mesh of its own,
unlisted sizes the pool_mesh placement, as in the JAX pool. On 'cuda' the
indices are the cards', and too few cards fail at startup; on 'cpu' each
index is an entry of the CPU (one process standing in for the devices).

    python -m style_transfer2_tpu_torch.serve.pool [config.ini] [-d]
"""

import asyncio
import concurrent.futures
import functools
import io
import logging
import os
import time
from pathlib import Path

from aiohttp import web
import numpy as np
from PIL import Image
import yaml

from .. import utils
from ..engine.batched import batched_engine
from ..engine.objective import ObjectiveSpec
from ..engine.transfer import resolve_device
from ..models import vgg19
from ..models.weights import resolve_params
from ..optim import OPTIMIZERS
from . import persist
from . import phases
from . import session as sn
from .app import IGNORED_KEYS as APP_IGNORED_KEYS, device_name
from .driver import DeviceTimeoutError, run_with_watchdog
from .error_pages import error_pages
from .render import add_static_routes, render

ROOT_DIR = Path(__file__).resolve().parents[2]

logger = logging.getLogger('pool')

SESSION_COOKIE = 'pool_session'

# Config keys of the JAX pool with no meaning in the port, beside the
# single-session app's: logged once at startup and ignored. remat among
# them: the pool's batched engines have none, in the JAX pool too.
IGNORED_KEYS = ('pool_prewarm', 'remat') + APP_IGNORED_KEYS


class PoolSession(sn.Session):
    """A Session bound to one batch lane of one resolution bucket, with
    idle-expiry bookkeeping."""

    def __init__(self, session_id, lane, bucket_hw, precision):
        super().__init__()
        self.session_id = session_id
        self.lane = lane
        self.bucket_hw = bucket_hw
        self.precision = precision   # bucket identity = (bucket_hw, precision)
        self.last_access = time.monotonic()
        self.last_image_fetch = 0.0
        # The automated schedule (phases.Schedule: ladder -> polish ->
        # pause) driven by PooledTier._phase_tick, or None.
        self.sched = None

    # `ladder` / `polish` expose the schedule by phase (tests check these
    # for None-ness; assigning None abandons that phase — the
    # pre-phases.Schedule API, kept stable).

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

    def touch(self):
        self.last_access = time.monotonic()


class LaneActions(sn.EngineActions):
    """EngineActions for one pooled session: commands map to masked lane
    operations on its bucket's batched engine."""

    def __init__(self, tier, sess):
        self.tier = tier
        self.sess = sess

    @property
    def engine(self):
        return self.tier.engine_of(self.sess)

    async def start(self):
        if self.tier._first_start_t is None:
            self.tier._first_start_t = time.monotonic()
        await self.tier.maybe_begin_ladder(self.sess)
        # Through the tick lock: toggling running DURING a dispatch makes
        # the post-dispatch accounting emit iterates for a lane that was
        # masked out of it (or drop steps that did apply).
        await self.tier.engine_op(self.engine.set_running,
                                  self.sess.lane, True)
        self.tier.wake.set()

    async def pause(self):
        await self.tier.engine_op(self.engine.set_running,
                                  self.sess.lane, False)

    async def reset_input(self):
        self.sess.ladder = None   # a reset restarts the schedule
        self.sess.polish = None   # abandon any full-precision tail
        await self.tier.engine_op(self.tier.requeue, self.sess,
                                  reset_input=True)
        # The iterate counter restarts at 1, so a configured ladder
        # re-begins from its smallest rung — whose migration also exits a
        # polish bucket (bucket_for's default precision). Without a
        # ladder the reset re-optimizes in place, polish bucket included.
        await self.tier.maybe_begin_ladder(self.sess)

    async def restart_engine(self):
        # There is no per-session worker to restart; rebuilding the lane
        # around the LIVE iterate is the equivalent. The reference's
        # restart costs only optimizer momentum — the app re-feeds the
        # current image to the fresh worker (app.py:336-344,
        # worker.py:399-401) — so the iterate and counter must survive
        # here too; the state echo keeps the UI honest.
        await self.tier.engine_op(self.tier.requeue, self.sess,
                                  keep_progress=True)
        self.sess.push_state()

    async def change_size(self, size):
        size = int(size)
        if (size == max(self.sess.bucket_hw)
                and self.sess.precision == self.tier.main_precision()):
            return size
        # A user-driven resize overrides the automated schedules; the
        # default-precision migration also exits a polish bucket (even at
        # the same size — the not-equal check above lets that through).
        self.sess.ladder = None
        self.sess.polish = None
        await self.tier.migrate_session(self.sess, size)
        return size

    async def set_optimizer(self, name, step_size):
        if name != self.engine.optimizer_name:
            raise ValueError(
                "This pooled instance runs the '%s' optimizer for all "
                'sessions.' % self.engine.optimizer_name)
        await self.tier.engine_op(self.engine.set_step_size,
                                  self.sess.lane, float(step_size))

    async def set_weights(self, weights, scalars):
        if ObjectiveSpec.from_weights(weights, scalars) != self.engine.spec:
            raise ValueError(
                'This pooled instance serves a fixed objective structure '
                '(which layers carry which losses); weight values may '
                'change, structure may not.')
        await self.tier.engine_op(self.engine.set_lane_weights,
                                  self.sess.lane, weights, scalars)


class PooledTier:
    """The pool: resolution buckets of BatchedStyleTransfer lanes plus a
    cookie->(bucket, lane) session table."""

    def __init__(self, config, debug_level=0):
        self.config = config
        self.debug_level = debug_level
        self.engines = {}    # (bucket hw, precision) -> BatchedStyleTransfer
        self.default_hw = None
        self.base_hw = None          # aspect prototype for hw_for()
        self.model_params = None
        # The pool_mesh DataPlacement of every bucket not listed in
        # pool_bucket_devices (on_startup), or None.
        self.placement = None
        self.weights_doc = None
        self.layers = []
        self.sessions = {}
        self.wake = None
        self.tick_lock = None
        # Serializes lane ALLOCATION (free_lane -> claim) on the event
        # loop: engine methods running in the executor release the GIL at
        # torch calls, so allocation must never happen there.
        self.lane_lock = None
        self.executor = None
        self.tasks = []
        self.instance_id = os.urandom(8).hex()
        self.router = None
        # Set when a device call exceeds pool_dispatch_timeout: the device
        # is wedged. Stepping stops, router heartbeats stop (so
        # the LB expires this instance and routes new users elsewhere), and
        # /stats shows it — instead of a zombie instance that still answers
        # HTTP but never iterates.
        self.wedged = False
        # Session persistence (pool_persist_dir): one snapshot file per
        # cookie session, restored at boot — a pooled redeploy keeps every
        # user's iterate at the cost of optimizer momentum.
        self.persist_dir = config.get('pool_persist_dir', '')
        self._persist_sigs = {}
        # Cold-start metric: seconds from the instance's first `start`
        # command to the first fan-out iterate.
        self.first_iterate_s = None
        self._first_start_t = None

    # -- buckets ------------------------------------------------------------

    def hw_for(self, size):
        """The bucket grid for a requested size: the initial content's
        aspect scaled so max(H, W) == size (every lane of one bucket must
        share (H, W) exactly)."""
        return utils.fit_into_square(self.base_hw, int(size), scale_up=True)

    def allowed_sizes(self):
        """Sizes buckets may exist at: the pool_sizes config list, or any
        size up to max_size when unset (each size is a bucket of its own,
        with its own lanes and model copy, so production configs pin the
        list)."""
        raw = self.config.get('pool_sizes', '')
        if not raw:
            return None
        return sorted({int(s) for s in raw.replace(',', ' ').split()})

    def check_size_allowed(self, size):
        allowed = self.allowed_sizes()
        if allowed is not None and size not in allowed:
            raise sn.SizeRejected(
                'This pooled instance serves these resolutions: %s.'
                % ', '.join(str(s) for s in allowed))
        if size > self.config.getint('max_size', 9999):
            raise sn.SizeRejected(
                'Size is over %d' % self.config.getint('max_size', 9999))

    def bucket_placement(self, size):
        """The placement of a bucket at `size`: a DataPlacement over the
        devices pool_bucket_devices lists for it ('256:0-5; 512:6-7': each
        listed size its own sub-mesh), else the pool-wide pool_mesh
        placement (None: one device)."""
        from ..parallel import DataPlacement, Mesh
        from ..parallel.mesh import available_devices
        spec = self.config.get('pool_bucket_devices', '')
        for part in spec.split(';'):
            size_s, _, devs = part.strip().partition(':')
            if not size_s or int(size_s) != int(size):
                continue
            idxs = []
            for tok in devs.replace(',', ' ').split():
                if '-' in tok:
                    a, b = tok.split('-')
                    idxs.extend(range(int(a), int(b) + 1))
                else:
                    idxs.append(int(tok))
            devices = available_devices(self.config.get('device', 'cuda'),
                                        max(idxs) + 1)
            if max(idxs) >= len(devices):
                raise ValueError('pool_bucket_devices %s: device %d of %d'
                                 % (part.strip(), max(idxs), len(devices)))
            return DataPlacement(Mesh([devices[i] for i in idxs],
                                      ('data',)))
        return self.placement

    def main_precision(self):
        return self.config.get('precision', 'float32')

    def bucket_for(self, size, precision=None):
        """The engine serving `size` at `precision` (default: the tier's
        configured precision), created lazily. Buckets are keyed by
        (grid, precision): the polish tail puts sessions in a
        full-precision bucket at the SAME grid as their bfloat16 one.
        Device work (the bucket's model and lane state): call it on the
        executor thread."""
        precision = precision or self.main_precision()
        hw = self.hw_for(size)
        key = (hw, precision)
        if key not in self.engines:
            self.engines[key] = batched_engine(
                self.model_params, self.weights_doc[0], self.weights_doc[1],
                hw, max_lanes=self.config.getint('pool_lanes', 4),
                placement=self.bucket_placement(size),
                optimizer=self.config.get('pool_optimizer', 'adam'),
                precision=precision,
                device=self.config.get('device', 'cuda'))
            logger.info('created bucket %s at %s', hw, precision)
        return self.engines[key]

    def engine_of(self, sess):
        return self.engines[(sess.bucket_hw, sess.precision)]

    async def _device_call(self, fn, *args, **kwargs):
        """One executor-thread device call under the shared watchdog
        (driver.run_with_watchdog): exceeding pool_dispatch_timeout marks
        the tier wedged and raises. Size the timeout WELL above the
        slowest device call, a new bucket's first dispatch included; 0
        (default) disables."""
        loop = asyncio.get_event_loop()
        fut = loop.run_in_executor(self.executor,
                                   functools.partial(fn, *args, **kwargs))
        timeout = self.config.getfloat('pool_dispatch_timeout', 0.0)
        try:
            return await run_with_watchdog(fut, timeout,
                                           getattr(fn, '__name__', fn))
        except DeviceTimeoutError:
            self.wedged = True
            logger.critical(
                'device watchdog tripped — the pooled tier stops stepping '
                'and router heartbeats cease')
            raise

    def _check_not_wedged(self):
        """Fail fast once the watchdog has tripped: new device work would
        queue behind the stuck call on the single executor thread and hang
        a full pool_dispatch_timeout each before failing."""
        if self.wedged:
            raise web.HTTPServiceUnavailable(
                text='Style Transfer device backend is unavailable; this '
                     'instance is draining.')

    async def migrate_session(self, sess, size, precision=None):
        """Moves a session to the bucket serving `size` (at `precision`,
        default the tier's main — the polish tail passes the raised one)
        with warm-started state (the tier-level body of a size change;
        LaneActions and the pooled ladder both route here). Lane
        allocation happens on the event loop under lane_lock (atomic vs
        lookup()); the bucket may need creating first — that is device
        work, so it runs on the executor while we hold the lock (brief,
        rare: once per new resolution)."""
        self.check_size_allowed(size)
        async with self.lane_lock:
            engine = await self.engine_op(self.bucket_for, size, precision)
            new_lane = engine.free_lane()
            if new_lane is None:
                raise sn.SizeRejected(
                    'No capacity at %d px right now; try again later.'
                    % size)
            engine.active[new_lane] = True
        try:
            await self.engine_op(self.migrate, sess, size, new_lane,
                                 precision)
        except Exception:
            engine.active[new_lane] = False  # un-claim; session intact
            raise
        if self.engine_of(sess).running[sess.lane]:
            self.wake.set()
        h, w = sess.bucket_hw
        sess.push('newSize', height=h, width=w)

    # -- pooled multi-scale ladder --------------------------------------------
    #
    # The serving ladder (serve/app.py) for pooled sessions: rungs are the
    # instance's ALLOWED sizes at or below the session's size, and a rung
    # advance is a warm-started bucket migration.

    def ladder_rungs(self, sess):
        per_rung = 0
        try:
            per_rung = max(0, int(sess.params.get('ladder', 0) or 0))
        except (TypeError, ValueError):
            pass
        if not per_rung:
            return 0, []
        allowed = self.allowed_sizes() or []
        target = max(sess.bucket_hw)
        rungs = [s for s in allowed if s <= target]
        if not rungs or rungs[-1] != target:
            rungs.append(target)
        return per_rung, rungs

    async def maybe_begin_ladder(self, sess):
        """Activates the ladder for a FRESH session (iterate <= 1): migrate
        down to the smallest allowed rung, then climb via _phase_tick."""
        if sess.sched is not None:
            return
        per_rung, rungs = self.ladder_rungs(sess)
        if len(rungs) < 2 or self.engine_of(sess).t[sess.lane] > 1:
            return
        polish_n = (self._polish_iters(sess)
                    if self._polish_applicable(sess) else 0)
        sched = sess.sched = phases.Schedule(rungs, per_rung, polish_n)
        logger.info('pooled ladder for %s: %s at %d iters/rung',
                    sess.session_id, rungs, per_rung)
        action = sched.begin()   # ('advance', rungs[0], is_final)
        try:
            await self.migrate_session(sess, action[1])
        except Exception:
            sched.transition_failed(sess.i)
            raise
        sched.transition_done(sess.i)

    def _phase_tick(self, sess):
        """Called from the drive fan-out (under tick_lock): drives the
        shared schedule and runs its actions with this tier's mechanics —
        a rung advance is a warm bucket migration, a polish begin a
        cross-precision migration, a pause a lane stop. Each action runs
        as its OWN task: migrate_session/engine_op take the tick lock
        themselves, so they must run after this tick releases it."""
        sched = sess.sched
        if sched is None:
            return
        if sched.laddering:
            # Polish applicability is decided when the ladder completes
            # (the user may toggle the params' polish key mid-ladder).
            sched.polish_n = (self._polish_iters(sess)
                              if self._polish_applicable(sess) else 0)
        was_laddering = sched.laddering
        action = sched.tick(sess.i)
        if was_laddering and not sched.laddering:
            logger.info('pooled ladder for %s complete at %s',
                        sess.session_id, sess.bucket_hw)
        if action is None:
            if sched.phase == 'done' and sess.sched is sched:
                sess.sched = None
            return
        if action[0] == 'advance':
            self._advance_rung(sess, sched, action[1])
        elif action[0] == 'polish':
            self._begin_polish(sess, sched, action[1])
        elif action[0] == 'pause':
            self._end_polish(sess, sched)

    def _advance_rung(self, sess, sched, size):
        async def go():
            try:
                await self.migrate_session(sess, size)
            except Exception:
                # Transient failures (e.g. the target bucket momentarily
                # full while another session migrates through) RETRY after
                # another rung-budget's worth of iterations; only repeated
                # failure cancels the schedule.
                if sched.transition_failed(sess.i):
                    logger.info('pooled ladder migration to %d failed '
                                '(attempt %d); will retry', size,
                                sched.retries)
                else:
                    logger.warning('pooled ladder migration to %d failed '
                                   '%d times; schedule cancelled', size,
                                   sched.retries, exc_info=True)
                    if sess.sched is sched:
                        sess.sched = None
                return
            sched.transition_done(sess.i)

        asyncio.ensure_future(go())

    # -- pooled polish tail -----------------------------------------------------
    #
    # The single-session tier's polish (serve/app.py) for pooled sessions:
    # when the pooled ladder completes, a session with `polish: N` in its
    # params migrates to a bucket at the SAME grid but the raised
    # polish_precision (iterate carried, optimizer re-primed — the
    # cross-precision migrate), runs N iterations there, and pauses. Any
    # later size change or ladder restart migrates through bucket_for's
    # default precision, which is the exit.

    def _polish_iters(self, sess):
        try:
            return max(0, int(sess.params.get('polish', 0) or 0))
        except (TypeError, ValueError):
            return 0

    def _polish_precision(self):
        return self.config.get('polish_precision', 'float32')

    def _polish_applicable(self, sess):
        return (self._polish_iters(sess) > 0
                and sn.PRECISION_RANK.get(self._polish_precision(), -1)
                > sn.PRECISION_RANK.get(self.main_precision(), 99))

    def _begin_polish(self, sess, sched, n):
        """Runs the schedule's polish action: the cross-precision
        migration, as its own task, like a rung advance."""
        precision = self._polish_precision()
        size = max(sess.bucket_hw)
        logger.info('pooled polish for %s: migrating to %s for %d '
                    'iterations', sess.session_id, precision, n)

        async def go():
            if sess.sched is not sched:
                return   # user action cancelled it before we started
            try:
                await self.migrate_session(sess, size, precision=precision)
            except Exception:
                if sess.sched is sched:
                    sess.sched = None
                logger.warning('pooled polish migration for %s failed; '
                               'tail skipped', sess.session_id,
                               exc_info=True)
                return
            if sess.sched is not sched:
                # A user action (size change, reset) landed while we
                # migrated and our move clobbered it: undo — back to the
                # main precision at the current grid, so the session is
                # never stranded at the raised precision with no active
                # tail. (If the user's own migration ran after ours the
                # session is already back at the main precision — skip.)
                if sess.precision != self.main_precision():
                    try:
                        await self.migrate_session(sess,
                                                   max(sess.bucket_hw))
                    except Exception:
                        logger.warning('pooled polish cancel-revert for '
                                       '%s failed', sess.session_id,
                                       exc_info=True)
                return
            sched.transition_done(sess.i)
        asyncio.ensure_future(go())

    def _end_polish(self, sess, sched):
        """Runs the schedule's pause action: the tail's budget is spent —
        pause the lane (its own task; the tick holds tick_lock)."""
        if sess.sched is sched:
            sess.sched = None
        # The session's binding NOW: a migration racing in before our
        # engine_op acquires the tick lock re-binds the session (and may
        # hand this lane to someone else) — the pause must then not fire.
        expected = (sess.bucket_hw, sess.precision, sess.lane)

        def pause_if_unmoved():
            if (sess.bucket_hw, sess.precision, sess.lane) != expected:
                return False
            self.engine_of(sess).set_running(sess.lane, False)
            return True

        async def go():
            try:
                paused = await self.engine_op(pause_if_unmoved)
            except Exception:
                logger.warning('pooled polish pause for %s failed',
                               sess.session_id, exc_info=True)
                return
            if not paused:
                logger.info('pooled polish pause for %s skipped: session '
                            'migrated meanwhile', sess.session_id)
                return
            sess.running = False
            sess.push_state()
            logger.info('pooled polish complete for %s at iterate %d; '
                        'paused', sess.session_id, sess.i)
        asyncio.ensure_future(go())

    async def engine_op(self, fn, *args, **kwargs):
        """Runs an engine/session mutation atomically with respect to the
        stepping task: the tick lock excludes an in-flight dispatch+fan-out
        (whose completion writes engine state back and whose fan-out reads
        session bindings), and the single executor thread keeps all device
        work serialized."""
        self._check_not_wedged()
        async with self.tick_lock:
            return await self._device_call(fn, *args, **kwargs)

    def _drop_empty_buckets(self):
        default_key = (self.default_hw, self.main_precision())
        for key, engine in list(self.engines.items()):
            if key != default_key and not any(engine.active):
                del self.engines[key]
                logger.info('dropped empty bucket %s at %s', *key)

    # -- session table --------------------------------------------------------

    async def lookup(self, request, create=True):
        sid = request.cookies.get(SESSION_COOKIE)
        if sid and sid in self.sessions:
            sess = self.sessions[sid]
            sess.touch()
            return sess, False
        if not create:
            raise web.HTTPForbidden()
        # Existing sessions above still read host state (e.g. /output's
        # last snapshot) while wedged; CREATING one needs device work.
        self._check_not_wedged()
        async with self.lane_lock:
            engine = self.engines[(self.default_hw, self.main_precision())]
            lane = engine.free_lane()
            if lane is None:
                raise web.HTTPServiceUnavailable()
            sid = os.urandom(8).hex()
            sess = PoolSession(sid, lane, self.default_hw,
                               self.main_precision())
            engine.active[lane] = True   # claim before yielding (running
            self.sessions[sid] = sess    # stays False until start)
        try:
            await self.engine_op(self.seed_session, sess)
        except Exception:
            # No half-initialized session may survive: it would crash
            # greet() and /output and hold the lane until idle expiry.
            engine.active[lane] = False
            self.sessions.pop(sid, None)
            raise
        logger.info('new session %s on lane %d', sid, lane)
        return sess, True

    def seed_session(self, sess):
        """Seeds a fresh session with the configured demo job, paused."""
        engine = self.engine_of(sess)
        # Fresh-session defaults throughout: add_job below resets the lane's
        # engine step size to the optimizer default, so the params doc must
        # NOT echo the previous occupant's leftover value.
        sess.load_defaults(self.config, ROOT_DIR,
                           optimizer=engine.optimizer_name)
        sess.params['size'] = max(sess.bucket_hw)
        sess.params['weights'] = [dict(engine.default_weights),
                                  dict(engine.default_scalars)]
        sess.input_arr = sn.fresh_random_input(sess.bucket_hw)
        engine.add_job(self._fit(sess.content_image, sess.bucket_hw),
                       self._fit(sess.style_image, sess.bucket_hw),
                       sess.input_arr, lane=sess.lane)
        engine.set_running(sess.lane, False)

    def release(self, sess):
        self.engine_of(sess).remove_job(sess.lane)
        self.sessions.pop(sess.session_id, None)
        self._drop_persisted(sess.session_id)
        logger.info('released session %s (lane %d)',
                    sess.session_id, sess.lane)

    # -- session persistence -----------------------------------------------

    def _persist_file(self, sid):
        return Path(self.persist_dir) / (sid + '.npz')

    def _drop_persisted(self, sid):
        self._persist_sigs.pop(sid, None)
        if self.persist_dir:
            try:
                self._persist_file(sid).unlink(missing_ok=True)
            except OSError:
                pass

    def _phase_state(self, sess):
        """The session's schedule state (pooled ladder / polish tail) as a
        YAML-able dict for the snapshot. An advance or migration caught in
        flight is recorded as NOT yet taken (the persisted bucket is the
        pre-move one), with a zero/full budget so the restore re-attempts
        the move on its first tick."""
        state = {}
        sched = sess.sched
        if sched is None:
            return state
        if sched.laddering:
            idx, remaining = sched.idx, sched.remaining(sess.i)
            if sched.in_transition:
                idx, remaining = max(0, idx - 1), 0
            state['ladder'] = {'rungs': [int(s) for s in sched.rungs],
                               'idx': int(idx),
                               'per_rung': int(sched.per_rung),
                               'remaining': int(remaining or 0)}
        if sched.polishing:
            if sched.in_transition or sched.next_at is None:
                state['polish'] = {'pending': True}
            else:
                state['polish'] = {
                    'pending': False,
                    'remaining': max(1, int(sched.next_at) - sess.i)}
        return state

    def _restore_phase(self, sess, phase_yaml):
        """Re-establishes a restored session's schedule state. The session
        is already bound to its persisted (grid, precision) bucket, so an
        active polish tail just needs its budget re-anchored; a tail whose
        migration never landed (pending, or precision inconsistently still
        the main one) re-begins from scratch. A malformed blob restores no
        schedule — the pre-persistence behavior, not an error."""
        if not phase_yaml:
            return
        try:
            phase = yaml.safe_load(phase_yaml) or {}
            pol = phase.get('polish')
            if pol is not None:
                if (not pol.get('pending')
                        and sess.precision != self.main_precision()):
                    # polish_n = remaining, so a re-persist before the
                    # anchor lands still records the REMAINING budget.
                    remaining = max(1, int(pol['remaining']))
                    sess.sched = phases.Schedule.restore_polish(pol,
                                                                remaining)
                    sess.sched.transition_done(sess.i)
                else:
                    self._restart_polish(sess)
                return   # polish only begins after the ladder: exclusive
            lad = phase.get('ladder')
            if lad is not None:
                polish_n = (self._polish_iters(sess)
                            if self._polish_applicable(sess) else 0)
                sess.sched = phases.Schedule.restore_ladder(lad, polish_n)
                # The session is already bound to its persisted bucket:
                # affirm the rung so the budget re-anchors immediately (a
                # mid-migration snapshot recorded idx-1/remaining 0, so
                # the next tick re-attempts the move).
                sess.sched.transition_done(sess.i)
        except Exception:
            logger.warning('session %s: unreadable phase state; schedule '
                           'not restored', sess.session_id, exc_info=True)
            sess.sched = None

    def _restart_polish(self, sess):
        """Re-begins a polish tail whose migration never landed (the
        snapshot caught it pending, or the persisted precision is
        inconsistently still the main one): from scratch, like a live
        ladder completion would."""
        if not self._polish_applicable(sess) or sess.sched is not None:
            return
        sched = sess.sched = phases.Schedule([], 0,
                                             self._polish_iters(sess))
        action = sched.begin()
        if action is not None:
            self._begin_polish(sess, sched, action[1])

    def _persist_all(self):
        """Snapshots every changed session (host state only — no device
        work, so this is safe even while wedged)."""
        if not self.persist_dir:
            return
        try:
            Path(self.persist_dir).mkdir(parents=True, exist_ok=True)
        except OSError as err:
            logger.warning('pool persist dir unavailable: %s', err)
            return
        for sid, sess in list(self.sessions.items()):
            phase = self._phase_state(sess)
            phase_yaml = yaml.safe_dump(phase) if phase else ''
            sig = (persist.signature(sess), sess.precision, phase_yaml)
            if self._persist_sigs.get(sid) == sig:
                continue
            extra = {'pool_bucket_hw': np.asarray(sess.bucket_hw, np.int64),
                     'pool_precision': np.str_(sess.precision)}
            if phase_yaml:
                extra['pool_phase_yaml'] = np.str_(phase_yaml)
            try:
                persist.save_session(self._persist_file(sid), sess,
                                     extra=extra)
                self._persist_sigs[sid] = sig
            except OSError as err:
                logger.warning('session %s persist failed: %s', sid, err)

    async def _persist_loop(self):
        interval = self.config.getfloat('persist_interval', 30.0)
        while True:
            await asyncio.sleep(interval)
            self._persist_all()

    async def _restore_sessions(self):
        """Rebuilds persisted sessions at boot: each snapshot claims a lane
        in its bucket (re-created as needed) and re-feeds the engine from
        host state, so the returning browser's cookie lands on its old
        session with only optimizer momentum lost. Runs before the serving
        tasks start, so no lookup() can race a restore; the bucket and the
        lane's device work run on the executor thread, the lane claim and
        the schedule on the event loop. Capacity shrinks, corrupt files,
        and disallowed sizes skip the session (logged), never abort boot."""
        paths = sorted(Path(self.persist_dir).glob('*.npz'))
        for path in paths:
            sid = path.stem
            try:
                with np.load(str(path), allow_pickle=False) as data:
                    hw = tuple(int(x) for x in data['pool_bucket_hw'])
                    precision = (str(data['pool_precision'])
                                 if 'pool_precision' in data else '')
                    phase_yaml = (str(data['pool_phase_yaml'])
                                  if 'pool_phase_yaml' in data else '')
            except Exception as err:
                logger.warning('%s: unreadable pool snapshot (%r)',
                               path, err)
                continue
            if precision not in sn.PRECISION_RANK:
                # Pre-precision snapshots (or junk): the main bucket.
                precision = self.main_precision()
            size = max(hw)
            try:
                self.check_size_allowed(size)
            except sn.SizeRejected as err:
                logger.warning('skipping session %s: %s', sid, err)
                continue
            engine = await self._device_call(self.bucket_for, size,
                                             precision=precision)
            lane = engine.free_lane()
            if lane is None:
                logger.warning('skipping session %s: bucket %s is full',
                               sid, engine.hw)
                continue
            sess = PoolSession(sid, lane, engine.hw, precision)
            if not persist.load_session(path, sess):
                continue
            if (sess.input_arr is None
                    or sess.content_image is None
                    or sess.style_image is None):
                logger.warning('skipping session %s: incomplete snapshot',
                               sid)
                continue
            if sess.input_arr.shape[:2] != engine.hw:
                # The bucket grid moved (config/base-image change since the
                # snapshot): warm-resample the iterate onto it.
                sess.input_arr = utils.resample_hwc(sess.input_arr,
                                                    engine.hw)
            sess.params['size'] = max(engine.hw)
            sess.params['optimizer'] = engine.optimizer_name  # bucket-fixed
            engine.active[lane] = True
            self.sessions[sid] = sess

            def readd(engine=engine, sess=sess, lane=lane):
                engine.add_job(self._fit(sess.content_image, engine.hw),
                               self._fit(sess.style_image, engine.hw),
                               np.float32(sess.input_arr), lane=lane,
                               weights=sess.params['weights'][0],
                               scalar_params=sess.params['weights'][1],
                               step_size=sess.params.get(
                                   'optimizer_step_size'),
                               t=sess.i, norms=sess.norms)
                engine.set_running(lane, sess.running)
            try:
                await self._device_call(readd)
            except Exception:
                engine.active[lane] = False
                self.sessions.pop(sid, None)
                logger.warning('session %s restore failed', sid,
                               exc_info=True)
                continue
            self._restore_phase(sess, phase_yaml)
            phase = self._phase_state(sess)
            self._persist_sigs[sid] = (persist.signature(sess),
                                       sess.precision,
                                       yaml.safe_dump(phase)
                                       if phase else '')
            logger.info('restored session %s (lane %d, iterate %d, '
                        'running=%s, precision=%s)', sid, lane, sess.i,
                        sess.running, sess.precision)
        if self.sessions:
            self.wake.set()

    @staticmethod
    def _fit(pil_image, hw):
        """Squashes an original onto a bucket grid."""
        return np.uint8(pil_image.resize(hw[::-1], Image.LANCZOS))

    def requeue(self, sess, content=None, style=None, input_arr=None,
                keep_progress=False, reset_input=False):
        """Re-adds the session's job to its lane with updated slots; images
        default to the current session originals.

        keep_progress preserves the ON-DEVICE iterate, the iterate counter,
        and the reference's objective_changed optimizer semantics (Adam
        keeps its second moment, L-BFGS clears and re-primes) — the
        behavior a style/content upload must have (the single-session tier
        sends SetImages without reset; reference worker.py re-extracts
        features around the live iterate). Without it the lane re-seeds
        from a fresh random input (the 'reset' action)."""
        engine = self.engine_of(sess)
        hw = sess.bucket_hw
        was_running = engine.running[sess.lane]
        if content is None:
            content = self._fit(sess.content_image, hw)
        if style is None:
            style = self._fit(sess.style_image, hw)
        lane_state = None
        norms = None
        t = 0
        if (keep_progress or input_arr is not None) and not reset_input:
            # Warm paths: a content/style upload re-extracts features
            # around the live iterate (keep_progress), and an explicit
            # input upload REPLACES the iterate but — like reference
            # set_input on a same-shape image (worker.py:191-195) — keeps
            # the counter, the first-eval norms, and the optimizer through
            # objective_changed (Adam keeps its second moment, L-BFGS
            # clears and re-primes). Only a reset re-anchors the norms.
            # lane_state() returns views into the stacked state, and
            # add_job below writes them back into the SAME lane: a copy
            # onto itself, so the live iterate and moments survive.
            mod = OPTIMIZERS[engine.optimizer_name]
            lane_state = mod.objective_changed(engine.lane_state(sess.lane))
            if input_arr is not None:
                # add_job takes the iterate from lane_state, so the upload
                # replaces it there (cast to the bucket's iterate dtype).
                lane_state = dict(lane_state,
                                  x=vgg19.preprocess(
                                      input_arr, engine.device).to(
                                      lane_state['x'].dtype))
            norms = engine.lane_norms(sess.lane)
            t = sess.i
        elif input_arr is None:
            input_arr = sn.fresh_random_input(hw)
            sess.input_arr = input_arr
            sess.input_was_reset = True
            sess.norms = None   # the reset re-anchors the norms
        weights, scalars = sess.params['weights']
        # No remove_job first: add_job(lane=...) overwrites the lane
        # completely, and transiently marking it inactive opens a window
        # (torch calls release the GIL) where lookup()'s free_lane() on the
        # event loop could hand the lane to a new session.
        engine.add_job(content, style, input_arr, weights=weights,
                       scalar_params=scalars,
                       step_size=sess.params.get('optimizer_step_size'),
                       lane=sess.lane, lane_state=lane_state, t=t,
                       norms=norms)
        sess.i = t
        engine.set_running(sess.lane, was_running)

    def migrate(self, sess, size, new_lane, precision=None):
        """Moves a session to the bucket serving `size` with warm-started
        state: the iterate and optimizer moments resample to the new grid
        (reference optimizers.py:29-40); a session still at iterate <= 1
        re-seeds cold from a fresh random input (reference app.py:187-194).
        A CROSS-PRECISION move (the polish tail, or its exit) carries the
        iterate but not the optimizer state — the moments' dtypes belong
        to the old bucket's program, so the optimizer re-primes at the new
        precision, same as the single-session tier's polish respawn.
        `new_lane` must already be CLAIMED by the caller on the event loop
        (LaneActions.change_size under lane_lock) — allocation in this
        executor-thread context would race lookup()."""
        precision = precision or self.main_precision()
        old_engine = self.engine_of(sess)
        new_engine = self.bucket_for(size, precision)
        new_hw = self.hw_for(size)

        was_running = old_engine.running[sess.lane]
        weights, scalars = sess.params['weights']
        step_size = sess.params.get('optimizer_step_size')
        content = self._fit(sess.content_image, new_hw)
        style = self._fit(sess.style_image, new_hw)

        lane_state = None
        norms = None
        t = 0
        if sess.i > 1:
            if precision == sess.precision:
                # lane_state() returns views into the old bucket's stacked
                # state: resample reads them here, before remove_job and
                # _drop_empty_buckets below (which may delete that bucket).
                mod = OPTIMIZERS[old_engine.optimizer_name]
                lane_state = mod.resample(old_engine.lane_state(sess.lane),
                                          new_hw)
                lane_state = mod.objective_changed(lane_state)
            # Norms carry across EVERY warm move — size changes (ladder
            # rung climbs) and cross-precision moves (the polish tail)
            # alike: they are f32 scalars independent of grid and compute
            # dtype, and the session must keep optimizing the objective
            # its norms were anchored at (re-anchoring at a converged
            # iterate inflates the per-layer weights).
            norms = old_engine.lane_norms(sess.lane)
            t = sess.i
            sess.input_arr = utils.resample_hwc(sess.input_arr, new_hw)
        else:
            sess.input_arr = sn.fresh_random_input(new_hw)
            sess.input_was_reset = True
            sess.norms = None   # cold re-seed re-anchors the norms

        # A failure above or here propagates to change_size, which
        # un-claims new_lane; the session stays intact on its old lane.
        new_engine.add_job(content, style, sess.input_arr, weights=weights,
                           scalar_params=scalars, step_size=step_size,
                           lane=new_lane, lane_state=lane_state, t=t,
                           norms=norms)
        # Only after the new lane is fully populated: free the old one.
        old_engine.remove_job(sess.lane)
        new_engine.set_running(new_lane, was_running)
        sess.lane = new_lane
        sess.bucket_hw = new_hw
        sess.precision = precision
        sess.its_per_s.clear()
        self._drop_empty_buckets()
        logger.info('migrated session %s to bucket %s at %s lane %d '
                    '(warm=%s)', sess.session_id, new_hw, precision,
                    new_lane, lane_state is not None)

    # -- the batched stepping task ------------------------------------------

    async def drive(self):
        """Steps every running lane of every bucket — one batched dispatch
        per bucket per tick (K fused steps when pool_steps_per_dispatch >
        1) — then fans the iterate bookkeeping out to the sessions. The
        image snapshots once per tick; each fused step still gets its own
        iterateInfo trace."""
        k = self.config.getint('pool_steps_per_dispatch', 1)
        # Iterate snapshots only matter to the browser's 4 Hz /output poll
        # (iterateInfo frames carry no image), so fetching every lane every
        # tick wastes a deprocess and a device-to-host copy (which waits
        # for the card) per lane per tick. Throttle per session; a
        # session's FIRST batch and any pending reset always fetch (the
        # input_was_reset guard needs an image-bearing frame to clear).
        image_interval = self.config.getfloat('pool_image_interval', 0.25)
        try:
            while True:
                busy_engines = [e for e in self.engines.values()
                                if e.any_running()]
                if not busy_engines:
                    self.wake.clear()
                    await self.wake.wait()
                    continue
                # One tick = begin EVERY busy bucket, then collect + fan
                # out — atomic vs. engine_op mutations (a migration
                # interleaved here would re-bind the session while we hand
                # it this bucket's results). Beginning all dispatches before
                # the first collect queues every bucket's step on the card
                # before the host waits for the first.
                async with self.tick_lock:
                    # Engine IDENTITY keys the fan-out: a polish bucket
                    # shares its grid with the main bucket, so (hw, lane)
                    # would alias across them.
                    by_key = {}
                    for s in self.sessions.values():
                        eng = self.engines.get((s.bucket_hw, s.precision))
                        if eng is not None:
                            by_key[(id(eng), s.lane)] = s
                    handles = []
                    for engine in busy_engines:
                        handle = await self._device_call(
                            engine.begin_steps_all, k)
                        if handle is not None:
                            handles.append((engine, handle))
                    for engine, handle in handles:
                        lane_traces = await self._device_call(
                            engine.collect_steps_all, handle)
                        for lane, traces in lane_traces.items():
                            sess = by_key.get((id(engine), lane))
                            if sess is None:
                                continue
                            now = time.monotonic()
                            fetch = (sess.input_was_reset
                                     or engine.t[lane] <= len(traces)
                                     or now - sess.last_image_fetch
                                     >= image_interval)
                            image = None
                            if fetch:
                                image = await self._device_call(
                                    engine.lane_image, lane)
                                sess.last_image_fetch = now
                            sess.note_iterates(engine.t[lane], image, traces)
                            if (self.first_iterate_s is None
                                    and self._first_start_t is not None):
                                self.first_iterate_s = round(
                                    time.monotonic() - self._first_start_t,
                                    2)
                                logger.info('first iterate %.2fs after '
                                            'start', self.first_iterate_s)
                            self._phase_tick(sess)
                        missing = [
                            lane for lane in lane_traces
                            if (s := by_key.get((id(engine), lane)))
                            is not None and s.norms is None]
                        if missing:
                            await self._capture_norms(engine, by_key)
                await asyncio.sleep(0)
        except DeviceTimeoutError:
            logger.critical('drive loop stopped by the device watchdog')

    async def _capture_norms(self, engine, by_key):
        """Captures first-eval gradient-RMS norms (host floats) for this
        bucket's sessions that lack them: one bulk device transfer, once
        per session reset epoch (norms never change between resets), so
        persistence can snapshot them and a restore re-seeds the SAME
        normalized objective instead of re-anchoring at the live iterate.
        Called from the drive fan-out under tick_lock — right after a
        collect, when the device is demonstrably alive (the persist loop
        itself stays device-free by contract)."""
        try:
            keys, vals, set_ = await self._device_call(engine.norms_host)
        except Exception:
            logger.debug('norm capture failed', exc_info=True)
            return
        for lane in range(engine.max_lanes):
            sess = by_key.get((id(engine), lane))
            if sess is None or sess.norms is not None:
                continue
            if not set_[:, lane].any():
                continue   # lane hasn't evaluated yet
            sess.norms = (
                {k: float(vals[i, lane]) for i, k in enumerate(keys)},
                {k: bool(set_[i, lane]) for i, k in enumerate(keys)})

    async def expire_idle(self):
        timeout = self.config.getint('pool_session_timeout', 300)
        while True:
            now = time.monotonic()
            if not self.wedged:  # releasing a lane is device work
                for sess in list(self.sessions.values()):
                    if not sess.sockets and sess.last_access < now - timeout:
                        await self.engine_op(self.release, sess)
                await self.engine_op(self._drop_empty_buckets)
            await asyncio.sleep(5)

    # -- HTTP handlers ----------------------------------------------------------

    async def handle_index(self, request):
        sess, created = await self.lookup(request)
        resp = render('index.html', {
            'max_size': self.config.getint('max_size', 9999),
            'ga_tracking_code': self.config.get('ga_tracking_code', ''),
            'top': '',
        })
        if created:
            resp.set_cookie(SESSION_COOKIE, sess.session_id)
        return resp

    async def handle_output(self, request):
        sess, _ = await self.lookup(request, create=False)
        buf = io.BytesIO()
        utils.as_pil(sess.input_arr).save(buf, format='png')
        return web.Response(content_type='image/png', body=buf.getvalue(),
                            headers={'Cache-Control': 'no-cache'})

    async def handle_upload(self, request):
        sess, _ = await self.lookup(request, create=False)
        slot, image, _size = sn.decode_upload(await request.post())
        arr = self._fit(image, sess.bucket_hw)
        if slot == 'content':
            # Progress is kept: the reference re-extracts content features
            # around the live iterate (the bucket grid is fixed, so no
            # input resample is needed, unlike the single-session tier).
            sess.set_slot_image('content', image)
            sess.its_per_s.clear()
            await self.engine_op(self.requeue, sess, content=arr,
                                 keep_progress=True)
            sess.push('thumbnails', content=sess.thumbnail('content'))
        elif slot == 'style':
            sess.set_slot_image('style', image)
            await self.engine_op(self.requeue, sess, style=arr,
                                 keep_progress=True)
            sess.push('thumbnails', style=sess.thumbnail('style'))
        elif slot == 'input':
            sess.input_arr = arr
            await self.engine_op(self.requeue, sess, input_arr=arr)
        else:
            raise web.HTTPBadRequest(reason='unknown slot')
        return web.Response()

    async def handle_websocket(self, request):
        sess, _ = await self.lookup(request, create=False)
        sess.touch()
        return await sn.pump_websocket(request, sess,
                                       LaneActions(self, sess),
                                       lambda: self.layers,
                                       self.config.getint('max_size', 9999))

    async def handle_stats(self, request):
        # Lanes in use vs capacity are SEPARATE numbers (the reference's
        # /stats reports sessions vs instances, router.py:57-63).
        return render('stats.html', {
            'lanes_in_use': sum(bool(a) for e in self.engines.values()
                                for a in e.active),
            'capacity': sum(e.max_lanes for e in self.engines.values()),
            'sessions': len(self.sessions),
            'health': 'WEDGED (device watchdog)' if self.wedged else 'ok',
            'first_iterate_s': self.first_iterate_s,
            'timestamp': time.asctime(time.gmtime()),
            'loadavg': os.getloadavg(),
            'devices': device_name(self.config),
            'ga_tracking_code': self.config.get('ga_tracking_code', '')})

    # -- lifecycle ------------------------------------------------------------------

    async def on_startup(self, app):
        config = self.config
        # No fallback: without CUDA the default device fails here, before
        # anything is served.
        device = config.get('device', 'cuda')
        resolve_device(device)
        mesh_spec = config.get('pool_mesh', '')
        if mesh_spec:
            from ..parallel import DataPlacement, make_mesh
            self.placement = DataPlacement(
                make_mesh(mesh_spec, axis_names=('data',), device=device))
        for key in IGNORED_KEYS:
            if config.get(key, ''):
                logger.info('config key %s = %s has no meaning in the '
                            'port; ignored', key, config[key])
        size = config.getint('initial_size', 300)
        content = Image.open(
            str(ROOT_DIR / config['initial_content'])).convert('RGB')
        self.base_hw = (content.size[1], content.size[0])
        self.default_hw = self.hw_for(size)

        with open(str(ROOT_DIR / config['initial_weights'])) as f:
            self.weights_doc = yaml.safe_load(f)

        self.model_params = resolve_params(config.get('weights', 'auto'),
                                           ROOT_DIR)
        # The one device thread, before the first device call: the default
        # bucket is built on it too.
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='pool-driver')
        default_engine = await self._device_call(self.bucket_for, size)
        self.layers = list(vgg19.BLOB_NAMES)
        self.wake = asyncio.Event()
        self.tick_lock = asyncio.Lock()
        self.lane_lock = asyncio.Lock()
        if self.persist_dir:
            # Before the serving tasks start: no lookup() can race a
            # restore, and returning cookies land on their old sessions.
            await self._restore_sessions()
            self.tasks.append(asyncio.ensure_future(self._persist_loop()))
        self.tasks.append(asyncio.ensure_future(self.drive()))
        self.tasks.append(asyncio.ensure_future(self.expire_idle()))
        self.router = sn.RouterLink(
            config, self.instance_id,
            host=config.get('pool_host', config['http_host']),
            port=config.get('pool_port', config['http_port']),
            capacity=default_engine.max_lanes)
        self.router.enabled_check = lambda: not self.wedged
        if self.router.configured:
            self.tasks.append(asyncio.ensure_future(self.router.heartbeat()))

    async def on_cleanup(self, app):
        """Persists the sessions, then lets go of every engine. The tasks
        are cancelled AND awaited, so that no suspended frame of drive()
        or _device_call() keeps the tier; the executor finishes its
        running call (unless the watchdog found the card wedged) and drops
        its queued ones, so that its thread holds no engine; and the
        engine and session tables are emptied, so that the buckets (on the
        card: their step graphs' memory pools) go now, whoever still holds
        the tier or its app."""
        self._persist_all()
        if self.router is not None:
            await self.router.unregister()
        for task in self.tasks:
            task.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        self.tasks = []
        if self.executor is not None:
            self.executor.shutdown(wait=not self.wedged,
                                   cancel_futures=True)
        self.sessions.clear()
        self.engines.clear()


def init(args=None, config=None):
    if config is None:
        config = utils.read_config(args)
    debug_level = utils.debug_level(args, config)
    tier = PooledTier(config, debug_level)

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
        web.run_app(app, host=app['config'].get('pool_host',
                                                app['config']['http_host']),
                    port=int(app['config'].get('pool_port',
                                               app['config']['http_port'])),
                    shutdown_timeout=1)
    except KeyboardInterrupt:
        pass
    finally:
        logger.info('Shutting down pool app.')


if __name__ == '__main__':
    main()
