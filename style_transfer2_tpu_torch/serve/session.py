"""Shared session layer for the interactive serving tiers: a copy of
style_transfer2_tpu/serve/session.py on top of the port's utils.

Both serving tiers — the single-session app (serve/app.py, one user on a
dedicated engine) and the pooled app (serve/pool.py, many users as lanes of
one batched engine) — speak the same browser protocol: the reference's
HTTP routes and WS JSON message types (reference app.py:61-290 is the
behavior spec). This module holds everything that protocol implies about a
session, independent of which engine backs it:

  * `Session` — per-user host state (images, params document, iterate
    bookkeeping, connected sockets) with the iterate-rate EWMA, RMS
    step-size, and input_was_reset race-guard logic.
  * `EngineActions` — the small command surface a session needs from its
    engine tier; each tier implements it (driver queues vs. batch lanes).
  * `pump_websocket` — the WS greeting + inbound dispatch loop.
  * `apply_params_document` — the applyParams pipeline. Side effects apply
    PROGRESSIVELY (size, then optimizer, then weights) exactly like the
    reference (app.py:177-228): an invalid layer name still leaves an
    earlier size change applied, and the user-facing error strings match.
  * `RouterLink` — registration heartbeat against the HTTP/JSON router.

The tiers themselves keep only engine wiring and per-slot upload policy.
"""

import asyncio
import binascii
import io
import json
import logging
import time

import aiohttp
from aiohttp import web
import numpy as np
from PIL import Image
import yaml

from .. import utils

logger = logging.getLogger('session')

LOSS_GROUPS = ('content', 'style', 'deepdream')
SCALAR_KEYS = ('tv', 'tv_power', 'p', 'p_power')

THUMBNAIL_SIZE = 300
HEARTBEAT_SECONDS = 5


class SizeRejected(ValueError):
    """A requested resolution change this tier cannot honor."""


# -- Control-plane authentication ------------------------------------------
#
# The reference's router<->app control channel was unauthenticated ZMQ; this
# rebuild's is HTTP/JSON, which any network client could hit when the
# services bind beyond loopback (config.ini documents http_host = 0.0.0.0).
# Policy: if `control_token` is set in config, every control request must
# carry it in X-Control-Token; if unset, control endpoints only accept
# loopback peers.

CONTROL_TOKEN_HEADER = 'X-Control-Token'
_LOOPBACK_PEERS = ('127.0.0.1', '::1', 'localhost')


def control_headers(config):
    """Headers a control-plane client (heartbeat, reset delivery) attaches."""
    token = config.get('control_token', '') if config is not None else ''
    return {CONTROL_TOKEN_HEADER: token} if token else {}


def check_control_auth(request, config):
    """Gate for control-plane handlers; raises 403 on policy violation."""
    token = config.get('control_token', '') if config is not None else ''
    if token:
        if request.headers.get(CONTROL_TOKEN_HEADER) != token:
            raise web.HTTPForbidden(reason='bad or missing control token')
        return
    if request.remote is not None and request.remote not in _LOOPBACK_PEERS:
        raise web.HTTPForbidden(
            reason='control plane is loopback-only unless control_token '
                   'is configured')


# The precision ladder, ordered by fidelity: the polish machinery only ever
# moves a session UP this ranking (a float32 session "polished" at
# float32_fast would be a downgrade).
PRECISION_RANK = utils.PRECISION_RANK


class Session:
    """Host-side state of one interactive user session.

    The engine below it is rebuildable at any time (a respawned driver or a
    re-added lane); everything a browser can observe lives here.
    """

    def __init__(self):
        self.sockets = []
        self.running = False
        self.worker_ready = True   # single-session tier toggles this
        self.input_arr = None
        self.input_was_reset = False
        self.i = 0
        self.last_it_time = 0.0
        self.its_per_s = utils.DecayingMean()
        self.params = {}
        self.content_image = None
        self.style_image = None
        self.style_size = None
        # First-eval gradient-RMS norm state, captured from the live
        # engine (a (vals, set) dict pair of host floats/bools) so
        # respawns and restarts re-seed the SAME normalized objective.
        # Write-once per reset epoch: norms only change when the engine
        # resets, and every reset path clears this to None.
        self.norms = None
        self._thumbs = {}

    # -- outbound fan-out ---------------------------------------------------

    def push(self, msg_type, **fields):
        """Broadcasts one JSON payload to every connected socket,
        tolerating disconnect races (fire-and-forget per socket)."""
        fields['type'] = msg_type
        data = json.dumps(fields)
        for ws in list(self.sockets):
            self._send_soon(ws, data)

    @staticmethod
    def _send_soon(ws, data):
        async def _go():
            try:
                await ws.send_str(data)
            except (RuntimeError, ConnectionError, asyncio.CancelledError):
                pass
        asyncio.ensure_future(_go())

    def push_state(self):
        self.push('state', running=self.running)

    def push_params(self, error_string=None):
        if error_string is None:
            self.push('newParams', params=self.params_yaml())
        else:
            self.push('newParams', params=self.params_yaml(),
                      errorString=error_string)

    def params_yaml(self):
        return yaml.safe_dump(self.params)

    # -- images & thumbnails --------------------------------------------------

    def set_slot_image(self, slot, pil_image):
        """Stores a content/style PIL original and drops its stale
        thumbnail."""
        setattr(self, slot + '_image', pil_image)
        self._thumbs.pop(slot, None)

    def thumbnail(self, slot):
        """Base64 JPEG data URL for a slot's original, cached until the
        image changes."""
        if slot not in self._thumbs:
            image = getattr(self, slot + '_image')
            small = utils.resize_to_fit(image, THUMBNAIL_SIZE, scale_up=False)
            buf = io.BytesIO()
            small.save(buf, format='jpeg', quality=85)
            self._thumbs[slot] = ('data:image/jpeg;base64,'
                                  + binascii.b2a_base64(buf.getvalue())
                                  .decode())
        return self._thumbs[slot]

    def load_defaults(self, config, root_dir, optimizer='lbfgs',
                      step_size=None):
        """Seeds the session from the config's demo job (reference
        app.py:231-241): example images plus the initial params document."""
        from . import messages as m
        self.set_slot_image('content', Image.open(
            str(root_dir / config['initial_content'])).convert('RGB'))
        self.set_slot_image('style', Image.open(
            str(root_dir / config['initial_style'])).convert('RGB'))
        size = config.getint('initial_size')
        if step_size is None:
            step_size = m.SetOptimizer.step_sizes[optimizer]
        with open(str(root_dir / config['initial_weights'])) as f:
            weights_doc = yaml.safe_load(f)
        self.params = {'size': size, 'optimizer': optimizer,
                       'optimizer_step_size': step_size,
                       'weights': weights_doc}
        # serve_ladder = N seeds the multi-scale serving schedule: fresh
        # sessions coarse-to-fine to their requested size, N iters/rung
        # (users toggle it per-session via the params document).
        ladder = config.getint('serve_ladder', 0)
        if ladder:
            self.params['ladder'] = ladder
        # serve_polish = N seeds the full-precision polish tail: when the
        # ladder completes, N iterations at config polish_precision refine
        # the bfloat16 result, then the session pauses.
        polish = config.getint('serve_polish', 0)
        if polish:
            self.params['polish'] = polish
        self.style_size = size

    # -- iterate bookkeeping ----------------------------------------------------

    def note_iterates(self, i_last, image, traces):
        """Records a batch of completed iterations ending at `i_last` (one
        per `traces` entry; the single-step tiers pass one) and pushes
        iterateInfo frames.

        Keeps the reference's observable semantics (app.py:265-290): the
        rate EWMA clears when the batch starts at iteration 1; the RMS
        step-size compares against the previous snapshot; a pending
        input_was_reset suppresses the frame unless this IS iteration 1
        (the iterate that must carry the post-reset image)."""
        now = time.perf_counter()
        k = len(traces)
        if i_last == k:   # this batch began at iteration 1
            self.its_per_s.clear()
        else:
            elapsed = max(now - self.last_it_time, 1e-9)
            self.its_per_s(k / elapsed)
        self.i = i_last
        self.last_it_time = now

        step_size = 0.0
        has_image = image is not None
        if (has_image and i_last > 1
                and image.shape == self.input_arr.shape):
            diff = image - np.float32(self.input_arr)
            step_size = float(np.sqrt(np.mean(diff ** 2)))

        logger.info('iterate %d received, loss: %g, step size: %g',
                    i_last, traces[-1]['loss'], step_size)

        if not self.running or (self.input_was_reset and i_last != k):
            return
        if has_image:
            self.input_was_reset = False
            self.input_arr = image
        rate = self.its_per_s()
        for j, trace in enumerate(traces):
            self.push('iterateInfo', i=i_last - k + 1 + j,
                      trace=dict(trace), stepSize=step_size, itsPerS=rate)


class EngineActions:
    """Commands a session's UI can trigger, implemented per serving tier.

    Coroutines may raise to surface a readable error to the user (params
    pipeline) or to reject an unsupported operation (SizeRejected)."""

    async def start(self):
        raise NotImplementedError

    async def pause(self):
        raise NotImplementedError

    async def reset_input(self):
        raise NotImplementedError

    async def restart_engine(self):
        raise NotImplementedError

    async def change_size(self, size):
        raise NotImplementedError

    async def set_optimizer(self, name, step_size):
        raise NotImplementedError

    async def set_weights(self, weights, scalars):
        raise NotImplementedError


# -- applyParams pipeline ---------------------------------------------------------

def validate_weights_doc(doc, layers):
    """Validates the two-part weights document [per-layer, scalars] and
    returns (weights, scalars) with float values. Raises ValueError with
    the reference's user-facing message on an unknown layer name, KeyError
    on a missing group."""
    weights = {}
    for group in LOSS_GROUPS:
        weights[group] = {}
        for layer, value in doc[0][group].items():
            if layer not in layers:
                raise ValueError('Invalid layer name. Valid layer names '
                                 'are: %s.' % ', '.join(layers))
            weights[group][layer] = float(value)
    scalars = {key: float(doc[1][key]) for key in SCALAR_KEYS}
    return weights, scalars


def params_error_string(err):
    """The reference's error-string surface for a rejected params document
    (app.py:223-227)."""
    if isinstance(err, KeyError):
        return (type(err).__name__ + ': ' + str(err) +
                ": All required parameters were not found. Please don't "
                "delete parameters.")
    return type(err).__name__ + ': ' + str(err)


async def apply_params_document(sess, actions, text, layers, max_size):
    """Runs one applyParams request end to end and echoes newParams.

    Order matters and is part of the behavior contract: the size change
    dispatches before the optimizer, which dispatches before the weights
    are validated — a later rejection does not roll back earlier stages."""
    error_string = ''
    try:
        params = yaml.safe_load(text)

        if params['size'] > max_size:
            raise ValueError('Size is over %d' % max_size)
        params['size'] = await actions.change_size(int(params['size']))

        await actions.set_optimizer(params['optimizer'],
                                    params['optimizer_step_size'])

        weights, scalars = validate_weights_doc(params['weights'], layers)
        await actions.set_weights(weights, scalars)

        sess.params = params
    except Exception as err:   # surfaced to the user, never fatal
        error_string = params_error_string(err)
    sess.push_params(error_string)


# -- WebSocket pump -----------------------------------------------------------------

def greet(sess):
    """The initial WS message volley a newly connected browser expects
    (reference app.py:119-128)."""
    if sess.worker_ready:
        sess.push('workerReady')
    sess.push_params()
    h, w = sess.input_arr.shape[:2]
    sess.push('newSize', height=h, width=w)
    sess.push_state()
    sess.push('thumbnails', content=sess.thumbnail('content'),
              style=sess.thumbnail('style'))


async def pump_websocket(request, sess, actions, layers_fn, max_size):
    """Prepares the WS, greets, then dispatches inbound control messages
    until the socket closes. Sessions with a `touch` method (the pooled
    tier's idle-expiry bookkeeping) are touched per inbound message, so a
    WS-only client doesn't expire mid-conversation."""
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    sess.sockets.append(ws)
    greet(sess)
    touch = getattr(sess, 'touch', lambda: None)

    try:
        async for raw in ws:
            if raw.type != aiohttp.WSMsgType.TEXT:
                break
            touch()
            msg = json.loads(raw.data)
            kind = msg.get('type')
            if kind == 'applyParams':
                await apply_params_document(sess, actions, msg['params'],
                                            layers_fn(), max_size)
            elif kind == 'start':
                await actions.start()
                sess.running = True
                sess.push_state()
            elif kind == 'pause':
                await actions.pause()
                sess.running = False
                sess.push_state()
            elif kind == 'reset':
                await actions.reset_input()
            elif kind == 'restartWorker':
                await actions.restart_engine()
            else:
                logger.error('unknown WS message type %r', kind)
    finally:
        sess.sockets.remove(ws)
    return ws


def decode_upload(post_msg):
    """Decodes an /upload form: returns (slot, PIL RGB image, raw size
    field). The data field is a base64 data URL."""
    data = binascii.a2b_base64(post_msg['data'].partition(',')[2])
    image = Image.open(io.BytesIO(data)).convert('RGB')
    return post_msg['slot'], image, post_msg.get('size')


def fresh_random_input(hw):
    """The canonical random initial iterate (uniform [0, 255) uint8)."""
    return np.uint8(np.random.uniform(0, 255, tuple(hw) + (3,)))


# -- Router control plane -----------------------------------------------------------

class RouterLink:
    """Registers a serving instance with the router over HTTP/JSON and
    keeps it alive with a heartbeat; the reference's AppUp ZMQ ping
    (app.py:326-333) as a control-plane HTTP call."""

    def __init__(self, config, app_id, host, port, capacity=None):
        self.app_id = app_id
        self.capacity = capacity
        self.host = host
        self.port = int(port)
        router_host = config.get('router_host', '')
        router_port = config.get('router_control_port', '')
        self.url = ('http://%s:%s' % (router_host, router_port)
                    if router_host and router_port else None)
        self.headers = control_headers(config)
        self.enabled_check = lambda: True

    @property
    def configured(self):
        return self.url is not None

    def _payload(self):
        payload = {'addr': 'http://%s:%s/__control/reset'
                           % (self.host, self.port),
                   'host': self.host, 'port': self.port,
                   'app_id': self.app_id}
        if self.capacity is not None:
            payload['capacity'] = self.capacity
        return payload

    async def register_once(self):
        if not self.configured or not self.enabled_check():
            return
        try:
            async with aiohttp.ClientSession() as http:
                await http.post(self.url + '/__register',
                                json=self._payload(), headers=self.headers,
                                timeout=aiohttp.ClientTimeout(total=2))
        except Exception as err:
            logger.debug('router ping failed: %s', err)

    async def heartbeat(self):
        while True:
            await self.register_once()
            await asyncio.sleep(HEARTBEAT_SECONDS)

    async def unregister(self):
        if not self.configured:
            return
        try:
            async with aiohttp.ClientSession() as http:
                await http.post(self.url + '/__unregister',
                                json={'app_id': self.app_id},
                                headers=self.headers,
                                timeout=aiohttp.ClientTimeout(total=2))
        except Exception:
            pass
