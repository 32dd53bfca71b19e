#!/usr/bin/env python3
"""A request router for hosting multiple Style Transfer instances: the
port's own copy of style_transfer2_tpu/serve/router.py (host only; it
launches nothing on the card).

Replicates the reference router's behavior (router.py): cookie-session-affine
reverse proxying of GET /, GET /output, POST /upload and the WebSocket over a
fleet of app instances; an instance registry fed by app heartbeats; 60 s
session/ping expiry; a /stats page; state persisted across restarts; 503 when
the pool is exhausted.

The control plane is HTTP/JSON instead of pickled-object ZMQ: apps POST
/__register (AppUp, every 5 s) and /__unregister (AppDown) on the router's
control port; the router resets an app by POSTing its /__control/reset
endpoint. State persists as JSON (router_state.json), not pickle.

    python -m style_transfer2_tpu_torch.serve.router [config.ini] [-d]
"""

import asyncio
import json
import logging
import os
from pathlib import Path
import time

import aiohttp
from aiohttp import web

from .. import utils
from .error_pages import error_pages
from .render import add_static_routes, render
from .session import check_control_auth, control_headers

ROOT_DIR = Path(__file__).resolve().parents[2]
STATE_FILE = 'router_state.json'

logger = logging.getLogger('router')


class AppInstance:
    """Registry entry for one app. capacity > 1 marks a pooled instance
    (serve/pool.py) that multiplexes several sessions internally: the router
    then only provides affinity/balancing, never sends Reset (the pool
    manages per-session state via its own cookie)."""

    def __init__(self, addr, host, port, app_id, capacity=1,
                 sessions=None, last_ping=None):
        self.addr = addr          # the app's control-reset URL
        self.host = host
        self.port = port
        self.app_id = app_id
        self.capacity = max(1, int(capacity))
        self.sessions = dict(sessions or {})  # session_id -> last_access
        self.last_ping = last_ping or time.monotonic()

    def has_room(self):
        return len(self.sessions) < self.capacity

    def touch(self, session_id):
        self.sessions[session_id] = time.monotonic()

    def to_json(self):
        return {'addr': self.addr, 'host': self.host, 'port': self.port,
                'app_id': self.app_id, 'capacity': self.capacity,
                'sessions': sorted(self.sessions)}

    @classmethod
    def from_json(cls, data):
        now = time.monotonic()
        return cls(data['addr'], data['host'], data['port'], data['app_id'],
                   data.get('capacity', 1),
                   {sid: now for sid in data.get('sessions', [])})


async def send_reset(inst, config=None):
    """Delivers a Reset to an app instance over its control endpoint."""
    try:
        async with aiohttp.ClientSession() as sess:
            await sess.post(inst.addr,
                            headers=control_headers(config),
                            timeout=aiohttp.ClientTimeout(total=2))
    except Exception as err:
        logger.debug('reset delivery to %s failed: %s', inst.addr, err)


async def stats(request):
    app = request.app
    return render('stats.html', {
        'instances': sum(i.capacity for i in app['addrs'].values()),
        'sessions': len(app['sessions']),
        'timestamp': time.asctime(time.gmtime()),
        'loadavg': os.getloadavg(),
        'devices': app.get('device_summary', 'n/a'),
        'ga_tracking_code': app['config'].get('ga_tracking_code', '')})


async def proxy(request):
    app = request.app
    if ('session_id' in request.cookies
            and request.cookies['session_id'] in app['sessions']):
        session_id = request.cookies['session_id']
        set_session_id = False
    else:
        session_id = os.urandom(8).hex()
        inst = None
        for instance in app['addrs'].values():
            if instance.has_room():
                inst = instance
                logger.debug('New session: %s on %s', session_id, inst.addr)
                if inst.capacity == 1:
                    # Dedicated instance: clear the previous user's state
                    # (pooled instances manage per-session state themselves).
                    await send_reset(inst, app['config'])
                inst.touch(session_id)
                app['sessions'][session_id] = inst
                break
        if inst is None:
            raise web.HTTPServiceUnavailable()
        set_session_id = True

    inst = app['sessions'][session_id]
    inst.touch(session_id)

    try:
        async with aiohttp.ClientSession() as sess:
            url = 'http://%s:%d%s' % (inst.host, inst.port, request.rel_url)
            headers = {k: v for k, v in request.headers.items()
                       if k.lower() not in ('host', 'content-length')}
            if request.method == 'GET':
                async with sess.get(url, headers=headers) as resp:
                    data = await resp.read()
                    out_headers = {k: v for k, v in resp.headers.items()
                                   if k.lower() not in
                                   ('transfer-encoding', 'content-length',
                                    'content-encoding')}
                    resp = web.Response(body=data, headers=out_headers,
                                        status=resp.status)
            elif request.method == 'POST':
                data = await request.read()
                async with sess.post(url, headers=headers, data=data) as resp:
                    data = await resp.read()
                    out_headers = {k: v for k, v in resp.headers.items()
                                   if k.lower() not in
                                   ('transfer-encoding', 'content-length',
                                    'content-encoding')}
                    resp = web.Response(body=data, headers=out_headers,
                                        status=resp.status)
            else:
                raise web.HTTPForbidden()
    except aiohttp.ClientError:
        logger.debug('Expiring session %s on %s', session_id, inst.addr)
        if inst.capacity == 1:
            await send_reset(inst, app['config'])
        inst.sessions.pop(session_id, None)
        app['sessions'].pop(session_id, None)
        raise web.HTTPInternalServerError()

    if set_session_id:
        resp.set_cookie('session_id', session_id)
    return resp


async def proxy_ws(request):
    app = request.app
    if 'session_id' not in request.cookies:
        raise web.HTTPForbidden()
    if request.cookies['session_id'] not in app['sessions']:
        raise web.HTTPForbidden()
    session_id = request.cookies['session_id']
    inst = app['sessions'][session_id]
    inst.touch(session_id)
    url = 'http://%s:%d/websocket' % (inst.host, inst.port)
    ws_user = web.WebSocketResponse()
    try:
        async with aiohttp.ClientSession() as sess:
            # Forward the client's cookies: pooled instances key their own
            # per-user session off a cookie of their own.
            headers = {}
            if 'Cookie' in request.headers:
                headers['Cookie'] = request.headers['Cookie']
            async with sess.ws_connect(url, headers=headers) as ws_app:
                await ws_user.prepare(request)
                copy_coros = (copy_ws(inst, session_id, ws_app, ws_user),
                              copy_ws(inst, session_id, ws_user, ws_app))
                tasks = [asyncio.ensure_future(c) for c in copy_coros]
                _, pending = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                for fut in pending:
                    fut.cancel()
                return ws_user
    except aiohttp.ClientError:
        logger.debug('Expiring session %s on %s', session_id, inst.addr)
        if inst.capacity == 1:
            await send_reset(inst, app['config'])
        inst.sessions.pop(session_id, None)
        app['sessions'].pop(session_id, None)
        return ws_user


async def copy_ws(inst, session_id, a, b):
    """Copies WS messages b -> a until either side closes."""
    async for msg in b:
        try:
            if msg.type == aiohttp.WSMsgType.TEXT:
                await a.send_str(msg.data)
            elif msg.type == aiohttp.WSMsgType.BINARY:
                await a.send_bytes(msg.data)
            inst.touch(session_id)
        except (RuntimeError, ConnectionError):
            break
    await a.close()


# -- Control plane (replaces ZMQ AppUp/AppDown, reference router.py:149-188) --

async def register(request):
    app = request.app
    check_control_auth(request, app['config'])
    msg = await request.json()
    addr, app_id = msg['addr'], msg['app_id']
    known = app['addrs'].get(addr)
    if known is None or known.app_id != app_id:
        logger.info('AppUp %s (%s:%s, capacity %s)', addr, msg['host'],
                    msg['port'], msg.get('capacity', 1))
        if known is not None:
            # Same address, new app instance: its old sessions are gone.
            for sid in known.sessions:
                app['sessions'].pop(sid, None)
        inst = AppInstance(addr, msg['host'], int(msg['port']), app_id,
                           capacity=msg.get('capacity', 1))
        app['addrs'][addr] = inst
        if inst.capacity == 1:
            await send_reset(inst, app['config'])
    else:
        known.last_ping = time.monotonic()
    return web.json_response({'ok': True})


async def unregister(request):
    app = request.app
    check_control_auth(request, app['config'])
    msg = await request.json()
    app_id = msg.get('app_id')
    addr_to_del = None
    for addr, inst in app['addrs'].items():
        if inst.app_id == app_id:
            addr_to_del = addr
            break
    if addr_to_del:
        inst = app['addrs'].pop(addr_to_del)
        logger.info('AppDown %s', addr_to_del)
        for sid in inst.sessions:
            app['sessions'].pop(sid, None)
    return web.json_response({'ok': True})


async def expire_state(app, run_once=False):
    """Reaps idle sessions and dead instances (reference router.py:191-211).
    run_once is the startup-reap/test seam."""
    timeout = app['config'].getint('router_session_timeout', 60)
    while True:
        now = time.monotonic()
        addr_to_del = None
        for addr, inst in app['addrs'].items():
            for sid, last_access in list(inst.sessions.items()):
                if last_access < now - timeout:
                    logger.debug('Expiring session %s on %s', sid, addr)
                    if inst.capacity == 1:
                        await send_reset(inst, app['config'])
                    inst.sessions.pop(sid, None)
                    app['sessions'].pop(sid, None)
            if inst.last_ping < now - timeout:
                addr_to_del = addr
        if addr_to_del:
            logger.debug('Ping timeout for instance %s', addr_to_del)
            del app['addrs'][addr_to_del]
        if run_once:
            return
        await asyncio.sleep(1)


def save_state(app):
    state = {'addrs': [inst.to_json() for inst in app['addrs'].values()]}
    with open(app['state_file'], 'w') as f:
        json.dump(state, f)


def load_state(app):
    try:
        with open(app['state_file']) as f:
            state = json.load(f)
    except FileNotFoundError:
        return
    except (json.JSONDecodeError, KeyError, TypeError) as err:
        logger.warning('Unable to load state file: %s', err)
        return
    for data in state.get('addrs', []):
        inst = AppInstance.from_json(data)
        app['addrs'][inst.addr] = inst
        for sid in inst.sessions:
            app['sessions'][sid] = inst


async def startup_tasks(app):
    app['addrs'] = {}
    app['sessions'] = {}
    load_state(app)
    await expire_state(app, run_once=True)
    app['expire_task'] = asyncio.ensure_future(expire_state(app))


async def cleanup_tasks(app):
    app['expire_task'].cancel()
    save_state(app)


def init(args=None, config=None, state_file=STATE_FILE):
    if config is None:
        config = utils.read_config(args)
    template_vars = {'ga_tracking_code': config.get('ga_tracking_code', '')}
    app = web.Application(middlewares=[error_pages(template_vars)],
                          client_max_size=64 * 1024 ** 2)
    app['config'] = config
    app['state_file'] = state_file
    app['debug_level'] = config.getint('debug', 0)
    if args is not None and args.debug:
        app['debug_level'] += args.debug

    app.router.add_route('GET', '/', proxy)
    app.router.add_route('GET', '/output', proxy)
    app.router.add_route('POST', '/upload', proxy)
    app.router.add_route('GET', '/websocket', proxy_ws)
    app.router.add_route('GET', '/stats', stats)
    add_static_routes(app)

    app.on_startup.append(startup_tasks)
    app.on_cleanup.append(cleanup_tasks)
    return app


def make_control_app(router_app):
    """The control-plane app (register/unregister) — bound on a separate
    port so heartbeats never hit the proxy. Shares the registry dicts with
    the router app; call after the router app's startup has run."""
    control = web.Application()
    control['addrs'] = router_app['addrs']
    control['sessions'] = router_app['sessions']
    control['config'] = router_app['config']
    control.router.add_route('POST', '/__register', register)
    control.router.add_route('POST', '/__unregister', unregister)
    return control


def main():
    """The main function."""
    utils.setup_exceptions()
    utils.setup_signals()
    args = utils.parse_args(__doc__)
    app = init(args)
    utils.setup_logging(app['debug_level'])

    async def run():
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, app['config']['router_host'],
                           int(app['config']['router_port']))
        await site.start()

        control = make_control_app(app)
        control_runner = web.AppRunner(control)
        await control_runner.setup()
        control_site = web.TCPSite(
            control_runner, app['config']['router_host'],
            int(app['config']['router_control_port']))
        await control_site.start()
        logger.info('Router serving on :%s (control :%s)',
                    app['config']['router_port'],
                    app['config']['router_control_port'])
        while True:
            await asyncio.sleep(3600)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    finally:
        logger.info('Shutting down router.')
        save_state(app)


if __name__ == '__main__':
    main()
