"""The port's router (style_transfer2_tpu_torch.serve.router): the tests of
tests/test_router_proxy.py and the router tests of
tests/test_control_auth.py against it, and end to end on the CPU: the
port's pool registers with the port's router, and a browser through the
router gets a session, iterateInfo over the proxied WebSocket, and
/output."""

import asyncio
import configparser
import io
import json

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from style_transfer2_tpu_torch.serve import router as router_mod
from style_transfer2_tpu_torch.serve.session import (
    CONTROL_TOKEN_HEADER, RouterLink, check_control_auth)
from test_router_proxy import make_backend


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _cfg(**extra):
    cp = configparser.ConfigParser()
    cp['DEFAULT'] = dict({
        'debug': '0',
        'initial_content': 'examples/golden_gate.jpg',
        'initial_style': 'examples/starry_night.jpg',
        'initial_size': '48',
        'initial_weights': 'initial_weights.yaml',
        'http_host': '127.0.0.1',
        'http_port': '8000',
        'max_size': '96',
        'weights': 'random',
        'precision': 'float32',
        'device': 'cpu',
    }, **{k: str(v) for k, v in extra.items()})
    return cp['DEFAULT']


# -- tests/test_router_proxy.py, adapted ------------------------------------------

def test_router_proxies_to_backend(tmp_path):
    async def body():
        backend = make_backend()
        backend_server = TestServer(backend)
        await backend_server.start_server()

        config = configparser.ConfigParser()
        config['DEFAULT'] = {'router_session_timeout': '60'}
        router_app = router_mod.init(config=config['DEFAULT'],
                                     state_file=str(tmp_path / 's.json'))
        client = TestClient(TestServer(router_app),
                            cookie_jar=aiohttp.DummyCookieJar())
        await client.start_server()  # startup initializes addrs/sessions

        inst = router_mod.AppInstance(
            'http://127.0.0.1:%d/__control/reset' % backend_server.port,
            '127.0.0.1', backend_server.port, 'be1', capacity=2)
        router_app['addrs'][inst.addr] = inst

        # First GET: assigned a session, proxied body, both cookies arrive.
        resp = await client.get('/')
        assert resp.status == 200
        assert await resp.text() == 'backend-index'
        cookies = {c.key: c.value for c in resp.cookies.values()}
        assert 'session_id' in cookies          # router's affinity cookie
        assert cookies.get('pool_session') == 'backend-cookie'  # passthrough
        sid = cookies['session_id']
        hdr = {'Cookie': 'session_id=%s; pool_session=backend-cookie' % sid}

        # POST forwards form data.
        resp = await client.post('/upload', data={'slot': 'content'},
                                 headers=hdr)
        assert resp.status == 200
        assert backend['hits'][-1][0] == 'POST'
        assert backend['hits'][-1][2]['slot'] == 'content'

        # WS proxying forwards the client's cookies to the backend.
        ws = await client.ws_connect('/websocket', headers=hdr)
        msg = json.loads((await ws.receive()).data)
        assert msg['type'] == 'hello'
        assert msg['cookies'].get('pool_session') == 'backend-cookie'
        await ws.send_str('ping')
        echo = await ws.receive()
        assert echo.data == 'echo:ping'
        await ws.close()

        # Second user fits (capacity 2); third gets 503.
        resp = await client.get('/')
        assert resp.status == 200
        resp = await client.get('/')
        assert resp.status == 503

        # Affine: the first user's later requests reuse the same instance.
        resp = await client.get('/output', headers=hdr)
        assert resp.status == 200
        assert len(router_app['sessions']) == 2

        # The registry survives a restart through the JSON state file.
        await client.close()
        state = json.loads((tmp_path / 's.json').read_text())
        assert [a['app_id'] for a in state['addrs']] == ['be1']
        assert len(state['addrs'][0]['sessions']) == 2
        await backend_server.close()
    run(body())


# -- the router tests of tests/test_control_auth.py, adapted ----------------------

class FakeRequest:
    def __init__(self, headers=None, remote='127.0.0.1'):
        self.headers = headers or {}
        self.remote = remote


def test_check_control_auth_policy():
    # No token configured: loopback passes, remote peers are rejected.
    cfg = _cfg()
    check_control_auth(FakeRequest(), cfg)
    check_control_auth(FakeRequest(remote='::1'), cfg)
    check_control_auth(FakeRequest(remote=None), cfg)  # unix socket/mocks
    with pytest.raises(web.HTTPForbidden):
        check_control_auth(FakeRequest(remote='10.0.0.5'), cfg)

    # Token configured: the header decides, the peer address does not.
    cfg = _cfg(control_token='sesame')
    with pytest.raises(web.HTTPForbidden):
        check_control_auth(FakeRequest(), cfg)  # missing
    with pytest.raises(web.HTTPForbidden):
        check_control_auth(
            FakeRequest({CONTROL_TOKEN_HEADER: 'wrong'}), cfg)
    check_control_auth(
        FakeRequest({CONTROL_TOKEN_HEADER: 'sesame'}, remote='10.0.0.5'),
        cfg)


def test_router_register_requires_token(tmp_path):
    async def body():
        config = _cfg(control_token='sesame')
        app = router_mod.init(config=config,
                              state_file=str(tmp_path / 's.json'))
        app['addrs'] = {}
        app['sessions'] = {}
        control = router_mod.make_control_app(app)
        client = TestClient(TestServer(control))
        await client.start_server()

        payload = {'addr': 'http://127.0.0.1:9000/__control/reset',
                   'host': '127.0.0.1', 'port': 9000, 'app_id': 'id0'}
        resp = await client.post('/__register', json=payload)
        assert resp.status == 403
        resp = await client.post('/__register', json=payload,
                                 headers={'X-Control-Token': 'wrong'})
        assert resp.status == 403
        assert not app['addrs']
        resp = await client.post('/__register', json=payload,
                                 headers={'X-Control-Token': 'sesame'})
        assert resp.status == 200
        assert len(app['addrs']) == 1

        resp = await client.post('/__unregister', json={'app_id': 'id0'})
        assert resp.status == 403
        assert len(app['addrs']) == 1
        resp = await client.post('/__unregister', json={'app_id': 'id0'},
                                 headers={'X-Control-Token': 'sesame'})
        assert resp.status == 200
        assert not app['addrs']
        await client.close()
    run(body(), 300)


def test_router_link_and_reset_delivery_attach_token():
    """Both control-plane clients — the app's registration heartbeat and
    the router's reset delivery — carry the configured token."""
    async def body():
        seen = {}

        async def capture(request):
            seen[request.path] = request.headers.get('X-Control-Token')
            return web.json_response({'ok': True})

        target = web.Application()
        target.router.add_route('POST', '/__register', capture)
        target.router.add_route('POST', '/__unregister', capture)
        target.router.add_route('POST', '/__control/reset', capture)
        server = TestServer(target)
        await server.start_server()

        cfg = _cfg(control_token='sesame',
                   router_host='127.0.0.1',
                   router_control_port=str(server.port))
        link = RouterLink(cfg, 'app0', host='127.0.0.1', port=8000)
        await link.register_once()
        await link.unregister()
        assert seen['/__register'] == 'sesame'
        assert seen['/__unregister'] == 'sesame'

        inst = router_mod.AppInstance(
            'http://127.0.0.1:%d/__control/reset' % server.port,
            '127.0.0.1', server.port, 'app0')
        await router_mod.send_reset(inst, cfg)
        assert seen['/__control/reset'] == 'sesame'
        await server.close()
    run(body(), 300)


# -- End to end: the port's pool behind the port's router ------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_pool_registers_and_serves_through_router(tmp_path):
    """The port's pool (2 lanes at 32px on the CPU) registers with the
    port's router over its control port, and a browser that speaks only to
    the router's proxy port gets a session, iterateInfo frames over the
    proxied WebSocket and its /output; the router's /stats counts the
    pool's capacity and the session."""
    from style_transfer2_tpu_torch.serve import pool as port_pool

    async def body():
        router_port, control_port, pool_port = (_free_port() for _ in
                                                range(3))
        config = _cfg(initial_size=32, pool_lanes=2, pool_sizes='32 48',
                      router_host='127.0.0.1', router_port=router_port,
                      router_control_port=control_port,
                      http_port=pool_port)
        router_app = router_mod.init(config=config,
                                     state_file=str(tmp_path / 's.json'))
        pool_app = port_pool.init(config=config)
        runners = []

        async def serve(app, port):
            runner = web.AppRunner(app)
            await runner.setup()
            runners.append(runner)
            await web.TCPSite(runner, '127.0.0.1', port).start()

        try:
            await serve(router_app, router_port)
            # The control app shares the registry the router's startup made.
            await serve(router_mod.make_control_app(router_app),
                        control_port)
            await serve(pool_app, pool_port)

            for _ in range(100):    # the pool's heartbeat registers it
                if router_app['addrs']:
                    break
                await asyncio.sleep(0.1)
            (inst,) = router_app['addrs'].values()
            assert (inst.port, inst.capacity) == (pool_port, 2)

            base = 'http://127.0.0.1:%d' % router_port
            async with aiohttp.ClientSession(
                    cookie_jar=aiohttp.CookieJar(unsafe=True)) as http:
                async with http.get(base + '/') as resp:
                    assert resp.status == 200
                    assert 'Style Transfer' in await resp.text()
                names = {c.key for c in http.cookie_jar}
                assert {'session_id', 'pool_session'} <= names
                ws = await http.ws_connect(base + '/websocket')
                await ws.send_str(json.dumps({'type': 'start'}))
                while True:
                    data = json.loads((await ws.receive(timeout=120)).data)
                    if data['type'] == 'iterateInfo' and data['i'] >= 2:
                        break
                assert np.isfinite(data['trace']['loss'])
                async with http.get(base + '/output') as resp:
                    assert resp.status == 200
                    png = await resp.read()
                with Image.open(io.BytesIO(png)) as img:
                    assert img.format == 'PNG'
                    assert img.size == pool_app['tier'].default_hw[::-1]
                async with http.get(base + '/stats') as resp:
                    text = await resp.text()
                assert '1/2 session slots in use' in text
                await ws.close()
            assert len(pool_app['tier'].sessions) == 1
        finally:
            for runner in reversed(runners):
                await runner.cleanup()
        assert not router_app['addrs']   # the pool unregistered on cleanup
    run(body(), 300)
