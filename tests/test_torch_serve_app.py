"""The port's web app on the CPU (config device = cpu): the app tests of
tests/test_serve.py adapted to style_transfer2_tpu_torch.serve.app, the
ladder -> float32 polish -> pause schedule end to end, the browser protocol
held against the JAX app's for one script, the startup failure of the
default device without CUDA, a spatial mesh snapping the session's grid,
and the ignored config keys."""

import asyncio
import base64
import configparser
import io
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch
import yaml
from aiohttp import WSMsgType
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from style_transfer2_tpu_torch.serve import app as port_app


def _data_url(size=(32, 32), seed=0):
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 256, size + (3,)).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='png')
    return ('data:image/png;base64,'
            + base64.b64encode(buf.getvalue()).decode())


def _config(**extra):
    cp = configparser.ConfigParser()
    cp['DEFAULT'] = {
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
        **{k: str(v) for k, v in extra.items()},
    }
    return cp['DEFAULT']


@pytest.fixture
def app_client():
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = port_app.init(config=_config())
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    yield client, loop
    loop.run_until_complete(client.close())
    loop.close()


class Browser:
    """One WebSocket client: keeps the last frame of each type."""

    def __init__(self, ws):
        self.ws = ws
        self.got = {}

    async def send(self, kind, **fields):
        await self.ws.send_str(json.dumps(dict(fields, type=kind)))

    async def recv_until(self, wanted, limit=400):
        for _ in range(limit):
            msg = await asyncio.wait_for(self.ws.receive(), 240)
            assert msg.type == WSMsgType.TEXT, msg
            data = json.loads(msg.data)
            self.got[data['type']] = data
            if data['type'] == wanted:
                return data
        raise AssertionError('never received %s (got %s)'
                             % (wanted, list(self.got)))


# -- The app tests of tests/test_serve.py, adapted ------------------------------

def test_app_end_to_end(app_client):
    client, loop = app_client

    async def body():
        resp = await client.get('/')
        assert resp.status == 200
        html = await resp.text()
        assert 'Style Transfer' in html and 'params' in html

        resp = await client.get('/app.js')
        assert resp.status == 200

        resp = await client.get('/output')
        assert resp.status == 200
        img = Image.open(io.BytesIO(await resp.read()))
        assert img.size[0] <= 48 and img.size[1] <= 48

        resp = await client.get('/stats')
        assert resp.status == 200
        assert 'cpu' in await resp.text()

        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('workerReady')
        await b.recv_until('state')
        assert 'newParams' in b.got and 'newSize' in b.got

        await b.send('start')
        info = await b.recv_until('iterateInfo')
        assert info['i'] >= 1
        assert np.isfinite(info['trace']['loss'])
        assert 'itsPerS' in info and 'stepSize' in info

        # A mid-run params change round-trips with an empty error.
        params = yaml.safe_load(b.got['newParams']['params'])
        params['optimizer'] = 'adam'
        params['optimizer_step_size'] = 5
        params['weights'][0]['style']['conv2_1'] = 2.0
        await b.send('applyParams', params=yaml.safe_dump(params))
        assert (await b.recv_until('newParams'))['errorString'] == ''

        # An invalid layer name is rejected with a readable error.
        bad = dict(params)
        bad['weights'] = [{'content': {'nope_1': 1}, 'style': {},
                           'deepdream': {}}, params['weights'][1]]
        await b.send('applyParams', params=yaml.safe_dump(bad))
        assert 'Invalid layer name' in (
            await b.recv_until('newParams'))['errorString']

        await b.send('pause')
        assert (await b.recv_until('state'))['running'] is False

        b.got.pop('thumbnails', None)
        resp = await client.post('/upload', data={
            'size': '48', 'slot': 'content', 'data': _data_url((40, 40), 7)})
        assert resp.status == 200
        await b.recv_until('thumbnails')

        await b.send('reset')
        await asyncio.sleep(0.2)
        await b.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 300))


def test_app_restart_worker_recovers(app_client):
    client, loop = app_client

    async def body():
        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('workerReady')
        # Kill the worker (reference app.py:146-149): the supervisor
        # respawns it and it comes back ready.
        await b.send('restartWorker')
        await b.recv_until('workerReady')

        await b.send('start')
        info = await b.recv_until('iterateInfo')
        assert np.isfinite(info['trace']['loss'])
        await b.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 300))


def test_app_control_reset_and_input_upload(app_client):
    """The router-facing control reset endpoint and the 'input'/'style'
    upload slots."""
    client, loop = app_client

    async def body():
        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('workerReady')

        resp = await client.post('/upload', data={
            'size': '48', 'slot': 'input', 'data': _data_url((48, 48), 9)})
        assert resp.status == 200
        b.got.pop('thumbnails', None)
        resp = await client.post('/upload', data={
            'size': '48', 'slot': 'style', 'data': _data_url((30, 30), 4)})
        assert resp.status == 200
        await b.recv_until('thumbnails')

        await b.send('start')
        await b.recv_until('iterateInfo')
        b.got.pop('state', None)
        resp = await client.post('/__control/reset')
        assert resp.status == 200
        assert (await b.recv_until('state'))['running'] is False
        await b.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 300))


def test_app_aspect_change_while_paused_recovers(app_client):
    """pause -> aspect-changing content upload -> reset -> start iterates
    (the state feed reconciles the full grid; reference app.py:249-252
    compared only the max size and wedged here)."""
    client, loop = app_client

    async def body():
        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('thumbnails')
        await b.send('start')
        info = await b.recv_until('iterateInfo')
        while info['i'] < 3:
            info = await b.recv_until('iterateInfo')
        await b.send('pause')
        await b.recv_until('state')
        resp = await client.post('/upload', data={
            'size': '48', 'slot': 'content', 'data': _data_url((40, 40), 9)})
        assert resp.status == 200
        await b.send('reset')
        await b.send('start')
        b.got.pop('iterateInfo', None)
        info = await b.recv_until('iterateInfo')
        assert info['i'] >= 1 and np.isfinite(info['trace']['loss'])
        await b.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 300))


def test_app_ladder_polish_pause():
    """bfloat16 up a 3-rung ladder (3 iterations a rung), a driver respawn
    at float32 for a 3-iteration polish, then the session pauses itself:
    each rung's grid reaches the browser, the iterate counter carries
    across the respawn, and the polish engine runs float32."""
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = port_app.init(config=_config(
        precision='bfloat16', serve_ladder=3, ladder_min_scale=24,
        serve_polish=3, polish_precision='float32'))
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    tier = app['tier']

    async def body():
        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('thumbnails')   # the greeting's last frame
        while not tier.sess.worker_ready:
            await asyncio.sleep(0.05)
        first = tier.driver
        assert first.transfer.precision == 'bfloat16'
        await b.send('start')
        sizes, iterates = [], []
        while True:
            msg = json.loads((await asyncio.wait_for(b.ws.receive(),
                                                     240)).data)
            if msg['type'] == 'newSize':
                sizes.append((msg['height'], msg['width']))
            elif msg['type'] == 'iterateInfo':
                iterates.append(msg)
            elif (msg['type'] == 'state' and not msg['running']
                  and tier.sched is None and iterates):
                break
        assert sizes == [(18, 24), (25, 34), (36, 48)]
        assert tier.driver is not first
        assert tier.driver.transfer.precision == 'float32'
        assert tier._precision_override == 'float32'
        numbers = [it['i'] for it in iterates]
        assert numbers == sorted(numbers) and numbers[-1] >= 3 * 3 + 3
        assert all(np.isfinite(it['trace']['loss']) for it in iterates)
        assert tuple(tier.sess.input_arr.shape[:2]) == (36, 48)
        await b.ws.close()

    try:
        loop.run_until_complete(asyncio.wait_for(body(), 300))
    finally:
        loop.run_until_complete(client.close())
        loop.close()


def test_respawn_waits_for_the_old_device_thread(app_client, monkeypatch):
    """Leaving a polish respawns the driver at the main precision at once
    (_respawn_driver) while the old one may be inside a device call: the
    new driver's first device call starts only after that call returned."""
    from style_transfer2_tpu_torch.serve.driver import Driver
    client, loop = app_client
    tier = client.server.app['tier']
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

    async def body():
        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('workerReady')
        await b.send('start')
        await b.recv_until('iterateInfo')
        old = tier.driver
        in_step = threading.Event()

        def slow(real):
            def call(*args):
                in_step.set()
                time.sleep(1.0)
                return real(*args)
            return call

        # The config's adaptive dispatch runs single steps and chunks.
        old.transfer.step = slow(old.transfer.step)
        old.transfer.begin_steps = slow(old.transfer.begin_steps)
        while not in_step.is_set():
            await asyncio.sleep(0.01)
        tier._precision_override = 'float32'   # as a polish leaves it
        await tier._exit_polish()
        new = tier.driver
        assert new is not old and tier._precision_override is None
        await b.recv_until('workerReady')
        await b.send('start')
        b.got.pop('iterateInfo', None)
        assert np.isfinite((await b.recv_until('iterateInfo'))['trace'][
            'loss'])
        await b.ws.close()
        return old, new

    old, new = loop.run_until_complete(asyncio.wait_for(body(), 300))
    old.executor.shutdown(wait=True)   # its last call has returned
    old_end = max(t for d, what, t in log if d is old and what == 'end')
    new_start = min(t for d, what, t in log if d is new and what == 'start')
    assert new_start >= old_end


# -- Protocol parity with the JAX app ------------------------------------------

async def _browser_script(client, tier):
    """One browser session: greet, start, pause, a weight change, a
    content upload, reset, start, pause. Returns each frame's (type, its
    keys, its trace's keys), runs of equal entries collapsed (how many
    iterateInfo frames arrive before a pause depends on timing)."""
    while not tier.sess.worker_ready:
        await asyncio.sleep(0.05)
    ws = await client.ws_connect('/websocket')
    seen = []

    async def until(kind, n=1):
        while n:
            msg = await asyncio.wait_for(ws.receive(), 240)
            data = json.loads(msg.data)
            seen.append((data['type'], tuple(sorted(data)),
                         tuple(sorted(data.get('trace', ())))))
            if data['type'] == kind:
                n -= 1
        return data

    async def send(kind, **fields):
        await ws.send_str(json.dumps(dict(fields, type=kind)))

    await until('thumbnails')
    params = yaml.safe_load(tier.sess.params_yaml())
    await send('start')
    await until('iterateInfo', 3)
    await send('pause')
    while (await until('state'))['running']:
        pass
    params['weights'][0]['style']['conv2_1'] = 2.0
    params['optimizer_step_size'] = 0.5
    await send('applyParams', params=yaml.safe_dump(params))
    await until('newParams')
    resp = await client.post('/upload', data={
        'size': '48', 'slot': 'content', 'data': _data_url((40, 40), 3)})
    assert resp.status == 200
    await until('thumbnails')
    await send('reset')
    await send('start')
    await until('iterateInfo', 2)
    await send('pause')
    while (await until('state'))['running']:
        pass
    await ws.close()
    return [e for i, e in enumerate(seen) if i == 0 or e != seen[i - 1]]


def _run_script(init, config):
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = init(config=config)
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    try:
        return loop.run_until_complete(asyncio.wait_for(
            _browser_script(client, app['tier']), 300))
    finally:
        loop.run_until_complete(client.close())
        loop.close()


def test_protocol_parity_with_jax_app():
    """The port's app and the JAX app, given one browser script, send the
    same sequence of WebSocket message types with the same keys in each
    (iterateInfo's trace keys included)."""
    from style_transfer2_tpu.serve import app as jax_app
    config = dict(_config())
    config.pop('device')
    cp = configparser.ConfigParser()
    cp['DEFAULT'] = config
    ours = _run_script(port_app.init, _config())
    theirs = _run_script(jax_app.init, cp['DEFAULT'])
    assert [e[0] for e in ours] == [e[0] for e in theirs]
    assert ours == theirs
    kinds = {e[0] for e in ours}
    assert kinds == {'workerReady', 'newParams', 'newSize', 'state',
                     'thumbnails', 'iterateInfo'}


# -- Startup ---------------------------------------------------------------------

def _start(config):
    """Starts the app's server and closes it again; returns the tier."""
    async def body():
        app = port_app.init(config=config)
        server = TestServer(app)
        try:
            await server.start_server()
        finally:
            await server.close()
        return app['tier']
    return asyncio.run(asyncio.wait_for(body(), 120))


@pytest.mark.parametrize('extra', [{}, {'platform': 'cpu'}],
                         ids=['default', 'platform_cpu'])
def test_default_device_needs_cuda(extra):
    """Without CUDA the default device fails at startup; platform = cpu
    (a JAX app key) does not move the port to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    config = _config(**extra)
    config.parser.remove_option('DEFAULT', 'device')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        _start(config)


def test_mesh_snaps_the_grid_and_steps():
    """mesh = 4: the session's image shards over 4 CPU entries; a content
    upload at 66x50 snaps to 68x52 (_snap_grid), and the sharded engine
    steps there with a finite loss."""
    from style_transfer2_tpu_torch.parallel import Sharded
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = port_app.init(config=_config(mesh='4'))
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    tier = app['tier']

    async def body():
        assert tier.placement.n_shards == 4
        b = Browser(await client.ws_connect('/websocket'))
        await b.recv_until('state')
        resp = await client.post('/upload', data={
            'size': '66', 'slot': 'content',
            'data': _data_url((66, 50), 7)})
        assert resp.status == 200
        size = await b.recv_until('newSize')
        assert (size['height'], size['width']) == (68, 52)
        await b.send('start')
        for _ in range(100):
            info = await b.recv_until('iterateInfo')
            if info['i'] >= 2 and tier.driver.transfer.input_hw == (68, 52):
                break
        assert np.isfinite(info['trace']['loss'])
        engine = tier.driver.transfer
        assert engine.placement is tier.placement
        assert isinstance(engine._input, Sharded)
        assert {tuple(s.shape) for s in engine._input.shards} == {
            (1, 17, 52, 3)}
        await b.ws.close()
    try:
        loop.run_until_complete(asyncio.wait_for(body(), 300))
    finally:
        loop.run_until_complete(client.close())
        loop.close()


def test_config_remat_reaches_engine(caplog):
    """tests/test_serve.py's test of the same name: the `remat` key
    reaches the engine, and a bad value is refused when the driver
    spawns. The key is no longer logged as ignored."""
    from style_transfer2_tpu_torch.models import random_params
    from style_transfer2_tpu_torch.serve import messages as m

    async def body():
        config = _config(remat='block')
        tier = port_app.SingleSessionTier(config)
        tier.model_params = random_params(0)
        tier._spawn_driver()
        try:
            assert tier.driver.transfer.remat == 'block'
            assert tier.driver.transfer.model.remat == 'block'
        finally:
            await tier.driver.in_queue.put(m.Shutdown())
            await tier.driver_task
            tier.pump_task.cancel()

        config['remat'] = 'everything'
        with pytest.raises(ValueError, match='remat'):
            tier._spawn_driver()
    asyncio.run(asyncio.wait_for(body(), 120))
    with caplog.at_level(logging.INFO, logger='app'):
        tier = _start(_config(remat='conv'))
    assert tier.driver.transfer.remat == 'conv'
    assert not [r for r in caplog.records
                if r.name == 'app' and r.args and r.args[0] == 'remat']


def test_jax_only_keys_logged_once_and_ignored(caplog):
    keys = {'pallas': 'true', 'platform': 'cpu', 'prewarm_sizes': '64, 96'}
    with caplog.at_level(logging.INFO, logger='app'):
        tier = _start(_config(**keys))
    for key in keys:
        hits = [r for r in caplog.records
                if r.name == 'app' and r.args and r.args[0] == key]
        assert len(hits) == 1, key
    assert tier.driver.transfer.device.type == 'cpu'
    assert port_app.IGNORED_KEYS == tuple(sorted(keys))
