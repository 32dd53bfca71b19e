"""The port's pooled multi-session tier on the CPU (config device = cpu):
the tests of tests/test_pool.py and the pool tests of
tests/test_persist_phase.py adapted to style_transfer2_tpu_torch.serve.pool,
the keys that mean nothing in the port (pool_prewarm logged once and
ignored), pool_mesh and pool_bucket_devices placing buckets, the default
device's failure without CUDA, every device call on the tier's one
executor thread, at startup and in a restore too, and a closed tier
letting go of its engines."""

import asyncio
import base64
import io
import json
import logging
import subprocess
import sys
import threading
from pathlib import Path

import aiohttp
import numpy as np
import pytest
import torch
import yaml
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from style_transfer2_tpu_torch.engine.batched import BatchedStyleTransfer
from style_transfer2_tpu_torch.serve import pool as port_pool
from test_pool import WSSession, _config as _jax_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these grids are tiny, and where the test runner
    runs several workers at once, more threads only wait on each other
    (the pool's executor thread follows the process-wide setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**extra):
    """tests/test_pool.py's config (32px, 2 float32 Adam lanes, sizes 32
    and 48) on the CPU."""
    config = _jax_config()
    config['device'] = 'cpu'
    for key, value in extra.items():
        config[key] = str(value)
    return config


def _data_url(size=(40, 40), seed=0):
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 256, size + (3,)).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='png')
    return ('data:image/png;base64,'
            + base64.b64encode(buf.getvalue()).decode())


def _dummy_jar(loop):
    """A DummyCookieJar (sessions manage their own cookies explicitly; a
    shared jar would silently reuse session A's cookie for B), made on
    `loop`."""
    async def make():
        return aiohttp.DummyCookieJar()
    return loop.run_until_complete(make())


@pytest.fixture
def pool_client():
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = port_pool.init(config=_config())
    client = TestClient(TestServer(app), loop=loop,
                        cookie_jar=_dummy_jar(loop))
    loop.run_until_complete(client.start_server())
    yield client, loop, app
    loop.run_until_complete(client.close())
    loop.close()


def _run_tier(init, config, body, timeout=560):
    """Starts a tier (init: either package's pool.init) with `config` on a
    fresh loop, runs body(client, tier) and closes the server."""
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = init(config=config)
    client = TestClient(TestServer(app), loop=loop,
                        cookie_jar=_dummy_jar(loop))
    loop.run_until_complete(client.start_server())
    try:
        return loop.run_until_complete(asyncio.wait_for(
            body(client, app['tier']), timeout))
    finally:
        loop.run_until_complete(client.close())
        loop.close()


def _default_engine(tier):
    return tier.engines[(tier.default_hw, tier.main_precision())]


def _lane_of(tier, cookie):
    return tier.sessions[cookie].lane


# -- tests/test_pool.py, adapted ------------------------------------------------

def test_two_sessions_share_one_engine(pool_client):
    client, loop, app = pool_client
    tier = app['tier']

    async def body():
        a = await WSSession(client).open()
        b = await WSSession(client).open()
        assert a.cookie != b.cookie
        await a.recv_until('state')
        await b.recv_until('state')
        assert {s.lane for s in tier.sessions.values()} == {0, 1}
        engine = _default_engine(tier)
        assert engine.device.type == 'cpu'

        # Start only session A: it iterates, B stays idle.
        await a.send({'type': 'start'})
        info_a = await a.recv_until('iterateInfo')
        assert info_a['i'] >= 1
        assert engine.t[_lane_of(tier, b.cookie)] == 0

        # Start B too; both advance independently.
        await b.send({'type': 'start'})
        info_b = await b.recv_until('iterateInfo')
        assert info_b['i'] >= 1
        a.got.pop('iterateInfo')
        info_a2 = await a.recv_until('iterateInfo')
        assert info_a2['i'] > info_a['i']

        # Pause A: A freezes while B keeps running.
        await a.send({'type': 'pause'})
        state = await a.recv_until('state')
        assert state['running'] is False
        await asyncio.sleep(0.3)
        lane_a = _lane_of(tier, a.cookie)
        t_a = engine.t[lane_a]
        b.got.pop('iterateInfo')
        await b.recv_until('iterateInfo')
        assert engine.t[lane_a] == t_a  # frozen

        # Per-lane weight VALUE change is accepted, and reaches B's lane
        # only.
        lane_b = _lane_of(tier, b.cookie)
        rows = engine._weights.copy()
        params = yaml.safe_load(b.got['newParams']['params'])
        params['weights'][0]['style']['conv1_1'] = 2.5
        b.got.pop('newParams')
        await b.send({'type': 'applyParams',
                      'params': yaml.safe_dump(params)})
        reply = await b.recv_until('newParams')
        assert reply['errorString'] == ''
        changed = np.any(engine._weights != rows, axis=(1, 2))
        assert changed.tolist() == [lane == lane_b for lane in range(2)]

        # Structure change is rejected with a readable error.
        bad = yaml.safe_load(b.got['newParams']['params'])
        bad['weights'][0]['deepdream'] = {'conv3_1': 1.0}
        b.got.pop('newParams')
        await b.send({'type': 'applyParams', 'params': yaml.safe_dump(bad)})
        reply = await b.recv_until('newParams')
        assert 'structure' in reply['errorString']

        # A size outside the configured bucket list is rejected.
        bad2 = yaml.safe_load(b.got['newParams']['params'])
        bad2['size'] = 64
        b.got.pop('newParams')
        await b.send({'type': 'applyParams', 'params': yaml.safe_dump(bad2)})
        reply = await b.recv_until('newParams')
        assert 'resolutions' in reply['errorString']

        # /output serves each session its own image.
        img_a = await a.output()
        img_b = await b.output()
        assert img_a.shape[:2] == tier.default_hw
        assert not np.array_equal(img_a, img_b)

        await a.ws.close()
        await b.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_exhaustion_503(pool_client):
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        b = await WSSession(client).open()
        # Third fresh session: no free lane -> 503.
        resp = await client.get('/')
        assert resp.status == 503
        await a.ws.close()
        await b.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 300))


def test_pool_upload_and_reset(pool_client):
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        await a.recv_until('iterateInfo')

        # Upload a new content image; the lane requeues and iterates anew.
        resp = await client.post(
            '/upload', data={'size': '32', 'slot': 'content',
                             'data': _data_url(seed=3)},
            headers=a._headers())
        assert resp.status == 200
        a.got.pop('thumbnails', None)
        await a.recv_until('thumbnails')
        a.got.pop('iterateInfo', None)
        info = await a.recv_until('iterateInfo')
        assert info['i'] >= 1

        # Reset: iterate count restarts.
        await a.send({'type': 'reset'})
        for _ in range(50):
            a.got.pop('iterateInfo', None)
            info = await a.recv_until('iterateInfo')
            if info['i'] == 1:
                break
        assert info['i'] == 1
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_size_migration_warm_start(pool_client):
    """A pooled session applies a size change via applyParams and continues
    with WARM-STARTED state in the new bucket: the iterate counter carries
    over, the new-bucket image is the resampled old iterate (not a fresh
    random init), and iteration proceeds at the new resolution."""
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        info = await a.recv_until('iterateInfo')
        while info['i'] < 3:
            a.got.pop('iterateInfo')
            info = await a.recv_until('iterateInfo')
        img32 = await a.output()

        params = yaml.safe_load(a.got['newParams']['params'])
        params['size'] = 48
        a.got.pop('newParams')
        a.got.pop('newSize')
        await a.send({'type': 'applyParams', 'params': yaml.safe_dump(params)})
        reply = await a.recv_until('newParams')
        assert reply['errorString'] == ''
        new_size = a.got['newSize']   # pushed just before newParams
        tier = app['tier']
        sess = list(tier.sessions.values())[0]
        assert max(sess.bucket_hw) == 48
        assert (new_size['height'], new_size['width']) == tuple(sess.bucket_hw)
        assert tier.engine_of(sess).hw == sess.bucket_hw

        # Warm start: the migrated input is the resampled old iterate.
        img48 = np.float32(sess.input_arr)
        up = np.float32(np.asarray(
            Image.fromarray(np.uint8(np.clip(img32, 0, 255)))
            .resize(sess.bucket_hw[::-1], Image.LANCZOS)))
        corr = np.corrcoef(img48.ravel(), up.ravel())[0, 1]
        assert corr > 0.8, 'migrated input not warm-started (corr %.3f)' % corr

        # Iteration continues in the new bucket, counter carried over.
        i_before = sess.i
        a.got.pop('iterateInfo', None)
        info = await a.recv_until('iterateInfo')
        assert info['i'] > i_before >= 3
        assert np.isfinite(info['trace']['loss'])
        out = await a.output()
        assert out.shape[:2] == sess.bucket_hw

        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_device_watchdog(pool_client):
    """A wedged device call marks the tier wedged: stepping stops, router
    heartbeats are disabled, and /stats reports it — instead of a zombie
    instance that still answers HTTP but never iterates."""
    import time as _time

    client, loop, app = pool_client

    async def body():
        tier = app['tier']
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        await a.recv_until('iterateInfo')

        # Arm the watchdog (read per call) and wedge the engine at the
        # drive loop's dispatch entry point.
        tier.config['pool_dispatch_timeout'] = '0.3'
        engine = next(iter(tier.engines.values()))
        engine.begin_steps_all = lambda k: _time.sleep(30)

        for _ in range(100):
            if tier.wedged:
                break
            await asyncio.sleep(0.1)
        assert tier.wedged
        assert not tier.router.enabled_check()

        resp = await client.get('/stats')
        assert 'WEDGED' in await resp.text()
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 120))


def test_pool_style_upload_keeps_progress(pool_client):
    """A style (or content) upload must NOT restart the stylization: the
    iterate and its counter continue (the worker only re-extracts features
    around the live iterate)."""
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        info = await a.recv_until('iterateInfo')
        for _ in range(30):
            a.got.pop('iterateInfo', None)
            info = await a.recv_until('iterateInfo')
            if info['i'] >= 5:
                break
        assert info['i'] >= 5
        before = info['i']

        resp = await client.post(
            '/upload', data={'size': '32', 'slot': 'style',
                             'data': _data_url(seed=7)},
            headers=a._headers())
        assert resp.status == 200
        a.got.pop('thumbnails', None)
        await a.recv_until('thumbnails')
        a.got.pop('iterateInfo', None)
        info = await a.recv_until('iterateInfo')
        assert info['i'] > before, (info['i'], before)
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_input_upload_keeps_norms_and_counter(pool_client):
    """An input-image upload REPLACES the iterate but must not restart the
    session: it keeps the optimizer through objective_changed, the
    first-eval norm cache and the counter — only reset clears them. The
    upload reaches the lane as the preprocessed image."""
    client, loop, app = pool_client
    tier = app['tier']

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        for _ in range(30):
            a.got.pop('iterateInfo', None)
            info = await a.recv_until('iterateInfo')
            if info['i'] >= 5:
                break
        assert info['i'] >= 5
        before = info['i']

        sess = next(iter(tier.sessions.values()))
        engine = tier.engine_of(sess)
        vals, set_ = engine.lane_norms(sess.lane)
        vals_before = {k: float(v) for k, v in vals.items()}
        assert all(bool(v) for v in set_.values())  # anchored

        await a.send({'type': 'pause'})
        while (await a.recv_until('state'))['running']:
            pass
        resp = await client.post(
            '/upload', data={'size': '32', 'slot': 'input',
                             'data': _data_url((32, 32), 11)},
            headers=a._headers())
        assert resp.status == 200
        # The paused lane holds the upload, as the bucket's iterate.
        np.testing.assert_allclose(
            engine.lane_image(sess.lane), np.float32(sess.input_arr),
            atol=1e-4)
        await a.send({'type': 'start'})

        a.got.pop('iterateInfo', None)
        info = await a.recv_until('iterateInfo')
        assert info['i'] > before, (info['i'], before)  # counter continues

        vals_after, set_after = engine.lane_norms(sess.lane)
        assert all(bool(v) for v in set_after.values())  # still anchored
        for k, v in vals_after.items():
            assert float(v) == vals_before[k], k  # same anchors, bit-exact
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_concurrent_session_churn(pool_client):
    """Stress the lane lifecycle: concurrent clients churning through
    open / start / upload / reset / size-change / disconnect on a 2-lane
    pool. Asserts the invariants the lane_lock work protects: no two live
    sessions ever share a (bucket, lane), every received frame is
    well-formed, and capacity rejections surface as clean 503s."""
    client, loop, app = pool_client
    tier = app['tier']
    data_url = _data_url(seed=11)
    violations = []

    def check_no_shared_lanes():
        keys = [(s.bucket_hw, s.lane) for s in tier.sessions.values()]
        if len(keys) != len(set(keys)):
            violations.append('shared lane: %s' % keys)

    async def one_client(seed):
        r = np.random.RandomState(seed)
        for _ in range(3):
            try:
                a = await WSSession(client).open()
            except AssertionError:
                # 503 (pool full) renders the error page without a cookie —
                # a clean rejection, try again later.
                await asyncio.sleep(0.2)
                continue
            try:
                await a.recv_until('state')
                await a.send({'type': 'start'})
                await a.recv_until('iterateInfo')
                for _ in range(r.randint(1, 4)):
                    op = r.randint(4)
                    check_no_shared_lanes()
                    if op == 0:
                        slot = ('style', 'content')[r.randint(2)]
                        resp = await client.post(
                            '/upload', data={'size': '32', 'slot': slot,
                                             'data': data_url},
                            headers=a._headers())
                        assert resp.status == 200
                    elif op == 1:
                        await a.send({'type': 'reset'})
                    elif op == 2:
                        await a.send({'type': 'pause'})
                        await a.send({'type': 'start'})
                    else:
                        doc = yaml.safe_load(
                            a.got['newParams']['params'])
                        doc['size'] = (32, 48)[r.randint(2)]
                        await a.send({'type': 'applyParams',
                                      'params': yaml.safe_dump(doc)})
                    a.got.pop('iterateInfo', None)
                    info = await a.recv_until('iterateInfo')
                    assert np.isfinite(info['trace']['loss'])
                    check_no_shared_lanes()
            finally:
                await a.ws.close()
                # Free the lane for the other churners.
                sess = tier.sessions.get(a.cookie)
                if sess is not None:
                    await tier.engine_op(tier.release, sess)
            check_no_shared_lanes()

    async def body():
        await asyncio.gather(*(one_client(100 + i) for i in range(4)))
        assert not violations, violations

    loop.run_until_complete(asyncio.wait_for(body(), 900))


def test_pool_restart_worker_keeps_progress(pool_client):
    """restartWorker on a pooled session costs only optimizer momentum:
    the iterate counter and the image survive."""
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        info = await a.recv_until('iterateInfo')
        for _ in range(60):
            if info['i'] >= 5:
                break
            a.got.pop('iterateInfo', None)
            info = await a.recv_until('iterateInfo')
        assert info['i'] >= 5
        before_i = info['i']
        tier = app['tier']
        sess = list(tier.sessions.values())[0]
        img_before = np.float32(
            await tier.engine_op(tier.engine_of(sess).lane_image, sess.lane))

        await a.send({'type': 'restartWorker'})
        a.got.pop('state', None)
        await a.recv_until('state')
        a.got.pop('iterateInfo', None)
        info = await a.recv_until('iterateInfo')
        assert info['i'] > before_i, (info['i'], before_i)

        # The on-device iterate continued from where it was (a random
        # re-seed would decorrelate it completely).
        img_after = np.float32(
            await tier.engine_op(tier.engine_of(sess).lane_image, sess.lane))
        corr = np.corrcoef(img_before.ravel(), img_after.ravel())[0, 1]
        assert corr > 0.8, 'iterate lost across restart (corr %.3f)' % corr
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_wedged_fails_fast(pool_client):
    """Once the watchdog marks the tier wedged, new sessions and engine
    operations 503 immediately instead of queueing behind the stuck
    executor call; an existing session's host-state reads still work."""
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        tier = app['tier']
        tier.wedged = True

        # Existing session: /output serves the last host-side snapshot.
        resp = await client.get('/output', headers=a._headers())
        assert resp.status == 200

        # New session: rejected up front.
        resp = await client.get('/')
        assert resp.status == 503

        # Engine ops (upload needs device work): rejected up front.
        buf = io.BytesIO()
        Image.new('RGB', (40, 40)).save(buf, format='png')
        data_url = ('data:image/png;base64,'
                    + base64.b64encode(buf.getvalue()).decode())
        resp = await client.post(
            '/upload', data={'size': '32', 'slot': 'style', 'data': data_url},
            headers=a._headers())
        assert resp.status == 503

        tier.wedged = False
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_pool_prewarm_is_logged_once_and_ignored(caplog):
    """pool_prewarm (the JAX pool's background compile of every bucket)
    means nothing in the port: logged once at startup, and no bucket but
    the default one exists until a session migrates; the migration into
    the other size then works."""
    async def body(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        assert set(tier.engines) == {(tier.default_hw,
                                      tier.main_precision())}
        await a.send({'type': 'start'})
        await a.recv_until('iterateInfo')
        params = yaml.safe_load(a.got['newParams']['params'])
        params['size'] = 48
        a.got.pop('newParams')
        await a.send({'type': 'applyParams', 'params': yaml.safe_dump(params)})
        reply = await a.recv_until('newParams')
        assert reply['errorString'] == ''
        sess = list(tier.sessions.values())[0]
        assert max(sess.bucket_hw) == 48
        a.got.pop('iterateInfo', None)
        assert np.isfinite((await a.recv_until('iterateInfo'))['trace'][
            'loss'])
        await a.ws.close()

    with caplog.at_level(logging.INFO, logger='pool'):
        _run_tier(port_pool.init, _config(pool_prewarm='yes'), body)
    hits = [r for r in caplog.records
            if r.name == 'pool' and r.args and r.args[0] == 'pool_prewarm']
    assert len(hits) == 1
    assert 'ignored' in hits[0].getMessage()


def test_pool_logs_remat_once_and_ignores_it(caplog):
    """The single-session app now takes `remat`; the pool's batched
    engines have none (nor do the JAX pool's), so the pool logs the key
    once at startup, ignores it, and its bucket steps as without it."""
    async def body(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        info = await a.recv_until('iterateInfo')
        assert np.isfinite(info['trace']['loss'])
        assert not hasattr(_default_engine(tier), 'remat')
        await a.ws.close()

    with caplog.at_level(logging.INFO, logger='pool'):
        _run_tier(port_pool.init, _config(remat='block'), body)
    hits = [r for r in caplog.records
            if r.name == 'pool' and r.args and r.args[0] == 'remat']
    assert len(hits) == 1
    assert 'ignored' in hits[0].getMessage()
    assert 'remat' in port_pool.IGNORED_KEYS


def test_pool_stats_reports_lanes_and_capacity_separately(pool_client):
    """/stats reports lanes-in-use vs capacity as distinct numbers (the
    reference's sessions/instances split, router.py:57-63), and names the
    buckets' device."""
    client, loop, app = pool_client

    async def body():
        a = await WSSession(client).open()
        await a.recv_until('state')
        resp = await client.get('/stats')
        assert resp.status == 200
        text = await resp.text()
        assert '1 active sessions' in text
        assert '1/2 engine lanes in use' in text
        assert 'Devices: cpu' in text
        await a.ws.close()
    loop.run_until_complete(asyncio.wait_for(body(), 600))


def test_closed_tier_lets_go_of_its_engines():
    """Once the client is closed, nothing reaches the tier's engines: two
    sessions iterate, the server closes, and every bucket dies at the next
    garbage collection (on the card each holds its step graphs' memory
    pool). A suspended drive() or _device_call() frame, or the executor's
    thread, used to keep them."""
    import gc
    import weakref
    refs = []

    async def body(client, tier):
        sessions = [await WSSession(client).open() for _ in range(2)]
        for s in sessions:
            await s.recv_until('state')
            await s.send({'type': 'start'})
        for s in sessions:
            for _ in range(3):
                await s.recv_until('iterateInfo')
        refs.extend(weakref.ref(e) for e in tier.engines.values())

    _run_tier(port_pool.init, _config(), body)
    gc.collect()
    assert refs and not [r for r in refs if r() is not None]


@pytest.mark.parametrize('key,value', [('pool_mesh', '2'),
                                       ('pool_bucket_devices',
                                        '32:0-1; 48:2,3')])
def test_pool_multi_device_keys_place_buckets(key, value):
    """pool_mesh splits each bucket's 2 lanes over 2 devices, and
    pool_bucket_devices gives the 32px bucket devices 0-1 of its own (two
    CPU entries here): the default bucket is a PlacedBatchedStyleTransfer
    of two one-lane groups, and a session on it iterates."""
    from style_transfer2_tpu_torch.engine.batched import (
        PlacedBatchedStyleTransfer)

    async def body(client, tier):
        engine = _default_engine(tier)
        assert isinstance(engine, PlacedBatchedStyleTransfer)
        assert [g.max_lanes for g in engine.groups] == [1, 1]
        a = await WSSession(client).open()
        await a.recv_until('state')
        await a.send({'type': 'start'})
        for _ in range(100):
            info = await a.recv_until('iterateInfo')
            if info['i'] >= 3:
                break
        assert np.isfinite(info['trace']['loss'])
        assert engine.t[_lane_of(tier, a.cookie)] >= 3
        await a.ws.close()

    _run_tier(port_pool.init, _config(**{key: value}), body)


def test_pool_bucket_devices_sub_mesh_spans_the_listed_indices():
    """pool_bucket_devices names device indices (on the CPU each is an
    entry of the CPU): a listed bucket's sub-mesh spans its indices, an
    unlisted one takes the pool_mesh placement (none here)."""
    tier = port_pool.PooledTier(_config(pool_bucket_devices='32:0-2'))
    placement = tier.bucket_placement(32)
    assert placement.n_groups == 3
    assert tier.bucket_placement(48) is None


def test_pooled_ladder_climbs_buckets():
    """The pooled multi-scale ladder: a fresh session with `ladder` in its
    params starts in the smallest allowed bucket and migrates up every N
    iterations with warm-started state, ending in its requested bucket."""
    async def body(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        sess = next(iter(tier.sessions.values()))
        target_hw = sess.bucket_hw
        assert max(target_hw) == 48

        await a.send({'type': 'start'})
        # Drops to the smallest allowed bucket first.
        msg = await a.recv_until('newSize')
        assert max(msg['height'], msg['width']) == 24
        assert sess.ladder is not None

        # Climbs through 32 to 48, then the schedule clears.
        seen = [24]
        for _ in range(400):
            if sess.ladder is None and sess.bucket_hw == target_hw:
                break
            try:
                msg = await asyncio.wait_for(a.ws.receive(), 5)
            except asyncio.TimeoutError:
                continue
            data = json.loads(msg.data)
            if data['type'] == 'newSize':
                seen.append(max(data['height'], data['width']))
        assert sess.ladder is None
        assert sess.bucket_hw == target_hw
        assert seen == [24, 32, 48], seen
        # Iterates carried across migrations (warm-started counter), and
        # the emptied rung buckets were dropped.
        assert sess.i >= 6
        assert set(tier.engines) == {(target_hw, 'float32')}
        await a.ws.close()

    _run_tier(port_pool.init, _config(initial_size=48,
                                      pool_sizes='24 32 48', serve_ladder=3),
              body)


def test_pooled_polish_tail_and_exit():
    """Pooled polish: when the ladder completes, a `polish` session
    migrates to a bucket at the SAME grid but the raised polish precision
    (iterate carried, optimizer re-primed), runs N iterations, and pauses;
    a reset's restarted ladder migrates it back to the main precision."""
    async def body(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        sess = next(iter(tier.sessions.values()))
        target_hw = sess.bucket_hw
        assert sess.precision == 'bfloat16'

        await a.send({'type': 'start'})
        # Ladder 24 -> 32, then the polish tail runs and pauses.
        for _ in range(1500):
            if (sess.ladder is None and sess.polish is None
                    and sess.precision == 'float32'
                    and not sess.running):
                break
            await asyncio.sleep(0.2)
        assert sess.ladder is None and sess.polish is None
        assert sess.precision == 'float32'
        assert not sess.running            # tail done -> paused
        assert sess.bucket_hw == target_hw  # same grid, raised precision
        assert tier.engine_of(sess).precision == 'float32'
        i_polished = sess.i

        # Reset: the restarted ladder's rung-0 migration exits the
        # polish bucket back to the main precision.
        await a.send({'type': 'reset'})
        for _ in range(300):
            if sess.precision == 'bfloat16':
                break
            await asyncio.sleep(0.2)
        assert sess.precision == 'bfloat16'
        assert sess.ladder is not None     # schedule restarted
        assert i_polished >= 2             # the tail actually iterated
        await a.ws.close()

    _run_tier(port_pool.init, _config(
        initial_size=32, pool_sizes='24 32', serve_ladder=2,
        precision='bfloat16', serve_polish=2, polish_precision='float32'),
        body)


# -- tests/test_persist_phase.py's pool tests, adapted ----------------------------

def _two_lives(config, first_life, second_life):
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)

    async def life(fn, *args):
        app = port_pool.init(config=config)
        client = TestClient(TestServer(app),
                            cookie_jar=aiohttp.DummyCookieJar())
        await client.start_server()
        try:
            return await fn(client, app['tier'], *args)
        finally:
            await client.close()

    try:
        state = loop.run_until_complete(
            asyncio.wait_for(life(first_life), 560))
        loop.run_until_complete(
            asyncio.wait_for(life(second_life, *state), 560))
    finally:
        loop.close()


def test_pool_restart_resumes_ladder(tmp_path):
    """A pooled redeploy mid-ladder: the restored session still holds its
    schedule position and remaining rung budget, and resumes migrating up
    to the target bucket."""
    config = _config(initial_size=48, pool_sizes='24 32 48', serve_ladder=6,
                     pool_persist_dir=tmp_path / 'pool',
                     persist_interval=3600)

    async def first_life(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        sess = next(iter(tier.sessions.values()))
        await a.send({'type': 'start'})
        # Wait for the first rung advance (bucket 24 -> 32), then pause
        # mid-ladder (a pause is not a schedule-cancelling action).
        for _ in range(900):
            lad = sess.ladder
            if (lad is not None and lad['idx'] >= 1
                    and not lad.get('migrating')):
                break
            await asyncio.sleep(0.1)
        assert sess.ladder is not None and sess.ladder['idx'] >= 1
        await a.send({'type': 'pause'})
        for _ in range(100):
            if not sess.running:
                break
            await asyncio.sleep(0.1)
        await a.ws.close()
        return a.cookie, sess.ladder['rungs'], sess.i

    async def second_life(client, tier, cookie, rungs, i_before):
        sess = tier.sessions[cookie]
        assert sess.ladder is not None, 'pooled ladder not restored'
        assert sess.ladder['rungs'] == rungs
        assert sess.i == i_before and not sess.running
        a = WSSession(client)
        a.cookie = cookie
        a.ws = await client.ws_connect('/websocket', headers=a._headers())
        await a.send({'type': 'start'})
        # The climb resumes and ends in the target bucket.
        for _ in range(1500):
            if sess.ladder is None and max(sess.bucket_hw) == rungs[-1]:
                break
            await asyncio.sleep(0.2)
        assert sess.ladder is None
        assert max(sess.bucket_hw) == rungs[-1]
        assert sess.i > i_before
        await a.ws.close()

    _two_lives(config, first_life, second_life)


def test_pool_restart_resumes_polish_tail(tmp_path):
    """A pooled redeploy mid-polish: the session restores into the
    (grid, polish-precision) bucket with the tail's remaining budget,
    resumes stepping, completes, and pauses."""
    config = _config(initial_size=32, pool_sizes='24 32', serve_ladder=2,
                     precision='bfloat16', serve_polish=200,
                     polish_precision='float32',
                     pool_persist_dir=tmp_path / 'pool',
                     persist_interval=3600)

    async def first_life(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        sess = next(iter(tier.sessions.values()))
        await a.send({'type': 'start'})
        # Ladder 24 -> 32, then the cross-precision migration lands.
        for _ in range(1500):
            if (sess.precision == 'float32' and sess.polish is not None
                    and sess.polish.get('until_i') is not None):
                break
            await asyncio.sleep(0.2)
        assert sess.precision == 'float32'
        assert sess.polish is not None
        await a.ws.close()
        return a.cookie, sess.i, tuple(sess.bucket_hw)

    async def second_life(client, tier, cookie, i_before, hw):
        sess = tier.sessions[cookie]
        assert sess.precision == 'float32'
        assert tuple(sess.bucket_hw) == hw
        assert sess.polish is not None, 'polish tail not restored'
        assert tier.engine_of(sess).precision == 'float32'
        assert sess.i == i_before
        # The running tail resumes, spends its remaining budget, pauses.
        a = WSSession(client)
        a.cookie = cookie
        a.ws = await client.ws_connect('/websocket', headers=a._headers())
        for _ in range(1500):
            if sess.polish is None and not sess.running:
                break
            await asyncio.sleep(0.2)
        assert sess.polish is None
        assert not sess.running
        assert sess.precision == 'float32'
        assert sess.i > i_before
        await a.ws.close()

    _two_lives(config, first_life, second_life)


# -- The port's own ------------------------------------------------------------

def test_every_device_call_runs_on_the_executor_thread(tmp_path,
                                                       monkeypatch):
    """Bucket creation at startup, a restore's bucket and add_job, lane
    work and migrations all run on the tier's one executor thread (grad
    mode and the current CUDA stream are per thread): two lives of a
    pool, the second restoring the first's session mid-ladder."""
    threads = []
    names = ('__init__', 'add_job', 'begin_steps_all', 'collect_steps_all',
             'lane_image', 'lane_state', 'lane_norms', 'norms_host',
             'set_lane_weights', 'set_step_size', 'remove_job')
    for name in names:
        real = getattr(BatchedStyleTransfer, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            threads.append((_name, threading.current_thread().name))
            return _real(*args, **kwargs)
        monkeypatch.setattr(BatchedStyleTransfer, name, spy)

    config = _config(initial_size=48, pool_sizes='24 32 48', serve_ladder=3,
                     pool_persist_dir=tmp_path / 'pool',
                     persist_interval=3600)

    async def first_life(client, tier):
        a = await WSSession(client).open()
        await a.recv_until('state')
        sess = next(iter(tier.sessions.values()))
        await a.send({'type': 'start'})
        while sess.ladder is None or sess.ladder['idx'] < 1:
            await asyncio.sleep(0.05)
        await a.send({'type': 'pause'})
        while sess.running:
            await asyncio.sleep(0.05)
        await a.ws.close()
        return (a.cookie,)

    async def second_life(client, tier, cookie):
        assert cookie in tier.sessions
        a = WSSession(client)
        a.cookie = cookie
        a.ws = await client.ws_connect('/websocket', headers=a._headers())
        await a.send({'type': 'start'})
        await a.recv_until('iterateInfo')
        await a.ws.close()

    _two_lives(config, first_life, second_life)
    called = {name for name, _ in threads}
    assert {'__init__', 'add_job', 'begin_steps_all', 'lane_state',
            'lane_norms', 'norms_host', 'remove_job'} <= called
    assert all(t.startswith('pool-driver') for _, t in threads), threads


def _start(config):
    async def body():
        server = TestServer(port_pool.init(config=config))
        try:
            await server.start_server()
        finally:
            await server.close()
    asyncio.run(asyncio.wait_for(body(), 120))


def test_default_device_needs_cuda():
    """Without CUDA the default device fails at startup, before any bucket
    is built; platform = cpu (a JAX key) does not move the port."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    config = _config(platform='cpu')
    config.parser.remove_option('DEFAULT', 'device')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        _start(config)


def test_module_entry_point_needs_cuda_or_device_cpu(tmp_path):
    """python -m style_transfer2_tpu_torch.serve.pool with a config that
    leaves `device` at its default exits at startup without CUDA."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    ini = tmp_path / 'pool.ini'
    ini.write_text('[DEFAULT]\nweights = random\ninitial_size = 24\n'
                   'http_host = 127.0.0.1\nhttp_port = 0\n')
    proc = subprocess.run(
        [sys.executable, '-m', 'style_transfer2_tpu_torch.serve.pool',
         str(ini)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert 'CUDA is not available' in proc.stdout + proc.stderr


# -- Parity with the JAX pool ----------------------------------------------------

def _jax_init(config):
    from style_transfer2_tpu.serve import pool as jax_pool
    config = dict(config)
    config.pop('device')
    return jax_pool.init(config=_section(config))


def _section(mapping):
    import configparser
    cp = configparser.ConfigParser()
    cp['DEFAULT'] = mapping
    return cp['DEFAULT']


def _pause_at(tier, stop):
    """Pauses a session's lane inside the tick that brings it to iterate
    stop[0], so both tiers run exactly that many iterates whatever the
    timing (the browser's pause would land after a variable number)."""
    real = tier._phase_tick

    def tick(sess):
        real(sess)
        if sess.i >= stop[0]:
            tier.engine_of(sess).set_running(sess.lane, False)
    tier._phase_tick = tick


async def _traces_script(client, tier):
    """Uploads a seeded input at the bucket's grid, runs 5 iterates, resizes
    from 32 to 48 (a warm migration), runs 3 more; returns {i: trace}."""
    stop = [5]
    _pause_at(tier, stop)
    a = await WSSession(client).open()
    await a.recv_until('state')
    h, w = tier.default_hw
    resp = await client.post('/upload', data={
        'size': '32', 'slot': 'input', 'data': _data_url((h, w), 21)},
        headers=a._headers())
    assert resp.status == 200
    traces = {}

    async def run_to(n):
        stop[0] = n
        await a.send({'type': 'start'})
        while max(traces, default=0) < n:
            info = await a.recv_until('iterateInfo')
            a.got.pop('iterateInfo')
            traces[info['i']] = info['trace']

    await run_to(5)
    params = yaml.safe_load(a.got['newParams']['params'])
    params['size'] = 48
    a.got.pop('newParams')
    await a.send({'type': 'applyParams', 'params': yaml.safe_dump(params)})
    assert (await a.recv_until('newParams'))['errorString'] == ''
    sess = next(iter(tier.sessions.values()))
    assert max(sess.bucket_hw) == 48 and sess.i == 5
    await run_to(8)
    await a.ws.close()
    return traces


def test_pool_traces_match_jax():
    """The same seeded input in one session of each tier: the first 5
    iterates' traces agree within rtol 5e-3, and still do for 3 iterates
    after a warm resize from 32 to 48."""
    ours = _run_tier(port_pool.init, _config(), _traces_script)
    theirs = _run_tier(_jax_init, _config(), _traces_script)
    assert sorted(ours) == sorted(theirs) == list(range(1, 9))
    for i in range(1, 9):
        assert set(ours[i]) == set(theirs[i]), i
        for key, value in theirs[i].items():
            np.testing.assert_allclose(ours[i][key], value, rtol=5e-3,
                                       err_msg='iterate %d %s' % (i, key))
    assert ours[8]['loss'] < ours[1]['loss']


async def _browser_script(client, tier):
    """One browser session: greet, start, pause, a weight and step-size
    change, a content upload, a resize, reset, start, pause. Returns each
    frame's (type, its keys, its trace's keys), runs of equal entries
    collapsed (how many iterateInfo frames arrive before a pause depends
    on timing)."""
    a = WSSession(client)
    resp = await client.get('/')
    assert resp.status == 200
    a.cookie = resp.cookies['pool_session'].value
    a.ws = await client.ws_connect('/websocket', headers=a._headers())
    seen = []

    async def until(kind, n=1):
        while n:
            msg = await asyncio.wait_for(a.ws.receive(), 240)
            data = json.loads(msg.data)
            seen.append((data['type'], tuple(sorted(data)),
                         tuple(sorted(data.get('trace', ())))))
            if data['type'] == kind:
                n -= 1
        return data

    await until('thumbnails')
    params = yaml.safe_load(
        next(iter(tier.sessions.values())).params_yaml())
    await a.send({'type': 'start'})
    await until('iterateInfo', 3)
    await a.send({'type': 'pause'})
    while (await until('state'))['running']:
        pass
    params['weights'][0]['style']['conv2_1'] = 2.0
    params['optimizer_step_size'] = 5
    await a.send({'type': 'applyParams', 'params': yaml.safe_dump(params)})
    await until('newParams')
    resp = await client.post('/upload', data={
        'size': '32', 'slot': 'content', 'data': _data_url((40, 40), 3)},
        headers=a._headers())
    assert resp.status == 200
    await until('thumbnails')
    params['size'] = 48
    await a.send({'type': 'applyParams', 'params': yaml.safe_dump(params)})
    await until('newParams')
    await a.send({'type': 'reset'})
    await a.send({'type': 'start'})
    await until('iterateInfo', 2)
    await a.send({'type': 'pause'})
    while (await until('state'))['running']:
        pass
    await a.ws.close()
    return [e for i, e in enumerate(seen) if i == 0 or e != seen[i - 1]]


def test_pool_protocol_parity_with_jax():
    """The port's pool and the JAX pool, given one browser script, send the
    same sequence of WebSocket message types with the same keys in each
    (iterateInfo's trace keys included)."""
    ours = _run_tier(port_pool.init, _config(), _browser_script)
    theirs = _run_tier(_jax_init, _config(), _browser_script)
    assert [e[0] for e in ours] == [e[0] for e in theirs]
    assert ours == theirs
    assert {e[0] for e in ours} == {'workerReady', 'newParams', 'newSize',
                                    'state', 'thumbnails', 'iterateInfo'}


def _snapshot_config(tmp_path):
    # 20 iterations a rung: the pause after iterate 3 lands well inside
    # the first rung, so no rung advance is in flight at the snapshot.
    return _config(initial_size=48, pool_sizes='24 32 48', serve_ladder=20,
                   pool_persist_dir=tmp_path / 'pool', persist_interval=3600)


async def _write_snapshot(client, tier):
    """A session 3 iterates into its ladder's first rung, paused."""
    a = await WSSession(client).open()
    await a.recv_until('state')
    sess = next(iter(tier.sessions.values()))
    await a.send({'type': 'start'})
    info = await a.recv_until('iterateInfo')
    while info['i'] < 3:
        a.got.pop('iterateInfo')
        info = await a.recv_until('iterateInfo')
    await a.send({'type': 'pause'})
    while (await a.recv_until('state'))['running']:
        a.got.pop('state')
    await a.ws.close()
    return (a.cookie, sess.i, tuple(sess.bucket_hw), sess.precision,
            sess.ladder['rungs'], sess.params)


def _restore_snapshot(written):
    cookie, i, hw, precision, rungs, params = written

    async def body(client, tier):
        sess = tier.sessions[cookie]
        assert (sess.i, tuple(sess.bucket_hw), sess.precision) == (
            i, hw, precision)
        assert sess.ladder is not None and sess.ladder['rungs'] == rungs
        # The restore puts the session's bucket size in its params.
        assert sess.params == dict(params, size=max(hw))
        assert not sess.running
        assert tier.engine_of(sess).active[sess.lane]
        a = WSSession(client)
        a.cookie = cookie
        a.ws = await client.ws_connect('/websocket', headers=a._headers())
        await a.send({'type': 'start'})
        info = await a.recv_until('iterateInfo')
        assert info['i'] == i + 1 and np.isfinite(info['trace']['loss'])
        await a.send({'type': 'pause'})
        while (await a.recv_until('state'))['running']:
            a.got.pop('state')
        await a.ws.close()
    return body


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_pool_snapshots_restore_across_packages(tmp_path, writer, reader):
    """A pool snapshot (a session paused mid-ladder) that one package's
    pool writes restores in the other's: the same cookie lands on the same
    iterate, bucket, precision, schedule and params, and steps on; the
    reader's snapshot of it holds the same npz keys."""
    inits = {'jax': _jax_init, 'port': port_pool.init}
    config = _snapshot_config(tmp_path)
    written = _run_tier(inits[writer], config, _write_snapshot)
    path = tmp_path / 'pool' / (written[0] + '.npz')
    with np.load(path) as data:
        keys = set(data.files)
    assert {'pool_bucket_hw', 'pool_precision', 'pool_phase_yaml'} <= keys
    _run_tier(inits[reader], config, _restore_snapshot(written))
    with np.load(path) as data:
        assert set(data.files) == keys
        assert int(data['i']) > written[1]   # the reader's own write
