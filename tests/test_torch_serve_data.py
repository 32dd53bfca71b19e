"""The port's serving data and host helpers against the JAX package's: the
session snapshot file read both ways, the phase schedule, the message
dataclasses, the templates and static files byte for byte, the utils the
tier calls; and that the port's app keeps jax out of the process."""

import filecmp
import json
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from style_transfer2_tpu import utils as jax_utils
from style_transfer2_tpu.serve import messages as jm
from style_transfer2_tpu.serve import persist as jpersist
from style_transfer2_tpu.serve import phases as jphases
from style_transfer2_tpu.serve import session as jsn
from style_transfer2_tpu_torch import utils
from style_transfer2_tpu_torch.serve import messages as m
from style_transfer2_tpu_torch.serve import persist, phases
from style_transfer2_tpu_torch.serve import session as sn

ROOT = Path(__file__).resolve().parents[1]
JAX_SERVE = ROOT / 'style_transfer2_tpu' / 'serve'
PORT_SERVE = ROOT / 'style_transfer2_tpu_torch' / 'serve'

# Session fields a snapshot holds (persist.snapshot).
FIELDS = ('i', 'running', 'input_was_reset', 'params', 'style_size',
          'norms')


def _populated(session_mod, seed=0):
    rng = np.random.RandomState(seed)
    sess = session_mod.Session()
    sess.i = 37
    sess.running = True
    sess.input_arr = rng.uniform(-20, 300, (24, 32, 3)).astype(np.float32)
    sess.set_slot_image('content', Image.fromarray(
        rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)))
    sess.set_slot_image('style', Image.fromarray(
        rng.randint(0, 256, (30, 30, 3)).astype(np.uint8)))
    sess.style_size = '128'
    sess.params = {'size': 32, 'optimizer': 'adam',
                   'optimizer_step_size': 5, 'ladder': 20,
                   'weights': [{'content': {'conv2_2': 0.1},
                                'style': {'conv1_1': 1.0},
                                'deepdream': {}},
                               {'p': 50.0, 'p_power': 6.0,
                                'tv': 5.0, 'tv_power': 2.0}]}
    sess.norms = ({'conv1_1:s': 0.25, 'conv2_2:c': 1.5},
                  {'conv1_1:s': True, 'conv2_2:c': False})
    return sess


@pytest.mark.parametrize('writer,reader', [
    ((jpersist, jsn), (persist, sn)),
    ((persist, sn), (jpersist, jsn)),
], ids=['jax_to_port', 'port_to_jax'])
def test_snapshot_loads_across_packages(tmp_path, writer, reader):
    """A snapshot either package's save_session writes loads through the
    other's load_session to equal Session fields, images and the tier's
    extra entries."""
    (save_mod, wsn), (load_mod, rsn) = writer, reader
    path = tmp_path / 'session.npz'
    src = _populated(wsn)
    save_mod.save_session(path, src,
                          extra={'app_phase_yaml': np.str_('ladder: {}\n')})
    dst = rsn.Session()
    extra = {}
    assert load_mod.load_session(path, dst, extra)
    for name in FIELDS:
        assert getattr(dst, name) == getattr(src, name), name
    np.testing.assert_array_equal(dst.input_arr, src.input_arr)
    for slot in ('content', 'style'):
        np.testing.assert_array_equal(
            np.asarray(getattr(dst, slot + '_image')),
            np.asarray(getattr(src, slot + '_image')))
    assert str(extra['app_phase_yaml']) == 'ladder: {}\n'
    assert load_mod.signature(dst)[:-1] == save_mod.signature(src)[:-1]


def _events(mod):
    """One event sequence through a Schedule: a 3-rung ladder with one
    restore mid-rung, a polish tail, a retry of a failed advance."""
    sched = mod.Schedule([(96, 128), (136, 181), (192, 256)], 20, 10)
    out = [sched.begin()]
    i = 0
    for step in range(200):
        i += 1
        action = sched.tick(i)
        out.append(action)
        if action is not None and action[0] in ('advance', 'polish'):
            if step == 30:
                out.append(sched.transition_failed(i))
            else:
                sched.transition_done(i + 2)
        if step == 50:
            state = sched.state(i, awaiting=(136, 181))
            out.append(state)
            sched = mod.Schedule.restore_ladder(yaml.safe_load(
                yaml.safe_dump(state['ladder'])), 10)
            sched.transition_done(i)
        out.append((sched.phase, sched.idx, sched.next_at,
                    sched.in_transition, sched.remaining(i)))
    tail = mod.Schedule.restore_polish({'remaining': 4}, 4)
    tail.transition_done(0)
    out.extend([tail.state(1), tail.tick(3), tail.tick(4), tail.phase])
    return out


def test_schedule_matches_jax():
    """The port's phases.Schedule and the JAX one give the same actions,
    states and persisted dicts for one event sequence."""
    ours, theirs = _events(phases), _events(jphases)
    assert ours == theirs
    assert ('polish', 10) in ours and ('pause',) in ours


def test_messages_match_jax():
    """The same dataclasses with the same fields and defaults, so that the
    two apps speak one protocol."""
    names = sorted(n for n, v in vars(jm).items()
                   if isinstance(v, type) and issubclass(v, jm.Message))
    assert sorted(n for n, v in vars(m).items()
                  if isinstance(v, type) and issubclass(v, m.Message)) == names
    for name in names:
        ours, theirs = getattr(m, name), getattr(jm, name)
        if name == 'Message':
            continue
        assert ([(f.name, f.default) for f in fields(ours)]
                == [(f.name, f.default) for f in fields(theirs)]), name
    assert m.SetImages.RESAMPLE == jm.SetImages.RESAMPLE
    assert m.SetOptimizer.step_sizes == jm.SetOptimizer.step_sizes
    assert m.SetOptimizer('adam').step_size == 10


@pytest.mark.parametrize('rel', [
    'templates/base.html', 'templates/error.html', 'templates/index.html',
    'templates/stats.html', 'static/app.js', 'static/main.css'])
def test_templates_and_static_equal_jax(rel):
    assert filecmp.cmp(PORT_SERVE / rel, JAX_SERVE / rel, shallow=False)


def test_template_and_static_trees_match():
    for sub in ('templates', 'static'):
        assert (sorted(p.name for p in (PORT_SERVE / sub).iterdir())
                == sorted(p.name for p in (JAX_SERVE / sub).iterdir()))


def test_session_helpers_match_jax():
    """The applyParams validation and error strings, and the rate EWMA."""
    layers = ['data', 'conv1_1', 'conv2_2']
    doc = [{'content': {'conv2_2': 1}, 'style': {'conv1_1': 2},
            'deepdream': {}}, {'p': 1, 'p_power': 2, 'tv': 3,
                               'tv_power': 4}]
    assert (sn.validate_weights_doc(doc, layers)
            == jsn.validate_weights_doc(doc, layers))
    bad = [dict(doc[0], content={'nope': 1}), doc[1]]
    for err_doc in (bad, [doc[0], {}]):
        errors = []
        for mod in (sn, jsn):
            try:
                mod.validate_weights_doc(err_doc, layers)
            except (KeyError, ValueError) as err:
                errors.append(mod.params_error_string(err))
        assert len(errors) == 2 and errors[0] == errors[1]
    assert sn.PRECISION_RANK == jsn.PRECISION_RANK
    ours, theirs = utils.DecayingMean(), jax_utils.DecayingMean()
    for v in (3.0, 5.0, None, 11.0):
        assert ours(v) == theirs(v)
    ours.clear()
    theirs.clear()
    assert ours() == theirs() == 0


def test_resample_hwc_matches_jax():
    """The port resamples with PIL's Lanczos. The JAX function uses its
    native resampler where that library is built: held to PIL within
    tests/test_native.py's atol 0.05 (rtol 1e-4); PIL on both sides agrees
    exactly."""
    rng = np.random.RandomState(0)
    img = rng.uniform(-20, 280, (40, 56, 3)).astype(np.float32)
    for hw in ((20, 28), (57, 77), (31, 31)):
        ours = utils.resample_hwc(img, hw)
        theirs = jax_utils.resample_hwc(img, hw)
        assert ours.shape == hw + (3,) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, theirs, atol=0.05, rtol=1e-4)
    u8 = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    np.testing.assert_allclose(utils.resample_hwc(u8, (36, 48)),
                               jax_utils.resample_hwc(u8, (36, 48)),
                               atol=0.05, rtol=1e-4)


def test_config_matches_jax(tmp_path):
    """parse_args and read_config: the same layered [DEFAULT] section."""
    extra = tmp_path / 'extra.ini'
    extra.write_text('[DEFAULT]\ninitial_size = 77\ndevice = cpu\n')
    argv = [str(extra), '-dd']
    ours = utils.parse_args('x', argv)
    theirs = jax_utils.parse_args('x', argv)
    assert vars(ours) == vars(theirs) == {'config': str(extra), 'debug': 2}
    assert (dict(utils.read_config(ours))
            == dict(jax_utils.read_config(theirs)))
    assert utils.read_config(ours).getint('initial_size') == 77


def test_serve_app_imports_no_jax():
    """A fresh interpreter that imports the port's serving tier, builds its
    app with init(config) and starts it on the CPU has neither jax nor the
    JAX package in sys.modules."""
    code = (
        'import asyncio, configparser, json, sys\n'
        'from aiohttp.test_utils import TestServer\n'
        'from style_transfer2_tpu_torch.serve import app\n'
        'import style_transfer2_tpu_torch.serve.driver, '
        'style_transfer2_tpu_torch.serve.persist, '
        'style_transfer2_tpu_torch.serve.phases\n'
        'import style_transfer2_tpu_torch.engine.batched, '
        'style_transfer2_tpu_torch.parallel.batch\n'
        'cp = configparser.ConfigParser()\n'
        'cp.read("config.ini")\n'
        'config = cp["DEFAULT"]\n'
        'config.update(device="cpu", weights="random", initial_size="24",\n'
        '              http_port="0")\n'
        'async def main():\n'
        '    server = TestServer(app.init(config=config))\n'
        '    await server.start_server()\n'
        '    await server.close()\n'
        'asyncio.run(main())\n'
        'print(json.dumps(sorted(m for m in sys.modules\n'
        '    if m.split(".")[0] in\n'
        '    ("jax", "jaxlib", "style_transfer2_tpu"))))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
