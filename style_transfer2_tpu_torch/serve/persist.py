"""Session persistence for the serving tiers: a copy of
style_transfer2_tpu/serve/persist.py, in its file format, so that a snapshot
either package writes loads in the other.

The reference keeps session state only in the app process: when app.py
dies, the user's images, iterate, and parameters die with it — only a
WORKER crash is survivable, because the app re-feeds the live iterate
(reference app.py:336-344, worker.py:399-401). This rebuild's tiers
already treat the engine as rebuildable from host state ("state above,
compute below"): the GetImages handshake reconstructs the whole device
side from the Session. Surviving a full process restart therefore only
requires snapshotting the host Session — on boot the normal handshake
rebuilds the engine from the restored state, and the restart costs only
optimizer momentum, the same contract as a worker restart.

Format: one .npz written atomically (tmp + os.replace, same directory so
the rename never crosses filesystems). Arrays are stored natively; the
params document travels as YAML; PIL originals round-trip as uint8 HWC
arrays. A missing, truncated, or future-versioned file restores nothing
and the tier falls back to its defaults — persistence must never be able
to take the service down.
"""

import logging
import os

import numpy as np
from PIL import Image
import yaml

logger = logging.getLogger('persist')

SCHEMA_VERSION = 1

# Session fields snapshotted as-is (arrays or scalars).
_ARRAY_FIELDS = ('input_arr',)
_IMAGE_SLOTS = ('content', 'style')


def signature(sess):
    """A cheap change detector over everything snapshot() would save, so
    the periodic persist loop skips writes while the session is idle.
    The iterate counter covers running sessions; the checksum covers
    pause-time mutations (uploads, reset) that don't advance it."""
    arr = sess.input_arr
    arr_sig = None
    if arr is not None:
        arr_sig = (arr.shape, str(arr.dtype), float(np.sum(arr, dtype=np.float64)))
    return (sess.i, sess.running, yaml.safe_dump(sess.params),
            str(sess.style_size), sess.input_was_reset, arr_sig,
            sess.norms is not None,   # write-once per reset epoch
            tuple(id(getattr(sess, slot + '_image')) for slot in _IMAGE_SLOTS))


def snapshot(sess):
    """Collects the Session's host state into a flat dict of npz-able
    values. None-valued fields are simply absent (restore tolerates)."""
    data = {'version': np.int64(SCHEMA_VERSION),
            'i': np.int64(sess.i),
            'running': np.bool_(sess.running),
            'input_was_reset': np.bool_(sess.input_was_reset),
            'params_yaml': np.str_(yaml.safe_dump(sess.params)),
            'style_size': np.str_('' if sess.style_size is None
                                  else str(sess.style_size))}
    if sess.input_arr is not None:
        data['input_arr'] = np.asarray(sess.input_arr)
    if sess.norms is not None:
        # First-eval norm state (host floats/bools): a restored session
        # keeps optimizing the objective its norms were anchored at.
        data['norms_yaml'] = np.str_(yaml.safe_dump(
            {'vals': sess.norms[0], 'set': sess.norms[1]}))
    for slot in _IMAGE_SLOTS:
        image = getattr(sess, slot + '_image')
        if image is not None:
            data[slot + '_image'] = np.asarray(image.convert('RGB'))
    return data


def save_session(path, sess, extra=None):
    """Atomically writes the session snapshot to `path`. `extra` adds
    tier-specific npz entries (e.g. the pooled tier's bucket grid);
    load_session ignores keys it doesn't know."""
    data = snapshot(sess)
    if extra:
        data.update(extra)
    tmp = str(path) + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **data)
    os.replace(tmp, str(path))
    logger.debug('session persisted to %s (iterate %d)', path, sess.i)


_KNOWN_KEYS = frozenset(('version', 'i', 'running', 'input_was_reset',
                         'params_yaml', 'style_size', 'input_arr',
                         'content_image', 'style_image', 'norms_yaml'))


def load_session(path, sess, extra=None):
    """Restores a snapshot into `sess` (which should already hold the
    tier's defaults). Returns True on success; on any failure the session
    is left as it was and False is returned. If `extra` is a dict, any
    tier-specific entries the snapshot carries beyond the session fields
    (the save_session `extra` channel) are copied into it."""
    try:
        with np.load(str(path), allow_pickle=False) as data:
            version = int(data['version'])
            if version > SCHEMA_VERSION:
                logger.warning('%s: snapshot schema v%d is newer than this '
                               'build (v%d); ignoring', path, version,
                               SCHEMA_VERSION)
                return False
            fields = {}
            fields['i'] = int(data['i'])
            fields['running'] = bool(data['running'])
            fields['input_was_reset'] = bool(data['input_was_reset'])
            fields['params'] = yaml.safe_load(str(data['params_yaml']))
            style_size = str(data['style_size'])
            fields['style_size'] = style_size if style_size else None
            fields['input_arr'] = (np.array(data['input_arr'])
                                   if 'input_arr' in data else None)
            fields['norms'] = None
            if 'norms_yaml' in data:
                doc = yaml.safe_load(str(data['norms_yaml']))
                fields['norms'] = (
                    {str(k): float(v) for k, v in doc['vals'].items()},
                    {str(k): bool(v) for k, v in doc['set'].items()})
            images = {}
            for slot in _IMAGE_SLOTS:
                key = slot + '_image'
                if key in data:
                    images[slot] = Image.fromarray(np.array(data[key]))
            extras = {}
            if extra is not None:
                for key in data.files:
                    if key not in _KNOWN_KEYS:
                        extras[key] = np.array(data[key])
    except FileNotFoundError:
        return False
    except Exception as err:
        logger.warning('%s: unreadable session snapshot (%r); starting '
                       'from defaults', path, err)
        return False
    for name, value in fields.items():
        setattr(sess, name, value)
    for slot, image in images.items():
        sess.set_slot_image(slot, image)
    if extra is not None:
        extra.update(extras)
    logger.info('session restored from %s (iterate %d, running=%s)',
                path, sess.i, sess.running)
    return True
