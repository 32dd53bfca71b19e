"""Process-wide logging, exception and signal setup
(style_transfer2_tpu/utils/logging.py; reference utils.py:163-190)."""

import logging
import signal
import sys


def setup_exceptions(mode='Plain', color_scheme='Neutral'):
    """Uses IPython's ultratb for readable tracebacks when available."""
    try:
        from IPython.core import ultratb
        sys.excepthook = ultratb.AutoFormattedTB(mode=mode,
                                                 color_scheme=color_scheme)
    except Exception:
        pass


def setup_logging(debug=0):
    """Configures logging with the PID in the format; DEBUG at -d, aiohttp
    access logs from debug 2, and every driver message logged from debug 2
    (reference utils.py:172-185)."""
    fmt = ('%(asctime)s.%(msecs)03d %(process)d %(name)s %(levelname)s: '
           '%(message)s')
    level = logging.DEBUG if debug else logging.INFO
    logging.basicConfig(level=level, format=fmt, datefmt='%H:%M:%S')
    if debug <= 1:
        logging.getLogger('aiohttp.access').setLevel(logging.WARNING)
    else:
        from ..serve import messages
        messages.Message.debug = True
    logging.captureWarnings(True)


def setup_signals():
    """Makes SIGHUP raise KeyboardInterrupt, for a clean shutdown when the
    terminal hangs up."""
    def handler(*args):
        raise KeyboardInterrupt()
    try:
        signal.signal(signal.SIGHUP, handler)
    except (ValueError, OSError):
        pass  # not the main thread, or unsupported platform
