"""Message types exchanged between the web app and the driver: a copy of
style_transfer2_tpu/serve/messages.py, so that the two apps speak one
protocol.

Mirrors the reference protocol (messages.py: 11 pickled classes over
ZeroMQ) as plain dataclasses over in-process asyncio queues — the
cross-process API becomes a cross-task API with identical semantics,
including the SetImages RESAMPLE sentinel and the GetImages re-request
handshake. Router control messages (AppUp/AppDown) travel as HTTP/JSON
(serve/router.py) and exist here only as dataclasses for symmetry/tests.
"""

from dataclasses import dataclass, field
from typing import Any, Optional


import logging

logger = logging.getLogger(__name__)


class Message:
    """Base class for driver/app messages. Set Message.debug = True (done at
    debug level >= 2, like the reference messages.py:27-35 / utils.py:183)
    to log every message creation."""

    debug = False

    def __post_init__(self):
        if Message.debug:
            logger.debug('%s created: %r', type(self).__name__, self)

    def __repr__(self):
        def short(v):
            if hasattr(v, 'shape') and hasattr(v, 'dtype'):
                return '<array, shape: %s, dtype: %s>' % (v.shape, v.dtype)
            return repr(v)
        args = ['%s=%s' % (k, short(v)) for k, v in sorted(vars(self).items())]
        return type(self).__name__ + '(' + ', '.join(args) + ')'


@dataclass(repr=False)
class AppDown(Message):
    """App -> router: the app is shutting down."""
    addr: str
    app_id: str


@dataclass(repr=False)
class AppUp(Message):
    """App -> router: the app is up and serving (also the 5 s heartbeat)."""
    addr: str
    host: str
    port: int
    app_id: str


@dataclass(repr=False)
class GetImages(Message):
    """Driver -> app: iteration can't start because image slots are missing;
    please (re)send them (the bootstrap/crash-recovery handshake)."""


@dataclass(repr=False)
class Iterate(Message):
    """Driver -> app: a new iterate. image is HxWx3 float32 RGB; trace is
    the ordered dict of internal values; i counts iterates since start."""
    image: Any
    i: int
    trace: dict


@dataclass(repr=False)
class PauseIteration(Message):
    """App -> driver: pause iteration."""


@dataclass(repr=False)
class Prewarm(Message):
    """App -> driver: the JAX driver compiles the programs for these (H, W)
    grids in the background. The port has nothing to compile: its driver
    accepts the message and ignores it. Not a reference message."""
    grids: list = field(default_factory=list)


@dataclass(repr=False)
class Reset(Message):
    """Router -> app: reset all session state (new user assigned)."""


@dataclass(repr=False)
class SetImages(Message):
    """App -> driver: fill image slots. A slot set to None is left alone
    (unless consistency forces a zero-fill); the RESAMPLE sentinel asks the
    driver to warm-start-resample that slot to `size`. reset_state clears
    the optimizer and iterate count."""
    RESAMPLE = 1

    size: Optional[tuple] = None
    input_image: Any = None
    content_image: Any = None
    style_image: Any = None
    reset_state: bool = False
    # Seeds the engine's iterate counter after the slots apply: a respawned
    # driver re-fed mid-session state continues the user's numbering
    # instead of restarting at 1 (the pooled tier's add_job(t=...) analog;
    # reference restarts cost only optimizer momentum, app.py:336-344).
    t0: int = 0
    # Optional (vals, set) dict pair of host floats/bools: the session's
    # first-eval gradient-RMS norm state, re-seeded into a respawned
    # engine so it keeps optimizing the same normalized objective
    # (reference semantics: norms persist until reset, worker.py:137).
    # Ignored when reset_state is set.
    norms: Any = None


@dataclass(repr=False)
class SetOptimizer(Message):
    """App -> driver: select the optimizer and step size. Defaults per
    optimizer match the reference (messages.py:119)."""
    optimizer: str
    step_size: Optional[float] = None

    names = ('adam', 'lbfgs')
    step_sizes = {'adam': 10, 'lbfgs': 1}

    def __post_init__(self):
        if self.optimizer not in self.names:
            raise ValueError('Invalid optimizer type')
        if not self.step_size:
            self.step_size = self.step_sizes[self.optimizer]
        super().__post_init__()


@dataclass(repr=False)
class SetWeights(Message):
    """App -> driver: per-(layer, loss) weights plus input-layer scalar
    params (tv/tv_power/p/p_power)."""
    weights: dict
    params: dict

    loss_names = ('content', 'style', 'deepdream')
    scalar_loss_names = ('tv', 'tv_power', 'p', 'p_power')


@dataclass(repr=False)
class Shutdown(Message):
    """Signals the receiving task to shut down."""


@dataclass(repr=False)
class StartIteration(Message):
    """App -> driver: start iterating."""


@dataclass(repr=False)
class WorkerReady(Message):
    """Driver -> app: the driver is initialized; layers lists the model's
    blob names (the app validates user weight edits against it)."""
    layers: list = field(default_factory=list)
