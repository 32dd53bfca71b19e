"""Optimizers with the reference's semantics, over tensor-dict states."""

from . import adam, lbfgs

OPTIMIZERS = {'adam': adam, 'lbfgs': lbfgs}

# Default step sizes per optimizer (reference messages.py:119).
STEP_SIZES = {'adam': 10.0, 'lbfgs': 1.0}

__all__ = ['adam', 'lbfgs', 'OPTIMIZERS', 'STEP_SIZES']
