"""The objective, the optimization steps and the StyleTransfer state
machine."""

from .checkpoint import load_checkpoint, save_checkpoint
from .objective import ObjectiveSpec, make_objective
from .steps import (build_scan_fn, build_step_core, precision_config,
                    precision_scope)
from .transfer import StepsDispatch, StyleTransfer, resolve_device

__all__ = ['load_checkpoint', 'save_checkpoint', 'ObjectiveSpec',
           'make_objective', 'build_scan_fn', 'build_step_core',
           'precision_config',
           'precision_scope', 'StepsDispatch', 'StyleTransfer',
           'resolve_device']
