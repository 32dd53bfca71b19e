"""The objective, the optimization steps and the StyleTransfer state
machine."""

from .objective import ObjectiveSpec, make_objective
from .steps import apply_precision, build_step_core, precision_config
from .transfer import StyleTransfer, resolve_device

__all__ = ['ObjectiveSpec', 'make_objective', 'apply_precision',
           'build_step_core', 'precision_config', 'StyleTransfer',
           'resolve_device']
