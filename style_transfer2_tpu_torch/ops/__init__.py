"""Ops: the hand-written CUDA kernels' wrappers (conv, style) beside their
plain PyTorch versions, Gram matrices and the input-domain losses."""

from .conv import conv3x3_bias_relu, conv3x3_bias_relu_plain
from .gram import gram_matrix
from .losses import p_norm, tv_norm
from .style import fused_style_branch, fused_style_branch_plain

__all__ = ['conv3x3_bias_relu', 'conv3x3_bias_relu_plain', 'gram_matrix',
           'p_norm', 'tv_norm', 'fused_style_branch',
           'fused_style_branch_plain']
