"""Ops: the hand-written CUDA kernels' wrappers (conv, style, image) beside
their plain PyTorch versions, Gram matrices, the input-domain losses and
resampling."""

from .conv import conv3x3_bias_relu, conv3x3_bias_relu_plain
from .gram import gram_matrix
from .image import (deprocess, deprocess_plain, preprocess,
                    preprocess_plain)
from .losses import p_norm, tv_norm
from .resample import resize_nhwc
from .style import fused_style_branch, fused_style_branch_plain

__all__ = ['conv3x3_bias_relu', 'conv3x3_bias_relu_plain', 'gram_matrix',
           'deprocess', 'deprocess_plain', 'preprocess', 'preprocess_plain',
           'p_norm', 'tv_norm', 'resize_nhwc', 'fused_style_branch',
           'fused_style_branch_plain']
