"""Fused style-loss branch: Gram, Gram difference and style half-gradient.

Counterpart of style_transfer2_tpu/ops/pallas/style_kernel.py:
fused_style_branch. For an NHWC feature map X (M = h*w rows of C channels)
and a target Gram G_style:

    G_diff = X^T X / size - G_style                   size = M*C
    s_grad = X G_diff * 2 / (C^2 * size)

On a CUDA tensor the wrapper launches the kernels in csrc/style.cu (split-M
Gram partials, a fixed-order reduction with the G_diff epilogue, and the
gradient product; float32, never TF32). On a CPU tensor it runs
fused_style_branch_plain, two matmuls. Any other device raises. The outputs
are injected as vjp cotangents and never differentiated through.
"""

import torch

from .. import _build

# Launches of the kernel through fused_style_branch (chip_smoke.py resets
# and reads this).
launches = 0

_TILE = 64          # output tile edge of the Gram kernel
_ROW_STEP = 16      # M-chunks are multiples of the kernel's staging depth
_TARGET_BLOCKS = 264  # two waves of blocks on a 132-SM card


def fused_style_branch_plain(feat, gram_style):
    """The plain version: (s_grad (1, h, w, c), gram_diff (c, c))."""
    _, h, w, c = feat.shape
    size = h * w * c
    flat = feat.reshape(h * w, c).float()
    gram_diff = flat.T @ flat / size - gram_style.float()
    s_grad = flat @ gram_diff * (2.0 / (float(c) * float(c) * float(size)))
    return s_grad.reshape(1, h, w, c), gram_diff


def _chunking(m, c):
    """(chunk, n_chunks) for the split-M Gram: enough M-chunks that the
    (tiles x tiles x chunks) grid fills the card about twice."""
    tiles = -(-c // _TILE)
    n_chunks = max(1, min(-(-_TARGET_BLOCKS // (tiles * tiles)),
                          -(-m // _ROW_STEP)))
    chunk = -(-m // n_chunks)
    chunk = -(-chunk // _ROW_STEP) * _ROW_STEP
    return chunk, -(-m // chunk)


def _launch(feat, gram_style):
    global launches
    if feat.dim() != 4 or feat.shape[0] != 1:
        raise ValueError('fused_style_branch: expected (1, h, w, c), got %s'
                         % (tuple(feat.shape),))
    _, h, w, c = feat.shape
    if gram_style.shape != (c, c) or gram_style.device != feat.device:
        raise ValueError('fused_style_branch: gram_style must be (c, c) on '
                         'the feature map\'s device')
    if feat.dtype != torch.float32 or gram_style.dtype != torch.float32:
        raise TypeError('fused_style_branch: the kernel takes float32')
    m = h * w
    size = m * c
    x = feat.reshape(m, c).contiguous()
    gs = gram_style.contiguous()
    chunk, n_chunks = _chunking(m, c)
    partials = torch.empty((n_chunks, c, c), dtype=torch.float32,
                           device=feat.device)
    gdiff = torch.empty((c, c), dtype=torch.float32, device=feat.device)
    sgrad = torch.empty((m, c), dtype=torch.float32, device=feat.device)
    err = _build.lib().st2_style_branch(
        x.data_ptr(), gs.data_ptr(), partials.data_ptr(), gdiff.data_ptr(),
        sgrad.data_ptr(), m, c, chunk, n_chunks, 1.0 / float(size),
        2.0 / (float(c) * float(c) * float(size)),
        torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(err, 'st2_style_branch')
    launches += 1
    return sgrad.reshape(1, h, w, c), gdiff


def fused_style_branch(feat, gram_style):
    """(s_grad, gram_diff) for a (1, h, w, c) float32 feature map and its
    (c, c) target Gram. Launches the CUDA kernels for a CUDA feat; the
    plain version for a CPU feat."""
    if feat.is_cuda:
        return _launch(feat, gram_style)
    if feat.device.type == 'cpu':
        return fused_style_branch_plain(feat, gram_style)
    raise RuntimeError('fused_style_branch: no kernel for device %s'
                       % feat.device)
