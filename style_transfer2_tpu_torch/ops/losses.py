"""Input-domain losses with analytic gradients, reference-exact
(style_transfer2_tpu/ops/losses.py; reference utils.py:285-304).

The TV boundary is circular (the reference's roll wraps around) and its
1e-8 epsilon sits inside the power even at beta = 2. The gradients are the
reference's formulas, not autograd; the objective applies both losses to
x/255 and adds their gradients without the 1/255 chain factor. Layout is
NHWC: rolls act on dims 1 (height) and 2 (width), so no term mixes two
images of a batch. tv_norm and p_norm sum over the whole tensor (one
image); tv_norm_lanes and p_norm_lanes give one value per image, shape
(B,), for the batched engine's lanes.
"""

import torch

_IMAGE_DIMS = (1, 2, 3)


def _tv_terms(x, beta):
    """The per-element TV terms and the gradient."""
    half = float(beta) / 2
    x_diff = x - torch.roll(x, -1, dims=2)    # horizontal neighbour
    y_diff = x - torch.roll(x, -1, dims=1)    # vertical neighbour
    grad_norm2 = x_diff ** 2 + y_diff ** 2 + 1e-8
    dgrad_norm = half * grad_norm2 ** (half - 1)
    dx_diff = 2 * x_diff * dgrad_norm
    dy_diff = 2 * y_diff * dgrad_norm
    grad = dx_diff + dy_diff
    grad = grad - torch.roll(dx_diff, 1, dims=2)
    grad = grad - torch.roll(dy_diff, 1, dims=1)
    return grad_norm2 ** half, grad


def tv_norm(x, beta=2.0):
    """Total variation norm (circular boundary) and its gradient:
    norm = sum((dx^2 + dy^2 + 1e-8)^(beta/2))."""
    terms, grad = _tv_terms(x, beta)
    return torch.sum(terms), grad


def tv_norm_lanes(x, beta=2.0):
    """tv_norm of each image of an (B, H, W, C) batch: ((B,) norms, the
    gradient)."""
    terms, grad = _tv_terms(x, beta)
    return torch.sum(terms, dim=_IMAGE_DIMS), grad


def p_norm(x, p=2.0):
    """1/p of the p-norm to the p-th power, and its gradient."""
    p = float(p)
    norm = torch.sum(torch.abs(x) ** p) / p
    grad = torch.sign(x) * torch.abs(x) ** (p - 1)
    return norm, grad


def p_norm_lanes(x, p=2.0):
    """p_norm of each image of an (B, H, W, C) batch: ((B,) values, the
    gradient)."""
    p = float(p)
    norm = torch.sum(torch.abs(x) ** p, dim=_IMAGE_DIMS) / p
    grad = torch.sign(x) * torch.abs(x) ** (p - 1)
    return norm, grad
