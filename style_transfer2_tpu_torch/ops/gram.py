"""Gram matrices of feature maps (style_transfer2_tpu/ops/gram.py).

For a (1, h, w, c) feature map, G = X^T X / (c*h*w) with X the (h*w, c)
pixel rows (reference worker.py:109-114). Used for the style targets at
set_style time; a plain matmul, as the JAX package left it to XLA. The
float32 mode turns TF32 off (engine/steps.py), so it runs in full float32.
"""


def gram_matrix(feat):
    """(1, h, w, c) or (h, w, c) feature map -> (c, c) float32 Gram matrix,
    divided by the element count c*h*w."""
    if feat.dim() == 4:
        if feat.shape[0] != 1:
            raise ValueError('gram_matrix expects batch size 1')
        feat = feat[0]
    c = feat.shape[-1]
    flat = feat.reshape(-1, c).float()
    return flat.T @ flat / flat.numel()
