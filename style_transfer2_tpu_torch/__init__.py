"""style_transfer2_tpu_torch: the PyTorch and CUDA port of style_transfer2_tpu.

Gatys-style optimization of an image against VGG-19 losses, for one NVIDIA
Hopper card. The JAX package beside it is the reference the port is tested
against; the module names match it, so each counterpart is easy to find.
This package imports torch and never jax.

Subpackages:
  models  — the truncated VGG-19 (NHWC, HWIO weights) and its weights
  ops     — the hand-written CUDA kernels' wrappers (csrc/: conv, style
            branch, image boundaries) beside their plain PyTorch versions,
            Gram matrices, TV and p-norm losses, resampling
  optim   — the reference's Adam variant and fixed-step L-BFGS
  engine  — the objective, the steps, the StyleTransfer state machine and
            its checkpoints
  cli     — the single-image command line, single-scale or up the
            coarse-to-fine ladder
"""

__version__ = '0.1.0'
