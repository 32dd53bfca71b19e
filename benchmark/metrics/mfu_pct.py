"""mfu_pct: model FLOPs of the window's evaluations and forward passes
(frozen counts) over the window's seconds over the precision's data-sheet
peak (float32: 67 TFLOP/s, SIMT; bfloat16: 989)."""

from portbench.layers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
