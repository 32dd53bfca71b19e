"""glue_ms_per_step: device ms an evaluation (a step, or a job's prime) in
kernels of neither the conv nor the style class: PyTorch's elementwise
work, copies, index_select, reductions, the sumsq and image kernels."""

from portbench.layers import glue_ms_per_step


def read(ctx):
    return glue_ms_per_step(ctx)
