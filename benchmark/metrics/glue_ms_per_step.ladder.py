"""glue_ms_per_step.ladder: what metrics/glue_ms_per_step.py reads, in a cell whose
end-to-end metric is image_s."""

from portbench.layers import glue_ms_per_step


def read(ctx):
    return glue_ms_per_step(ctx)
