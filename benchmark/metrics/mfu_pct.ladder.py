"""mfu_pct.ladder: what metrics/mfu_pct.py reads, in a cell whose
end-to-end metric is image_s."""

from portbench.layers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
