"""idle_pct.ladder: what metrics/idle_pct.py reads, in a cell whose
end-to-end metric is image_s."""

from portbench.layers import idle_pct


def read(ctx):
    return idle_pct(ctx)
