"""idle_in_build_pct.ladder: what metrics/idle_in_build_pct.py reads, in a
cell whose end-to-end metric is image_s."""

from portbench.spans import idle_in_build_pct


def read(ctx):
    return idle_in_build_pct(ctx)
