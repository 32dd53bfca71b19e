"""style_roofline: the least time the traced part's style branches need
(frozen counts) over the device time of the style kernel class
(benchmark/kernels/style.json)."""

from portbench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, 'style')
