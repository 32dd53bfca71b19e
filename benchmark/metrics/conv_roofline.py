"""conv_roofline: the least time the traced part's convolutions need
(frozen counts, portbench/roofline.py) over the device time of the conv
kernel class (benchmark/kernels/conv.json)."""

from portbench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, 'conv')
