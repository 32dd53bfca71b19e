"""style_roofline.ladder: what metrics/style_roofline.py reads, in a cell whose
end-to-end metric is image_s."""

from portbench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, 'style')
