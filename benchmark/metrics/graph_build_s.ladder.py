"""graph_build_s.ladder: what metrics/graph_build_s.py reads, in a cell whose
end-to-end metric is image_s."""

from portbench.spans import graph_build_s


def read(ctx):
    return graph_build_s(ctx)
