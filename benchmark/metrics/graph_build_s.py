"""graph_build_s: host seconds an image spends building and dropping step
graphs, from the program's own spans: a key's eager first call
('graphs.warm'), its capture ('graphs.capture') and the old grid's graph
pool going back at a warm start ('graphs.release'), summed over the
window's finished images and divided by their number."""

from portbench.spans import graph_build_s


def read(ctx):
    return graph_build_s(ctx)
