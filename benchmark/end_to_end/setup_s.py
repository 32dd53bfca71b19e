"""setup_s: from the start of the process to the window: imports, the card,
the kernels' build (or load), the weights, the engine, every shape's first
calls and captures, and the start the comparison follows."""


def read(ctx):
    return ctx.setup_s
