"""its_per_s: the image-iterations the window completed (every chunk
collected in it, all lanes summed, those of a job cut by the window's edge
too) over the window's seconds."""


def read(ctx):
    done = sum(n for t, n in ctx.in_window(ctx.record.iterations))
    if not done:
        return None
    return done / (ctx.t1 - ctx.t0)
