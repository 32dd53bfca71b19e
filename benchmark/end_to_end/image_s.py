"""image_s: all the time the window spent on the images it finished, over
the number of those images; an image cut by the window's edge counts in
neither."""


def read(ctx):
    done = [j for j in ctx.record.jobs
            if j['finished'] and ctx.t0 <= j['t0'] and j['t1'] <= ctx.t1]
    if not done:
        return None
    return sum(j['t1'] - j['t0'] for j in done) / sum(j['lanes']
                                                      for j in done)
