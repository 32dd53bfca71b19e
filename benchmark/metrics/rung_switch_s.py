"""rung_switch_s: host seconds a ladder's rung change takes, from
resample_input through set_content and start to the return of the new
grid's first begin_steps (eager and captured), over the switches of the
window."""


def read(ctx):
    spans = ctx.in_window([(s[1], s[2] - s[1]) for s in ctx.record.spans
                           if s[0] == 'rung_switch'])
    if not spans:
        return None
    return sum(d for _, d in spans) / len(spans)
