"""Arithmetic the metric readers share: the work a part of the window
enqueued, as frozen counts (roofline.py), and the device's busy share."""

from . import roofline as R


def _last(ctx, last):
    convs = ctx.config['convs']
    return convs[-1][0] if last == 'all' else last


def bounds(ctx, work):
    """(conv seconds, style seconds) the work needs at the least: every
    evaluation's convs forward and backward and its style branch, every
    forward pass's convs."""
    convs, prec = ctx.config['convs'], ctx.config['precision']
    style = list(ctx.config['objective']['style'])
    conv_s = style_s = 0.0
    for _, kind, hw, lanes, count, last in work:
        last = _last(ctx, last)
        if kind == 'eval':
            conv_s += count * R.conv_bound_s(hw, convs, last, prec,
                                             lanes=lanes)
            style_s += count * lanes * R.style_bound_s(hw, convs, style,
                                                       prec)
        else:
            conv_s += count * R.conv_bound_s(hw, convs, last, prec,
                                             backward=False, lanes=lanes)
    return conv_s, style_s


def model_flops(ctx, work):
    """Model FLOPs of the work: each evaluation's (roofline.eval_flops),
    each forward pass's convs."""
    convs = ctx.config['convs']
    obj = ctx.config['objective']
    flops = 0.0
    for _, kind, hw, lanes, count, last in work:
        if kind == 'eval':
            flops += count * lanes * R.eval_flops(hw, convs, obj['content'],
                                                  obj['style'])
        else:
            flops += count * lanes * R.forward_flops(hw, convs,
                                                     _last(ctx, last))
    return flops


def class_seconds(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.class_seconds(ctx.classes)


def roofline_pct(ctx, cls):
    secs = class_seconds(ctx)
    if not secs or secs.get(cls, 0.0) <= 0.0:
        return None
    conv_s, style_s = bounds(ctx, ctx.traced_work())
    need = conv_s if cls == 'conv' else style_s
    return 100.0 * need / secs[cls]


def glue_ms_per_step(ctx):
    """Device ms an evaluation of the traced part in kernels of neither
    class."""
    secs = class_seconds(ctx)
    evals = sum(w[4] for w in ctx.traced_work() if w[1] == 'eval')
    if not secs or not evals:
        return None
    return 1e3 * secs.get(None, 0.0) / evals


def idle_pct(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s() <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def mfu_pct(ctx):
    """Model FLOPs of the window's work over its seconds over the
    precision's peak."""
    flops = model_flops(ctx, ctx.work_in(ctx.t0, ctx.t1))
    peak = R.PEAK_FLOPS[ctx.config['precision']]
    return 100.0 * flops / (ctx.t1 - ctx.t0) / peak
