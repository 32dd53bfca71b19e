"""The comparison's control: the reference put in the program's place and run
one precision below the configuration's (float32 -> TF32; bfloat16 -> float8
e4m3), so that the limits can be shown to fail what a tempting lower-precision
path would produce.

The control makes the same records a run makes (the set-up job's rows and
iterates, the step it follows after the window, the loss reported with each
finished job's final image), from the same inputs: it steps from the same
random starts, computes its own gradient at the program's state as the
window left it and at each state a re-run held (driver.rerun) and steps
from there, and reports its own loss at the program's final images.
check.Check then judges those records against the float32 reference
exactly as it judges a run's.
"""

from . import check

LOWER = {'float32': 'tf32', 'bfloat16': 'fp8'}


def nhwc(x):
    """(1, 3, H, W) device tensor -> (1, H, W, 3) float32 host tensor."""
    return x.permute(0, 2, 3, 1).float().cpu().contiguous()


def _rows(traces):
    return [dict(t) for t in traces]


def records(ref_mod, config, driver, warm, follow, held=()):
    """(warm, follow, answers, held) as the control produces them; held:
    the re-run jobs `held` (driver.rerun's) with each point's gradient the
    control's at its iterate and its next iterate the control's step from
    there."""
    ctrl = ref_mod.Reference(config, driver.weights,
                             LOWER[config['precision']])
    ctrl.set_style(driver.style)
    contents = driver.contents
    d = driver

    def x0(job):
        return ctrl.preprocess(d.start_image(job))

    def norms(job, c):
        obj = ctrl.objective(contents[c][0])
        obj(x0(job))
        return obj.norms

    def job_id(base, lane):
        return base + lane if d.lanes > 1 else base

    c_warm = {'job': warm['job'], 'rungs': []}
    lanes = list(warm['rungs'][0]['rows'])
    state = {}
    for r, rung in enumerate(warm['rungs']):
        rec = {'hw': rung['hw'], 'rows': {}, 'x_start': {}, 'x_step': {},
               'x_end': {}}
        for lane in lanes:
            c = lane % len(contents)
            if r == 0:
                x = x0(job_id(warm['job'], lane))
                nm = None
            else:
                x = ctrl.resize(state[lane][0], rung['hw'])
                nm = state[lane][1]
            obj = ctrl.objective(contents[c][r], nm)
            opt = ctrl.lbfgs(x, obj)
            opt.prime()
            opt.step()
            rec['rows'][lane] = _rows(opt.traces[-len(rung['rows'][lane]):])
            rec['x_step'][lane] = nhwc(opt.x)
            opt.step()
            opt.step()
            rec['x_start'][lane] = nhwc(x)
            rec['x_end'][lane] = nhwc(opt.x)
            state[lane] = (opt.x, obj.norms)
        c_warm['rungs'].append(rec)

    def step(x, st, grad):
        """The control's L-BFGS step over its gradient and the program
        state's history."""
        opt = ctrl.lbfgs(x, None, history=check.history(st, ctrl.device))
        with ctrl.precision.scope():
            return -opt.step_size * opt.inv_hv(grad)

    c_follow = dict(follow, state={}, x_end={})
    for lane, st in follow['state'].items():
        x = check.nchw(st['x']).to(ctrl.device)
        c = lane % len(contents)
        obj = ctrl.objective(contents[c][follow['rung']],
                             norms(job_id(follow['job'], lane), c))
        _, grad, _ = obj(x)
        c_follow['state'][lane] = dict(st, grad=nhwc(grad))
        c_follow['x_end'][lane] = nhwc(x + step(x, st, grad))

    c_answers = []
    for a in driver.answers:
        obj = ctrl.objective(contents[a['content']][-1],
                             norms(a['job'], a['content']))
        loss, _, _ = obj(ctrl.preprocess(a['image']))
        c_answers.append(dict(a, row={'loss': loss}))

    c_held = []
    for h in held:
        c = h['lane'] % len(contents)
        nm = norms(h['job'], c)
        objs, points = {}, []
        for p in h['points']:
            r = p['rung']
            if r not in objs:
                objs[r] = ctrl.objective(contents[c][r], nm)
            x = check.nchw(p['state']['x']).to(ctrl.device)
            _, grad, _ = objs[r](x)
            points.append(dict(p, state=dict(p['state'], grad=nhwc(grad)),
                               next=nhwc(x + step(x, p['state'], grad))))
        c_held.append(dict(h, points=points))
    return c_warm, c_follow, c_answers, c_held
