"""The comparison that decides `correct`: what the timed path produced against
the plain reference, at the timed sizes.

An L-BFGS run is chaotic, and near its optimum a residual: two sound float32
programs part after some tens of steps, and at an optimized iterate the
bfloat16 objective and its gradient differ from float32's by a large share of
what is left of them. So the reference follows the program step by step from
the program's own state where it must, and checks the start that this skips by
itself:
  * start: the set-up job (for a single grid the second, whose prime is a
    captured graph's replay too) from its random start, made again here:
    at every rung the prime and the first step; at a ladder's later rungs
    from the program's warm start, which is held apart against the
    reference's own lanczos3 resample of the program's iterate at the end of
    the rung below (the steps after the first take their scale from the
    newest pair, which can be 50 times the first step and multiply the loss
    many times over: there any rounding gap grows without bound);
  * follow: the state the window left (iterate, gradient, curvature
    history): the gradient a replay of the window's call computed at that
    iterate against the reference's there (its norms worked out again from
    the job's start), and one more step through the window's call against
    the reference's L-BFGS step from that same state;
  * answers: a sample, drawn from the seed, of the jobs the window finished:
    the loss the program reported with each final image, against the
    reference's loss at that image (its norms worked out again from the
    job's start).

The numbers, each the worst over everything compared (per image, per lane):
  start_loss_gap   |program - reference| / |reference| of every loss term
                   of the start's evaluations
  start_grad_gap   the same of every gradient-RMS term (the trunk's vjp, TV,
                   p, each tap's cotangent, the total)
  start_step_gap   |dx program - dx reference| / |dx reference| of each
                   rung's first step
  follow_grad_gap  |g program - g reference| / |g reference| of the
                   gradient at the window's last iterate
  follow_step_gap  |x program - (x + dx reference)| / |dx reference| of the
                   step from the window's state
  answer_loss_gap  |loss program - loss reference| / |loss reference| at
                   the final images
  failed_share     the share of finished jobs whose final loss or image is
                   not finite: fixed-step L-BFGS from a random start on this
                   objective now and then overflows float32, in the
                   reference too (PERF.md); the answers are sampled from
                   the others
  input_gap        |x program - x reference| / |x reference| of the iterate
                   each rung switch produced (ladders only)

Each non-finite finished job gets a verdict of its own (classify): the
program's states on the way to where it first went non-finite, found by a
re-run (driver.rerun), held against the reference as `follow` holds the
window's last state, under limits of their own (benchmark/held/<cell>.json).
'diverged' where, at every state held, the program's gradient lay well
within the error of the reference one precision down and its step was the
reference's to within its limit, and the reference, stepping from the
newest, overflows too; 'failed' otherwise, and in a cell without held
limits. The result line's `failed` counts the second kind.
"""

import math

import numpy as np
import torch

from . import inputs

EPS32 = float(torch.finfo(torch.float32).eps)
NUMBERS = ('start_loss_gap', 'start_grad_gap', 'start_step_gap',
           'follow_grad_gap', 'follow_step_gap', 'answer_loss_gap',
           'failed_share')


def nchw(x):
    """A (1, H, W, 3) host or device tensor as (1, 3, H, W) float32."""
    return x.permute(0, 3, 1, 2).float().contiguous()


def _gap(p, r):
    p, r = float(p), float(r)
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-30)


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def _rel(a, b):
    """|a| / |b|: 0 where both are 0; inf where only b is (a step lost in
    the rounding of a huge iterate) or where the ratio is not finite."""
    num, den = _norm(a), _norm(b)
    if num == 0.0 and den == 0.0:
        return 0.0
    ratio = num / den if den != 0.0 else math.inf
    return ratio if math.isfinite(ratio) else math.inf


def _finite(t):
    return bool(torch.isfinite(t).all())


def history(state, device, dtype=torch.float32):
    """A program state's curvature pairs, oldest first, as the reference's
    list history."""
    n = state['sk'].shape[0]
    count, pos = int(state['count']), int(state['pos'])
    return [(nchw(state['sk'][s]).to(device, dtype),
             nchw(state['yk'][s]).to(device, dtype))
            for s in ((pos - count + j) % n for j in range(count))]


def finite(answer):
    """Whether a finished job's reported loss and final image are
    finite."""
    image = torch.as_tensor(answer['image'])
    return (math.isfinite(answer['row']['loss'])
            and bool(torch.isfinite(image).all()))


class Readings:
    def __init__(self, ladder=False):
        self.values = dict.fromkeys(NUMBERS, 0.0)
        if ladder:
            self.values['input_gap'] = 0.0
        self.where = {}        # number -> where its worst reading came from
        self.answer_gaps = []
        self.verdicts = []     # classify's, one a re-run job

    def put(self, name, value, where):
        value = float(value)
        if not math.isfinite(value):
            value = math.inf
        if name not in self.where or value > self.values[name]:
            self.where[name] = where
        self.values[name] = max(self.values[name], value)

    def rows(self, prog_rows, ref_traces, where):
        """Each program row against the reference's trace of the same
        evaluation, every key."""
        for i, (row, ref) in enumerate(zip(prog_rows, ref_traces)):
            for key, r in ref.items():
                name = ('start_loss_gap' if key.endswith('loss')
                        else 'start_grad_gap')
                self.put(name, _gap(row[key], r), '%s row %d %s: %r vs %r'
                         % (where, i, key, row[key], r))


class Check:
    """Runs the comparison of one run's records with one reference."""

    def __init__(self, ref, driver):
        self.ref = ref
        self.d = driver
        self.dev = ref.device
        self.contents = driver.contents
        self.refs = {}
        ref.set_style(driver.style)

    def _x0(self, job):
        return self.ref.preprocess(self.d.start_image(job))

    def _norms(self, job, content, ref=None):
        """The norm state of job `job` (its first evaluation, at rung 0) in
        `ref` (the reference by default)."""
        ref = ref or self.ref
        obj = ref.objective(self.contents[content][0])
        obj(ref.preprocess(self.d.start_image(job)))
        return obj.norms

    def _at(self, precision):
        """The reference at another precision (made on first use)."""
        if precision not in self.refs:
            ref = type(self.ref)(self.ref.config, self.d.weights, precision)
            ref.set_style(self.d.style)
            self.refs[precision] = ref
        return self.refs[precision]

    def _job_id(self, base, lane):
        return base + lane if self.d.lanes > 1 else base

    def start(self, warm, out):
        """The set-up job from its start, rung by rung: the prime and the
        first step."""
        for lane in warm['rungs'][0]['rows']:
            c = lane % len(self.contents)
            norms = x_prev = None
            for r, rung in enumerate(warm['rungs']):
                where = 'start lane %d rung %d' % (lane, r)
                if r == 0:
                    x = self._x0(self._job_id(warm['job'], lane))
                else:
                    # The warm start against the reference's own resample;
                    # the rung's steps then follow from the program's.
                    xr = self.ref.resize(nchw(x_prev).to(self.dev),
                                         rung['hw'])
                    x = nchw(rung['x_start'][lane]).to(self.dev)
                    out.put('input_gap', _rel(x - xr, xr), where)
                obj = self.ref.objective(self.contents[c][r], norms)
                opt = self.ref.lbfgs(x, obj)
                opt.prime()
                norms = obj.norms
                opt.step()
                rows = rung['rows'][lane]
                out.rows(rows, opt.traces[-len(rows):], where)
                dx_p = nchw(rung['x_step'][lane] - rung['x_start'][lane])
                dx_r = (opt.x - x).cpu()
                out.put('start_step_gap', _rel(dx_p - dx_r, dx_r),
                        '%s |dx| %r vs %r' % (where, _norm(dx_p),
                                               _norm(dx_r)))
                x_prev = rung['x_end'][lane]

    def follow(self, fol, out):
        """The state the window left: its gradient against the reference's
        at its iterate; then one step from it, the reference's two-loop over
        the program's gradient and history, added to the iterate in float32
        as the program adds it."""
        for lane, state in fol['state'].items():
            x = nchw(state['x']).to(self.dev)
            c = lane % len(self.contents)
            obj = self.ref.objective(
                self.contents[c][fol['rung']],
                self._norms(self._job_id(fol['job'], lane), c))
            _, g_ref, _ = obj(x)
            g = nchw(state['grad']).to(self.dev)
            out.put('follow_grad_gap', _rel(g - g_ref, g_ref),
                    'follow lane %d |g| %r vs %r' % (lane, _norm(g),
                                                     _norm(g_ref)))
            s = self._step(x, state)
            x_end = nchw(fol['x_end'][lane]).to(self.dev)
            out.put('follow_step_gap', _rel(x_end - (x + s), s),
                    'follow lane %d |dx| %r, history %d'
                    % (lane, _norm(s), int(state['count'])))

    def _step(self, x, state, dtype=torch.float32):
        """The reference's L-BFGS step from a program state: its two-loop
        over the state's gradient and curvature history, in dtype."""
        opt = self.ref.lbfgs(x, None,
                             history=history(state, self.dev, dtype))
        return -opt.step_size * opt.inv_hv(
            nchw(state['grad']).to(self.dev, dtype))

    def classify(self, held, spec):
        """The verdict on a job that a re-run (driver.rerun) found going
        non-finite, by the reference held at the program's points on the way
        (each EVERY-th step's state and the last KEPT before the first
        non-finite one), under the cell's held limits `spec` (core.held_spec;
        None: the cell has none, and the job is failed). At every point:
          grad_share  the program's gradient's distance from the float64
                      reference's, as a share of the distance of the
                      reference one precision down (spec['yardstick'], the
                      control's precision) from it; read where that
                      precision's distance is at least `yardstick_resolved`
                      times the float32 reference's own (at least float32's
                      epsilon of the norm), so that the yardstick stands
                      clear of float32's rounding there (norms worked out
                      again from the job's start);
          step_gap    the program's next iterate against the point's plus the
                      reference's float32 step over the program's gradient
                      and history (0 where both are non-finite), read where
                      float32 resolves that step: where the reference's
                      float32 step lies within `step_resolved` of its float64
                      one (that gap is `rounding`).
        S is the newest point the reference can evaluate. 'diverged' only
        where every grad_share and every step_gap read holds its limit, one
        of each was read, and the reference's loss or gradient at S's iterate
        plus its step is not finite: the program stepped as the reference
        steps all the way, and the reference, stepping from the program's
        last state, overflows as well. 'failed' otherwise, and where the
        re-run stayed finite (the answer went wrong after the iterate)."""
        out = {'job': held['job'], 'rung': held['rung'],
               'step': held['step'], 'verdict': 'failed', 'points': [],
               'grad_share': None, 'step_gap': None, 'at': None,
               'stepped_loss': None, 'stepped_grad': None}
        if spec is None:
            out['why'] = 'the cell has no held limits'
            return out
        if held['rung'] is None:
            out['why'] = 'the re-run stayed finite'
            return out
        c = held['lane'] % len(self.contents)
        refs = (self.ref, self._at('float64'), self._at(spec['yardstick']))
        norms = [self._norms(held['job'], c, r) for r in refs]
        objs, last = {}, None
        for p in held['points']:
            r, state = p['rung'], p['state']
            if r not in objs:
                objs[r] = [ref.objective(self.contents[c][r], n)
                           for ref, n in zip(refs, norms)]
            x = nchw(state['x']).to(self.dev)
            loss_r, g_r, _ = objs[r][0](x)
            s = self._step(x, state)
            row = {'rung': r, 'step': p['step'], 'grad_share': None,
                   'over_float32': None, 'rounding': None, 'step_gap': None}
            if math.isfinite(loss_r) and _finite(g_r):
                g = nchw(state['grad']).to(self.dev).double()
                _, g64, _ = objs[r][1](x.double())
                _, g_y, _ = objs[r][2](x)
                if _finite(g64) and _finite(g_y):
                    e_y = _norm(g_y.double() - g64)
                    row['over_float32'] = e_y / max(
                        _norm(g_r.double() - g64), EPS32 * _norm(g64))
                    if row['over_float32'] >= spec['yardstick_resolved']:
                        row['grad_share'] = _norm(g - g64) / e_y
                last = (r, p['step'], x, s)
            x_next = nchw(p['next']).to(self.dev)
            if not (_finite(x_next) or _finite(x + s)):
                row['step_gap'] = 0.0
            else:
                row['rounding'] = _rel(
                    s - self._step(x, state, torch.float64), s)
                if row['rounding'] <= spec['step_resolved']:
                    row['step_gap'] = _rel(x_next - (x + s), s)
            out['points'].append(row)
        limits = spec['limits']
        shares = [(p['grad_share'], p['step']) for p in out['points']
                  if p['grad_share'] is not None]
        steps = [(p['step_gap'], p['step']) for p in out['points']
                 if p['step_gap'] is not None]
        out['grad_share'] = max(shares, default=None)
        out['step_gap'] = max(steps, default=None)
        if last is not None:
            r, step, x, s = last
            loss_s, g_s, _ = objs[r][0](x + s)
            out.update(at=step, stepped_loss=loss_s, stepped_grad=_norm(g_s))
        if last is None:
            out['why'] = 'no point the reference can evaluate'
        elif not shares:
            out['why'] = 'the yardstick resolves the gradient at no point'
        elif not out['grad_share'][0] <= limits['held_grad_share']:
            out['why'] = 'the gradient is not the reference\'s'
        elif not steps:
            out['why'] = 'float32 resolves the step at no point'
        elif not out['step_gap'][0] <= limits['held_step_gap']:
            out['why'] = 'the step is not the reference\'s'
        elif math.isfinite(out['stepped_loss']) and _finite(g_s):
            out['why'] = 'the reference\'s step stays finite'
        else:
            out.update(verdict='diverged', why='the reference overflows too')
        return out

    def answers(self, answers, out):
        """The sampled finished jobs: the loss reported with each final
        image against the reference's at that image."""
        if not answers:
            return 0
        ok = [a for a in answers if finite(a)]
        bad = ['job %d loss %r, %d non-finite pixels' % (
            a['job'], a['row']['loss'],
            int((~torch.isfinite(torch.as_tensor(a['image']))).sum()))
            for a in answers if not finite(a)]
        out.put('failed_share', 1.0 - len(ok) / len(answers),
                '%d of %d finished jobs not finite%s'
                % (len(bad), len(answers), ''.join('; ' + b for b in bad)))
        answers = ok
        n = min(len(answers), int(self.d.t['answers']))
        if not n:
            return 0
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence(inputs._seed_words(self.d.seed) + [3])))
        for i in sorted(rng.choice(len(answers), size=n, replace=False)):
            a = answers[i]
            norms = self._norms(a['job'], a['content'])
            obj = self.ref.objective(self.contents[a['content']][-1], norms)
            loss, _, _ = obj(self.ref.preprocess(a['image']))
            gap = _gap(a['row']['loss'], loss)
            out.answer_gaps.append(gap)
            out.put('answer_loss_gap', gap, 'answer job %d: %r vs %r'
                    % (a['job'], a['row']['loss'], loss))
        return n
