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
                   reference too (PERF.md); such a job is counted as failed,
                   and the answers are sampled from the others
  input_gap        |x program - x reference| / |x reference| of the iterate
                   each rung switch produced (ladders only)
"""

import math

import numpy as np
import torch

from . import inputs

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
        ref.set_style(driver.style)

    def _x0(self, job):
        return self.ref.preprocess(self.d.start_image(job))

    def _norms(self, job, content):
        """The norm state of job `job` (its first evaluation, at rung 0)."""
        obj = self.ref.objective(self.contents[content][0])
        obj(self._x0(job))
        return obj.norms

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
                    out.put('input_gap', _norm(x - xr) / _norm(xr), where)
                obj = self.ref.objective(self.contents[c][r], norms)
                opt = self.ref.lbfgs(x, obj)
                opt.prime()
                norms = obj.norms
                opt.step()
                rows = rung['rows'][lane]
                out.rows(rows, opt.traces[-len(rows):], where)
                dx_p = nchw(rung['x_step'][lane] - rung['x_start'][lane])
                dx_r = (opt.x - x).cpu()
                out.put('start_step_gap', _norm(dx_p - dx_r) / _norm(dx_r),
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
            out.put('follow_grad_gap', _norm(g - g_ref) / _norm(g_ref),
                    'follow lane %d |g| %r vs %r' % (lane, _norm(g),
                                                     _norm(g_ref)))
            n = state['sk'].shape[0]
            count, pos = int(state['count']), int(state['pos'])
            history = [(nchw(state['sk'][s]).to(self.dev),
                        nchw(state['yk'][s]).to(self.dev))
                       for s in ((pos - count + j) % n for j in range(count))]
            opt = self.ref.lbfgs(x, None, history=history)
            s = -opt.step_size * opt.inv_hv(nchw(state['grad']).to(self.dev))
            x_end = nchw(fol['x_end'][lane]).to(self.dev)
            out.put('follow_step_gap', _norm(x_end - (x + s)) / _norm(s),
                    'follow lane %d |dx| %r, history %d'
                    % (lane, _norm(s), count))

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
