"""The one general traffic driver: it reads a traffic mix (benchmark/traffic/
<name>.json) and drives the program's engines as the CLI drives them.

A mix is data:
  engine      'single' (engine/transfer.py StyleTransfer: begin_steps /
              collect_steps) or 'lanes' (engine/batched.py
              BatchedStyleTransfer: begin_steps_all / collect_steps_all)
  contents    the content images (a job a content; lanes take one each)
  style       the style image, fitted into style_size
  rungs       the (h, w) grids of a job, coarse to fine; more than one is a
              ladder: each later rung warm-starts from the one below
              (resample_input, set_content, start), as the CLI's
              --multi-scale does
  iterations  L-BFGS iterations a rung; chunk, depth: iterations a
              begin_steps and chunks in flight (the CLI's dispatch_chunks)
  lanes       lanes of the batched engine, refilled as their jobs end
  trace       what a --trace 1 run profiles after the window: {"images": n},
              n jobs
  answers     how many finished jobs the comparison samples

A job is one image (one wave of lanes): a random start from (seed, job),
reset, start, then every rung's iterations; its final image comes to the
host at its end. Jobs run back to back on one engine. The window starts no
chunk after its deadline; the chunks in flight are collected and the window
ends at the last collect. A job cut by the deadline is not finished.

After the window, a finished job whose answer was not finite is run again
(rerun) to find where it first went non-finite and the program's states
on the way there, which the comparison holds the reference at
(check.classify).
"""

import collections
import time

import torch

from . import inputs

_EPOCH = time.time_ns() - time.perf_counter_ns()
RERUNS = 8    # non-finite jobs a run runs again, at most
KEPT = 3      # finite per-step states a re-run keeps before the first
              # non-finite one
EVERY = 10    # and, before those, the state of every EVERY-th step


def now():
    return time.perf_counter()


def epoch_ns(t):
    """A perf_counter time on the profiler's clock (ns since the epoch)."""
    return int(t * 1e9) + _EPOCH


def _host(t, dtype=torch.float32):
    """A copy of t on the host (never a view of the engine's buffers)."""
    return t.detach().to('cpu', dtype=dtype or t.dtype, copy=True)


def _clone(t):
    """A copy of t on its device (the engine's next step rewrites its
    buffers)."""
    return t.detach().clone()


def _on_host(state):
    """A state's tensors copied to the host in their own dtypes."""
    return {k: (_host(v, None) if torch.is_tensor(v) else v)
            for k, v in state.items()}


class Record:
    """What the driver saw: host spans, the work it enqueued, the jobs."""

    def __init__(self):
        self.spans = []        # (name, t0, t1): perf_counter seconds
        self.work = []         # (t, kind, hw, lanes, count, last layer)
        self.jobs = []         # dicts: job, lanes, t0, t1, finished
        self.iterations = []   # (t collected, image-iterations of a chunk)

    def span(self, name, t0, t1=None):
        self.spans.append((name, t0, now() if t1 is None else t1))


class Driver:
    def __init__(self, traffic, config, seed, device, program):
        """program: the program's modules (engine classes), handed in so
        that a test can run the driver on the CPU."""
        self.t = traffic
        self.config = config
        self.seed = int(seed)
        self.device = device
        self.program = program
        self.rungs = [tuple(r) for r in traffic['rungs']]
        self.lanes = int(traffic.get('lanes', 1))
        self.chunk = int(traffic['chunk'])
        self.depth = int(traffic['depth'])
        self.iterations = int(traffic['iterations'])
        self.rec = Record()
        self.answers = []      # finished jobs: job, lane, image, row, rungs
        self.next_job = 0
        self._switch = None    # open rung switch: its start time
        self._primed = set()   # lanes whose next begin primes
        self.weights = inputs.make_weights(config['convs'], seed, device)
        obj = config['objective']
        self.weights_doc = ({'content': dict(obj['content']),
                             'style': dict(obj['style']), 'deepdream': {}},
                            {k: obj[k] for k in ('p', 'p_power', 'tv',
                                                 'tv_power')})
        self.style = inputs.style_image(traffic['style'],
                                        int(traffic['style_size']))
        self.contents = [[inputs.fit(inputs.load_image(c), hw)
                          for hw in self.rungs] for c in traffic['contents']]
        self.last_tap = self._last(list(obj['content']) + list(obj['style']))
        self.style_tap = self._last(list(obj['style']))

    def _last(self, layers):
        from .roofline import deepest
        return deepest(self.config['convs'], layers)

    # -- engine ----------------------------------------------------------

    def build(self):
        opt = self.config['optimizer']
        params = inputs.as_params(self.weights)
        prec = self.config['precision']
        if self.t['engine'] == 'single':
            st = self.program.StyleTransfer(
                params, precision=prec, n_corr=int(opt['n_corr']),
                device=self.device)
            st.set_weights(*self.weights_doc)
            st.set_optimizer(opt['name'])
            st.set_step_size(float(opt['step_size']))
            st.set_style(self.style)
            self.work('fwd', self.style.shape[:2], 1, 'all')
        else:
            st = self.program.BatchedStyleTransfer(
                params, self.weights_doc[0], self.weights_doc[1],
                self.rungs[0], self.lanes, optimizer=opt['name'],
                precision=prec, n_corr=int(opt['n_corr']),
                device=self.device)
        self.st = st
        return st

    def start_image(self, job):
        """Job `job`'s random start at the first rung."""
        return inputs.random_start(self.seed, job, self.rungs[0])

    def work(self, kind, hw, lanes, last, count=1):
        self.rec.work.append((now(), kind, tuple(hw), lanes, count, last))

    # -- one job -----------------------------------------------------------

    def _start_job(self, job):
        t0 = now()
        hw = self.rungs[0]
        if self.t['engine'] == 'single':
            st = self.st
            if st.content is None or tuple(st.content.shape[1:3]) != hw:
                st.set_content(self.contents[0][0])
                self.work('fwd', hw, 1, self.last_tap)
            st.set_input(self.start_image(job))
            st.reset()
            if not st.start():
                raise RuntimeError('the engine did not start')
            self._primed = {0}
        else:
            st = self.st
            for lane in range(self.lanes):
                if st.active[lane]:
                    st.remove_job(lane)
            for lane in range(self.lanes):
                content = self.contents[lane % len(self.contents)][0]
                st.add_job(content, self.style,
                           self.start_image(job + lane),
                           lane=lane)
                self.work('fwd', hw, 1, self.last_tap)
                self.work('fwd', hw, 1, self.style_tap)
            self._primed = set(range(self.lanes))
        self.rec.span('job_start', t0)

    def _switch_rung(self, r):
        self._switch = now()
        st = self.st
        st.resample_input(self.rungs[r])
        st.set_content(self.contents[0][r])
        self.work('fwd', self.rungs[r], 1, self.last_tap)
        if not st.start():
            raise RuntimeError('the engine did not start at %s'
                               % (self.rungs[r],))
        self._primed = {0}

    def _begin(self, n, hw):
        t0 = now()
        if self.t['engine'] == 'single':
            h = self.st.begin_steps(n)
        else:
            h = self.st.begin_steps_all(n)
        t1 = now()
        # A job's or a rung's first begin primes, and at a new grid also runs
        # the step's first call eagerly and captures it: the trace's idle
        # gaps name it apart from the replays' begins.
        self.rec.span('begin_first' if self._primed else 'begin', t0, t1)
        if self._switch is not None:
            self.rec.span('rung_switch', self._switch, t1)
            self._switch = None
        if self._primed:
            self.work('eval', hw, self.lanes, self.last_tap)
            self._primed = set()
        self.work('eval', hw, self.lanes, self.last_tap, n)
        return h

    def _collect(self, h, fetch):
        t0 = now()
        if self.t['engine'] == 'single':
            image, traces = self.st.collect_steps(h, fetch_image=fetch)
            rows = {0: [t.data for t in traces]}
            images = {0: image} if fetch else {}
        else:
            rows = self.st.collect_steps_all(h)
            images = ({lane: self.st.lane_image(lane)
                       for lane in range(self.lanes)} if fetch else {})
        self.rec.span('collect', t0)
        return rows, images

    def run_job(self, job, deadline):
        """Runs job `job` until done or the deadline; True if it finished
        (its final image on the host)."""
        t0 = now()
        self._start_job(job)
        last_rows = {}
        done = False
        for r, hw in enumerate(self.rungs):
            if r > 0:
                if now() >= deadline:
                    done = False
                    break
                self._switch_rung(r)
            final = r == len(self.rungs) - 1
            done, rows, images = self._pump(hw, deadline, final)
            last_rows.update({lane: rr[-1] for lane, rr in rows.items()
                              if rr})
            if not done:
                break
        t1 = now()
        self.rec.jobs.append({'job': job, 't0': t0, 't1': t1,
                              'finished': done, 'lanes': self.lanes})
        if done:
            for lane, image in images.items():
                self.answers.append({'job': job + lane if self.lanes > 1
                                     else job, 'lane': lane,
                                     'image': image, 'row': last_rows[lane],
                                     'content': lane % len(self.contents)})
        return done

    def _pump(self, hw, deadline, final):
        """One rung's iterations in chunks, `depth` in flight. Returns
        (finished, the last chunk's rows by lane, the final images)."""
        handles = collections.deque()
        remaining = self.iterations
        first, stopped = True, False
        rows, images = {}, {}
        while True:
            while not stopped and remaining > 0 and len(handles) < self.depth:
                if not first and now() >= deadline:
                    stopped = True
                    break
                n = min(self.chunk, remaining)
                handles.append((self._begin(n, hw), n))
                remaining -= n
                first = False
            if not handles:
                break
            h, n = handles.popleft()
            last = final and remaining == 0 and not handles
            rows, images = self._collect(h, fetch=last)
            self.rec.iterations.append((now(), n * self.lanes))
        return remaining == 0, rows, images

    # -- set-up and the window ----------------------------------------------

    def warm_job(self):
        """One job through the window's calls, every rung's first calls
        (eager), captures and replays: the prime and one step, collected,
        then two steps more. Returns what the comparison follows: per rung
        and lane the rows of the prime (the single engine's) and the first
        step, and the iterate at the rung's start, after the first step and
        at the rung's end."""
        job = self.next_job
        self.next_job += self.lanes
        self._start_job(job)
        out = {'job': job, 'rungs': []}
        for r, hw in enumerate(self.rungs):
            if r > 0:
                self._switch_rung(r)
            rec = {'hw': hw, 'x_start': self._iterates()}
            n0 = len(self.st.traces) if self.t['engine'] == 'single' else 0
            rows, _ = self._collect(self._begin(1, hw), fetch=False)
            if self.t['engine'] == 'single':
                rows = {0: [t.data for t in self.st.traces[n0:]]}
            rec.update(rows=rows, x_step=self._iterates())
            self._collect(self._begin(2, hw), fetch=r == len(self.rungs) - 1)
            rec['x_end'] = self._iterates()
            out['rungs'].append(rec)
        return out

    def _iterates(self):
        """{lane: the iterate (1, H, W, 3) float32, on the host}."""
        if self.t['engine'] == 'single':
            return {0: _host(self.st.input)}
        x = self.st.states['x']
        return {lane: _host(x[lane:lane + 1]) for lane in range(self.lanes)}

    def window(self, seconds):
        """Jobs back to back for `seconds`. Returns (t0, t1)."""
        t0 = now()
        deadline = t0 + seconds
        while now() < deadline:
            job = self.next_job
            self.next_job += self.lanes
            self.run_job(job, deadline)
        return t0, now()

    def traced(self, tracer):
        """The traced part of a --trace 1 run, after the window (a profiler
        session slows the host for the rest of the process, so nothing the
        window measures runs after one): whole jobs under the profiler."""
        tracer.start()
        for _ in range(int(tracer.spec['images'])):
            job = self.next_job
            self.next_job += self.lanes
            self.run_job(job, float('inf'))
        tracer.stop()

    def _lane_state(self, lane, copy):
        """Lane `lane`'s optimizer state, each tensor through copy, in the
        single engine's layout (x (1, H, W, 3), history (n_corr, 1, H, W,
        3))."""
        st = self.st
        if self.t['engine'] == 'single':
            return {k: (copy(v) if torch.is_tensor(v) else v)
                    for k, v in st.opt_state.items()}
        state = {k: copy(v[lane]) for k, v in st.states.items()}
        for k in ('x', 'grad'):
            state[k] = state[k][None]
        for k in ('sk', 'yk'):
            state[k] = state[k][:, None]
        return state

    def _state(self):
        """{lane: the optimizer state, on the host}."""
        return {lane: self._lane_state(lane, lambda v: _host(v, None))
                for lane in range(self.lanes)}

    def follow(self):
        """After the window: the engine's state as the window left it, then
        one more step through the window's call. Returns what the
        comparison follows from. Where the window's last job had diverged
        (a non-finite iterate or gradient: a failed job, which fixed-step
        L-BFGS on this objective sometimes is, in the reference too), the
        next job's first chunk gives the state instead."""
        lanes = self._state()
        if not all(torch.isfinite(s[k]).all() for s in lanes.values()
                   for k in ('x', 'grad')):
            job = self.next_job
            self.next_job += self.lanes
            t0 = now()
            self._start_job(job)
            self._collect(self._begin(self.chunk, self.rungs[0]), fetch=False)
            self.rec.jobs.append({'job': job, 't0': t0, 't1': now(),
                                  'finished': False, 'lanes': self.lanes})
            lanes = self._state()
        hw = (self.st.input_hw if self.t['engine'] == 'single'
              else self.rungs[0])
        self._collect(self._begin(1, hw), fetch=False)
        return {'job': self.rec.jobs[-1]['job'],
                'rung': self.rungs.index(tuple(hw)), 'hw': hw,
                'state': lanes, 'x_end': self._iterates()}

    def rerun(self, answer):
        """A finished job whose answer was not finite, run again after the
        window from its random start, rung by rung as run_job runs it but
        one iteration a begin (a begin replays the same step graph once a
        step whether it holds 1 or `chunk`, so the iterates are the
        window's), until the answer's lane shows a non-finite iterate,
        gradient or loss. Returns {'job', 'lane', 'rung', 'step', 'points',
        'image'}: the rung and the step in it (from 1) that first went
        non-finite, and the points the comparison holds, oldest first: each
        EVERY-th step's state before the last KEPT, and those KEPT, each a
        finite state on the host with the iterate the next step made from
        it ({'rung', 'step', 'state', 'next'}). Where the re-run stays
        finite to the job's end: rung and step None, no points, and its
        final image. Nothing of it enters the run's record."""
        lane = answer['lane']
        rec, self.rec = self.rec, Record()
        try:
            rung, step, points, image = self._first_nonfinite(
                answer['job'] - lane, lane)
        finally:
            self.rec = rec
        return {'job': answer['job'], 'lane': lane, 'rung': rung,
                'step': step, 'points': points, 'image': image}

    def _first_nonfinite(self, job, lane):
        """(rung, step, points, None) where lane `lane` of job `job` first
        goes non-finite; (None, None, [], its final image) where it stays
        finite."""
        self._start_job(job)
        marks = []     # each EVERY-th step's point
        for r, hw in enumerate(self.rungs):
            if r > 0:
                self._switch_rung(r)
            kept = collections.deque(maxlen=KEPT + 1)
            for step in range(1, self.iterations + 1):
                end = r == len(self.rungs) - 1 and step == self.iterations
                _, images = self._collect(self._begin(1, hw), fetch=end)
                state = self._lane_state(lane, _clone)
                if marks and marks[-1]['next'] is None and (
                        marks[-1]['rung'] == r):
                    marks[-1]['next'] = _host(state['x'])
                kept.append((step, state))
                if not all(bool(torch.isfinite(state[k]).all())
                           for k in ('x', 'grad', 'loss')):
                    first = kept[0][0]
                    points = [m for m in marks if m['next'] is not None
                              and (m['rung'], m['step']) < (r, first)]
                    points += [{'rung': r, 'step': s, 'state': _on_host(st),
                                'next': _host(nxt['x'])}
                               for (s, st), (_, nxt) in zip(
                                   kept, list(kept)[1:])]
                    return r, step, points, None
                if step % EVERY == 0:
                    marks.append({'rung': r, 'step': step,
                                  'state': _on_host(state), 'next': None})
        return None, None, [], images[lane]
