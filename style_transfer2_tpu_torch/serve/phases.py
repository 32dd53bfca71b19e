"""Tier-agnostic phase schedule: ladder -> polish -> pause (VERDICT r4 #6).
A copy of style_transfer2_tpu/serve/phases.py.

Both serving tiers run the same automated session schedule — climb the
coarse-to-fine rung ladder, then a raised-precision polish tail, then
pause — but round 4 grew the bookkeeping twice, with diverging dict
shapes (serve/app.py vs serve/pool.py). This module owns the SHARED pure
logic: rung/budget arithmetic, the in-flight-transition gate, retry
accounting, completion, and the persistence encoding. The tiers keep
their mechanics — what "advance to rung r" means (a device-side grid
change vs a bucket migration), what completes a transition (the new grid
observed in the iterate stream vs the migration coroutine returning),
and what "begin polish" does (driver respawn vs cross-precision
migration) — and drive this object with three calls:

    action = sched.tick(i)        # from the iterate stream
    sched.transition_done(i)      # when the tier's advance/begin lands
    sched.transition_failed(i)    # pooled migrate raced/full -> retry

tick() returns at most one action tuple per call:
    ('advance', rung, is_final)   begin moving to `rung`; is_final means
                                  "prewarm the polish now" to the tier
    ('polish', n)                 ladder done; begin the polish tail
    ('pause',)                    polish budget spent; pause the session
and None otherwise. While a transition is in flight, tick() returns None
(budgets anchor when the tier reports completion — under pipelined
dispatch, iterates from chunks dispatched at the previous grid keep
arriving after an advance, and counting those would burn the new rung's
budget on old-grid work).
"""

import logging

logger = logging.getLogger('phases')

MAX_RETRIES = 3


def _enc_rung(r):
    """A rung is a (H, W) grid (app tier) or a scalar size (pooled tier);
    both YAML-encode losslessly."""
    return [int(x) for x in r] if isinstance(r, (tuple, list)) else int(r)


def _dec_rung(r):
    return (tuple(int(x) for x in r) if isinstance(r, (list, tuple))
            else int(r))


class Schedule:
    """One session's ladder -> polish -> pause state machine."""

    def __init__(self, rungs, per_rung, polish_n=0, max_retries=MAX_RETRIES):
        self.rungs = list(rungs)
        self.per_rung = int(per_rung)
        self.polish_n = int(polish_n)
        self.max_retries = max_retries
        self.idx = 0
        self.phase = 'ladder' if self.rungs else 'polish_pending'
        # in-flight tier action gate; budgets anchor on transition_done.
        self.in_transition = False
        self.next_at = None
        self.retries = 0
        # A restore may carry a mid-phase remaining budget to re-anchor
        # with instead of a fresh per_rung/polish_n.
        self._budget_override = None

    # -- introspection -------------------------------------------------------

    def __getitem__(self, key):
        """Dict-shape compat with the pre-Schedule tier bookkeeping: tests
        and tools index the exposed ladder/polish objects by the old dict
        keys ('idx', 'rungs', 'per_rung'; 'until_i'/'migrating' for the
        polish dict's shape)."""
        if key in ('rungs', 'idx', 'per_rung', 'polish_n'):
            return getattr(self, key)
        if key == 'until_i':   # old polish dict: budget-end counter
            return (self.next_at
                    if self.polishing and not self.in_transition else None)
        if key == 'migrating':
            return self.in_transition
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    @property
    def current_rung(self):
        return self.rungs[self.idx] if self.rungs else None

    @property
    def laddering(self):
        return self.phase == 'ladder'

    @property
    def polishing(self):
        return self.phase == 'polish'

    def _final_rung(self):
        return self.idx == len(self.rungs) - 1

    def remaining(self, i):
        """Iterations left in the current phase budget at counter i, or
        None while unanchored (mid-transition)."""
        return (None if self.next_at is None
                else max(0, int(self.next_at) - i))

    # -- lifecycle -----------------------------------------------------------

    def begin(self):
        """Starts the schedule: the first action for the tier to perform
        (advancing to rung 0, or straight to polish when rungless)."""
        if self.phase == 'ladder':
            self.in_transition = True
            return ('advance', self.rungs[0], self._final_rung())
        return self._begin_polish()

    def _begin_polish(self):
        if self.polish_n <= 0:
            self.phase = 'done'
            return None
        self.phase = 'polish'
        self.in_transition = True
        return ('polish', self._budget_or(self.polish_n))

    def _budget_or(self, default):
        budget, self._budget_override = self._budget_override, None
        return default if budget is None else budget

    def tick(self, i):
        """Consumes the session's iterate counter; returns the next action
        due, or None. Call transition_done/failed before the action's
        successor can fire."""
        if self.in_transition or self.phase == 'done':
            return None
        if self.next_at is None or i < self.next_at:
            return None
        if self.phase == 'ladder':
            self.idx += 1
            if self.idx >= len(self.rungs):
                return self._begin_polish()
            self.in_transition = True
            self.next_at = None
            return ('advance', self.rungs[self.idx], self._final_rung())
        # polish budget spent
        self.phase = 'done'
        return ('pause',)

    def transition_done(self, i):
        """The tier's in-flight action landed (grid observed / migration
        returned / polish driver ready): anchor the phase budget at i."""
        self.in_transition = False
        self.retries = 0
        budget = self._budget_or(self.per_rung if self.phase == 'ladder'
                                 else self.polish_n)
        self.next_at = i + max(0, budget)

    def transition_failed(self, i):
        """A rung advance failed transiently (pooled bucket momentarily
        full): back off one rung-budget and retry, up to max_retries —
        then the schedule cancels. Returns True while retrying."""
        self.in_transition = False
        self.retries += 1
        if self.phase != 'ladder' or self.retries > self.max_retries:
            self.phase = 'done'
            return False
        self.idx = max(0, self.idx - 1)
        self.next_at = i + self.per_rung
        return True

    # -- persistence ---------------------------------------------------------
    #
    # The encoded dict deliberately matches the round-4 app-tier YAML
    # schema (persist compatibility: snapshots written before this module
    # existed restore into it, and vice versa).

    def state(self, i, awaiting=None):
        """Persistable snapshot. `awaiting` is the tier's own pending-
        transition marker (the app tier's await_grid), stored verbatim."""
        out = {}
        if self.phase == 'ladder':
            out['ladder'] = {
                'rungs': [_enc_rung(r) for r in self.rungs],
                'idx': int(self.idx),
                'per_rung': int(self.per_rung),
                'await_grid': ([int(x) for x in awaiting]
                               if awaiting else None),
                'remaining': self.remaining(i),
            }
        if self.phase == 'polish':
            out['polish'] = {
                'remaining': (max(1, int(self.next_at) - i)
                              if self.next_at is not None
                              else int(self.polish_n)),
            }
        return out

    @classmethod
    def restore_ladder(cls, lad, polish_n=0):
        """Rebuilds a mid-ladder schedule from state()['ladder']; raises
        on malformed input (callers treat that as no-schedule)."""
        rungs = [_dec_rung(r) for r in lad['rungs']]
        idx = int(lad['idx'])
        if not 0 <= idx < len(rungs):
            raise ValueError(f'ladder idx {idx} out of range')
        sched = cls(rungs, max(1, int(lad['per_rung'])), polish_n)
        sched.idx = idx
        sched.in_transition = True   # tier re-issues/affirms the rung
        if lad.get('remaining') is not None:
            sched._budget_override = max(0, int(lad['remaining']))
        return sched

    @classmethod
    def restore_polish(cls, pol, polish_n):
        """Rebuilds a mid-polish schedule from state()['polish']."""
        sched = cls([], 0, max(1, int(polish_n)))
        sched.phase = 'polish'
        sched.in_transition = True   # tier re-establishes the tail
        sched._budget_override = max(1, int(pol['remaining']))
        return sched
