"""Training goodput: the phase vocabulary and the in-process recorder.

Copied from `skypilot_tpu/obs/goodput.py`: the category constants and
`PhaseRecorder` verbatim (pinned by `tests/test_torch_train.py`) apart
from `PhaseRecorder.from_env`.  The durable `GoodputLedger` and the
straggler functions stay out until the managed-jobs port brings the
state store they write to, so `from_env` refuses SKYTPU_GOODPUT_JOB
instead of dropping the ledger.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

from skypilot_tpu_torch.server import tracing

# ----- categories -------------------------------------------------------------
PRODUCTIVE = 'productive'
INIT_COMPILE = 'init_compile'
CHECKPOINT_SAVE = 'checkpoint_save'
CHECKPOINT_RESTORE = 'checkpoint_restore'
INPUT_STALL = 'input_stall'
PREEMPTION_DOWNTIME = 'preemption_downtime'
RECOVERY_RELAUNCH = 'recovery_relaunch'

BADPUT_CATEGORIES = (INIT_COMPILE, CHECKPOINT_SAVE, CHECKPOINT_RESTORE,
                     INPUT_STALL, PREEMPTION_DOWNTIME, RECOVERY_RELAUNCH)
CATEGORIES = (PRODUCTIVE,) + BADPUT_CATEGORIES

# The categories only the controller can observe (the worker is dead
# while they accrue).
CONTROLLER_CATEGORIES = (PREEMPTION_DOWNTIME, RECOVERY_RELAUNCH)

# Flight-recorder span names (registered in tracing.SPAN_HELP).
PHASE_SPAN = 'train.phase'
DOWNTIME_SPAN = 'jobs.downtime'
# Recorder rid when the trainer runs outside a managed job.
TRAIN_RID = 'train-goodput'

# A trainer launched by a managed job finds its ledger identity here
# (the task's run command exports it; tests set it directly).
JOB_ENV = 'SKYTPU_GOODPUT_JOB'


class PhaseRecorder:
    """In-process wall-clock classifier: at any instant exactly ONE
    category is open, so the closed intervals tile elapsed time with
    no gaps and no overlaps *by construction* — ``sum(totals) ==
    last_boundary - first_boundary`` exactly (the tiling property
    tests/test_goodput.py fuzzes).

    Two attribution mechanisms, matched to their cost budgets:

    - :meth:`begin` — a phase transition: closes the open interval
      (flight-recorder span + optional ledger write) and opens the
      next.  Used at coarse boundaries only (init→productive,
      checkpoint save, log-window roll), so the durable writes stay
      off the per-step path;
    - :meth:`carve` — re-attributes seconds *within* the open interval
      to another category (per-step input-stall time) without a span
      or db write: a dict add on the hot loop, settled when the
      interval closes.  Carves are clamped so they can never exceed
      the interval they were carved from (tiling survives a lying
      clock).
    """

    def __init__(self, job: str = '',
                 ledger: Optional[GoodputLedger] = None,
                 rid: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 to_wall: Optional[Callable[[float], float]] = None
                 ) -> None:
        self.job = str(job or '')
        self.ledger = ledger if self.job else None
        self.rid = rid or (f'job-{self.job}' if self.job else TRAIN_RID)
        self._clock = clock or time.perf_counter
        # perf_counter stamps render in wall time via the tracing
        # anchor; an injected (sim) clock is its own wall time.
        if to_wall is not None:
            self._to_wall = to_wall
        elif clock is None:
            self._to_wall = tracing.wall_of
        else:
            self._to_wall = lambda t: t
        self.totals: Dict[str, float] = {}
        self._cat: Optional[str] = None
        self._t0: Optional[float] = None
        self._carves: Dict[str, float] = {}

    @classmethod
    def from_env(cls) -> 'PhaseRecorder':
        """The trainer's default: local recording (gauges + flight
        recorder only).  A managed job exports SKYTPU_GOODPUT_JOB for the
        durable ledger, which this package does not have yet: refused
        rather than silently dropped."""
        job = os.environ.get(JOB_ENV, '').strip()
        if job:
            raise RuntimeError(
                f'{JOB_ENV}={job!r} asks for the durable goodput ledger, '
                f'which comes with the managed-jobs port; unset it to '
                f'record phases locally')
        return cls()

    def now(self) -> float:
        return self._clock()

    @property
    def category(self) -> Optional[str]:
        return self._cat

    def begin(self, category: str, now: Optional[float] = None) -> None:
        """Close the open interval (if any) at ``now`` and open
        ``category``.  Re-beginning the same category rolls the
        interval — the flush point for long productive windows."""
        if category not in CATEGORIES:
            raise ValueError(f'unknown goodput category: {category!r}')
        now = self.now() if now is None else now
        self._close_open(now)
        self._cat = category
        self._t0 = now
        self._carves = {}

    def carve(self, category: str, seconds: float) -> None:
        """Attribute ``seconds`` of the OPEN interval to ``category``
        instead of the interval's own; settled (clamped to the
        interval's duration) at close.  Hot-loop safe: no span, no db,
        no lock."""
        if self._cat is None or seconds <= 0:
            return
        self._carves[category] = self._carves.get(category, 0.0) \
            + seconds

    def close(self, now: Optional[float] = None) -> Dict[str, float]:
        """Close the open interval and return the final totals."""
        now = self.now() if now is None else now
        self._close_open(now)
        return dict(self.totals)

    def _close_open(self, now: float) -> None:
        if self._cat is None:
            return
        dur = max(0.0, now - self._t0)
        attrs: Dict[str, float] = {}
        carved = 0.0
        for cat, sec in self._carves.items():
            sec = min(sec, dur - carved)
            if sec <= 0:
                continue
            carved += sec
            self.totals[cat] = self.totals.get(cat, 0.0) + sec
            attrs[f'{cat}_s'] = round(sec, 6)
            if self.ledger is not None:
                self.ledger.add(self.job, cat, sec)
        main = dur - carved
        self.totals[self._cat] = self.totals.get(self._cat, 0.0) + main
        if self.ledger is not None:
            self.ledger.add(self.job, self._cat, main,
                            t0=self._to_wall(self._t0),
                            t1=self._to_wall(now))
        tracing.record_span(self.rid, PHASE_SPAN, self._t0, now,
                            category=self._cat, **attrs)
        self._cat = None
        self._t0 = None
        self._carves = {}

    # ----- live views (open interval included) --------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        """Totals as-if the open interval closed at ``now`` — without
        closing it (no span, no db write): the gauge-export view."""
        snap = dict(self.totals)
        if self._cat is not None:
            now = self.now() if now is None else now
            dur = max(0.0, now - self._t0)
            carved = 0.0
            for cat, sec in self._carves.items():
                sec = min(sec, dur - carved)
                if sec <= 0:
                    continue
                carved += sec
                snap[cat] = snap.get(cat, 0.0) + sec
            snap[self._cat] = snap.get(self._cat, 0.0) + (dur - carved)
        return snap

    def productive_s(self, now: Optional[float] = None) -> float:
        """Productive seconds including the open interval's elapsed
        share — the denominator of badput-aware throughput."""
        return self.snapshot(now).get(PRODUCTIVE, 0.0)

    def goodput_pct(self, now: Optional[float] = None
                    ) -> Optional[float]:
        snap = self.snapshot(now)
        wall = sum(snap.values())
        if wall <= 0:
            return None
        return 100.0 * snap.get(PRODUCTIVE, 0.0) / wall
