"""Training goodput ledger + multi-host straggler detection.

Serving got its trend layer in PR 19; this module gives training jobs
the same treatment.  Every second of a managed job's wall-clock is
classified into exactly one category — productive step time or one of
the badput buckets below — and the classification survives the two
ways training state usually dies: the *worker* process is preempted
with its slice (the trainer's in-memory recorder is gone) and the
*controller* restarts (its poll loop forgets what it was timing).
Both therefore write through to one durable ``goodput_ledger`` table
behind the pluggable state backend (sqlite + Postgres via the PR 15
dialect layer, same idiom as obs/store.py), keyed ``(job, category)``
with additive upserts — so the breakdown SUMS across recoveries and
controller restarts, and ``goodput_pct = productive / wall`` is a
number you can still compute after the job (and its cluster, and its
processes) are all gone.

Two producers write the ledger:

- the **trainer** (train/trainer.py) runs a :class:`PhaseRecorder` —
  an interval state machine over host-side ``perf_counter`` stamps
  (ZERO device syncs, zero recompile perturbation: classification
  never touches a jax value).  Coarse phases (init/XLA-compile,
  checkpoint save/restore, productive windows) are interval
  transitions; per-step input-stall time is *carved* out of the open
  productive interval without a per-step flight-recorder event, so
  the hot loop pays two ``perf_counter`` calls and a float add;
- the **jobs controller** (jobs/controller.py) writes the categories
  only it can see: ``preemption_downtime`` (preemption detected →
  recovery dispatch) and ``recovery_relaunch`` (slice delete +
  re-provision + resubmit → RUNNING again), bracketed by the
  ``jobs.preemption`` / ``jobs.recovery`` flight-recorder instants
  PR 11 already records.

Straggler detection rides the per-host step-time histograms the
trainer now exports (``skytpu_train_step_seconds{host=...}``): the
store keeps the host label through downsampling
(obs/store.py HISTOGRAM_SUB_FAMILIES) and
:func:`step_time_skew` derives max-host-p50 / median-host-p50 per
window into the ``skytpu_train_step_skew`` gauge, which the
``straggler`` alert rule (obs/alerts.train_rules) burns on.
"""
from __future__ import annotations

import os
import statistics
import time
from typing import Callable, Dict, List, Optional

from skypilot_tpu_torch.serve import metrics_math
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing
from skypilot_tpu_torch.utils import db_utils

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

_DDL = [
    # Additive per-(job, category) accumulator: the durable headline.
    """CREATE TABLE IF NOT EXISTS goodput_ledger (
        job TEXT NOT NULL,
        category TEXT NOT NULL,
        seconds REAL NOT NULL,
        intervals INTEGER NOT NULL,
        updated_at REAL NOT NULL,
        PRIMARY KEY (job, category))""",
    # Individual wall-clock intervals (recovery timeline feedstock for
    # `skytpu jobs top` postmortems — the flight-recorder ring dies
    # with its process; these rows do not).
    """CREATE TABLE IF NOT EXISTS goodput_intervals (
        job TEXT NOT NULL,
        category TEXT NOT NULL,
        t0 REAL NOT NULL,
        t1 REAL NOT NULL,
        PRIMARY KEY (job, category, t0))""",
]


def jobs_dsn() -> str:
    """The ledger's default home: the managed-jobs control-plane store
    (shared Postgres when SKYTPU_DB_URL is set, per-host sqlite
    otherwise) — the controller and `jobs top` already read it."""
    return db_utils.control_plane_dsn('SKYTPU_JOBS_DB',
                                      '~/.skytpu/managed_jobs.db')


class GoodputLedger:
    """The durable (job, category) -> seconds accumulator.

    Cheap to construct (schema creation is memoized by
    db_utils.ensure_schema); every write is one small transaction, so
    two producers (trainer on the task cluster, controller on the
    control plane) can add concurrently without coordination — the
    upsert is additive and they never write the same category."""

    def __init__(self, dsn: Optional[str] = None) -> None:
        self.dsn = dsn or jobs_dsn()

    def _ensure(self) -> str:
        db_utils.ensure_schema(self.dsn, _DDL)
        return self.dsn

    def add(self, job: str, category: str, seconds: float,
            t0: Optional[float] = None, t1: Optional[float] = None,
            now: Optional[float] = None) -> None:
        """Accumulate ``seconds`` into (job, category); when the
        interval's wall-clock bounds are known, also keep the interval
        row (timeline evidence).  Zero/negative durations are dropped
        — the recorder's tiling arithmetic never produces them, and a
        skipped empty interval cannot create a gap (its neighbours
        share the boundary stamp)."""
        if category not in CATEGORIES:
            raise ValueError(f'unknown goodput category: {category!r}')
        if seconds <= 0:
            return
        now = time.time() if now is None else now
        dsn = self._ensure()
        with db_utils.transaction(dsn) as conn:
            conn.execute(
                'INSERT INTO goodput_ledger '
                '(job, category, seconds, intervals, updated_at) '
                'VALUES (?,?,?,1,?) '
                'ON CONFLICT(job, category) DO UPDATE SET '
                'seconds = goodput_ledger.seconds + excluded.seconds, '
                'intervals = goodput_ledger.intervals + 1, '
                'updated_at = excluded.updated_at',
                (str(job), category, float(seconds), now))
            if t0 is not None and t1 is not None and t1 > t0:
                conn.execute(
                    'INSERT INTO goodput_intervals (job, category, t0, t1) '
                    'VALUES (?,?,?,?) '
                    'ON CONFLICT(job, category, t0) DO NOTHING',
                    (str(job), category, float(t0), float(t1)))

    # ----- queries ------------------------------------------------------------
    def totals(self, job: str) -> Dict[str, float]:
        return {r['category']: float(r['seconds'])
                for r in db_utils.query(
                    self._ensure(),
                    'SELECT category, seconds FROM goodput_ledger '
                    'WHERE job=?', (str(job),))}

    def wall(self, job: str) -> float:
        """Total classified wall-clock (the categories tile it)."""
        return sum(self.totals(job).values())

    def goodput_pct(self, job: str) -> Optional[float]:
        totals = self.totals(job)
        wall = sum(totals.values())
        if wall <= 0:
            return None
        return 100.0 * totals.get(PRODUCTIVE, 0.0) / wall

    def downtime_s(self, job: str) -> float:
        """Cumulative recovery cost: the controller-observed
        categories (the `jobs queue` DOWNTIME column)."""
        totals = self.totals(job)
        return sum(totals.get(c, 0.0) for c in CONTROLLER_CATEGORIES)

    def downtime_by_job(self) -> Dict[str, float]:
        """One query for the whole queue listing."""
        out: Dict[str, float] = {}
        marks = ','.join('?' * len(CONTROLLER_CATEGORIES))
        for r in db_utils.query(
                self._ensure(),
                f'SELECT job, SUM(seconds) AS s FROM goodput_ledger '
                f'WHERE category IN ({marks}) GROUP BY job',
                tuple(CONTROLLER_CATEGORIES)):
            out[r['job']] = float(r['s'])
        return out

    def intervals(self, job: str, category: Optional[str] = None
                  ) -> List[Dict]:
        sql = ('SELECT category, t0, t1 FROM goodput_intervals '
               'WHERE job=?')
        params: list = [str(job)]
        if category is not None:
            sql += ' AND category=?'
            params.append(category)
        sql += ' ORDER BY t0'
        return [{'category': r['category'], 't0': float(r['t0']),
                 't1': float(r['t1'])}
                for r in db_utils.query(self._ensure(), sql,
                                        tuple(params))]

    def jobs(self) -> List[str]:
        return [r['job'] for r in db_utils.query(
            self._ensure(),
            'SELECT DISTINCT job FROM goodput_ledger ORDER BY job')]


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
        """The trainer's default: a managed job exports SKYTPU_GOODPUT_JOB
        and gets durable accumulation; anything else records locally
        (gauges + flight recorder only)."""
        job = os.environ.get(JOB_ENV, '').strip()
        return cls(job=job, ledger=GoodputLedger() if job else None)

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


# ----- straggler detection ----------------------------------------------------
def step_time_skew(store, service: str, t0: float, t1: float,
                   q: float = 0.5) -> Optional[Dict]:
    """Per-host step-time skew over ``(t0, t1]``: max-host p50 over
    median-host p50 from the host-labeled step histograms the store
    keeps (HISTOGRAM_SUB_FAMILIES).  None below two reporting hosts —
    a single host has no skew, and a dead scrape must not read as
    'balanced'."""
    by_host = store.histogram_window_by_replica(
        service, metrics_lib.TRAIN_STEP_FAMILY, t0, t1)
    p50s: Dict[str, float] = {}
    for host, cum in by_host.items():
        if not host:
            continue  # unlabeled legacy series: no host attribution
        v = metrics_math.quantile_from_cumulative(cum, q)
        if v is not None and v > 0:
            p50s[host] = v
    if len(p50s) < 2:
        return None
    med = statistics.median(p50s.values())
    if med <= 0:
        return None
    slow_host = max(p50s, key=lambda h: p50s[h])
    return {
        'skew': p50s[slow_host] / med,
        'slow_host': slow_host,
        'p50_by_host': p50s,
    }


def evaluate_stragglers(store, service: str,
                        now: Optional[float] = None,
                        window: Optional[float] = None
                        ) -> Optional[Dict]:
    """Controller-side skew tick: derive the window's skew, export it
    as the ``skytpu_train_step_skew`` gauge AND write it into the
    store (a derived gauge row), so the `straggler` alert rule burns
    on the same number `jobs top` renders."""
    if now is None:
        now = store.last_t(service)
        now = time.time() if now is None else now
    if window is None:
        window = max(60.0, 6.0 * store.resolution)
    res = step_time_skew(store, service, now - window, now)
    if res is None:
        return None
    metrics_lib.set_gauge(metrics_lib.TRAIN_STEP_SKEW_FAMILY,
                          res['skew'], service=service)
    store.put_gauge(service, metrics_lib.TRAIN_STEP_SKEW_FAMILY,
                    res['skew'], now)
    return res


def train_obs_tick(store, service: str, exposition: str, now: float,
                   engine=None, roles: Optional[Dict[str, str]] = None
                   ) -> Optional[Dict]:
    """One controller tick for a training job, mirroring the serve
    controller's `_obs_tick`: ingest the workers' federated scrape,
    derive the skew gauge, evaluate the train alert rules.  Returns
    the skew result (None when skew is not derivable this tick)."""
    skew = None
    if store.ingest(service, exposition, now=now, roles=roles):
        skew = evaluate_stragglers(store, service, now=now)
        if engine is not None:
            engine.evaluate(now)
    return skew
