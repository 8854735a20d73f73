"""Durable time-series store over the controller's federated scrapes.

The serve controller already scrapes its LB's federated ``/metrics``
once per decision tick (every ready replica's engine series relabeled
``replica="<id>"``).  This module downsamples those scrapes into a
retention-bounded table behind the pluggable state backend, so trend
queries (burn rates, sparklines, `skytpu top`) survive process
restarts and are visible from any control-plane replica:

- **histograms** (TTFT/TPOT/LB duration): cumulative-since-boot per
  series; the Downsampler computes per-series bucket DELTAS with the
  same counter-reset clamping as ``metrics_math.WindowedHistogram`` —
  a restarted replica re-baselines instead of going negative, a
  rejoining series contributes nothing until its second scrape — and
  the store keeps the deltas summed per pool (events per interval);
- **counters**: per-series reset-clamped deltas, summed per pool (an
  optional sub-label, e.g. ``outcome``, lands in the ``bucket`` key);
- **gauges**: point-in-time values kept per replica (free pages,
  spec acceptance, prefix fingerprint, scrape age).

Row key: ``(service, pool, replica, family, bucket, t)`` where ``t``
is the resolution-aligned interval start.  Knobs:
``SKYTPU_OBS_RESOLUTION_S`` (interval width, default 10 s) and
``SKYTPU_OBS_RETENTION_S`` (default 21600 s = 6 h — the slow burn
window below needs it).  Ingest is WRITTEN ONLY BY THE SINGLETON-LEASE
HOLDER when lease mode is on (multi-replica control planes must not
double-count deltas); every ingest also writes one
``skytpu_obs_ingest_total`` heartbeat row, which is what the
dark-scrape alert rule measures gaps in.

All SQL goes through utils/db_utils (skytpu check: db-discipline), so
the table exists identically on sqlite and Postgres via the PR 15
dialect layer.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Tuple

from skypilot_tpu_torch.serve import metrics_math
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.state import leases
from skypilot_tpu_torch.utils import db_utils

RESOLUTION_ENV = 'SKYTPU_OBS_RESOLUTION_S'
RETENTION_ENV = 'SKYTPU_OBS_RETENTION_S'
DEFAULT_RESOLUTION_S = 10.0
DEFAULT_RETENTION_S = 21600.0
# Singleton-lease role gating ingest in lease mode (one writer per
# fleet — two control-plane replicas double-COUNTING deltas would halve
# every rate's apparent interval).
INGEST_LEASE = 'obs-ingest'
# Per-ingest heartbeat family: one row per performed ingest interval.
# Registered in server/metrics.py _HELP (the registry counter twin is
# incremented on every ingest), so alert rules may reference it.
INGEST_FAMILY = 'skytpu_obs_ingest_total'

# What gets downsampled out of a federated scrape.  Histograms keep
# their per-bucket deltas (quantiles need the distribution); counters
# keep event deltas; gauges keep per-replica point-in-time values.
HISTOGRAM_FAMILIES: Tuple[str, ...] = (
    metrics_lib.ENGINE_TTFT_FAMILY,
    metrics_lib.ENGINE_TPOT_FAMILY,
    'skytpu_lb_request_duration_seconds',
    metrics_lib.TRAIN_STEP_FAMILY,
)
# histogram family -> sub-label kept through downsampling (lands in
# the `replica` column, one distribution per label value).  Step-time
# histograms keep their `host` label so straggler skew (max-host p50 /
# median-host p50, obs/goodput.py) is derivable from store rows alone.
HISTOGRAM_SUB_FAMILIES: Dict[str, str] = {
    metrics_lib.TRAIN_STEP_FAMILY: 'host',
}
# family -> sub-label whose value keys the `bucket` column (None:
# aggregate every series of the family into one row per interval).
COUNTER_FAMILIES: Dict[str, Optional[str]] = {
    'skytpu_lb_requests_total': None,
    'skytpu_lb_shed_total': None,
    'skytpu_engine_requests_total': None,
    'skytpu_engine_prefix_cache_hits_total': None,
    'skytpu_engine_prefix_cache_misses_total': None,
    'skytpu_engine_spec_proposed_tokens_total': None,
    'skytpu_engine_spec_accepted_tokens_total': None,
    'skytpu_fleetsim_requests_total': 'outcome',
}
GAUGE_FAMILIES: Tuple[str, ...] = (
    'skytpu_engine_kv_free_pages',
    'skytpu_engine_spec_acceptance',
    'skytpu_engine_prefix_fingerprint',
    'skytpu_engine_mfu',
    metrics_lib.QUEUED_PREFILL_TOKENS_FAMILY,
    'skytpu_lb_scrape_age_seconds',
    # Training goodput plane: the headline goodput gauge from worker
    # scrapes; the skew gauge is DERIVED controller-side
    # (obs/goodput.evaluate_stragglers writes it via put_gauge) but
    # listed so a federated re-scrape of a controller round-trips it.
    metrics_lib.TRAIN_GOODPUT_FAMILY,
    metrics_lib.TRAIN_STEP_SKEW_FAMILY,
)

_DDL = [
    """CREATE TABLE IF NOT EXISTS obs_samples (
        service TEXT NOT NULL,
        pool TEXT NOT NULL,
        replica TEXT NOT NULL,
        family TEXT NOT NULL,
        bucket TEXT NOT NULL,
        t REAL NOT NULL,
        value REAL NOT NULL,
        PRIMARY KEY (service, pool, replica, family, bucket, t))""",
    """CREATE INDEX IF NOT EXISTS obs_samples_family_t
        ON obs_samples (service, family, t)""",
    """CREATE TABLE IF NOT EXISTS obs_alerts (
        service TEXT NOT NULL,
        rule TEXT NOT NULL,
        pool TEXT NOT NULL,
        state TEXT NOT NULL,
        fired_at REAL NOT NULL,
        cleared_at REAL,
        burn REAL,
        detail TEXT,
        PRIMARY KEY (service, rule, fired_at))""",
]


def resolution_s() -> float:
    try:
        return float(os.environ.get(RESOLUTION_ENV,
                                    DEFAULT_RESOLUTION_S))
    except ValueError:
        return DEFAULT_RESOLUTION_S


def retention_s() -> float:
    try:
        return float(os.environ.get(RETENTION_ENV, DEFAULT_RETENTION_S))
    except ValueError:
        return DEFAULT_RETENTION_S


def _le_text(le: float) -> str:
    """Stable text key for a histogram bound (the `bucket` column)."""
    return '+Inf' if math.isinf(le) else repr(float(le))


def _le_value(text: str) -> float:
    return math.inf if text == '+Inf' else float(text)


class Downsampler:
    """Per-series reset-aware delta extraction from successive scrapes.

    Holds one baseline per (family, series-label-set).  A scrape's
    delta for a series is ``current - baseline`` clamped at zero; a
    series whose cumulative values went BACKWARD (replica restart
    zeroes its registry) or that was never seen before contributes
    NOTHING this scrape and only re-baselines — the same one-window-of-
    partial-vision-beats-negative-deltas posture as
    metrics_math.WindowedHistogram.  Baselines unseen for
    ``forget_after_s`` are dropped, so a replica that churns out and
    back after a long absence is just a new series (its since-boot
    cumulative counts are never mistaken for one interval's events).
    """

    def __init__(self, forget_after_s: float = 600.0) -> None:
        self.forget_after_s = forget_after_s
        # (family, series_key) -> {le: cumulative} | float
        self._hist: Dict[Tuple[str, tuple], Dict[float, float]] = {}
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._seen: Dict[Tuple[str, tuple], float] = {}

    @staticmethod
    def _series_key(labels: Dict[str, str]) -> tuple:
        return tuple(sorted((k, v) for k, v in labels.items()
                            if k != 'le'))

    def _touch(self, key: Tuple[str, tuple], now: float) -> None:
        self._seen[key] = now

    def _forget_stale(self, now: float) -> None:
        stale = [k for k, seen in self._seen.items()
                 if now - seen > self.forget_after_s]
        for k in stale:
            del self._seen[k]
            self._hist.pop(k, None)
            self._counters.pop(k, None)

    def observe(self, samples: List[Tuple[str, Dict[str, str], float]],
                now: float, roles: Optional[Dict[str, str]] = None
                ) -> Dict[str, Dict[tuple, float]]:
        """One scrape in, pool-aggregated deltas/gauges out.

        Returns ``{'hist': {(family, pool, sub, le_text): delta},
        'counters': {(family, pool, bucket): delta},
        'gauges': {(family, pool, replica): value}}``.  ``roles`` maps
        replica label -> pool name for pool attribution; unlabeled or
        unknown series land under pool ''.  ``sub`` is the series'
        HISTOGRAM_SUB_FAMILIES label value ('' for families without a
        sub-label); it lands in the store's ``replica`` column so
        per-host step-time distributions survive downsampling.
        """
        roles = roles or {}
        hist: Dict[tuple, float] = {}
        counters: Dict[tuple, float] = {}
        gauges: Dict[tuple, float] = {}

        for family in HISTOGRAM_FAMILIES:
            by_series = metrics_math.histogram_cumulative_by_series(
                samples, family)
            for skey, cum in by_series.items():
                key = (family, skey)
                prev = self._hist.get(key)
                self._hist[key] = dict(cum)
                self._touch(key, now)
                if prev is None or any(
                        cum.get(le, 0.0) < count - 1e-9
                        for le, count in prev.items()):
                    continue  # new series or reset: baseline only
                pool = self._pool_of(skey, roles)
                sub_label = HISTOGRAM_SUB_FAMILIES.get(family)
                sub = (dict(skey).get(sub_label, '')
                       if sub_label else '')
                for le, count in cum.items():
                    delta = count - prev.get(le, 0.0)
                    if delta > 0.0:
                        k = (family, pool, sub, _le_text(le))
                        hist[k] = hist.get(k, 0.0) + delta

        for name, labels, value in samples:
            if name in COUNTER_FAMILIES and math.isfinite(value):
                skey = self._series_key(labels)
                key = (name, skey)
                prev = self._counters.get(key)
                self._counters[key] = value
                self._touch(key, now)
                if prev is None or value < prev - 1e-9:
                    continue  # new series or reset: baseline only
                delta = value - prev
                if delta <= 0.0:
                    continue
                pool = roles.get(labels.get('replica', ''), '')
                sub_label = COUNTER_FAMILIES[name]
                bucket = labels.get(sub_label, '') if sub_label else ''
                k = (name, pool, bucket)
                counters[k] = counters.get(k, 0.0) + delta
            elif name in GAUGE_FAMILIES and math.isfinite(value):
                replica = labels.get('replica', '')
                pool = roles.get(replica, '')
                gauges[(name, pool, replica)] = value

        self._forget_stale(now)
        return {'hist': hist, 'counters': counters, 'gauges': gauges}

    @staticmethod
    def _pool_of(series_key: tuple, roles: Dict[str, str]) -> str:
        labels = dict(series_key)
        return roles.get(labels.get('replica', ''), '')


class TelemetryStore:
    """The durable fleet time-series table + its query API.

    One instance per (dsn, service-scope); safe to construct cheaply —
    schema creation is memoized by db_utils.ensure_schema.
    """

    def __init__(self, dsn: str,
                 resolution: Optional[float] = None,
                 retention: Optional[float] = None) -> None:
        self.dsn = dsn
        self.resolution = (resolution_s() if resolution is None
                           else float(resolution))
        self.retention = (retention_s() if retention is None
                          else float(retention))
        self._down = Downsampler(
            forget_after_s=max(60.0, 10.0 * self.resolution))
        self._last_prune_bucket: Optional[float] = None

    def _ensure(self) -> str:
        db_utils.ensure_schema(self.dsn, _DDL)
        return self.dsn

    def bucket_t(self, now: float) -> float:
        res = max(self.resolution, 1e-9)
        return math.floor(now / res) * res

    # ----- ingest -------------------------------------------------------------
    def ingest(self, service: str, text: str,
               now: Optional[float] = None,
               roles: Optional[Dict[str, str]] = None,
               leader_check: bool = True) -> bool:
        """Downsample one federated scrape into the table.

        Returns False (writing NOTHING) when lease mode is on and this
        process does not hold the obs-ingest singleton lease — the
        second control-plane replica of an HA deployment must observe,
        not write.  Callers that already gated the tick on a singleton
        lease (the fleetsim decision tick) pass ``leader_check=False``
        rather than re-acquiring per scrape.
        """
        now = time.time() if now is None else now
        if self.resolution <= 0:
            return False
        if leader_check and leases.lease_mode(self.dsn):
            if not leases.try_acquire_singleton(self.dsn, INGEST_LEASE):
                return False
        t0 = time.perf_counter()
        dsn = self._ensure()
        deltas = self._down.observe(metrics_math.parse_samples(text),
                                    now, roles)
        tb = self.bucket_t(now)
        add_sql = (
            'INSERT INTO obs_samples '
            '(service, pool, replica, family, bucket, t, value) '
            'VALUES (?,?,?,?,?,?,?) '
            'ON CONFLICT(service, pool, replica, family, bucket, t) '
            'DO UPDATE SET value = obs_samples.value + excluded.value')
        set_sql = (
            'INSERT INTO obs_samples '
            '(service, pool, replica, family, bucket, t, value) '
            'VALUES (?,?,?,?,?,?,?) '
            'ON CONFLICT(service, pool, replica, family, bucket, t) '
            'DO UPDATE SET value = excluded.value')
        with db_utils.transaction(dsn) as conn:
            for (family, pool, sub, bucket), delta in \
                    deltas['hist'].items():
                conn.execute(add_sql, (service, pool, sub, family,
                                       bucket, tb, delta))
            for (family, pool, bucket), delta in \
                    deltas['counters'].items():
                conn.execute(add_sql, (service, pool, '', family,
                                       bucket, tb, delta))
            for (family, pool, replica), value in \
                    deltas['gauges'].items():
                conn.execute(set_sql, (service, pool, replica, family,
                                       '', tb, value))
            # Ingest heartbeat: the dark-scrape rule measures gaps in
            # THIS family's interval coverage.
            conn.execute(add_sql, (service, '', '', INGEST_FAMILY, '',
                                   tb, 1.0))
        self._prune(service, now)
        metrics_lib.inc_counter(INGEST_FAMILY, service=service)
        metrics_lib.observe_hist('skytpu_obs_ingest_seconds',
                                 time.perf_counter() - t0,
                                 service=service)
        return True

    def _prune(self, service: str, now: float) -> None:
        """Retention: drop rows older than the horizon, at most once
        per resolution interval (a DELETE per scrape would double the
        write load for nothing)."""
        tb = self.bucket_t(now)
        if self._last_prune_bucket == tb:
            return
        self._last_prune_bucket = tb
        db_utils.execute(
            self._ensure(),
            'DELETE FROM obs_samples WHERE service=? AND t < ?',
            (service, now - self.retention))

    # ----- query API ----------------------------------------------------------
    def histogram_window(self, service: str, family: str,
                         t0: float, t1: float,
                         pool: Optional[str] = None
                         ) -> Dict[float, float]:
        """Summed per-bucket event counts in ``(t0, t1]`` as a
        cumulative-shaped {le: count} map (feedable to
        metrics_math.quantile_from_cumulative)."""
        sql = ('SELECT bucket, value FROM obs_samples WHERE service=? '
               'AND family=? AND t > ? AND t <= ?')
        params: list = [service, family, t0, t1]
        if pool is not None:
            sql += ' AND pool=?'
            params.append(pool)
        agg: Dict[float, float] = {}
        for row in db_utils.query(self._ensure(), sql, tuple(params)):
            try:
                le = _le_value(row['bucket'])
            except ValueError:
                continue
            agg[le] = agg.get(le, 0.0) + float(row['value'])
        return agg

    def histogram_window_by_replica(self, service: str, family: str,
                                    t0: float, t1: float
                                    ) -> Dict[str, Dict[float, float]]:
        """Per-replica-column bucket counts in ``(t0, t1]`` — for
        sub-labeled histogram families (HISTOGRAM_SUB_FAMILIES) the
        replica column holds the sub-label value (e.g. ``host``), so
        this is the per-host step-time distribution the straggler
        detector compares quantiles across."""
        sql = ('SELECT replica, bucket, value FROM obs_samples WHERE '
               'service=? AND family=? AND t > ? AND t <= ?')
        out: Dict[str, Dict[float, float]] = {}
        for row in db_utils.query(self._ensure(), sql,
                                  (service, family, t0, t1)):
            try:
                le = _le_value(row['bucket'])
            except ValueError:
                continue
            agg = out.setdefault(row['replica'], {})
            agg[le] = agg.get(le, 0.0) + float(row['value'])
        return out

    def quantile(self, service: str, family: str, t0: float, t1: float,
                 q: float, pool: Optional[str] = None
                 ) -> Optional[float]:
        return metrics_math.quantile_from_cumulative(
            self.histogram_window(service, family, t0, t1, pool), q)

    def counter_sum(self, service: str, family: str,
                    t0: float, t1: float,
                    bucket: Optional[str] = None,
                    pool: Optional[str] = None) -> float:
        sql = ('SELECT COALESCE(SUM(value), 0) AS s FROM obs_samples '
               'WHERE service=? AND family=? AND t > ? AND t <= ?')
        params: list = [service, family, t0, t1]
        if bucket is not None:
            sql += ' AND bucket=?'
            params.append(bucket)
        if pool is not None:
            sql += ' AND pool=?'
            params.append(pool)
        row = db_utils.query_one(self._ensure(), sql, tuple(params))
        return float(row['s']) if row is not None else 0.0

    def gauge_min(self, service: str, family: str, t0: float, t1: float,
                  pool: Optional[str] = None) -> Optional[float]:
        """Worst (lowest) gauge value any replica reported in the
        window — the exhaustion signal for floor-type rules."""
        sql = ('SELECT MIN(value) AS m FROM obs_samples WHERE '
               'service=? AND family=? AND t > ? AND t <= ?')
        params: list = [service, family, t0, t1]
        if pool is not None:
            sql += ' AND pool=?'
            params.append(pool)
        row = db_utils.query_one(self._ensure(), sql, tuple(params))
        if row is None or row['m'] is None:
            return None
        return float(row['m'])

    def gauge_max(self, service: str, family: str, t0: float, t1: float,
                  pool: Optional[str] = None) -> Optional[float]:
        """Worst (highest) gauge value in the window — the ceiling
        signal for gauge_high rules (step-time skew)."""
        sql = ('SELECT MAX(value) AS m FROM obs_samples WHERE '
               'service=? AND family=? AND t > ? AND t <= ?')
        params: list = [service, family, t0, t1]
        if pool is not None:
            sql += ' AND pool=?'
            params.append(pool)
        row = db_utils.query_one(self._ensure(), sql, tuple(params))
        if row is None or row['m'] is None:
            return None
        return float(row['m'])

    def put_gauge(self, service: str, family: str, value: float,
                  now: float, pool: str = '', replica: str = '') -> None:
        """Write one DERIVED gauge interval directly (not via a
        scrape) — how the controller lands computed signals like
        step-time skew in the same table its alert rules read."""
        db_utils.execute(
            self._ensure(),
            'INSERT INTO obs_samples '
            '(service, pool, replica, family, bucket, t, value) '
            'VALUES (?,?,?,?,?,?,?) '
            'ON CONFLICT(service, pool, replica, family, bucket, t) '
            'DO UPDATE SET value = excluded.value',
            (service, pool, replica, family, '', self.bucket_t(now),
             float(value)))

    def gauge_latest(self, service: str, family: str,
                     replica: Optional[str] = None,
                     pool: Optional[str] = None
                     ) -> Dict[str, float]:
        """Latest value per replica label (newest interval wins)."""
        sql = ('SELECT replica, t, value FROM obs_samples WHERE '
               'service=? AND family=?')
        params: list = [service, family]
        if replica is not None:
            sql += ' AND replica=?'
            params.append(replica)
        if pool is not None:
            sql += ' AND pool=?'
            params.append(pool)
        sql += ' ORDER BY t'
        out: Dict[str, float] = {}
        for row in db_utils.query(self._ensure(), sql, tuple(params)):
            out[row['replica']] = float(row['value'])
        return out

    def series(self, service: str, family: str, t0: float, t1: float,
               bucket: Optional[str] = None,
               pool: Optional[str] = None
               ) -> List[Tuple[float, float]]:
        """(t, summed value) per interval — sparkline feedstock."""
        sql = ('SELECT t, SUM(value) AS v FROM obs_samples WHERE '
               'service=? AND family=? AND t > ? AND t <= ?')
        params: list = [service, family, t0, t1]
        if bucket is not None:
            sql += ' AND bucket=?'
            params.append(bucket)
        if pool is not None:
            sql += ' AND pool=?'
            params.append(pool)
        sql += ' GROUP BY t ORDER BY t'
        return [(float(r['t']), float(r['v']))
                for r in db_utils.query(self._ensure(), sql,
                                        tuple(params))]

    def first_t(self, service: str, family: str) -> Optional[float]:
        """Oldest retained interval of a family — the dark-scrape rule
        only counts an interval as missing once the store has history
        reaching back to it (a fresh deployment is not dark)."""
        row = db_utils.query_one(
            self._ensure(),
            'SELECT MIN(t) AS m FROM obs_samples WHERE service=? '
            'AND family=?', (service, family))
        if row is None or row['m'] is None:
            return None
        return float(row['m'])

    def last_t(self, service: str) -> Optional[float]:
        """Newest retained interval of the service — `skytpu top`'s
        frame anchor, so a postmortem view of a dead fleet (or a
        sim-time store) lands on the data instead of an empty
        wall-clock window."""
        row = db_utils.query_one(
            self._ensure(),
            'SELECT MAX(t) AS m FROM obs_samples WHERE service=?',
            (service,))
        if row is None or row['m'] is None:
            return None
        return float(row['m'])

    def present_intervals(self, service: str, family: str,
                          t0: float, t1: float) -> int:
        """Distinct resolution intervals holding any row of the family
        in ``(t0, t1]`` — the dark-scrape rule's coverage count."""
        row = db_utils.query_one(
            self._ensure(),
            'SELECT COUNT(DISTINCT t) AS n FROM obs_samples WHERE '
            'service=? AND family=? AND t > ? AND t <= ?',
            (service, family, t0, t1))
        return int(row['n']) if row is not None else 0

    def services(self) -> List[str]:
        return [r['service'] for r in db_utils.query(
            self._ensure(),
            'SELECT DISTINCT service FROM obs_samples ORDER BY service')]

    def pools(self, service: str, t0: float, t1: float) -> List[str]:
        """Distinct pool tags with any row in ``(t0, t1]`` ('' =
        unattributed, e.g. LB-level families)."""
        return [r['pool'] for r in db_utils.query(
            self._ensure(),
            'SELECT DISTINCT pool FROM obs_samples WHERE service=? '
            'AND t > ? AND t <= ? ORDER BY pool',
            (service, t0, t1))]

    # ----- alert rows (written by obs/alerts.py, read by CLI/LB) --------------
    def fire_alert(self, service: str, rule: str, pool: str,
                   fired_at: float, burn: float, detail: str) -> None:
        db_utils.execute(
            self._ensure(),
            'INSERT INTO obs_alerts '
            '(service, rule, pool, state, fired_at, burn, detail) '
            "VALUES (?,?,?,'firing',?,?,?)",
            (service, rule, pool, fired_at, burn, detail))

    def clear_alert(self, service: str, rule: str,
                    cleared_at: float) -> None:
        db_utils.execute(
            self._ensure(),
            "UPDATE obs_alerts SET state='cleared', cleared_at=? "
            "WHERE service=? AND rule=? AND state='firing'",
            (cleared_at, service, rule))

    def active_alerts(self, service: Optional[str] = None
                      ) -> List[Dict]:
        sql = ("SELECT * FROM obs_alerts WHERE state='firing'")
        params: tuple = ()
        if service is not None:
            sql += ' AND service=?'
            params = (service,)
        sql += ' ORDER BY fired_at'
        return [dict(r) for r in db_utils.query(self._ensure(), sql,
                                                params)]

    def alert_history(self, service: Optional[str] = None,
                      limit: int = 100) -> List[Dict]:
        sql = 'SELECT * FROM obs_alerts'
        params: tuple = ()
        if service is not None:
            sql += ' WHERE service=?'
            params = (service,)
        sql += ' ORDER BY fired_at DESC LIMIT ?'
        return [dict(r) for r in db_utils.query(
            self._ensure(), sql, params + (int(limit),))]
