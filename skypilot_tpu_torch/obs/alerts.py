"""Multi-window SLO burn-rate alerting over the telemetry store.

Rules are DECLARATIVE: a frozen `AlertRule` names a registered metric
family (skytpu check's metric-naming rule statically verifies the
reference), a burn semantic (`kind`), and hysteresis ratios.  The
engine turns each rule into a dimensionless **burn rate** — "how many
multiples of the SLO budget is this signal consuming right now" — and
applies the classic multi-window discipline (Google SRE workbook ch.5):
an alert fires only when the burn exceeds the threshold on BOTH windows
of a pair (the long window proves it is sustained, the short window
makes the alert responsive and lets it clear quickly), with a fast pair
(5 m / 1 h) for page-worthy burns and a slow pair (30 m / 6 h) for
budget-eroding simmer.  Transitions are durable `obs_alerts` rows plus
`alert.fire`/`alert.clear` instants in the flight recorder, so a storm's
alert timeline is auditable after the fact (`skytpu trace`,
`skytpu alerts --history`).

Burn semantics per kind (burn >= 1.0 means "out of SLO"):

- ``latency_burn``: windowed p95 of a latency histogram vs a
  millisecond target — ``p95_s * 1000 / target_ms``;
- ``ratio``: two counter families (e.g. shed / total requests) vs a
  target fraction — ``(num / den) / target``;
- ``gauge_low``: a floor on the worst per-replica gauge in the window
  (free pages, spec acceptance) — ``target / min_value``;
- ``gauge_high``: the symmetric ceiling — ``max_value / target`` —
  for signals where HIGH is bad (step-time skew: a straggling host
  drags every synchronous step to its pace);
- ``missing``: fraction of resolution intervals with NO ingest
  heartbeat vs a target fraction — the dark-scrape signal.  Evaluated
  on the fast short window only (absence is inherently a now-signal,
  not an error budget) and guarded by the store's oldest heartbeat so
  a fresh deployment is not instantly "dark".

The fleetsim chaos run drives this exact engine with second-scale
windows, which is how the canonical storm's fire/clear ticks get
test-pinned.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.obs import store as store_lib
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

# Synthetic request id for flight-recorder instants (same idiom as the
# recompile sentinel): alert transitions are fleet events, not request
# events, but they belong on the same timeline.
ALERT_RID = 'alert-engine'
ALERTS_FAMILY = 'skytpu_obs_alerts_total'

# Module constant so the dark-scrape rule's family reference below is
# statically resolvable by skytpu check's metric-naming rule.
DARK_SCRAPE_FAMILY = 'skytpu_obs_ingest_total'


@dataclasses.dataclass(frozen=True)
class BurnWindows:
    """(short, long) seconds per pair.  Production defaults follow the
    SRE-workbook pairs; fleetsim scales them to sim seconds."""
    fast: Tuple[float, float] = (300.0, 3600.0)
    slow: Tuple[float, float] = (1800.0, 21600.0)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative SLO rule.

    ``family`` (and ``ratio_family`` for kind='ratio') MUST name a
    registered metric family — skytpu check resolves these keyword
    arguments statically against server/metrics._HELP.  ``pool`` is
    attribution metadata carried onto fired alerts (which pool the
    operator should look at), not a query filter: store rows are
    pool-tagged only when the scrape carries replica labels.
    """
    name: str
    kind: str  # latency_burn|ratio|gauge_low|gauge_high|missing
    family: str
    pool: str = ''
    target: float = 1.0
    ratio_family: str = ''
    bucket: str = ''  # counter sub-label filter ('' = all)
    fire_ratio: float = 1.0
    clear_ratio: float = 0.9

    def __post_init__(self) -> None:
        if self.kind not in ('latency_burn', 'ratio', 'gauge_low',
                             'gauge_high', 'missing'):
            raise ValueError(f'unknown alert rule kind: {self.kind!r}')
        if self.kind == 'ratio' and not self.ratio_family:
            raise ValueError(
                f'rule {self.name!r}: kind=ratio needs ratio_family')


def default_rules(target_ttft_ms: float, target_tpot_ms: float,
                  dark_scrape_target: float = 0.4
                  ) -> Tuple[AlertRule, ...]:
    """The stock fleet rule set, parameterized by the service spec's
    latency targets (serve_llama.yaml documents each)."""
    return (
        AlertRule(name='ttft_slo_burn', kind='latency_burn',
                  family=metrics_lib.ENGINE_TTFT_FAMILY,
                  pool='prefill', target=float(target_ttft_ms)),
        AlertRule(name='tpot_slo_burn', kind='latency_burn',
                  family=metrics_lib.ENGINE_TPOT_FAMILY,
                  pool='decode', target=float(target_tpot_ms)),
        AlertRule(name='shed_rate', kind='ratio',
                  family='skytpu_lb_shed_total',
                  ratio_family='skytpu_lb_requests_total',
                  target=0.05),
        AlertRule(name='dark_scrape', kind='missing',
                  family=DARK_SCRAPE_FAMILY,
                  target=float(dark_scrape_target)),
        AlertRule(name='spec_acceptance_collapse', kind='gauge_low',
                  family='skytpu_engine_spec_acceptance',
                  pool='decode', target=0.1),
        AlertRule(name='kv_free_pages_exhausted', kind='gauge_low',
                  family='skytpu_engine_kv_free_pages',
                  pool='decode', target=8.0),
    )


def train_rules(goodput_target_pct: float = 80.0,
                skew_target: float = 1.3) -> Tuple[AlertRule, ...]:
    """The training-job rule set: `goodput_low` fires when
    the job's goodput gauge sags under the target percentage on both
    windows of a pair; `straggler` fires when the per-window host skew
    (max-host p50 / median-host p50, written by
    obs/goodput.evaluate_stragglers) sustains above `skew_target` —
    on a synchronous job the whole pod runs at the slow host's pace,
    so skew IS the badput multiplier."""
    return (
        AlertRule(name='goodput_low', kind='gauge_low',
                  family=metrics_lib.TRAIN_GOODPUT_FAMILY,
                  pool='train', target=float(goodput_target_pct)),
        AlertRule(name='straggler', kind='gauge_high',
                  family=metrics_lib.TRAIN_STEP_SKEW_FAMILY,
                  pool='train', target=float(skew_target)),
    )


class AlertEngine:
    """Evaluates a rule set against one service's store rows.

    Holds only the firing-set cache — all durable state lives in
    ``obs_alerts`` rows, so a restarted control plane resumes with the
    alerts it left firing instead of re-firing them (the cache is
    seeded from the table on first evaluate)."""

    def __init__(self, store: store_lib.TelemetryStore, service: str,
                 rules: Sequence[AlertRule],
                 windows: Optional[BurnWindows] = None) -> None:
        self.store = store
        self.service = service
        self.rules = tuple(rules)
        self.windows = windows or BurnWindows()
        self._firing: Optional[Dict[str, float]] = None  # rule -> t

    def _seed_firing(self) -> Dict[str, float]:
        if self._firing is None:
            self._firing = {
                row['rule']: float(row['fired_at'])
                for row in self.store.active_alerts(self.service)}
        return self._firing

    # ----- burn computation ---------------------------------------------------
    def _burn(self, rule: AlertRule, now: float, window: float
              ) -> Optional[float]:
        """Dimensionless burn of `rule` over ``(now - window, now]``;
        None when the store has no usable data (no transition)."""
        t0, t1 = now - window, now
        s = self.store
        if rule.kind == 'latency_burn':
            q = s.quantile(self.service, rule.family, t0, t1, 0.95)
            if q is None or rule.target <= 0:
                return None
            return (q * 1000.0) / rule.target
        if rule.kind == 'ratio':
            den = s.counter_sum(self.service, rule.ratio_family, t0, t1)
            if den <= 0 or rule.target <= 0:
                return None
            num = s.counter_sum(self.service, rule.family, t0, t1,
                                bucket=rule.bucket or None)
            return (num / den) / rule.target
        if rule.kind == 'gauge_low':
            worst = s.gauge_min(self.service, rule.family, t0, t1)
            if worst is None or rule.target <= 0:
                return None
            if worst <= 0:
                return math.inf
            return rule.target / worst
        if rule.kind == 'gauge_high':
            worst = s.gauge_max(self.service, rule.family, t0, t1)
            if worst is None or rule.target <= 0:
                return None
            return worst / rule.target
        # kind == 'missing': coverage gaps in the family's intervals,
        # counted only over history the store actually reaches back to.
        first = s.first_t(self.service, rule.family)
        if first is None or rule.target <= 0:
            return None
        res = max(self.store.resolution, 1e-9)
        t0 = max(t0, first)
        expected = int(round((t1 - t0) / res))
        if expected <= 0:
            return None
        present = s.present_intervals(self.service, rule.family, t0, t1)
        missing = max(0, expected - present) / expected
        return missing / rule.target

    def _pair_burns(self, rule: AlertRule, now: float,
                    pair: Tuple[float, float]
                    ) -> Tuple[Optional[float], Optional[float]]:
        return (self._burn(rule, now, pair[0]),
                self._burn(rule, now, pair[1]))

    def _tripped(self, rule: AlertRule, now: float, threshold: float
                 ) -> Tuple[bool, bool, Dict[str, float]]:
        """(any pair trips at `threshold`?, any data at all?,
        window->burn detail).  A pair trips when BOTH its windows' burns
        meet the threshold (the multi-window AND); pairs are ORed.  The
        `missing` kind is single-window (absence is a now-signal, not
        an error budget): the fast short window alone decides."""
        detail: Dict[str, float] = {}
        if rule.kind == 'missing':
            b = self._burn(rule, now, self.windows.fast[0])
            if b is None:
                return False, False, detail
            detail[f'{self.windows.fast[0]:g}s'] = round(b, 4)
            return b >= threshold, True, detail
        tripped = False
        any_data = False
        for pair in (self.windows.fast, self.windows.slow):
            b_short, b_long = self._pair_burns(rule, now, pair)
            for w, b in ((pair[0], b_short), (pair[1], b_long)):
                if b is not None:
                    any_data = True
                    if math.isfinite(b):
                        detail[f'{w:g}s'] = round(b, 4)
            if (b_short is not None and b_long is not None
                    and b_short >= threshold and b_long >= threshold):
                tripped = True
        return tripped, any_data, detail

    def _should_fire(self, rule: AlertRule, now: float
                     ) -> Tuple[bool, Optional[float], Dict[str, float]]:
        """(fire?, peak burn across windows, window->burn detail)."""
        fire, _, detail = self._tripped(rule, now, rule.fire_ratio)
        burn = max(detail.values()) if detail else None
        return fire, burn, detail

    def _should_clear(self, rule: AlertRule, now: float) -> bool:
        """Hysteresis symmetric with the fire condition: clear only
        when NO window pair trips at clear_ratio (clear_ratio <
        fire_ratio makes fire⇒¬clear, so the state machine cannot
        flap) — and never on no-data (a dark fleet keeps its latency
        alerts; dark_scrape covers the dark)."""
        tripped, any_data, _ = self._tripped(rule, now,
                                             rule.clear_ratio)
        return any_data and not tripped

    # ----- the state machine --------------------------------------------------
    def evaluate(self, now: float) -> List[Dict]:
        """One evaluation pass; returns this pass's transitions as
        [{'rule', 'pool', 'transition': 'fire'|'clear', 't', 'burn'}].
        """
        firing = self._seed_firing()
        transitions: List[Dict] = []
        for rule in self.rules:
            if rule.name in firing:
                if self._should_clear(rule, now):
                    del firing[rule.name]
                    self.store.clear_alert(self.service, rule.name, now)
                    tracing.record_instant(
                        ALERT_RID, 'alert.clear', service=self.service,
                        rule=rule.name, pool=rule.pool)
                    metrics_lib.inc_counter(
                        ALERTS_FAMILY, rule=rule.name,
                        transition='clear')
                    transitions.append(
                        {'rule': rule.name, 'pool': rule.pool,
                         'transition': 'clear', 't': now, 'burn': None})
                continue
            fire, burn, detail = self._should_fire(rule, now)
            if not fire:
                continue
            firing[rule.name] = now
            burn_val = (round(burn, 4)
                        if burn is not None and math.isfinite(burn)
                        else -1.0)
            self.store.fire_alert(self.service, rule.name, rule.pool,
                                  now, burn_val,
                                  json.dumps(detail, sort_keys=True))
            tracing.record_instant(
                ALERT_RID, 'alert.fire', service=self.service,
                rule=rule.name, pool=rule.pool, burn=burn_val)
            metrics_lib.inc_counter(ALERTS_FAMILY, rule=rule.name,
                                    transition='fire')
            transitions.append(
                {'rule': rule.name, 'pool': rule.pool,
                 'transition': 'fire', 't': now, 'burn': burn_val})
        return transitions
