"""Autoscalers (capability parity: sky/serve/autoscalers.py —
RequestRateAutoscaler :455, hysteresis :369).

Pure decision logic, no I/O: the controller feeds it either the load
balancer's monotonic request counter (`evaluate_counter`, the production
path — the same skytpu_lb_requests_total family /metrics exports, so the
autoscaler and the dashboards read one source of truth) or a raw request
timestamp trace (`evaluate`, kept for synthetic-trace unit tests), plus
current replica counts, and applies the returned delta.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, List, Optional, Tuple

from skypilot_tpu_torch.serve.service_spec import ServiceSpec
from skypilot_tpu_torch.server import metrics as _metrics_names

# Seconds of request history the QPS estimate averages over.
QPS_WINDOW_SECONDS = 60.0


@dataclasses.dataclass
class AutoscalerDecision:
    """target - current delta the controller should apply this tick."""
    target_num_replicas: int
    delta: int  # >0 scale up by delta, <0 scale down by -delta, 0 hold


class Autoscaler:
    """Fixed-size policy: hold at min_replicas (spec without autoscaling)."""

    # Set on policies that decide from the LB's federated /metrics
    # exposition (the controller only pays for a scrape when the policy
    # will read it).
    wants_lb_scrape = False

    def __init__(self, spec: ServiceSpec,
                 qps_window_seconds: float = QPS_WINDOW_SECONDS) -> None:
        self.spec = spec
        self.qps_window_seconds = qps_window_seconds
        self.target_num_replicas = spec.min_replicas

    # True on policies deciding per disaggregated pool: the controller
    # calls evaluate_pools and applies each pool's delta with
    # manager.scale_up/scale_down(role=...).
    is_pool_autoscaler = False

    @classmethod
    def make(cls, spec: ServiceSpec,
             decision_interval_seconds: float,
             qps_window_seconds: float = QPS_WINDOW_SECONDS) -> 'Autoscaler':
        if spec.disaggregation is not None:
            return DisaggSLOAutoscaler(spec, decision_interval_seconds,
                                       qps_window_seconds)
        if spec.slo_autoscaling_enabled:
            return SLOAutoscaler(spec, decision_interval_seconds,
                                 qps_window_seconds)
        if spec.autoscaling_enabled:
            return RequestRateAutoscaler(spec, decision_interval_seconds,
                                         qps_window_seconds)
        return cls(spec, qps_window_seconds)

    def evaluate(self, request_timestamps: List[float],
                 num_live_replicas: int,
                 now: Optional[float] = None) -> AutoscalerDecision:
        del request_timestamps, now
        return AutoscalerDecision(
            self.target_num_replicas,
            self.target_num_replicas - num_live_replicas)

    def evaluate_counter(self, total_requests: int,
                         num_live_replicas: int,
                         now: Optional[float] = None) -> AutoscalerDecision:
        """Counter-based twin of evaluate(): fed the LB's monotonic
        proxied-request count.  The fixed policy ignores load."""
        del total_requests
        return self.evaluate([], num_live_replicas, now)

    def evaluate_scrape(self, exposition: Optional[str],
                        total_requests: int, num_live_replicas: int,
                        now: Optional[float] = None) -> AutoscalerDecision:
        """Metrics-fed entry: the controller passes the LB's federated
        /metrics text (None when the scrape failed or the policy did
        not ask for one).  Policies that ignore latency fall through to
        the counter path."""
        del exposition
        return self.evaluate_counter(total_requests, num_live_replicas,
                                     now)

    def adopt_history(self, old: 'Autoscaler') -> None:
        """Carry scaling state over from the autoscaler this one
        replaces (`serve update` rebuilds every spec-derived object).
        The fixed policy pins to its configured count: nothing to
        adopt."""
        del old


class RequestRateAutoscaler(Autoscaler):
    """Scale on measured QPS with hysteresis.

    desired = ceil(qps / target_qps_per_replica), clamped to
    [min_replicas, max_replicas].  A change of target only takes effect
    after it has been sustained for upscale_delay_seconds (upscale) or
    downscale_delay_seconds (downscale) — counted in whole decision
    intervals, exactly the reference's upscale/downscale counter
    hysteresis (sky/serve/autoscalers.py:369).
    """

    def __init__(self, spec: ServiceSpec,
                 decision_interval_seconds: float,
                 qps_window_seconds: float = QPS_WINDOW_SECONDS) -> None:
        super().__init__(spec, qps_window_seconds)
        assert spec.max_replicas is not None
        assert spec.target_qps_per_replica is not None
        self.decision_interval_seconds = decision_interval_seconds
        self.upscale_threshold = max(
            1, int(math.ceil(spec.upscale_delay_seconds /
                             decision_interval_seconds)))
        self.downscale_threshold = max(
            1, int(math.ceil(spec.downscale_delay_seconds /
                             decision_interval_seconds)))
        self.upscale_counter = 0
        self.downscale_counter = 0
        # (time, cumulative request count) samples, pruned to the QPS
        # window: the counter-based QPS source (evaluate_counter).
        self._count_samples: Deque[Tuple[float, int]] = collections.deque()

    def current_qps(self, request_timestamps: List[float],
                    now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        cutoff = now - self.qps_window_seconds
        n = sum(1 for t in request_timestamps if t >= cutoff)
        return n / self.qps_window_seconds

    def adopt_history(self, old: 'Autoscaler') -> None:
        """Carry QPS samples, the current target, and the hysteresis
        counters over from the replaced autoscaler: an empty window
        would read 0 QPS, and a target reset to min_replicas would
        emit an immediate scale-down of a loaded service right after
        every `serve update` (then re-provision minutes later).  The
        adopted target is clamped to the NEW spec's bounds — the
        update may have changed min/max_replicas."""
        self.target_num_replicas = max(
            self.spec.min_replicas,
            min(self.spec.max_replicas, old.target_num_replicas))
        theirs = getattr(old, '_count_samples', None)
        if theirs is not None:
            self._count_samples.extend(theirs)
        self.upscale_counter = getattr(old, 'upscale_counter', 0)
        self.downscale_counter = getattr(old, 'downscale_counter', 0)

    def record_request_count(self, total_requests: int,
                             now: Optional[float] = None) -> None:
        """Sample the LB's monotonic request counter.  Keeps one sample
        at (or just outside) the window edge as the rate baseline.

        Counter-reset clamp: an LB restart zeroes its counter, so the
        new value can be BELOW the window's samples — every prior
        sample is then a baseline from a dead counter generation and
        would read as a negative delta.  Drop them and treat the new
        value as a fresh baseline (one window of 0-QPS vision beats a
        window of garbage)."""
        now = time.time() if now is None else now
        if self._count_samples and \
                total_requests < self._count_samples[-1][1]:
            self._count_samples.clear()
        self._count_samples.append((now, total_requests))
        cutoff = now - self.qps_window_seconds
        while len(self._count_samples) >= 2 and \
                self._count_samples[1][0] <= cutoff:
            self._count_samples.popleft()

    def current_qps_from_counter(self) -> float:
        """Requests/sec over the sampled window (same window-averaged
        semantics as the timestamp-trace estimate).  The divisor is
        floored at the window but follows the REAL sample span when
        ticks stalled (rollout, controller pause): dividing a
        multi-window delta by one window would report a post-stall QPS
        spike and spuriously scale up."""
        if len(self._count_samples) < 2:
            return 0.0
        (t0, c0), (t1, c1) = self._count_samples[0], self._count_samples[-1]
        return max(0, c1 - c0) / max(self.qps_window_seconds, t1 - t0)

    def evaluate(self, request_timestamps: List[float],
                 num_live_replicas: int,
                 now: Optional[float] = None) -> AutoscalerDecision:
        return self._decide(self.current_qps(request_timestamps, now),
                            num_live_replicas)

    def evaluate_counter(self, total_requests: int,
                         num_live_replicas: int,
                         now: Optional[float] = None) -> AutoscalerDecision:
        self.record_request_count(total_requests, now)
        return self._decide(self.current_qps_from_counter(),
                            num_live_replicas)

    def _decide(self, qps: float,
                num_live_replicas: int) -> AutoscalerDecision:
        desired = int(math.ceil(qps / self.spec.target_qps_per_replica))
        return self._apply_hysteresis(desired, num_live_replicas)

    def _apply_hysteresis(self, desired: int,
                          num_live_replicas: int) -> AutoscalerDecision:
        """Clamp `desired` to the spec bounds and commit it only after
        it has been sustained for the up/downscale delay (counted in
        whole decision intervals)."""
        desired = max(self.spec.min_replicas,
                      min(self.spec.max_replicas, desired))
        if desired > self.target_num_replicas:
            self.upscale_counter += 1
            self.downscale_counter = 0
            if self.upscale_counter >= self.upscale_threshold:
                self.target_num_replicas = desired
                self.upscale_counter = 0
        elif desired < self.target_num_replicas:
            self.downscale_counter += 1
            self.upscale_counter = 0
            if self.downscale_counter >= self.downscale_threshold:
                self.target_num_replicas = desired
                self.downscale_counter = 0
        else:
            self.upscale_counter = 0
            self.downscale_counter = 0
        return AutoscalerDecision(
            self.target_num_replicas,
            self.target_num_replicas - num_live_replicas)


class SLOAutoscaler(RequestRateAutoscaler):
    """Scale on p95 TTFT/TPOT measured from the LB's federated
    histograms (ThunderServe's thesis, arXiv:2502.09334: schedule and
    scale on per-replica latency signals, not request counts).

    Decision inputs per tick, all read from ONE federated /metrics
    scrape (the same text the dashboards scrape — no side channel):
      - p95 TTFT and p95 TPOT over the QPS window, from per-bucket
        deltas of skytpu_engine_ttft_seconds /
        skytpu_engine_inter_token_seconds (metrics_math);
      - the service-wide queued-prefill-token backlog gauge sum;
      - the LB's monotonic request counter (passed separately) for the
        QPS fallback — and because the LB counts SHED requests in it,
        suppressed demand still argues for scale-up while admission
        control protects the replicas.

    Policy:
      - scale UP (one replica per sustained violation, or more if QPS
        demands it) when a measured p95 exceeds its target, or when the
        backlog exceeds max_queue_tokens_per_replica x live replicas;
      - scale DOWN only when QPS wants fewer AND the projected
        post-scale-down p95 still meets every set target.  Projection
        is the conservative load-proportional model p95 x live/fewer —
        decode latency grows at least linearly in per-replica load once
        batching saturates, so the model under-estimates headroom and
        never green-lights a shrink the SLO cannot absorb;
      - with NO histogram samples in the window (cold service, scrape
        failure), behave exactly like RequestRateAutoscaler.
    """

    wants_lb_scrape = True

    # Histogram families the decision reads (federated engine series;
    # names shared with the exporter via server/metrics.py constants).
    TTFT_FAMILY = _metrics_names.ENGINE_TTFT_FAMILY
    TPOT_FAMILY = _metrics_names.ENGINE_TPOT_FAMILY
    BACKLOG_FAMILY = _metrics_names.QUEUED_PREFILL_TOKENS_FAMILY
    QUANTILE = 0.95

    def __init__(self, spec: ServiceSpec,
                 decision_interval_seconds: float,
                 qps_window_seconds: float = QPS_WINDOW_SECONDS) -> None:
        super().__init__(spec, decision_interval_seconds,
                         qps_window_seconds)
        from skypilot_tpu_torch.serve import metrics_math
        self._math = metrics_math
        # Per-SERIES windows (one per replica label): reset detection
        # must see each replica's own cumulative counts, or any replica
        # restart/departure would clear the whole window and a rejoin
        # would inject lifetime counts (metrics_math docstring).
        self._ttft_window = metrics_math.FederatedWindowedHistogram(
            qps_window_seconds)
        self._tpot_window = metrics_math.FederatedWindowedHistogram(
            qps_window_seconds)
        # Last measured state, for logs/status introspection.
        self.last_p95_ttft_ms: Optional[float] = None
        self.last_p95_tpot_ms: Optional[float] = None
        self.last_backlog_tokens: float = 0.0

    def adopt_history(self, old: 'Autoscaler') -> None:
        """Also carry the histogram scrape windows across a `serve
        update` rebuild: an empty window would blind the SLO signal for
        a full window right when a rollout is perturbing latency."""
        super().adopt_history(old)
        for attr in ('_ttft_window', '_tpot_window'):
            theirs = getattr(old, attr, None)
            if theirs is not None and hasattr(theirs, '_series'):
                getattr(self, attr).adopt(theirs)

    def observe_exposition(self, exposition: str,
                           now: Optional[float] = None) -> None:
        """Fold one federated scrape into the measurement windows."""
        samples = self._math.parse_samples(exposition)
        self._ttft_window.record(
            self._math.histogram_cumulative_by_series(
                samples, self.TTFT_FAMILY), now)
        self._tpot_window.record(
            self._math.histogram_cumulative_by_series(
                samples, self.TPOT_FAMILY), now)
        self.last_backlog_tokens = self._math.gauge_total(
            samples, self.BACKLOG_FAMILY)

    def _p95s(self, now: Optional[float] = None
              ) -> Tuple[Optional[float], Optional[float]]:
        """(p95 TTFT ms, p95 TPOT ms) over the window; None per family
        without samples — including when the newest scrape predates the
        window (scrape source dark: deciding on that frozen data would
        keep scaling on a latency picture minutes old)."""
        ttft = self._ttft_window.quantile(self.QUANTILE, now)
        tpot = self._tpot_window.quantile(self.QUANTILE, now)
        self.last_p95_ttft_ms = ttft * 1e3 if ttft is not None else None
        self.last_p95_tpot_ms = tpot * 1e3 if tpot is not None else None
        return self.last_p95_ttft_ms, self.last_p95_tpot_ms

    def _slo_pairs(self, now: Optional[float] = None
                   ) -> List[Tuple[Optional[float], float]]:
        """(measured p95 ms, target ms) for each configured SLO."""
        ttft, tpot = self._p95s(now)
        pairs = []
        if self.spec.target_ttft_ms is not None:
            pairs.append((ttft, self.spec.target_ttft_ms))
        if self.spec.target_tpot_ms is not None:
            pairs.append((tpot, self.spec.target_tpot_ms))
        return pairs

    def evaluate_scrape(self, exposition: Optional[str],
                        total_requests: int, num_live_replicas: int,
                        now: Optional[float] = None) -> AutoscalerDecision:
        now = time.time() if now is None else now
        self.record_request_count(total_requests, now)
        if exposition is not None:
            self.observe_exposition(exposition, now)
        else:
            # Scrape failed: the backlog figure is as stale as the
            # histograms — 0 means "no evidence", so neither the shed
            # check nor a downscale projection runs on frozen data.
            self.last_backlog_tokens = 0.0
        qps_desired = int(math.ceil(self.current_qps_from_counter() /
                                    self.spec.target_qps_per_replica))
        pairs = self._slo_pairs(now)
        measured = [(p95, target) for p95, target in pairs
                    if p95 is not None]
        if not measured:
            # No latency samples in the window: pure QPS behavior.
            return self._apply_hysteresis(qps_desired,
                                          num_live_replicas)
        live = max(num_live_replicas, 1)
        violated = any(p95 > target for p95, target in measured)
        if self.spec.max_queue_tokens_per_replica is not None and \
                self.last_backlog_tokens > \
                self.spec.max_queue_tokens_per_replica * live:
            # The LB is shedding (or about to): latency of ADMITTED
            # requests can look healthy exactly because demand is being
            # turned away — the backlog says scale anyway.
            violated = True
        if violated:
            # One more than what is RUNNING (not just our own target:
            # after adoption or manual changes live can exceed it, and a
            # service violating at `live` replicas needs > live).
            desired = max(qps_desired,
                          max(self.target_num_replicas, live) + 1)
        elif qps_desired < self.target_num_replicas:
            # QPS argues for fewer replicas: allow it only if the
            # load-proportional projection of every measured p95 at the
            # shrunken count still meets its target.
            candidate = max(qps_desired, self.spec.min_replicas, 1)
            projected_ok = all(
                p95 * (live / candidate) <= target
                for p95, target in measured)
            desired = qps_desired if projected_ok \
                else self.target_num_replicas
        else:
            desired = max(qps_desired, self.target_num_replicas)
        return self._apply_hysteresis(desired, num_live_replicas)


@dataclasses.dataclass
class PoolDecision:
    """Per-pool deltas for one disaggregated tick."""
    prefill: AutoscalerDecision
    decode: AutoscalerDecision


class _PoolState:
    """One pool's scaling state: bounds, hysteresis counters, and the
    spot preemption headroom (replicas held ABOVE the SLO-driven
    target so one preemption degrades margin, not the SLO, while the
    re-plan provisions a replacement)."""

    def __init__(self, lo: int, hi: int, upscale_threshold: int,
                 downscale_threshold: int, headroom: int) -> None:
        self.lo, self.hi = lo, hi
        self.upscale_threshold = upscale_threshold
        self.downscale_threshold = downscale_threshold
        self.headroom = headroom
        # SLO-driven target, WITHOUT headroom (decision() adds it).
        self.target = lo
        self.upscale_counter = 0
        self.downscale_counter = 0

    def commit(self, desired: int) -> None:
        """Same counter hysteresis as RequestRateAutoscaler, per
        pool."""
        desired = max(self.lo, min(self.hi, desired))
        if desired > self.target:
            self.upscale_counter += 1
            self.downscale_counter = 0
            if self.upscale_counter >= self.upscale_threshold:
                self.target = desired
                self.upscale_counter = 0
        elif desired < self.target:
            self.downscale_counter += 1
            self.upscale_counter = 0
            if self.downscale_counter >= self.downscale_threshold:
                self.target = desired
                self.downscale_counter = 0
        else:
            self.upscale_counter = 0
            self.downscale_counter = 0

    def decision(self, live: int) -> AutoscalerDecision:
        total = min(self.hi, self.target + self.headroom)
        return AutoscalerDecision(total, total - live)

    def adopt(self, old: '_PoolState') -> None:
        self.target = max(self.lo, min(self.hi, old.target))
        self.upscale_counter = old.upscale_counter
        self.downscale_counter = old.downscale_counter


class DisaggSLOAutoscaler(Autoscaler):
    """Per-pool SLO scaling for disaggregated prefill/decode serving
    (ThunderServe, arXiv:2502.09334: size each phase's pool by its own
    latency signal, place each pool by its own cost profile).

    The phase split makes attribution trivial: TTFT is made in the
    PREFILL pool (queue + prefill + handoff), TPOT in the DECODE pool
    (batch bandwidth) — so one federated scrape drives two independent
    decisions:

      - p95 TTFT over target (or prefill-token backlog over
        max_queue_tokens_per_replica x live prefill) -> prefill +1;
      - p95 TPOT over target -> decode +1, with QPS demand
        (ceil(qps / target_qps_per_replica)) as the decode pool's
        fallback/floor signal — decode slots are what requests occupy;
      - scale-down per pool only when the load-proportional projection
        of ITS p95 at the shrunken count still meets ITS target (the
        same conservative model as SLOAutoscaler);
      - a spot pool holds `spot_headroom` extra replicas, so a
        preemption mid-traffic spends margin instead of breaching the
        SLO; the next tick's delta restores the margin (the
        lightweight re-plan).

    Without SLO targets the pools hold their configured base sizes
    (plus spot headroom) — fixed-size disaggregation.
    """

    wants_lb_scrape = True
    is_pool_autoscaler = True

    TTFT_FAMILY = _metrics_names.ENGINE_TTFT_FAMILY
    TPOT_FAMILY = _metrics_names.ENGINE_TPOT_FAMILY
    BACKLOG_FAMILY = _metrics_names.QUEUED_PREFILL_TOKENS_FAMILY
    QUANTILE = 0.95
    # Scale-down margin: shrink a pool only when the projected p95 at
    # the smaller size stays under this fraction of the target, so the
    # shrink itself cannot ride the projection error into a violation.
    DOWNSCALE_MARGIN = 0.8

    # The counter-window QPS machinery is pool-agnostic; borrow it
    # verbatim instead of inheriting RequestRateAutoscaler's
    # replica_policy preconditions (a disaggregated spec may be
    # fixed-size).
    record_request_count = RequestRateAutoscaler.record_request_count
    current_qps_from_counter = \
        RequestRateAutoscaler.current_qps_from_counter

    def __init__(self, spec: ServiceSpec,
                 decision_interval_seconds: float,
                 qps_window_seconds: float = QPS_WINDOW_SECONDS) -> None:
        super().__init__(spec, qps_window_seconds)
        assert spec.disaggregation is not None
        d = spec.disaggregation
        from skypilot_tpu_torch.serve import metrics_math
        self._math = metrics_math
        self._ttft_window = metrics_math.FederatedWindowedHistogram(
            qps_window_seconds)
        self._tpot_window = metrics_math.FederatedWindowedHistogram(
            qps_window_seconds)
        self._count_samples: Deque[Tuple[float, int]] = \
            collections.deque()
        up = max(1, int(math.ceil(spec.upscale_delay_seconds /
                                  decision_interval_seconds)))
        down = max(1, int(math.ceil(spec.downscale_delay_seconds /
                                    decision_interval_seconds)))
        self._pools = {
            role: _PoolState(
                d.min_for(role), d.max_for(role), up, down,
                d.spot_headroom if d.use_spot(role) else 0)
            for role in ('prefill', 'decode')
        }
        self.last_p95_ttft_ms: Optional[float] = None
        self.last_p95_tpot_ms: Optional[float] = None
        self.last_backlog_tokens: float = 0.0

    def adopt_history(self, old: 'Autoscaler') -> None:
        """Carry QPS samples, scrape windows, and per-pool targets
        across a `serve update` rebuild."""
        theirs = getattr(old, '_count_samples', None)
        if theirs is not None:
            self._count_samples.extend(theirs)
        for attr in ('_ttft_window', '_tpot_window'):
            window = getattr(old, attr, None)
            if window is not None and hasattr(window, '_series'):
                getattr(self, attr).adopt(window)
        old_pools = getattr(old, '_pools', None)
        if old_pools:
            for role, state in self._pools.items():
                if role in old_pools:
                    state.adopt(old_pools[role])

    def observe_exposition(self, exposition: str,
                           now: Optional[float] = None) -> None:
        samples = self._math.parse_samples(exposition)
        self._ttft_window.record(
            self._math.histogram_cumulative_by_series(
                samples, self.TTFT_FAMILY), now)
        self._tpot_window.record(
            self._math.histogram_cumulative_by_series(
                samples, self.TPOT_FAMILY), now)
        self.last_backlog_tokens = self._math.gauge_total(
            samples, self.BACKLOG_FAMILY)

    def _pool_desired(self, state: _PoolState, live: int,
                      p95_ms: Optional[float],
                      target_ms: Optional[float],
                      demand: int, extra_violation: bool) -> int:
        """One pool's SLO-driven desired size (headroom excluded —
        _PoolState.decision adds it)."""
        live_sans_headroom = max(1, live - state.headroom)
        if target_ms is not None and p95_ms is not None:
            if p95_ms > target_ms or extra_violation:
                # Violating at `live` replicas needs more than live.
                return max(demand, state.target,
                           live_sans_headroom) + 1
            candidate = max(state.lo, demand, state.target - 1)
            if candidate < state.target and \
                    p95_ms * (live_sans_headroom / max(candidate, 1)) \
                    <= target_ms * self.DOWNSCALE_MARGIN:
                return candidate
            return max(state.target, demand)
        if extra_violation:
            return max(demand, state.target, live_sans_headroom) + 1
        # No latency signal: demand floor (decode) / base size.
        return max(state.lo, demand)

    def evaluate_pools(self, exposition: Optional[str],
                       total_requests: int, live_prefill: int,
                       live_decode: int,
                       now: Optional[float] = None) -> PoolDecision:
        now = time.time() if now is None else now
        self.record_request_count(total_requests, now)
        if exposition is not None:
            self.observe_exposition(exposition, now)
        else:
            self.last_backlog_tokens = 0.0
        ttft = self._ttft_window.quantile(self.QUANTILE, now)
        tpot = self._tpot_window.quantile(self.QUANTILE, now)
        self.last_p95_ttft_ms = ttft * 1e3 if ttft is not None else None
        self.last_p95_tpot_ms = tpot * 1e3 if tpot is not None else None
        qps_desired = 0
        if self.spec.target_qps_per_replica:
            qps_desired = int(math.ceil(
                self.current_qps_from_counter() /
                self.spec.target_qps_per_replica))
        # Prefill pool: TTFT + prefill-token backlog (the LB sheds on
        # the prefill pool's backlog, so over-limit backlog means
        # demand is being suppressed there).
        backlog_violation = (
            self.spec.max_queue_tokens_per_replica is not None and
            self.last_backlog_tokens >
            self.spec.max_queue_tokens_per_replica *
            max(live_prefill, 1))
        prefill_state = self._pools['prefill']
        prefill_state.commit(self._pool_desired(
            prefill_state, live_prefill, self.last_p95_ttft_ms,
            self.spec.target_ttft_ms, 0, backlog_violation))
        # Decode pool: TPOT, with QPS demand as the floor — decode
        # slots are what admitted requests occupy.
        decode_state = self._pools['decode']
        decode_state.commit(self._pool_desired(
            decode_state, live_decode, self.last_p95_tpot_ms,
            self.spec.target_tpot_ms, qps_desired, False))
        return PoolDecision(
            prefill=prefill_state.decision(live_prefill),
            decode=decode_state.decision(live_decode))

    def evaluate_scrape(self, exposition: Optional[str],
                        total_requests: int, num_live_replicas: int,
                        now: Optional[float] = None) -> AutoscalerDecision:
        """Single-count compatibility shim (status paths): pools are
        decided by evaluate_pools; the aggregate target is their sum."""
        del exposition, total_requests, now
        total = sum(
            min(s.hi, s.target + s.headroom)
            for s in self._pools.values())
        return AutoscalerDecision(total, total - num_live_replicas)
