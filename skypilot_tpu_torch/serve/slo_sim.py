"""Virtual-replica latency simulation for the SLO-autoscaling loop.

Backs ``bench.py bench_slo_ramp`` and the load-tier tests: N virtual
replicas with an analytic decode-latency model, producing the SAME
Prometheus exposition text the controller scrapes from a real LB's
federated /metrics — so the autoscaler under test consumes
production-format input end to end (parse -> bucket deltas -> windowed
p95 -> decision), not a pre-digested number.

Latency model: a continuous-batching decode engine holds its base
inter-token latency until per-replica load reaches the batching knee,
then degrades linearly (decode slots saturate, requests queue behind the
batch):

    tpot(load) = base_tpot_s * max(1, per_replica_qps / knee_qps)

The knee is the TRUE per-replica capacity; the interesting experiments
set ``target_qps_per_replica`` above it (the operator's optimistic
claim — e.g. calibrated on short prompts, then traffic shifted long), so
a QPS autoscaler under-provisions while the SLO autoscaler sees the p95
the users see.  Virtual time only — no sleeps; provisioning is instant
(both policies get the same, ideal replica budget, isolating the
decision quality).
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

from skypilot_tpu_torch.server import metrics as metrics_lib

TPOT_FAMILY = metrics_lib.ENGINE_TPOT_FAMILY
TTFT_FAMILY = metrics_lib.ENGINE_TTFT_FAMILY
BACKLOG_FAMILY = metrics_lib.QUEUED_PREFILL_TOKENS_FAMILY


class VirtualService:
    """Cumulative-histogram state of a simulated service under load."""

    def __init__(self, base_tpot_s: float = 0.010,
                 knee_qps_per_replica: float = 2.0,
                 base_ttft_s: float = 0.05) -> None:
        self.base_tpot_s = base_tpot_s
        self.knee_qps_per_replica = knee_qps_per_replica
        self.base_ttft_s = base_ttft_s
        self.total_requests = 0
        self.backlog_tokens = 0.0
        self._cum: Dict[str, Dict[float, float]] = {
            TPOT_FAMILY: {}, TTFT_FAMILY: {}}

    def tpot_s(self, qps: float, replicas: int) -> float:
        """The inter-token latency EVERY request experiences at this
        load (deterministic model: the p95 equals it)."""
        per_replica = qps / max(replicas, 1)
        return self.base_tpot_s * max(
            1.0, per_replica / self.knee_qps_per_replica)

    def _observe(self, family: str, value: float, n: float) -> None:
        cum = self._cum[family]
        for b in metrics_lib.buckets_for(family):
            if value <= b:
                cum[b] = cum.get(b, 0.0) + n
        cum[math.inf] = cum.get(math.inf, 0.0) + n

    def step(self, qps: float, replicas: int, dt_s: float) -> float:
        """Advance one tick: `qps` offered for `dt_s` seconds against
        `replicas` replicas.  Returns the tick's TPOT (seconds)."""
        tpot = self.tpot_s(qps, replicas)
        ttft = self.base_ttft_s * tpot / self.base_tpot_s
        n = qps * dt_s
        self._observe(TPOT_FAMILY, tpot, n)
        self._observe(TTFT_FAMILY, ttft, n)
        self.total_requests += int(round(n))
        return tpot

    def exposition(self) -> str:
        """The federated-/metrics text a controller scrape would see."""
        lines: List[str] = []
        for family, cum in self._cum.items():
            lines.append(f'# TYPE {family} histogram')
            for b in sorted(cum):
                le = '+Inf' if math.isinf(b) else repr(float(b))
                lines.append(f'{family}_bucket{{le="{le}"}} {cum[b]}')
        lines.append(f'# TYPE {BACKLOG_FAMILY} gauge')
        lines.append(f'{BACKLOG_FAMILY} {self.backlog_tokens}')
        return '\n'.join(lines) + '\n'


def run_ramp(autoscaler, service: VirtualService,
             qps_schedule: List[float], tick_s: float = 10.0,
             now0: float = 1_000.0) -> List[Tuple[float, int, float]]:
    """Drive one autoscaler through a traffic schedule.

    Each tick: traffic flows at the CURRENT replica count, then the
    autoscaler decides from the fresh scrape, and the decision applies
    instantly (ideal provisioning).  Works unmodified for every
    Autoscaler subclass — non-SLO policies ignore the exposition.
    Returns [(qps, replicas_during_tick, tpot_ms)].
    """
    history: List[Tuple[float, int, float]] = []
    replicas = autoscaler.target_num_replicas
    now = now0
    for qps in qps_schedule:
        tpot = service.step(qps, replicas, tick_s)
        history.append((qps, replicas, tpot * 1e3))
        decision = autoscaler.evaluate_scrape(
            service.exposition(), service.total_requests, replicas, now)
        replicas = decision.target_num_replicas
        now += tick_s
    return history


# The canonical SLO-vs-QPS comparison scenario, shared by bench.py's
# bench_slo_ramp and the load-tier tests so the README's pinned bench
# numbers and the asserting test provably describe the SAME experiment.
DEFAULT_TARGET_TPOT_MS = 15.0
DEFAULT_TICK_S = 10.0
DEFAULT_BASE_TPOT_S = 0.010
# True per-replica capacity; the spec's target_qps_per_replica below
# deliberately over-states it (operator calibrated on short prompts,
# traffic shifted long) — the miscalibration that breaks QPS-only
# autoscaling.
DEFAULT_KNEE_QPS = 2.0
DEFAULT_CLAIMED_QPS = 8.0
DEFAULT_MAX_REPLICAS = 8


def default_ramp(plateau_ticks: int = 12) -> List[float]:
    return [2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0] + \
        [16.0] * plateau_ticks


def make_ramp_autoscaler(slo: bool, tick_s: float = DEFAULT_TICK_S):
    """SLOAutoscaler (slo=True) or RequestRateAutoscaler (False) with
    the canonical scenario's spec — identical replica budget, identical
    QPS claim, 1-tick upscale delay, downscale effectively off."""
    from skypilot_tpu_torch.serve.autoscalers import Autoscaler
    from skypilot_tpu_torch.serve.service_spec import ServiceSpec
    policy = {
        'min_replicas': 1, 'max_replicas': DEFAULT_MAX_REPLICAS,
        'target_qps_per_replica': DEFAULT_CLAIMED_QPS,
        'upscale_delay_seconds': tick_s,
        'downscale_delay_seconds': 1200.0,
    }
    if slo:
        policy['target_tpot_ms'] = DEFAULT_TARGET_TPOT_MS
    spec = ServiceSpec.from_yaml_config(
        {'readiness_probe': '/health', 'replica_policy': policy})
    return Autoscaler.make(spec, decision_interval_seconds=tick_s)


def run_policy(slo: bool, qps_schedule: List[float],
               tick_s: float = DEFAULT_TICK_S
               ) -> List[Tuple[float, int, float]]:
    """Run the canonical scenario under one policy; -> run_ramp history."""
    service = VirtualService(base_tpot_s=DEFAULT_BASE_TPOT_S,
                             knee_qps_per_replica=DEFAULT_KNEE_QPS)
    return run_ramp(make_ramp_autoscaler(slo, tick_s), service,
                    qps_schedule, tick_s=tick_s)


def requests_weighted_p95(history: List[Tuple[float, int, float]],
                          last_n_ticks: Optional[int] = None) -> float:
    """p95 TPOT (ms) over the per-REQUEST distribution of a history
    window (each tick contributes qps-proportional weight) — the ground
    truth the autoscaler's windowed-histogram estimate approximates."""
    window = history[-last_n_ticks:] if last_n_ticks else history
    expanded = sorted((tpot_ms, qps) for qps, _, tpot_ms in window)
    total = sum(w for _, w in expanded)
    if total <= 0:
        return 0.0
    rank = 0.95 * total
    acc = 0.0
    for tpot_ms, w in expanded:
        acc += w
        if acc >= rank:
            return tpot_ms
    return expanded[-1][0]


# ----- disaggregated prefill/decode (phase-cost model) ------------------------
# VirtualService above models one homogeneous pool with a single
# latency knee.  The classes below split the model into the two PHASES
# a replica actually runs — compute-bound prefill and bandwidth-bound
# decode — so the sim can drive MIXED pools (ThunderServe,
# arXiv:2502.09334) and expose the coupling disaggregation removes:
# on a monolithic replica the phases share the device, so each phase
# sees only the device-time fraction the other leaves behind (the
# chunked-prefill interleave bounds the stall to one chunk, but the
# *throughput* steal remains); on split pools each phase gets a whole
# replica.

import dataclasses as _dataclasses


@_dataclasses.dataclass(frozen=True)
class PhaseCosts:
    """Per-replica phase costs for the disaggregated sim.

    prefill_tok_per_s is the replica's compute-bound prefill
    throughput; decode_tok_per_s its bandwidth-bound aggregate decode
    throughput (slots x 1/TPOT at the knee).  handoff_s is the KV-page
    push cost (serialize + RPC + adopt scatter), paid once per request
    on the disaggregated TTFT path only."""
    base_ttft_s: float = 0.05
    base_tpot_s: float = 0.010
    prefill_tok_per_s: float = 20000.0
    decode_tok_per_s: float = 2500.0
    handoff_s: float = 0.015


def phase_latency(base_s: float, own_share: float,
                  other_share: float) -> float:
    """Latency of one phase on a replica whose device time is shared.

    `own_share` / `other_share` are offered device-time fractions
    (demand / capacity).  The phase runs in the time the OTHER phase
    leaves (processor sharing — this is the cross-phase coupling), and
    queueing delay grows load-proportionally once its own effective
    utilization passes 1 (same shape as VirtualService's knee).  With
    other_share == 0 this reduces to base * max(1, own_share): a
    dedicated pool."""
    avail = max(0.05, 1.0 - min(other_share, 0.95))
    util = own_share / avail
    return (base_s / avail) * max(1.0, util)


class MixedPoolService(VirtualService):
    """Virtual service with separate prefill/decode phase costs.

    `step_monolithic` runs both phases colocated on one pool;
    `step_pools` runs them disaggregated on (prefill_replicas,
    decode_replicas).  Both record into the same cumulative TTFT/TPOT
    histograms VirtualService exposes, so the exposition() text drives
    the real autoscalers end to end."""

    def __init__(self, costs: PhaseCosts, prompt_tokens: float,
                 new_tokens: float) -> None:
        super().__init__(base_tpot_s=costs.base_tpot_s,
                         base_ttft_s=costs.base_ttft_s)
        self.costs = costs
        self.prompt_tokens = prompt_tokens
        self.new_tokens = new_tokens

    def _shares(self, qps: float, replicas: int):
        per = qps / max(replicas, 1)
        prefill = per * self.prompt_tokens / self.costs.prefill_tok_per_s
        decode = per * self.new_tokens / self.costs.decode_tok_per_s
        return prefill, decode

    def latencies_monolithic(self, qps: float, replicas: int):
        """(ttft_s, tpot_s) with both phases colocated: each phase
        sees the device-time fraction the other leaves behind."""
        p, d = self._shares(qps, replicas)
        ttft = phase_latency(self.costs.base_ttft_s, p, d)
        tpot = phase_latency(self.costs.base_tpot_s, d, p)
        return ttft, tpot

    def latencies_pools(self, qps: float, prefill_replicas: int,
                        decode_replicas: int):
        """(ttft_s, tpot_s) with dedicated pools: no cross-phase
        steal; TTFT pays the KV handoff once."""
        p, _ = self._shares(qps, max(prefill_replicas, 1))
        _, d = self._shares(qps, max(decode_replicas, 1))
        ttft = phase_latency(self.costs.base_ttft_s, p, 0.0) + \
            self.costs.handoff_s
        tpot = phase_latency(self.costs.base_tpot_s, d, 0.0)
        return ttft, tpot

    def _record(self, qps: float, dt_s: float, ttft: float,
                tpot: float):
        n = qps * dt_s
        self._observe(TPOT_FAMILY, tpot, n)
        self._observe(TTFT_FAMILY, ttft, n)
        self.total_requests += int(round(n))
        return ttft, tpot

    def step_monolithic(self, qps: float, replicas: int, dt_s: float):
        return self._record(qps, dt_s,
                            *self.latencies_monolithic(qps, replicas))

    def step_pools(self, qps: float, prefill_replicas: int,
                   decode_replicas: int, dt_s: float):
        return self._record(
            qps, dt_s,
            *self.latencies_pools(qps, prefill_replicas,
                                  decode_replicas))


# The canonical disaggregation scenario, shared by bench.py's
# bench_disagg and its test twin (tests/test_serve_disagg.py) so the
# README's pinned numbers and the asserting tests provably describe
# the SAME experiment.  Saturated mixed long/short traffic: the
# prompt-token mean models 70% short (256-token) / 30% long
# (~4100-token) requests — heavy enough prefill that a monolithic
# pool's cross-phase steal breaks the TPOT SLO at the plateau, while
# an equal-chip split pool holds both targets.
DISAGG_COSTS = PhaseCosts(base_ttft_s=0.05, base_tpot_s=0.010,
                          prefill_tok_per_s=20000.0,
                          decode_tok_per_s=1030.0, handoff_s=0.015)
DISAGG_PROMPT_TOKENS = 1408.0
DISAGG_NEW_TOKENS = 128.0
DISAGG_TARGET_TTFT_MS = 120.0
DISAGG_TARGET_TPOT_MS = 12.0
DISAGG_TOTAL_CHIPS = 8
DISAGG_PEAK_QPS = 40.0
DISAGG_TICK_S = 10.0

# The canonical FLEET scenario (skypilot_tpu/fleetsim/), documented
# next to its DISAGG_* siblings because bench_fleet, the fleetsim CLI
# and the test suite must all describe the SAME experiment.  One
# virtual replica here is deliberately SMALL (a single-host spot
# decode engine, ~2 req/s at SLO) so the bench's diurnal peak of
# roughly a thousand req/s genuinely needs a four-digit decode pool —
# the point of the fleet simulator is control-plane behavior at a
# replica count hardware quota won't allow, not latency fidelity of
# any one replica.  Traffic: Poisson arrivals at FLEET_BASE_QPS
# modulated by a sinusoidal diurnal envelope (amplitude
# FLEET_DIURNAL_AMPLITUDE, period FLEET_DIURNAL_PERIOD_S — compressed
# so a bench horizon of a few simulated minutes spans a full "day")
# plus scripted burst multipliers; multi-turn sessions (geometric turn
# count, exponential think time) over a large user population give
# every turn a shared system prefix + its own history, so prefix-cache
# hit rates EMERGE from the session structure.
FLEET_COSTS = PhaseCosts(base_ttft_s=0.08, base_tpot_s=0.020,
                         prefill_tok_per_s=9000.0,
                         decode_tok_per_s=260.0, handoff_s=0.010)
FLEET_PROMPT_TOKENS = 512.0     # mean NEW prompt tokens per turn
FLEET_NEW_TOKENS = 96.0         # mean decoded tokens per turn
FLEET_SHARED_PREFIX_TOKENS = 384.0   # system prompt, every session
FLEET_TURN_HISTORY_TOKENS = 256.0    # per prior turn, same session
FLEET_TARGET_TTFT_MS = 300.0
FLEET_TARGET_TPOT_MS = 25.0
FLEET_BASE_QPS = 1500.0         # diurnal mean arrival rate
FLEET_DIURNAL_AMPLITUDE = 0.6   # peak = base * (1 + amplitude)
FLEET_DIURNAL_PERIOD_S = 240.0  # one compressed "day" per bench run
FLEET_MEAN_TURNS = 4.0          # geometric session length
FLEET_MEAN_THINK_S = 8.0        # exponential inter-turn think time
FLEET_USERS = 2_000_000         # user-id population sampled from
FLEET_TICK_S = 1.0              # sim tick = LB/autoscaler cadence
FLEET_SEED = 20260807           # default --seed for published numbers

# Pool shape.  Prefill is a fixed-size pool (like the DISAGG scenario:
# evaluate_pools gives prefill no QPS demand floor) sized for the
# EFFECTIVE prompt-token peak — ~1.0k tokens/request after the emergent
# prefix-cache hit rate, times the burst-on-diurnal-peak QPS — at just
# under full utilization, so the token backlog (the LB shed signal)
# only accumulates transiently.  Decode scales on the QPS demand floor
# at FLEET_TARGET_QPS_PER_REPLICA plus TPOT violations, runs on spot
# with FLEET_SPOT_HEADROOM extra replicas banked against preemption.
FLEET_TARGET_QPS_PER_REPLICA = 2.0
FLEET_PREFILL_REPLICAS = 400
FLEET_DECODE_BASE_REPLICAS = 256
FLEET_DECODE_MAX_REPLICAS = 2048
FLEET_SPOT_HEADROOM = 64
FLEET_MAX_QUEUE_TOKENS = 4000   # LB shed limit per prefill replica
FLEET_PROVISION_DELAY_S = 8.0   # virtual replica launch -> READY
FLEET_UPSCALE_DELAY_S = 1.0     # react within one decision tick
FLEET_DOWNSCALE_DELAY_S = 30.0
FLEET_LEASE_TTL_S = 5.0         # singleton-lease failover window

# The canonical chaos script (Scenario.canonical): a 1.4x burst rides
# the diurnal peak; mid-burst a storm preempts half the decode spot
# pool; one second later the singleton-lease holder is killed (scaling
# frozen until the TTL elapses and the survivor's CAS takeover lands);
# on the decline one load balancer is severed for 20 s.
FLEET_BURST_AT_S = 60.0
FLEET_BURST_DURATION_S = 30.0
FLEET_BURST_MULTIPLIER = 1.4
FLEET_STORM_AT_S = 75.0
FLEET_STORM_FRACTION = 0.5
FLEET_KILL_AT_S = 76.0
FLEET_SEVER_AT_S = 150.0
FLEET_SEVER_DURATION_S = 20.0


def make_rng(seed: Optional[int] = None) -> random.Random:
    """The ONE seeded RNG shared by slo_sim and fleetsim.

    Every stochastic choice in a fleet run (arrival thinning, session
    turn counts, think times, storm victim sampling) draws from a
    single ``random.Random`` minted here, plumbed from the CLI/bench
    ``--seed`` flag — so every published fleet number is
    byte-reproducible from its command line."""
    return random.Random(FLEET_SEED if seed is None else seed)


def disagg_ramp(plateau_ticks: int = 8) -> List[float]:
    return [5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0] + \
        [DISAGG_PEAK_QPS] * plateau_ticks


def make_disagg_service() -> MixedPoolService:
    return MixedPoolService(DISAGG_COSTS, DISAGG_PROMPT_TOKENS,
                            DISAGG_NEW_TOKENS)


def make_disagg_autoscaler(spot_headroom: int = 1,
                           tick_s: float = DISAGG_TICK_S):
    """The canonical per-pool autoscaler: prefill pool fixed-size 2
    (TTFT never violates there), decode pool driven by the QPS demand
    floor (claimed 8 qps/replica) + TPOT violations, on spot with the
    given preemption headroom."""
    from skypilot_tpu_torch.serve.autoscalers import Autoscaler
    from skypilot_tpu_torch.serve.service_spec import ServiceSpec
    spec = ServiceSpec.from_yaml_config({
        'readiness_probe': '/health',
        'kv_page_size': 64,
        'replica_policy': {
            'min_replicas': 1,
            'max_replicas': DISAGG_TOTAL_CHIPS,
            'target_qps_per_replica': 8.0,
            'target_ttft_ms': DISAGG_TARGET_TTFT_MS,
            'target_tpot_ms': DISAGG_TARGET_TPOT_MS,
            'upscale_delay_seconds': tick_s,
            'downscale_delay_seconds': 1200.0,
        },
        'disaggregation': {
            'prefill_replicas': 2,
            'decode_replicas': 1,
            'prefill_max_replicas': DISAGG_TOTAL_CHIPS,
            'decode_max_replicas': DISAGG_TOTAL_CHIPS,
            'use_spot_decode': True,
            'spot_headroom': spot_headroom,
        },
    })
    return Autoscaler.make(spec, decision_interval_seconds=tick_s)


def run_disagg_ramp(autoscaler, service: MixedPoolService,
                    qps_schedule: List[float],
                    preempt_tick: Optional[int] = None,
                    tick_s: float = DISAGG_TICK_S,
                    now0: float = 1_000.0):
    """Drive the per-pool autoscaler through a ramp with ideal
    provisioning (run_ramp's disaggregated twin).  At `preempt_tick`
    one decode replica is preempted BEFORE traffic flows — that tick
    runs on the reduced pool, and the autoscaler's next decision is
    the lightweight re-plan that restores it.  Returns
    [(qps, prefill_replicas, decode_replicas, ttft_ms, tpot_ms)]."""
    history = []
    live_p = autoscaler.spec.disaggregation.prefill_replicas
    live_d = (autoscaler.spec.disaggregation.decode_replicas +
              (autoscaler.spec.disaggregation.spot_headroom
               if autoscaler.spec.disaggregation.use_spot_decode else 0))
    now = now0
    for i, qps in enumerate(qps_schedule):
        if preempt_tick is not None and i == preempt_tick:
            live_d = max(1, live_d - 1)
        ttft, tpot = service.step_pools(qps, live_p, live_d, tick_s)
        history.append((qps, live_p, live_d, ttft * 1e3, tpot * 1e3))
        decision = autoscaler.evaluate_pools(
            service.exposition(), service.total_requests, live_p,
            live_d, now)
        live_p = decision.prefill.target_num_replicas
        live_d = decision.decode.target_num_replicas
        now += tick_s
    return history
