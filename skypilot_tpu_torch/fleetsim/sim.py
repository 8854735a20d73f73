"""The fleet simulator: REAL control plane, virtual replicas.

A discrete-event loop (tick = slo_sim.FLEET_TICK_S of simulated time)
drives the production serving stack end to end:

- **Routing/admission** — real ``LoadBalancer`` instances (never
  ``start()``-ed; the sim calls the same internal entry points the
  HTTP handler does): per-request policy ``select()`` over the ready
  prefill pool, ``_pick_decode_targets`` for the KV handoff,
  ``_shed_excess_tokens`` + ``_shed_retry_after`` for queue-aware
  429s, ``_no_ready_retry_after`` for 503 back-off.
- **Scaling** — a real ``DisaggSLOAutoscaler`` built by
  ``Autoscaler.make`` from a real ``ServiceSpec``, fed the SAME
  Prometheus exposition text a controller scrape would see
  (slo_sim.MixedPoolService renders it) through ``evaluate_pools``.
- **Replica lifecycle** — a real ``ReplicaManager`` subclass that
  overrides ONLY the cloud boundary (``_launch_replica`` /
  ``_teardown_cluster``); every state transition
  (PROVISIONING→STARTING→READY, guarded CAS transitions, preemption
  accounting) runs the production serve_state code against the
  sqlite-or-Postgres backend.
- **Leases** — the singleton-controller role is exercised through the
  real ``leases.try_acquire_singleton``: a virtual controller holds
  the lease (its heartbeat row is re-upserted with wall time each
  tick, so the REAL respect-live-holder path refuses the sim), and
  when the scenario kills it the row is backdated past the TTL and
  the sim defers its next acquire until the TTL has elapsed in SIM
  time — then the genuine dead-holder CAS takeover runs.  The freeze
  window is the measured cost of controller failover.

Only replica LATENCY is modeled (slo_sim's PhaseCosts
processor-sharing model) — the one thing a zero-hardware run cannot
measure.  Everything the paper claims about fleet behavior (shed
rates, storm recovery, lease failover, DB hot paths) comes from the
real code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import itertools
import math
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.fleetsim import profile as profile_lib
from skypilot_tpu_torch.obs import alerts as obs_alerts
from skypilot_tpu_torch.obs import store as obs_store
from skypilot_tpu_torch.fleetsim.scenario import (LBSever, LeaseholderKill,
                                            PreemptionStorm, Scenario)
from skypilot_tpu_torch.fleetsim.traffic import (Request, TrafficGenerator,
                                           TrafficSpec)
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.serve import slo_sim
from skypilot_tpu_torch.serve.autoscalers import Autoscaler
from skypilot_tpu_torch.serve.load_balancer import LoadBalancer
from skypilot_tpu_torch.serve.load_balancing_policies import RoundRobinPolicy
from skypilot_tpu_torch.serve.replica_managers import ReplicaManager
from skypilot_tpu_torch.serve.serve_state import ReplicaStatus
from skypilot_tpu_torch.serve.service_spec import ServiceSpec
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.state import leases
from skypilot_tpu_torch.utils import db_utils

# Replicas launched per scale_up batch before the sim drains the
# launch threads: bounds concurrent sqlite writers (and threads) while
# a storm replacement provisions hundreds of replicas in one decision.
_SCALE_CHUNK = 64
# Total delivery attempts per request (1 initial + 2 retries).
_MAX_ATTEMPTS = 3
# Per-replica session-affinity cache entries (FIFO eviction): bounds
# the prefix-cache model's memory like a real radix cache's HBM does.
_SESSION_CACHE_CAP = 512
# evaluate_pools works in wall-clock space; the sim feeds it
# epoch0 + sim_t so its QPS windows see sim time.
_EPOCH0 = 1_000_000.0


@contextlib.contextmanager
def _timed(path: str) -> Iterator[None]:
    """Wall time of one control-plane step, by path — the fleetsim
    counterpart of db_utils' per-op timing; together they make the
    run's hot-path profile."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics_lib.observe_hist('skytpu_fleetsim_control_seconds',
                                 time.perf_counter() - t0, path=path)


@dataclasses.dataclass
class FleetConfig:
    """One fleet run, fully specified (canonical values: FLEET_*)."""
    service_name: str = 'fleet'
    horizon_s: float = slo_sim.FLEET_DIURNAL_PERIOD_S
    tick_s: float = slo_sim.FLEET_TICK_S
    seed: Optional[int] = None           # None -> slo_sim.FLEET_SEED
    # DSN: a sqlite path or postgresql:// URL; None -> a fresh sqlite
    # file under a temp dir (run_fleet wires it into the env).
    db: Optional[str] = None
    n_lbs: int = 3
    traffic: TrafficSpec = dataclasses.field(
        default_factory=TrafficSpec)
    scenario: Scenario = dataclasses.field(
        default_factory=Scenario.canonical)
    costs: slo_sim.PhaseCosts = slo_sim.FLEET_COSTS
    target_ttft_ms: float = slo_sim.FLEET_TARGET_TTFT_MS
    target_tpot_ms: float = slo_sim.FLEET_TARGET_TPOT_MS
    target_qps_per_replica: float = slo_sim.FLEET_TARGET_QPS_PER_REPLICA
    prefill_replicas: int = slo_sim.FLEET_PREFILL_REPLICAS
    decode_base_replicas: int = slo_sim.FLEET_DECODE_BASE_REPLICAS
    decode_max_replicas: int = slo_sim.FLEET_DECODE_MAX_REPLICAS
    spot_headroom: int = slo_sim.FLEET_SPOT_HEADROOM
    max_queue_tokens_per_replica: int = slo_sim.FLEET_MAX_QUEUE_TOKENS
    provision_delay_s: float = slo_sim.FLEET_PROVISION_DELAY_S
    lease_ttl_s: float = slo_sim.FLEET_LEASE_TTL_S
    upscale_delay_s: float = slo_sim.FLEET_UPSCALE_DELAY_S
    downscale_delay_s: float = slo_sim.FLEET_DOWNSCALE_DELAY_S
    qps_window_s: float = 30.0


def fleet_config(smoke: bool = False, seed: Optional[int] = None,
                 db: Optional[str] = None) -> FleetConfig:
    """The canonical run (bench/README numbers), or the CI-sized smoke
    twin: same structure — diurnal envelope, burst, storm, leaseholder
    kill, LB sever — an order of magnitude smaller and shorter."""
    if not smoke:
        return FleetConfig(seed=seed, db=db)
    return FleetConfig(
        service_name='fleet-smoke',
        horizon_s=60.0,
        seed=seed,
        db=db,
        n_lbs=2,
        traffic=TrafficSpec(base_qps=64.0, diurnal_period_s=60.0,
                            users=20_000),
        scenario=Scenario.from_config({
            'events': [
                {'kind': 'preemption_storm', 'at_s': 20.0,
                 'fraction': 0.5},
                {'kind': 'leaseholder_kill', 'at_s': 21.0},
                {'kind': 'lb_sever', 'at_s': 40.0, 'duration_s': 5.0},
            ],
            'bursts': [{'at_s': 15.0, 'duration_s': 10.0,
                        'multiplier': 1.4}],
        }),
        prefill_replicas=12,
        decode_base_replicas=16,
        decode_max_replicas=128,
        spot_headroom=4,
        provision_delay_s=2.0,
        lease_ttl_s=3.0,
    )


@dataclasses.dataclass
class FleetResult:
    """One run's headline numbers + per-tick history + profile."""
    sustained_qps_at_slo: float
    peak_replicas: int
    pools: int
    storm_fraction_pct: float
    recovery_s: Optional[float]
    admitted: int
    shed: int
    no_ready: int
    retried: int
    prefix_hit_rate: float
    lease_frozen_s: float
    backend: str
    seed: int
    horizon_s: float
    history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    profile: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    wall_s: float = 0.0
    # The run's SLO alert timeline (obs/alerts.py over the ingested
    # sim telemetry), fire-order, times in sim seconds — the canonical
    # storm's fire/clear ticks are test-pinned from this list.
    alerts: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def headline(self) -> str:
        """The README/bench claim, verbatim (test_readme_bench pins
        this exact format both directions)."""
        base = (f'sustains {self.sustained_qps_at_slo:.0f} req/s at '
                f'SLO with {self.peak_replicas} virtual replicas '
                f'across {self.pools} pools')
        if self.storm_fraction_pct and self.recovery_s is not None:
            return base + (f'; recovers from a '
                           f'{self.storm_fraction_pct:.0f}% preemption '
                           f'storm in {self.recovery_s:.1f} s')
        return base

    def to_dict(self, with_history: bool = False) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        if not with_history:
            out.pop('history')
        out['headline'] = self.headline()
        return out


class VirtualReplicaManager(ReplicaManager):
    """ReplicaManager whose cloud boundary is virtual.

    Overrides EXACTLY two methods — ``_launch_replica`` (no
    execution.launch; mints a synthetic URL, runs the same
    set_replica_endpoint + guarded PROVISIONING→STARTING transition
    the real launch thread does, then registers the replica's
    sim-time readiness) and ``_teardown_cluster`` (no cloud to tear
    down).  Everything else — scale_up's launch threads and DB rows,
    scale_down's least-useful-first ordering, terminate_replica's
    preemption accounting — is the production code, which is the
    point: tests assert this override surface stays exactly this
    small."""

    def __init__(self, service_name: str, spec: ServiceSpec,
                 task: task_lib.Task, sim: 'FleetSim') -> None:
        super().__init__(service_name, spec, task)
        self._sim = sim

    def _launch_replica(self, replica_id: int, zone: Optional[str],
                        is_spot: bool,
                        role: Optional[str] = None) -> None:
        del zone, is_spot, role
        url = (f'http://replica-{replica_id}.'
               f'{self.service_name}.sim')
        serve_state.set_replica_endpoint(self.service_name, replica_id,
                                         url, None)
        # Same guarded transition as the real launch thread: a replica
        # terminated mid-provision must not be resurrected.
        if not serve_state.set_replica_status_if(
                self.service_name, replica_id,
                ReplicaStatus.PROVISIONING, ReplicaStatus.STARTING):
            return
        self._sim.note_starting(replica_id)

    def _teardown_cluster(self, cluster_name: str) -> None:
        del cluster_name


class FleetSim:
    """One discrete-event fleet run.  Construct AFTER the control-plane
    env (SKYTPU_SERVE_DB / SKYTPU_DB_URL, SKYTPU_DB_LEASES,
    SKYTPU_LEASE_TTL_S) is set — run_fleet does both."""

    def __init__(self, config: FleetConfig) -> None:
        self.cfg = config
        self.rng = slo_sim.make_rng(config.seed)
        self.scenario = config.scenario
        traffic = config.traffic
        if not traffic.bursts and self.scenario.bursts:
            traffic = dataclasses.replace(traffic,
                                          bursts=self.scenario.bursts)
        self.traffic = traffic
        self.gen = TrafficGenerator(traffic, self.rng)
        self.spec = ServiceSpec.from_yaml_config({
            'readiness_probe': '/health',
            'kv_page_size': 64,
            'max_queue_tokens_per_replica':
                config.max_queue_tokens_per_replica,
            'replica_policy': {
                'min_replicas': 1,
                'max_replicas': (config.prefill_replicas +
                                 config.decode_max_replicas),
                'target_qps_per_replica':
                    config.target_qps_per_replica,
                'target_ttft_ms': config.target_ttft_ms,
                'target_tpot_ms': config.target_tpot_ms,
                'upscale_delay_seconds': config.upscale_delay_s,
                'downscale_delay_seconds': config.downscale_delay_s,
            },
            'disaggregation': {
                'prefill_replicas': config.prefill_replicas,
                'decode_replicas': config.decode_base_replicas,
                'prefill_max_replicas': config.prefill_replicas,
                'decode_max_replicas': config.decode_max_replicas,
                'use_spot_decode': True,
                'spot_headroom': config.spot_headroom,
            },
        })
        task = task_lib.Task(name=config.service_name,
                             run='echo virtual-replica')
        self.manager = VirtualReplicaManager(config.service_name,
                                             self.spec, task, sim=self)
        self.autoscaler = Autoscaler.make(
            self.spec, decision_interval_seconds=config.tick_s,
            qps_window_seconds=config.qps_window_s)
        self.service = slo_sim.MixedPoolService(
            config.costs, traffic.prompt_tokens, traffic.new_tokens)
        self.lbs = [
            LoadBalancer(config.service_name, 8080 + i,
                         RoundRobinPolicy(),
                         ready_urls_fn=self._cached_ready_urls,
                         ready_replicas_fn=self._cached_ready_replicas,
                         max_queue_tokens_per_replica=self.spec.
                         max_queue_tokens_per_replica)
            for i in range(config.n_lbs)
        ]
        self.dsn = serve_state._db_path()  # pylint: disable=protected-access
        # Telemetry plane on the SAME code path production runs: the
        # decision tick ingests the service exposition at sim time and
        # the alert engine burns over it, with the burn windows scaled
        # to sim ticks (5m/1h + 30m/6h compressed the same way the
        # diurnal "day" is).  leader_check is skipped per-scrape — the
        # tick itself is already lease-gated.
        self._obs = obs_store.TelemetryStore(
            self.dsn, resolution=config.tick_s,
            retention=max(config.horizon_s,
                          30.0 * config.tick_s) + config.tick_s)
        # clear_ratio 0.98 for the latency rules (not production's
        # 0.9): the sim's healthy TPOT (20 ms) interpolates inside the
        # 10–25 ms exposition bucket to a p95 of 24.25 ms = burn 0.97
        # against the 25 ms target, so a 0.9 clear bar could never be
        # reached — bucket quantization floors the burn a rule can see.
        rules = tuple(
            dataclasses.replace(r, clear_ratio=0.98)
            if r.kind == 'latency_burn' else r
            for r in obs_alerts.default_rules(config.target_ttft_ms,
                                              config.target_tpot_ms))
        self._alert_engine = obs_alerts.AlertEngine(
            self._obs, config.service_name, rules,
            windows=obs_alerts.BurnWindows(
                fast=(5.0 * config.tick_s, 15.0 * config.tick_s),
                slow=(10.0 * config.tick_s, 30.0 * config.tick_s)))
        self._lease_name = f'fleetsim-controller-{config.service_name}'
        self._virt = f'{config.service_name}-ctrl-a:0:virtual0'
        self._virtual_holder_alive = True
        self._lease_blocked_until = -math.inf
        self.now = 0.0
        self._warm = False
        self._pending_lock = threading.Lock()
        self._pending_ready: Dict[int, float] = {}
        self._ready_cache: List[Tuple[int, str, Optional[str]]] = []
        # url -> [shared_prefix_cached, {session_id: last turn}].
        self._prefix_state: Dict[str, list] = {}
        self._backlog_tokens = 0.0
        self._severed: Dict[int, float] = {}
        self._rr = 0
        self._seq = itertools.count()
        self._next_arrival = 0
        self._retries: List[Tuple[float, int, int, Request]] = []
        self._last_live = (0, 0)
        self._lease_frozen_s = 0.0
        self._storm_t: Optional[float] = None
        self._storm_fraction = 0.0
        self.totals = {'admitted': 0, 'shed': 0, 'no_ready': 0,
                       'retried': 0, 'hit_tokens': 0.0,
                       'miss_tokens': 0.0}

    # ----- hooks the virtual manager / LBs call -------------------------------
    def note_starting(self, replica_id: int) -> None:
        """Called by the virtual launch thread: the replica turns READY
        after the modeled provision delay (warm-start replicas are
        ready immediately — the run begins at steady state)."""
        ready_at = self.now if self._warm else \
            self.now + self.cfg.provision_delay_s
        with self._pending_lock:
            self._pending_ready[replica_id] = ready_at

    def _cached_ready_urls(self) -> List[str]:
        return [u for _, u, _ in self._ready_cache]

    def _cached_ready_replicas(self
                               ) -> List[Tuple[int, str, Optional[str]]]:
        return self._ready_cache

    # ----- lease chaos --------------------------------------------------------
    def _virt_heartbeat(self) -> None:
        """Keep the virtual controller's lease row WALL-live: sim ticks
        are milliseconds of wall time apart, so an every-tick upsert
        with time.time() means the real is_live() check genuinely
        refuses takeover while the scenario says the holder is up."""
        now = time.time()
        if leases._is_pg(self.dsn):  # pylint: disable=protected-access
            sql = (f'INSERT INTO server_instances (instance_id, host, '
                   f'pid, started_at, last_heartbeat) '
                   f'VALUES (?,?,?,?,{leases._PG_NOW}) '  # pylint: disable=protected-access
                   f'ON CONFLICT(instance_id) DO UPDATE SET '
                   f'last_heartbeat={leases._PG_NOW}')  # pylint: disable=protected-access
            params: Tuple = (self._virt, 'virtual', 0, now)
        else:
            sql = ('INSERT INTO server_instances (instance_id, host, '
                   'pid, started_at, last_heartbeat) VALUES (?,?,?,?,?) '
                   'ON CONFLICT(instance_id) DO UPDATE SET '
                   'last_heartbeat=excluded.last_heartbeat')
            params = (self._virt, 'virtual', 0, now, now)
        db_utils.execute(self.dsn, sql, params)

    def _kill_virtual_holder(self, t: float) -> None:
        """The scenario's leaseholder death: stop heartbeating and
        backdate the row past the TTL so it is immediately WALL-dead —
        the mechanism (stale heartbeat -> CAS takeover) is the real
        one; only the TTL *wait* is deferred into sim time."""
        self._virtual_holder_alive = False
        ttl = self.cfg.lease_ttl_s
        if leases._is_pg(self.dsn):  # pylint: disable=protected-access
            db_utils.execute(
                self.dsn,
                f'UPDATE server_instances SET '
                f'last_heartbeat={leases._PG_NOW} - ? '  # pylint: disable=protected-access
                f'WHERE instance_id=?', (ttl * 3 + 5, self._virt))
        else:
            db_utils.execute(
                self.dsn,
                'UPDATE server_instances SET last_heartbeat=? '
                'WHERE instance_id=?',
                (time.time() - ttl * 3 - 5, self._virt))
        self._lease_blocked_until = t + ttl

    # ----- lifecycle plumbing -------------------------------------------------
    def _drain_launches(self) -> None:
        with self.manager._lock:  # pylint: disable=protected-access
            threads = list(
                self.manager._launch_threads.items())  # pylint: disable=protected-access
        for _, th in threads:
            th.join(timeout=60.0)
        with self.manager._lock:  # pylint: disable=protected-access
            for rid, th in threads:
                if not th.is_alive():
                    self.manager._launch_threads.pop(rid, None)  # pylint: disable=protected-access

    def _scale_up(self, n: int, role: str) -> None:
        while n > 0:
            chunk = min(n, _SCALE_CHUNK)
            with _timed('replicas.scale_up'):
                self.manager.scale_up(chunk, role=role)
            self._drain_launches()
            n -= chunk

    def _apply_ready(self, t: float) -> None:
        with self._pending_lock:
            due = [rid for rid, at in self._pending_ready.items()
                   if at <= t]
            for rid in due:
                del self._pending_ready[rid]
        for rid in due:
            # Guarded like the probe loop's READY transition: a replica
            # scaled down while "starting" stays terminated.
            serve_state.set_replica_status_if(
                self.cfg.service_name, rid, ReplicaStatus.STARTING,
                ReplicaStatus.READY)

    def _refresh_ready(self) -> None:
        self._ready_cache = self.manager.ready_replicas()
        current = {u for _, u, _ in self._ready_cache}
        for url in [u for u in self._prefix_state
                    if u not in current]:
            del self._prefix_state[url]

    # ----- scenario events ----------------------------------------------------
    def _fire(self, ev: Any, t: float) -> None:
        if isinstance(ev, PreemptionStorm):
            with _timed('scenario.storm'):
                victims = [
                    r for r in serve_state.get_replicas(
                        self.cfg.service_name)
                    if r['status'] is ReplicaStatus.READY and
                    r['is_spot'] and r['role'] == ev.pool
                ]
                k = min(int(round(ev.fraction * len(victims))),
                        len(victims))
                for rec in self.rng.sample(victims, k):
                    self.manager.terminate_replica(rec['replica_id'],
                                                   preempted=True)
            if self._storm_t is None:
                self._storm_t = t
                self._storm_fraction = ev.fraction
            metrics_lib.inc_counter('skytpu_fleetsim_events_total',
                                    kind='preemption_storm')
        elif isinstance(ev, LeaseholderKill):
            self._kill_virtual_holder(t)
            metrics_lib.inc_counter('skytpu_fleetsim_events_total',
                                    kind='leaseholder_kill')
        elif isinstance(ev, LBSever):
            self._severed[ev.lb_index % len(self.lbs)] = \
                t + ev.duration_s
            metrics_lib.inc_counter('skytpu_fleetsim_events_total',
                                    kind='lb_severed')

    def _restore_severed(self, t: float) -> None:
        for i, until in list(self._severed.items()):
            if t >= until:
                del self._severed[i]
                metrics_lib.inc_counter('skytpu_fleetsim_events_total',
                                        kind='lb_restored')

    # ----- routing ------------------------------------------------------------
    def _prefix_hit_tokens(self, url: str, req: Request) -> float:
        """Emergent prefix-cache model: a replica that has served ANY
        request holds the shared system prefix; it holds a session's
        history up to the last turn it served for that session.  Hit
        rates thus fall out of how the policy spreads sessions across
        replicas — nothing is dialed in."""
        st = self._prefix_state.get(url)
        if st is None:
            st = [False, {}]
            self._prefix_state[url] = st
        hit = 0.0
        if st[0]:
            hit += min(req.prefix_tokens,
                       self.traffic.shared_prefix_tokens)
        else:
            st[0] = True
        seen_turns = st[1]
        cached_turns = seen_turns.get(req.session_id, 0)
        hit += (min(req.turn - 1, cached_turns) *
                self.traffic.turn_history_tokens)
        if req.session_id not in seen_turns and \
                len(seen_turns) >= _SESSION_CACHE_CAP:
            del seen_turns[next(iter(seen_turns))]
        seen_turns[req.session_id] = req.turn - 1
        return min(hit, req.prefix_tokens)

    def _route_tick(self, t0: float, t1: float,
                    requests: List[Request]) -> Dict[str, float]:
        cache = self._ready_cache
        prefill_urls = [u for _, u, r in cache if r == 'prefill']
        decode_urls = [u for _, u, r in cache if r == 'decode']
        all_urls = [u for _, u, _ in cache]
        disagg = bool(prefill_urls) and bool(decode_urls)
        route_urls = prefill_urls if disagg else all_urls
        admission_urls = prefill_urls if prefill_urls else all_urls
        live_lbs = [lb for i, lb in enumerate(self.lbs)
                    if i not in self._severed]
        # Refresh each live LB's internal ready view (role split,
        # departed-url pruning) exactly as its request path would.
        for lb in live_lbs:
            lb._ready()  # pylint: disable=protected-access
        # The admission view only changes between ticks (backlog is
        # noted once per tick), so the REAL shed check runs once per
        # LB per tick and its verdict applies to the tick's requests —
        # not once per request, which would be O(pool) x O(arrivals).
        shed_excess: Dict[int, Optional[float]] = {}
        limit = self.cfg.max_queue_tokens_per_replica
        gate_open = (limit is not None and prefill_urls and
                     self._backlog_tokens / len(prefill_urls) >
                     0.5 * limit)
        for i, lb in enumerate(self.lbs):
            if lb not in live_lbs:
                continue
            shed_excess[i] = lb._shed_excess_tokens(  # pylint: disable=protected-access
                admission_urls) if gate_open else None
        stats = {'admitted': 0, 'shed': 0, 'no_ready': 0,
                 'retried': 0, 'hit_tokens': 0.0, 'miss_tokens': 0.0,
                 'eff_prompt_tokens': 0.0, 'new_tokens': 0.0,
                 'offered': 0}

        def retry(req: Request, attempts: int, at: float) -> None:
            if attempts < _MAX_ATTEMPTS:
                heapq.heappush(
                    self._retries,
                    (at, next(self._seq), attempts + 1, req))
                stats['retried'] += 1

        def handle(req: Request, attempts: int) -> None:
            stats['offered'] += 1
            if not live_lbs:
                stats['no_ready'] += 1
                retry(req, attempts, t1 + 1.0)
                return
            i = self._rr % len(live_lbs)
            self._rr += 1
            lb = live_lbs[i]
            lb._request_count += 1  # pylint: disable=protected-access
            excess = shed_excess.get(self.lbs.index(lb))
            if excess is not None:
                stats['shed'] += 1
                retry(req, attempts,
                      t0 + lb._shed_retry_after(excess))  # pylint: disable=protected-access
                return
            url = lb.policy.select(route_urls)
            if url is None:
                stats['no_ready'] += 1
                retry(req, attempts,
                      t0 + lb._no_ready_retry_after())  # pylint: disable=protected-access
                return
            if disagg:
                lb._pick_decode_targets(decode_urls)  # pylint: disable=protected-access
            hit = self._prefix_hit_tokens(url, req)
            stats['hit_tokens'] += hit
            stats['miss_tokens'] += req.prefix_tokens - hit
            stats['admitted'] += 1
            stats['eff_prompt_tokens'] += \
                req.prompt_tokens + (req.prefix_tokens - hit)
            stats['new_tokens'] += req.new_tokens

        while self._retries and self._retries[0][0] < t1:
            _, _, attempts, req = heapq.heappop(self._retries)
            handle(req, attempts)
        while self._next_arrival < len(requests) and \
                requests[self._next_arrival].t < t1:
            handle(requests[self._next_arrival], 1)
            self._next_arrival += 1

        for outcome in ('admitted', 'shed', 'no_ready', 'retried'):
            if stats[outcome]:
                metrics_lib.inc_counter(
                    'skytpu_fleetsim_requests_total',
                    float(stats[outcome]), outcome=outcome)
                self.totals[outcome] += stats[outcome]
        for kind, key in (('hit', 'hit_tokens'),
                          ('miss', 'miss_tokens')):
            if stats[key]:
                metrics_lib.inc_counter(
                    'skytpu_fleetsim_prefix_tokens_total',
                    stats[key], outcome=kind)
                self.totals[key] += stats[key]
        stats['ready_prefill'] = len(prefill_urls)
        stats['ready_decode'] = len(decode_urls)
        stats['ready_total'] = len(all_urls)
        return stats

    # ----- latency + backlog model --------------------------------------------
    def _model_tick(self, stats: Dict[str, float],
                    tick_s: float) -> Tuple[float, float]:
        admitted = stats['admitted']
        qps = admitted / tick_s
        ready_p = int(stats['ready_prefill'])
        ready_d = int(stats['ready_decode'])
        if admitted:
            self.service.prompt_tokens = \
                stats['eff_prompt_tokens'] / admitted
            self.service.new_tokens = stats['new_tokens'] / admitted
            if ready_p and ready_d:
                ttft, tpot = self.service.latencies_pools(
                    qps, ready_p, ready_d)
            else:
                ttft, tpot = self.service.latencies_monolithic(
                    qps, max(int(stats['ready_total']), 1))
            self.service._record(qps, tick_s, ttft, tpot)  # pylint: disable=protected-access
        else:
            ttft = self.cfg.costs.base_ttft_s + self.cfg.costs.handoff_s
            tpot = self.cfg.costs.base_tpot_s
        # Prefill-token backlog: offered minus pool drain capacity,
        # clamped at zero — the source of the LB's queue-aware sheds
        # and the autoscaler's backlog-violation signal.
        offered_tok_s = qps * (stats['eff_prompt_tokens'] / admitted
                               if admitted else 0.0)
        drain_pool = ready_p if ready_p else int(stats['ready_total'])
        capacity = drain_pool * self.cfg.costs.prefill_tok_per_s
        self._backlog_tokens = max(
            0.0,
            self._backlog_tokens + (offered_tok_s - capacity) * tick_s)
        self.service.backlog_tokens = self._backlog_tokens
        per_replica = self._backlog_tokens / max(drain_pool, 1)
        prefill_urls = [u for _, u, r in self._ready_cache
                        if r == 'prefill'] or \
            [u for _, u, _ in self._ready_cache]
        for i, lb in enumerate(self.lbs):
            if i in self._severed:
                continue   # a severed LB's admission view freezes
            for url in prefill_urls:
                lb._note_backlog(url, per_replica)  # pylint: disable=protected-access
        return ttft, tpot

    # ----- the decision tick --------------------------------------------------
    def _decide(self, t: float) -> None:
        with _timed('replicas.ready_view'):
            live_p = self.manager.num_live('prefill')
            live_d = self.manager.num_live('decode')
        self._last_live = (live_p, live_d)
        total_requests = sum(lb.proxied_requests() for lb in self.lbs)
        if self._virtual_holder_alive:
            # The REAL respect-live-holder path: the virtual
            # controller's heartbeat is wall-fresh, so this returns
            # False — and the sim applies decisions *as* that holder.
            with _timed('lease.try_acquire'):
                leases.try_acquire_singleton(self.dsn,
                                             self._lease_name)
            can_decide = True
        elif t < self._lease_blocked_until:
            # TTL not yet elapsed in SIM time: nobody may take over
            # yet.  This window is the failover freeze the run
            # measures.
            can_decide = False
        else:
            # The REAL dead-holder CAS takeover.
            with _timed('lease.try_acquire'):
                can_decide = leases.try_acquire_singleton(
                    self.dsn, self._lease_name)
        if not can_decide:
            self._lease_frozen_s += self.cfg.tick_s
            return
        with _timed('obs.ingest'):
            # leader_check=False: this tick IS the singleton decision
            # path — the freeze window above therefore shows up as a
            # telemetry gap, which is exactly what dark_scrape alerts
            # on after takeover.
            self._obs.ingest(self.cfg.service_name,
                             self.service.exposition(),
                             now=_EPOCH0 + t, leader_check=False)
            self._alert_engine.evaluate(_EPOCH0 + t)
        with _timed('autoscaler.evaluate'):
            decision = self.autoscaler.evaluate_pools(
                self.service.exposition(), total_requests, live_p,
                live_d, now=_EPOCH0 + t)
        for role, pool_decision in (('prefill', decision.prefill),
                                    ('decode', decision.decode)):
            if pool_decision.delta > 0:
                self._scale_up(pool_decision.delta, role)
            elif pool_decision.delta < 0:
                with _timed('replicas.scale_down'):
                    self.manager.scale_down(-pool_decision.delta,
                                            role=role)

    # ----- setup / run --------------------------------------------------------
    def _setup(self) -> None:
        db_utils.ensure_schema(self.dsn, leases._DDL)  # pylint: disable=protected-access
        # Stage the virtual controller as the current lease holder.
        self._virt_heartbeat()
        db_utils.execute(
            self.dsn,
            'INSERT INTO singleton_leases (name, instance_id, '
            'acquired_at) VALUES (?,?,?) ON CONFLICT(name) DO NOTHING',
            (self._lease_name, self._virt, time.time()))
        # Warm start: the run opens at steady state — prefill at its
        # fixed size, decode sized for t=0 demand plus headroom.
        self._warm = True
        decode0 = min(
            self.cfg.decode_max_replicas,
            max(self.cfg.decode_base_replicas,
                int(math.ceil(self.gen.rate(0.0) /
                              self.cfg.target_qps_per_replica)) +
                self.cfg.spot_headroom))
        self._scale_up(self.cfg.prefill_replicas, 'prefill')
        self._scale_up(decode0, 'decode')
        self._apply_ready(0.0)
        self._warm = False
        self._refresh_ready()

    def run(self) -> FleetResult:
        cfg = self.cfg
        self._setup()
        requests = self.gen.generate(cfg.horizon_s)
        history: List[Dict[str, Any]] = []
        n_ticks = int(round(cfg.horizon_s / cfg.tick_s))
        for k in range(n_ticks):
            t0 = k * cfg.tick_s
            t1 = t0 + cfg.tick_s
            self.now = t0
            self._restore_severed(t0)
            for ev in self.scenario.due(t0, t1):
                self._fire(ev, t0)
            if self._virtual_holder_alive:
                with _timed('servers.heartbeat'):
                    self._virt_heartbeat()
            self._drain_launches()
            with _timed('replicas.apply_ready'):
                self._apply_ready(t0)
            with _timed('replicas.ready_view'):
                self._refresh_ready()
            with _timed('lb.route'):
                stats = self._route_tick(t0, t1, requests)
            ttft, tpot = self._model_tick(stats, cfg.tick_s)
            self._decide(t0)
            ttft_ms, tpot_ms = ttft * 1e3, tpot * 1e3
            slo_ok = (stats['admitted'] == 0 or
                      (ttft_ms <= cfg.target_ttft_ms and
                       tpot_ms <= cfg.target_tpot_ms))
            # A tick only counts as HEALTHY if latencies hold AND
            # nothing was shed or bounced — shedding half the load
            # and then meeting the SLO on the survivors must not read
            # as recovered.
            healthy = (slo_ok and stats['shed'] == 0 and
                       stats['no_ready'] == 0)
            history.append({
                't': t0,
                'offered': int(stats['offered']),
                'admitted_qps': stats['admitted'] / cfg.tick_s,
                'shed': int(stats['shed']),
                'no_ready': int(stats['no_ready']),
                'ready_prefill': int(stats['ready_prefill']),
                'ready_decode': int(stats['ready_decode']),
                'live_replicas': sum(self._last_live),
                'ttft_ms': round(ttft_ms, 2),
                'tpot_ms': round(tpot_ms, 3),
                'slo_ok': slo_ok,
                'healthy': healthy,
                'backlog_tokens': round(self._backlog_tokens, 1),
            })
        return self._result(history)

    def _result(self, history: List[Dict[str, Any]]) -> FleetResult:
        from skypilot_tpu_torch import state as state_lib
        sustained = max(
            (h['admitted_qps'] for h in history if h['healthy']),
            default=0.0)
        peak = max((h['live_replicas'] for h in history), default=0)
        recovery: Optional[float] = None
        if self._storm_t is not None:
            after = [h for h in history if h['t'] >= self._storm_t]
            breach = next((h for h in after if not h['healthy']), None)
            if breach is None:
                recovery = 0.0
            else:
                ok = next((h for h in after
                           if h['t'] > breach['t'] and h['healthy']),
                          None)
                if ok is not None:
                    recovery = ok['t'] - self._storm_t
        seen = self.totals['hit_tokens'] + self.totals['miss_tokens']
        alerts: List[Dict[str, Any]] = []
        for row in self._obs.alert_history(self.cfg.service_name,
                                           limit=100):
            alerts.append({
                'rule': row['rule'],
                'pool': row['pool'],
                'state': row['state'],
                'fired_at_s': round(row['fired_at'] - _EPOCH0, 3),
                'cleared_at_s': (round(row['cleared_at'] - _EPOCH0, 3)
                                 if row['cleared_at'] is not None
                                 else None),
                'burn': row['burn'],
            })
        alerts.sort(key=lambda a: (a['fired_at_s'], a['rule']))
        return FleetResult(
            sustained_qps_at_slo=round(sustained, 1),
            peak_replicas=peak,
            pools=2 if self.spec.disaggregation is not None else 1,
            storm_fraction_pct=round(self._storm_fraction * 100.0, 1),
            recovery_s=recovery,
            admitted=self.totals['admitted'],
            shed=self.totals['shed'],
            no_ready=self.totals['no_ready'],
            retried=self.totals['retried'],
            prefix_hit_rate=(round(self.totals['hit_tokens'] / seen, 4)
                             if seen else 0.0),
            lease_frozen_s=self._lease_frozen_s,
            backend=('postgres'
                     if state_lib.is_postgres_dsn(self.dsn)
                     else 'sqlite'),
            seed=(self.cfg.seed if self.cfg.seed is not None
                  else slo_sim.FLEET_SEED),
            horizon_s=self.cfg.horizon_s,
            history=history,
            alerts=alerts,
        )


def run_fleet(config: FleetConfig) -> FleetResult:
    """Run one fleet simulation with the control-plane env wired up:
    points the serve state at the run's DSN (fresh sqlite by default,
    Postgres when config.db is a postgresql:// URL), forces lease mode
    on, pins the lease TTL, snapshots the metrics registry around the
    run, and attaches the control-plane profile to the result."""
    overrides = {
        'SKYTPU_DB_LEASES': '1',
        'SKYTPU_LEASE_TTL_S': str(config.lease_ttl_s),
    }
    tmpdir: Optional[tempfile.TemporaryDirectory] = None
    from skypilot_tpu_torch import state as state_lib
    if config.db is not None and state_lib.is_postgres_dsn(config.db):
        overrides['SKYTPU_DB_URL'] = config.db
    else:
        if config.db is not None:
            db_path = config.db
        else:
            tmpdir = tempfile.TemporaryDirectory(prefix='fleetsim-')
            db_path = os.path.join(tmpdir.name, 'fleet.db')
        overrides['SKYTPU_SERVE_DB'] = db_path
        overrides['SKYTPU_DB_URL'] = ''   # a configured pg must not win
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    before = profile_lib.snapshot()
    t_start = time.perf_counter()
    try:
        result = FleetSim(config).run()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if tmpdir is not None:
            tmpdir.cleanup()
    result.wall_s = round(time.perf_counter() - t_start, 3)
    result.profile = profile_lib.diff(before, profile_lib.snapshot())
    return result
