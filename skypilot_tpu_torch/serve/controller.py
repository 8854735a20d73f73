"""Serve controller: one thread per service driving autoscaler decisions
into the replica manager (capability parity: sky/serve/controller.py +
sky/serve/service.py — controller loop; consolidation like managed jobs:
the controller runs inside the process that owns the serve DB, the same
argument as jobs/controller.py).

Each service gets a controller thread + an in-process load balancer; both
are re-adopted by maybe_start_controllers() after an API-server restart
(replica clusters and the serve DB survive; only the threads die).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from skypilot_tpu_torch import catalog
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.obs import alerts as obs_alerts
from skypilot_tpu_torch.obs import store as obs_store
from skypilot_tpu_torch.serve import serve_state
from skypilot_tpu_torch.serve.autoscalers import Autoscaler
from skypilot_tpu_torch.serve.load_balancer import LoadBalancer
from skypilot_tpu_torch.serve.load_balancing_policies import LoadBalancingPolicy
from skypilot_tpu_torch.serve.replica_managers import ReplicaManager
from skypilot_tpu_torch.serve.serve_state import ReplicaStatus, ServiceStatus
from skypilot_tpu_torch.serve.service_spec import ServiceSpec
from skypilot_tpu_torch.serve.spot_placer import SpotPlacer

logger = sky_logging.init_logger(__name__)


def _tick_interval() -> float:
    return float(os.environ.get('SKYTPU_SERVE_TICK_INTERVAL', '10'))


def _qps_window() -> float:
    return float(os.environ.get('SKYTPU_SERVE_QPS_WINDOW', '60'))


class ServiceController:
    """Drives one service: LB + probe/reconcile + autoscale until DOWN."""

    def __init__(self, service_name: str) -> None:
        rec = serve_state.get_service(service_name)
        assert rec is not None, service_name
        self.service_name = service_name
        self.spec = ServiceSpec.from_yaml_config(rec['spec'])
        self.task = task_lib.Task.from_yaml_config(rec['task_config'])
        self.version = rec['version']
        placer: Optional[SpotPlacer] = None
        if self.task.any_resources.use_spot:
            try:
                zones = catalog.get_zones(self.task.any_resources)
            except Exception:  # pylint: disable=broad-except
                zones = []
            placer = SpotPlacer(zones)
        self.manager = ReplicaManager(service_name, self.spec, self.task,
                                      spot_placer=placer,
                                      version=self.version)
        self.lb = LoadBalancer(
            service_name, rec['lb_port'],
            LoadBalancingPolicy.make(self.spec.load_balancing_policy),
            self.manager.ready_urls,
            ready_replicas_fn=self.manager.ready_replicas,
            max_queue_tokens_per_replica=(
                self.spec.max_queue_tokens_per_replica))
        self.autoscaler = Autoscaler.make(self.spec, _tick_interval(),
                                          _qps_window())
        # Telemetry plane (lazy: built on the first tick so a
        # SKYTPU_OBS_RESOLUTION_S=0 opt-out costs nothing).
        self._obs_store: Optional[obs_store.TelemetryStore] = None
        self._obs_engine: Optional[obs_alerts.AlertEngine] = None

    def run(self) -> None:
        try:
            self.lb.start()
        except Exception as e:  # pylint: disable=broad-except
            logger.exception(f'Service {self.service_name!r}: load '
                             f'balancer failed to start')
            serve_state.set_service_status(self.service_name,
                                           ServiceStatus.FAILED, repr(e))
            return
        try:
            self._run_inner()
        except Exception as e:  # pylint: disable=broad-except
            logger.exception(f'Service {self.service_name!r}: controller '
                             f'crashed')
            serve_state.set_service_status(self.service_name,
                                           ServiceStatus.FAILED, repr(e))
        finally:
            self.lb.stop()

    def _run_inner(self) -> None:
        while True:
            if _shutdown.is_set():
                # Cooperative stop (drain/tests): no status writes —
                # the service is re-adopted by maybe_start_controllers
                # on the next server start.
                logger.info(f'Service {self.service_name!r}: controller '
                            f'stopped (shutdown); left for re-adoption')
                return
            rec = serve_state.get_service(self.service_name)
            if rec is None or rec['status'] is ServiceStatus.SHUTTING_DOWN:
                logger.info(f'Service {self.service_name!r}: shutting '
                            f'down, terminating replicas.')
                self.manager.terminate_all()
                serve_state.set_service_status(self.service_name,
                                               ServiceStatus.SHUTDOWN)
                return
            if rec['version'] != self.version:
                # `serve update`: adopt the new spec/task; rollout_step
                # below drains old-version replicas as new ones ready.
                # EVERY spec-derived object is rebuilt — autoscaler, LB
                # policy, spot placer — or a changed
                # load_balancing_policy / use_spot would silently keep
                # v(old) behavior until a server restart.
                logger.info(f'Service {self.service_name!r}: updating '
                            f'v{self.version} -> v{rec["version"]}.')
                self.version = rec['version']
                self.spec = ServiceSpec.from_yaml_config(rec['spec'])
                self.task = task_lib.Task.from_yaml_config(
                    rec['task_config'])
                placer = None
                if self.task.any_resources.use_spot:
                    try:
                        zones = catalog.get_zones(self.task.any_resources)
                    except Exception:  # pylint: disable=broad-except
                        zones = []
                    placer = SpotPlacer(zones)
                self.manager.spot_placer = placer
                self.manager.set_template(self.spec, self.task,
                                          self.version)
                self.lb.policy = LoadBalancingPolicy.make(
                    self.spec.load_balancing_policy)
                self.lb.max_queue_tokens_per_replica = \
                    self.spec.max_queue_tokens_per_replica
                new_autoscaler = Autoscaler.make(
                    self.spec, _tick_interval(), _qps_window())
                # Keep the QPS sample history: an empty window would
                # read 0 QPS and spuriously downscale after the update.
                new_autoscaler.adopt_history(self.autoscaler)
                self.autoscaler = new_autoscaler
            now = time.time()
            self.manager.probe_and_reconcile(now)
            if self.manager.rollout_step():
                # Mid-rollout: the surge/drain logic owns replica
                # counts; autoscaling resumes when no old replicas
                # remain.
                self._update_service_status()
                _shutdown.wait(_tick_interval())
                continue
            # QPS from the LB's monotonic request counter — the same
            # series /metrics exports, not a parallel timestamp trace.
            # SLO policies additionally get the LB's FEDERATED /metrics
            # text (engine TTFT/TPOT histograms + backlog gauges of
            # every ready replica): one scrape, the same bytes the
            # dashboards read.
            exposition = (self._scrape_lb_metrics()
                          if self.autoscaler.wants_lb_scrape else None)
            self._obs_tick(exposition, now)
            if self.autoscaler.is_pool_autoscaler:
                # Disaggregated pools: one scrape, two independent
                # decisions — TTFT sizes prefill, TPOT sizes decode.
                pools = self.autoscaler.evaluate_pools(
                    exposition, self.lb.proxied_requests(),
                    self.manager.num_live('prefill'),
                    self.manager.num_live('decode'), now)
                for role, d in (('prefill', pools.prefill),
                                ('decode', pools.decode)):
                    if d.delta > 0:
                        logger.info(
                            f'Service {self.service_name!r}: scaling '
                            f'{role} pool up by {d.delta} to '
                            f'{d.target_num_replicas}{self._slo_note()}.')
                        self.manager.scale_up(d.delta, role=role)
                    elif d.delta < 0:
                        logger.info(
                            f'Service {self.service_name!r}: scaling '
                            f'{role} pool down by {-d.delta} to '
                            f'{d.target_num_replicas}{self._slo_note()}.')
                        self.manager.scale_down(-d.delta, role=role)
                self._update_service_status()
                _shutdown.wait(_tick_interval())
                continue
            decision = self.autoscaler.evaluate_scrape(
                exposition, self.lb.proxied_requests(),
                self.manager.num_live(), now)
            if decision.delta > 0:
                logger.info(f'Service {self.service_name!r}: scaling up '
                            f'by {decision.delta} to '
                            f'{decision.target_num_replicas}'
                            f'{self._slo_note()}.')
                self.manager.scale_up(decision.delta)
            elif decision.delta < 0:
                logger.info(f'Service {self.service_name!r}: scaling '
                            f'down by {-decision.delta} to '
                            f'{decision.target_num_replicas}'
                            f'{self._slo_note()}.')
                self.manager.scale_down(-decision.delta)
            self._update_service_status()
            _shutdown.wait(_tick_interval())

    def _scrape_lb_metrics(self) -> Optional[str]:
        """One federated scrape of this service's own LB; None when the
        scrape fails (the autoscaler then falls back to QPS)."""
        import requests as requests_lib
        from skypilot_tpu_torch.serve.load_balancer import (
            _FEDERATE_TIMEOUT_SECONDS)
        try:
            # Strictly ABOVE the LB's per-replica federation budget: the
            # federated /metrics answers only after its slowest replica
            # scrape resolves, so a smaller timeout here would miss the
            # healthy replicas' data whenever ONE replica hangs — i.e.
            # disable SLO scaling exactly during partial failure.  Still
            # bounded, so a hung LB cannot stall the decision loop; a
            # failed scrape just means QPS fallback this tick.
            resp = requests_lib.get(
                f'{self.lb.endpoint}/metrics',
                timeout=_FEDERATE_TIMEOUT_SECONDS + 1.0)
            if resp.status_code == 200:
                return resp.text
        except requests_lib.RequestException as e:
            logger.debug(f'Service {self.service_name!r}: LB metrics '
                         f'scrape failed: {e}')
        return None

    def _obs_tick(self, exposition: Optional[str], now: float) -> None:
        """Feed this tick's federated scrape into the telemetry store
        and run the SLO alert rules.  Reuses the autoscaler's scrape
        when one happened; QPS-policy services get their own (the
        telemetry plane sees every service, not just SLO-scaled ones).
        Telemetry must never break the decision loop, and in HA control
        planes only the obs-ingest singleton-lease holder writes (the
        store enforces that)."""
        try:
            if self._obs_store is None:
                if obs_store.resolution_s() <= 0:
                    return  # opted out; re-checked next tick (cheap)
                self._obs_store = obs_store.TelemetryStore(
                    serve_state._db_path())  # pylint: disable=protected-access
                self._obs_engine = obs_alerts.AlertEngine(
                    self._obs_store, self.service_name,
                    obs_alerts.default_rules(
                        self.spec.target_ttft_ms or 1000.0,
                        self.spec.target_tpot_ms or 100.0))
            if exposition is None:
                exposition = self._scrape_lb_metrics()
            if exposition is None:
                return
            roles = {str(rid): role or ''
                     for rid, _, role in self.manager.ready_replicas()}
            if self._obs_store.ingest(self.service_name, exposition,
                                      now=now, roles=roles):
                self._obs_engine.evaluate(now)
        except Exception:  # pylint: disable=broad-except
            logger.exception(f'Service {self.service_name!r}: telemetry '
                             f'ingest failed (decision loop continues)')

    def _slo_note(self) -> str:
        ttft = getattr(self.autoscaler, 'last_p95_ttft_ms', None)
        tpot = getattr(self.autoscaler, 'last_p95_tpot_ms', None)
        if ttft is None and tpot is None:
            return ''
        fmt = lambda v: f'{v:.1f}ms' if v is not None else 'n/a'
        return (f' (p95 TTFT {fmt(ttft)} / TPOT {fmt(tpot)} over the '
                f'window)')

    def _update_service_status(self) -> None:
        rec = serve_state.get_service(self.service_name)
        if rec is None or rec['status'] in (ServiceStatus.SHUTTING_DOWN,
                                            ServiceStatus.SHUTDOWN,
                                            ServiceStatus.FAILED):
            return
        replicas = serve_state.get_replicas(self.service_name)
        any_ready = any(r['status'] is ReplicaStatus.READY
                        for r in replicas)
        if any_ready:
            new = ServiceStatus.READY
        elif rec['status'] is ServiceStatus.STARTING:
            new = ServiceStatus.STARTING  # still bringing up the first one
        else:
            new = ServiceStatus.NO_REPLICA
        if new is not rec['status']:
            serve_state.set_service_status(self.service_name, new)


# ----- controller manager -----------------------------------------------------

_manager_lock = threading.Lock()
_controllers: Dict[str, threading.Thread] = {}
_shutdown = threading.Event()


def live_controllers() -> list:
    """Service names with a live controller thread IN THIS PROCESS
    (dedicated mode keeps this empty in the API server — the daemon on
    the serve controller cluster owns them)."""
    with _manager_lock:
        return [name for name, th in _controllers.items()
                if th.is_alive()]


def stop_all_controllers(timeout_s: float = 15.0) -> None:
    """Cooperatively stop every service controller without status
    writes (services stay re-adoptable); mirrors
    jobs.controller.stop_all_controllers."""
    with _manager_lock:
        threads = [th for th in _controllers.values() if th.is_alive()]
    if not threads:
        with _manager_lock:
            _controllers.clear()
        return
    _shutdown.set()
    try:
        deadline = time.time() + timeout_s
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.time()))
    finally:
        _shutdown.clear()
    with _manager_lock:
        # Keep stragglers registered (see jobs.controller: forgetting a
        # still-alive thread lets maybe_start_controllers duplicate it).
        stragglers = {name: th for name, th in _controllers.items()
                      if th.is_alive()}
        _controllers.clear()
        _controllers.update(stragglers)
    for name in stragglers:
        logger.warning(f'serve controller {name!r} did not stop within '
                       f'{timeout_s}s; left registered')


def maybe_start_controllers() -> None:
    """Start controller threads for live services (startup re-adoption +
    serve-up hook), mirroring jobs.controller.maybe_start_controllers."""
    if _shutdown.is_set():
        return            # draining: do not resurrect controllers
    with _manager_lock:
        for rec in serve_state.list_services():
            name = rec['name']
            if rec['status'].is_terminal():
                continue
            th = _controllers.get(name)
            if th is not None and th.is_alive():
                continue
            th = threading.Thread(target=ServiceController(name).run,
                                  name=f'serve-controller-{name}',
                                  daemon=True)
            _controllers[name] = th
            th.start()


def controller_alive(service_name: str) -> bool:
    with _manager_lock:
        th = _controllers.get(service_name)
        return th is not None and th.is_alive()


def wait_service_status(service_name: str, statuses,
                        timeout_s: float = 120.0) -> ServiceStatus:
    """Block until the service reaches one of `statuses` (test helper)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        rec = serve_state.get_service(service_name)
        if rec is not None and rec['status'] in statuses:
            return rec['status']
        time.sleep(0.2)
    rec = serve_state.get_service(service_name)
    raise TimeoutError(
        f'service {service_name!r} never reached {statuses}; at '
        f'{rec["status"] if rec else None}')
