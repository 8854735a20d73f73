"""API-server background daemons (parity: the reference's server-side
periodic work — requests GC in sky/server/requests/requests.py
clean_finished_requests, status refresh, controller liveness; the
agent-side analog is skypilot_tpu/agent/autostop.py).

Each daemon is a named periodic function on its own thread with jittered
first run, clean stop, and per-tick error isolation (one failing tick
never kills the daemon).  Intervals are env-tunable
(SKYTPU_DAEMON_<NAME>_INTERVAL, seconds) so tests can tick fast.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, List

from skypilot_tpu_torch import sky_logging

logger = sky_logging.init_logger(__name__)


class Daemon:
    def __init__(self, name: str, interval_s: float,
                 fn: Callable[[], None]) -> None:
        self.name = name
        env = os.environ.get(
            f'SKYTPU_DAEMON_{name.upper().replace("-", "_")}_INTERVAL')
        self.interval_s = float(env) if env else interval_s
        self.fn = fn
        self._stop = threading.Event()
        self._thread: threading.Thread = threading.Thread(
            target=self._loop, name=f'skytpu-daemon-{name}', daemon=True)

    def _loop(self) -> None:
        # Jittered first tick so a fleet of restarting servers does not
        # hammer the cloud APIs in phase.
        if self._stop.wait(self.interval_s * random.uniform(0.1, 0.5)):
            return
        while True:
            try:
                self.fn()
            except Exception:  # pylint: disable=broad-except
                logger.exception(f'daemon {self.name}: tick failed')
            if self._stop.wait(self.interval_s):
                return

    def start(self) -> None:
        self._thread.start()

    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Signal and JOIN (bounded): a tick in flight must not keep
        touching databases while app cleanup tears state down."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)


# ----- the daemons -----------------------------------------------------------
def _requests_gc() -> None:
    from skypilot_tpu_torch.server import requests_db
    retention_h = float(os.environ.get(
        'SKYTPU_REQUESTS_RETENTION_HOURS', '24'))
    n = requests_db.prune(retention_h * 3600.0)
    if n:
        logger.info(f'requests-gc: pruned {n} finished requests')


def _status_refresh() -> None:
    """Reconcile cluster records against cloud truth so statuses stay
    honest even when nobody polls (detects out-of-band
    preemption/deletion; sky/backends/backend_utils.py:2222)."""
    from skypilot_tpu_torch.backends import backend_utils
    backend_utils.refresh_all(None)


def _controller_liveness() -> None:
    """Re-adopt managed jobs and services whose controller threads died
    (e.g. an unhandled error path): maybe_start_controllers restarts a
    controller for every non-terminal record not currently owned by a
    live thread."""
    from skypilot_tpu_torch.jobs import controller as jobs_controller
    from skypilot_tpu_torch.serve import controller as serve_controller
    jobs_controller.maybe_start_controllers()
    serve_controller.maybe_start_controllers()


def _k8s_metrics_scrape() -> int:
    from skypilot_tpu_torch import metrics_utils
    return metrics_utils.maybe_scrape()


def _usage_heartbeat() -> bool:
    from skypilot_tpu_torch import usage_lib
    return usage_lib.heartbeat()


def default_daemons() -> List[Daemon]:
    return [
        Daemon('requests-gc', 3600.0, _requests_gc),
        Daemon('status-refresh', 300.0, _status_refresh),
        Daemon('controller-liveness', 60.0, _controller_liveness),
        # Pod cpu/mem/TPU-chip gauges for /metrics (no-op without k8s;
        # ref scrapes GPU metrics similarly, sky/metrics/utils.py:218).
        Daemon('k8s-metrics', 60.0, _k8s_metrics_scrape),
        # Opt-in fleet-shape heartbeat (no-op unless usage.enabled;
        # ref: UsageHeartbeatReportEvent, sky/skylet/events.py:153).
        Daemon('usage-heartbeat', 600.0, _usage_heartbeat),
    ]


class DaemonSet:
    """Start/stop a set of daemons with the app lifecycle."""

    def __init__(self, daemons: List[Daemon]) -> None:
        self.daemons: Dict[str, Daemon] = {d.name: d for d in daemons}

    def start(self) -> None:
        for d in self.daemons.values():
            d.start()
        logger.info(f'daemons started: {sorted(self.daemons)}')

    def stop(self) -> None:
        for d in self.daemons.values():
            d.stop()
