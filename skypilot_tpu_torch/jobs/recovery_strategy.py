"""Recovery strategies for managed jobs (parity:
sky/jobs/recovery_strategy.py:656 FailoverStrategyExecutor, :757
EagerFailoverStrategyExecutor), tuned for TPU preemption semantics.

A spot TPU pod slice is preempted whole and cannot be restarted in place
(sky/clouds/gcp.py:219-226, :1095-1101: stale nodes need manual delete) —
so recovery is always: delete the stale slice, re-provision (the failover
engine walks zones), re-run the task.  Checkpoint/resume is the workload's
job (trainer.restore_if_available reloads the newest step from the
checkpoint dir; the managed-jobs convention is to put that dir on shared
storage).

FAILOVER        retry the original placement first (the slice may come
                right back in the same zone), then let the failover engine
                walk other zones.
EAGER_FAILOVER  blocklist the preempted zone immediately — a zone that
                just preempted us has demonstrably tight capacity.
"""
from __future__ import annotations

import enum
from typing import List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import execution
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import resources as resources_lib
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.backends import TpuVmBackend

logger = sky_logging.init_logger(__name__)


class StrategyName(enum.Enum):
    FAILOVER = 'FAILOVER'
    EAGER_FAILOVER = 'EAGER_FAILOVER'


def task_recovery_config(task: task_lib.Task,
                         default_strategy: str = 'FAILOVER',
                         default_max_restarts: int = 0):
    """(strategy_name, max_restarts_on_errors) for one task.

    Tasks carrying their own ``job_recovery`` (string or
    {strategy, max_restarts_on_errors}) override the job-level defaults —
    the reference builds one strategy executor per dag task
    (sky/jobs/controller.py:98)."""
    raw = task.any_resources.job_recovery
    if raw is None:
        return default_strategy, default_max_restarts
    if isinstance(raw, str):
        return raw.upper(), default_max_restarts
    if isinstance(raw, dict):
        return (str(raw.get('strategy', default_strategy)).upper(),
                int(raw.get('max_restarts_on_errors',
                            default_max_restarts)))
    raise exceptions.InvalidResourcesError(
        f'job_recovery must be a string or object, got {raw!r}')


class StrategyExecutor:
    """Launch/recover one managed job's task cluster."""

    def __init__(self, task: task_lib.Task, cluster_name: str,
                 strategy: StrategyName = StrategyName.FAILOVER) -> None:
        self.task = task
        self.cluster_name = cluster_name
        self.strategy = strategy
        # Zones that preempted us (EAGER_FAILOVER blocklist, accumulated
        # across recoveries like the reference's _blocked_resources).
        self._blocked: List[resources_lib.Resources] = []

    @classmethod
    def make(cls, task: task_lib.Task, cluster_name: str,
             strategy: Optional[str]) -> 'StrategyExecutor':
        name = StrategyName((strategy or 'FAILOVER').upper())
        return cls(task, cluster_name, name)

    def launch(self) -> int:
        """Provision (with failover) + run; returns the cluster job id."""
        job_id, _ = execution.launch(
            self.task, self.cluster_name, detach_run=True,
            quiet_optimizer=True, blocked_resources=self._blocked or None,
            policy_operation='jobs')
        assert job_id is not None
        return job_id

    def recover(self) -> int:
        """Delete the stale slice and relaunch; returns new cluster job id.

        Raises ResourcesUnavailableError when every placement is exhausted
        (the controller maps that to FAILED_NO_RESOURCE).
        """
        import time as time_lib

        from skypilot_tpu_torch.obs import goodput as goodput_lib
        from skypilot_tpu_torch.server import metrics as metrics_lib
        from skypilot_tpu_torch.server import tracing
        metrics_lib.inc_counter('skytpu_jobs_recovery_launches_total',
                                strategy=self.strategy.value)
        tracing.record_instant(f'cluster-{self.cluster_name}',
                               'jobs.recovery_launch',
                               strategy=self.strategy.value)
        # Cluster-rid twin of the controller's job-rid downtime span:
        # how long THIS slice's teardown + re-provision + resubmit took
        # (the controller owns the ledger write; this is trace-only, so
        # the seconds are never double-counted).
        t0 = time_lib.perf_counter()
        try:
            return self._recover_inner()
        finally:
            tracing.record_span(f'cluster-{self.cluster_name}',
                                goodput_lib.DOWNTIME_SPAN, t0,
                                time_lib.perf_counter(),
                                category=goodput_lib.RECOVERY_RELAUNCH,
                                strategy=self.strategy.value)

    def _recover_inner(self) -> int:
        record = global_user_state.get_cluster(self.cluster_name)
        if record is not None:
            if self.strategy is StrategyName.EAGER_FAILOVER:
                handle = record['handle']
                if handle.region is not None:
                    infra = f'{handle.cloud}/{handle.region}'
                    if handle.zone:
                        infra += f'/{handle.zone}'
                    entry = resources_lib.Resources.from_yaml_config(
                        {'infra': infra})
                    self._blocked.append(entry)
                    logger.info(
                        f'EAGER_FAILOVER: blocklisting {infra} for '
                        f'{self.cluster_name!r}')
            try:
                TpuVmBackend().teardown(record['handle'], terminate=True)
            except Exception as e:  # pylint: disable=broad-except
                # The slice may already be deleted by the cloud; recovery
                # proceeds, but log it — a half-dead slice left behind
                # would keep billing.
                logger.warning(
                    f'teardown of stale cluster {self.cluster_name!r} '
                    f'failed (continuing recovery): {e}')
                if global_user_state.get_cluster(
                        self.cluster_name) is not None:
                    global_user_state.remove_cluster(self.cluster_name)
        return self.launch()

    def cleanup(self) -> None:
        """Tear down the task cluster (job finished or cancelled)."""
        record = global_user_state.get_cluster(self.cluster_name)
        if record is None:
            return
        try:
            TpuVmBackend().teardown(record['handle'], terminate=True)
        except Exception as e:  # pylint: disable=broad-except
            logger.warning(
                f'cleanup of cluster {self.cluster_name!r} failed: {e}')
