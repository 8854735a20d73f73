"""Managed-jobs controller (parity: sky/jobs/controller.py:98 JobController,
:962 ControllerManager; scheduler caps sky/jobs/scheduler.py:194).

One controller thread per managed job, running "consolidated" inside the
process that owns the jobs DB (the API server, or the caller for
library-direct use) — the reference's consolidation mode
(sky/jobs/server/core.py:314).  A dedicated controller VM is unnecessary
for TPU fleets: the controller does no compute, only polling and REST
calls, and threads survive as long as the API server, whose requests DB
already makes restarts resumable (maybe_start_controllers re-adopts
non-terminal jobs on startup).

Controller loop per job:
  launch (failover engine walks zones) -> poll cluster job status ->
  - SUCCEEDED            -> teardown cluster, job SUCCEEDED
  - user-code failure    -> cluster still healthy? restart up to
                            max_restarts_on_errors, else FAILED
  - agent unreachable /
    cluster preempted    -> RECOVERING: delete stale slice, re-provision
                            (possibly new zone), resubmit, RUNNING
Preemption is detected exactly like the reference: reconcile the state DB
against cloud truth (backend_utils.refresh_cluster_status ->
provision.query_instances), sky/backends/backend_utils.py:2222.
"""
from __future__ import annotations

import enum
import os
import threading
import time
from typing import Dict, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.agent.job_queue import JobStatus as ClusterJobStatus
from skypilot_tpu_torch.backends import TpuVmBackend
from skypilot_tpu_torch.backends import backend_utils
from skypilot_tpu_torch.global_user_state import ClusterStatus
from skypilot_tpu_torch.jobs import recovery_strategy as recovery_lib
from skypilot_tpu_torch.jobs import state
from skypilot_tpu_torch.jobs.recovery_strategy import StrategyExecutor
from skypilot_tpu_torch.jobs.state import ManagedJobStatus
from skypilot_tpu_torch.obs import goodput as goodput_lib
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

logger = sky_logging.init_logger(__name__)


class _TaskOutcome(enum.Enum):
    """How one pipeline task ended."""
    SUCCEEDED = 'SUCCEEDED'
    CANCELLED = 'CANCELLED'
    FAILED = 'FAILED'


def _poll_interval() -> float:
    return float(os.environ.get('SKYTPU_JOBS_POLL_INTERVAL', '10'))


# Consecutive agent "no such job" polls on an UP cluster before the
# controller declares the job lost and resubmits it.
_LOST_JOB_POLLS = int(os.environ.get('SKYTPU_JOBS_LOST_JOB_POLLS', '6'))


def cluster_name_for_job(job_id: int, name: Optional[str],
                         task_index: int = 0, num_tasks: int = 1) -> str:
    base = (name or 'task').lower().replace('_', '-')[:20].strip('-')
    if num_tasks > 1:
        return f'jobs-{job_id}-t{task_index}-{base}'
    return f'jobs-{job_id}-{base}'


class JobController:
    """Drives one managed job to a terminal state."""

    def __init__(self, job_id: int) -> None:
        self.job_id = job_id
        self.backend = TpuVmBackend()

    # ----- polling helpers ---------------------------------------------------
    def _cluster_job_status(self, cluster_name: str,
                            cluster_job_id: int):
        """Status of the job on its cluster.

        Returns a ClusterJobStatus, or one of two distinct non-answers:
        UNREACHABLE (cluster record gone / agent did not answer —
        candidate preemption, treated as transient while the cloud says
        UP) or JOB_UNKNOWN (the agent answered but has no record of this
        job id — its queue was lost, e.g. agent restarted; the job must
        be resubmitted)."""
        record = global_user_state.get_cluster(cluster_name)
        if record is None:
            return self.UNREACHABLE
        client = self.backend._agent_client(record['handle'])  # pylint: disable=protected-access
        try:
            job = client.get_job(cluster_job_id)
        except Exception:  # pylint: disable=broad-except
            return self.UNREACHABLE
        finally:
            client.close()
        if job is None:
            return self.JOB_UNKNOWN
        return ClusterJobStatus(job['status'])

    UNREACHABLE = object()
    JOB_UNKNOWN = object()

    def _cancel_requested(self) -> bool:
        rec = state.get(self.job_id)
        return rec is not None and \
            rec['status'] is ManagedJobStatus.CANCELLING

    def _snapshot_logs(self, cluster_name: str,
                       cluster_job_id: Optional[int]) -> None:
        """Persist the run log before the task cluster is torn down, so
        `jobs logs` works after the job finishes (reference downloads
        controller-side, sky/jobs/controller.py:201)."""
        if cluster_job_id is None:
            return
        record = global_user_state.get_cluster(cluster_name)
        if record is None:
            return
        client = self.backend._agent_client(record['handle'])  # pylint: disable=protected-access
        try:
            data = client.read_logs(cluster_job_id)
        except Exception:  # pylint: disable=broad-except
            return
        finally:
            client.close()
        path = state.log_path(self.job_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'ab') as f:
            f.write(data)

    # ----- terminal paths ----------------------------------------------------
    def _finish_cancel(self, strategy: StrategyExecutor,
                       cluster_job_id: Optional[int]) -> None:
        record = global_user_state.get_cluster(strategy.cluster_name)
        if record is not None and cluster_job_id is not None:
            try:
                self.backend.cancel_job(record['handle'], cluster_job_id)
            except Exception:  # pylint: disable=broad-except
                pass
        self._snapshot_logs(strategy.cluster_name, cluster_job_id)
        strategy.cleanup()
        state.set_status(self.job_id, ManagedJobStatus.CANCELLED)
        logger.info(f'Managed job {self.job_id} cancelled.')

    # ----- main loop ---------------------------------------------------------
    def run(self) -> None:
        """Drive every task of the job's (chain) dag to completion.

        The reference controller iterates dag tasks sequentially with one
        strategy executor per task (sky/jobs/controller.py:98); here the
        per-task progress (``task_index``) persists in the jobs DB so an
        API-server restart re-adopts a pipeline at the task it was on,
        not at the beginning.
        """
        rec = state.get(self.job_id)
        if rec is None or rec['status'].is_terminal():
            return
        # Act as the submitting user in the submitting workspace for the
        # whole job lifetime, so recovery clusters launched from this
        # (server-ambient) controller thread are stamped correctly.
        from skypilot_tpu_torch import users as users_lib
        from skypilot_tpu_torch import workspaces as workspaces_lib
        try:
            with users_lib.override(rec.get('user_name')), \
                    workspaces_lib.override(rec.get('workspace')):
                self._run_all_tasks(rec)
        except _ControllerStopped:
            logger.info(f'Managed job {self.job_id}: controller stopped '
                        f'(shutdown); job left for re-adoption')

    def _run_all_tasks(self, rec: dict) -> None:
        configs = rec['task_configs']
        strategy: Optional[StrategyExecutor] = None
        try:
            for idx in range(rec['task_index'], len(configs)):
                _check_shutdown()
                rec = state.get(self.job_id)
                task = task_lib.Task.from_yaml_config(configs[idx])
                cluster_name = rec['cluster_name'] or cluster_name_for_job(
                    self.job_id, task.name or rec['name'], idx,
                    len(configs))
                strat_name, max_restarts = recovery_lib.task_recovery_config(
                    task, rec['recovery_strategy'],
                    int(rec['max_restarts_on_errors'] or 0))
                strategy = StrategyExecutor.make(task, cluster_name,
                                                 strat_name)
                outcome = self._run_task(rec, strategy, max_restarts)
                if outcome is not _TaskOutcome.SUCCEEDED:
                    return      # terminal status already recorded
                if idx + 1 < len(configs):
                    logger.info(f'Managed job {self.job_id}: task '
                                f'{idx + 1}/{len(configs)} done, '
                                f'advancing.')
                    state.advance_task(self.job_id, idx + 1)
                else:
                    state.set_status(self.job_id,
                                     ManagedJobStatus.SUCCEEDED)
                    logger.info(f'Managed job {self.job_id} SUCCEEDED.')
        except exceptions.ClusterSetupError as e:
            # Setup failure is deterministic (bad image, bad deps):
            # restarting re-runs the same broken setup, so it is
            # immediately terminal and never counts against
            # max_restarts_on_errors (reference:
            # recovery_strategy.should_restart_on_failure).
            logger.warning(f'Managed job {self.job_id}: setup failed: {e}')
            state.set_status(self.job_id,
                             ManagedJobStatus.FAILED_SETUP, str(e))
            if strategy is not None:
                strategy.cleanup()
        except exceptions.ResourcesUnavailableError as e:
            logger.warning(f'Managed job {self.job_id}: placements '
                           f'exhausted: {e}')
            state.set_status(self.job_id,
                             ManagedJobStatus.FAILED_NO_RESOURCE, str(e))
            if strategy is not None:
                strategy.cleanup()
        except Exception as e:  # pylint: disable=broad-except
            logger.exception(f'Managed job {self.job_id}: controller '
                             f'crashed')
            state.set_status(self.job_id,
                             ManagedJobStatus.FAILED_CONTROLLER, repr(e))
            if strategy is not None:
                strategy.cleanup()
        finally:
            maybe_start_controllers()

    def _record_downtime(self, job_id: int, up_p: float, rec_p: float,
                         end_p: float) -> float:
        """Write one recovery's goodput intervals — durable ledger rows
        plus their flight-recorder twins: ``preemption_downtime`` spans
        last-healthy-poll -> recovery dispatch (the true loss instant
        is inside it, within one poll interval), ``recovery_relaunch``
        spans dispatch -> RUNNING again.  Lost-job/user-failure
        resubmits pass ``up_p == rec_p`` (the cluster never went down)
        and record only the relaunch.  Returns the new healthy-poll
        anchor."""
        ledger = goodput_lib.GoodputLedger()
        rid = f'job-{job_id}'
        for cat, p0, p1 in (
                (goodput_lib.PREEMPTION_DOWNTIME, up_p, rec_p),
                (goodput_lib.RECOVERY_RELAUNCH, rec_p, end_p)):
            if p1 <= p0:
                continue
            tracing.record_span(rid, goodput_lib.DOWNTIME_SPAN, p0, p1,
                                category=cat)
            ledger.add(str(job_id), cat, p1 - p0,
                       t0=tracing.wall_of(p0), t1=tracing.wall_of(p1))
        return end_p

    def _run_task(self, rec: dict, strategy: StrategyExecutor,
                  max_restarts: int) -> '_TaskOutcome':
        job_id = self.job_id
        cluster_name = strategy.cluster_name
        cluster_job_id = rec['cluster_job_id']

        if self._cancel_requested():
            self._finish_cancel(strategy, cluster_job_id)
            return _TaskOutcome.CANCELLED
        if cluster_job_id is None:
            state.set_status(job_id, ManagedJobStatus.STARTING)
            state.set_cluster(job_id, cluster_name, None)
            cluster_job_id = strategy.launch()
            state.set_cluster(job_id, cluster_name, cluster_job_id)
        state.set_status(job_id, ManagedJobStatus.RUNNING)

        # An UP cluster whose agent answers but has no record of this job
        # id (agent restarted and lost its queue) would otherwise poll
        # forever; after _LOST_JOB_POLLS consecutive such answers we treat
        # the job as lost and resubmit.  Mere unreachability does NOT
        # count — the original job may still be running, and resubmitting
        # over it would run two copies concurrently.
        unknown_streak = 0
        # Goodput ledger anchor: the last poll that confirmed the
        # cluster healthy.  A preemption's downtime interval starts
        # here — the true loss instant is unobservable, but it lies
        # within one poll interval of this stamp.
        last_up_p = time.perf_counter()
        while True:
            _check_shutdown()
            if self._cancel_requested():
                self._finish_cancel(strategy, cluster_job_id)
                return _TaskOutcome.CANCELLED
            status = self._cluster_job_status(cluster_name, cluster_job_id)
            if status is ClusterJobStatus.SUCCEEDED:
                # Snapshot before the cluster goes away: jobs-logs
                # readers switch to the snapshot once the job record says
                # terminal (or the cluster record is gone).
                self._snapshot_logs(cluster_name, cluster_job_id)
                strategy.cleanup()
                return _TaskOutcome.SUCCEEDED
            if status is ClusterJobStatus.CANCELLED:
                # Cancelled out-of-band on the cluster itself.
                self._snapshot_logs(cluster_name, cluster_job_id)
                state.set_status(job_id, ManagedJobStatus.CANCELLED,
                                 'cluster job cancelled externally')
                strategy.cleanup()
                return _TaskOutcome.CANCELLED
            # Non-success: reconcile against cloud truth BEFORE judging.
            # A gang failure can be the *symptom* of preemption (a dead
            # host kills every rank), and a slice can be preempted while
            # the job still looks RUNNING (partial preemption wedges ICI
            # collectives; the head agent stays responsive).  Reference:
            # recovery_strategy.should_restart_on_failure semantics +
            # backend_utils._update_cluster_status:2222.
            cl_status = backend_utils.refresh_cluster_status(cluster_name)
            if cl_status is ClusterStatus.UP and \
                    status is self.JOB_UNKNOWN:
                unknown_streak += 1
                if unknown_streak >= _LOST_JOB_POLLS:
                    n = state.bump_recovery_count(job_id)
                    metrics_lib.inc_counter('skytpu_jobs_recoveries_total',
                                            reason='lost_job')
                    tracing.record_instant(f'job-{job_id}',
                                           'jobs.recovery',
                                           reason='lost_job', attempt=n,
                                           cluster=cluster_name)
                    logger.warning(
                        f'Managed job {job_id}: cluster {cluster_name!r} '
                        f'is UP but its agent has no record of job '
                        f'{cluster_job_id} after {unknown_streak} polls; '
                        f'resubmitting (recovery #{n}).')
                    unknown_streak = 0
                    state.set_status(job_id, ManagedJobStatus.RECOVERING)
                    rec_p = time.perf_counter()
                    cluster_job_id = strategy.launch()
                    state.set_cluster(job_id, cluster_name, cluster_job_id)
                    state.set_status(job_id, ManagedJobStatus.RUNNING)
                    last_up_p = self._record_downtime(
                        job_id, rec_p, rec_p, time.perf_counter())
                    continue
            else:
                unknown_streak = 0
            if cl_status is not ClusterStatus.UP:
                n = state.bump_recovery_count(job_id)
                metrics_lib.inc_counter('skytpu_jobs_preemptions_total')
                metrics_lib.inc_counter('skytpu_jobs_recoveries_total',
                                        reason='preemption')
                # Flight-recorder postmortem trail: the controller's
                # /debug dump explains a crashed job even after its
                # cluster is gone.
                tracing.record_instant(f'job-{job_id}',
                                       'jobs.preemption',
                                       cluster=cluster_name,
                                       cluster_status=str(cl_status))
                tracing.record_instant(f'job-{job_id}', 'jobs.recovery',
                                       reason='preemption', attempt=n,
                                       cluster=cluster_name)
                logger.warning(
                    f'Managed job {job_id}: cluster {cluster_name!r} '
                    f'lost (status={cl_status}); recovery #{n}.')
                state.set_status(job_id, ManagedJobStatus.RECOVERING)
                if self._cancel_requested():
                    self._finish_cancel(strategy, None)
                    return _TaskOutcome.CANCELLED
                rec_p = time.perf_counter()
                cluster_job_id = strategy.recover()
                state.set_cluster(job_id, cluster_name, cluster_job_id)
                state.set_status(job_id, ManagedJobStatus.RUNNING)
                last_up_p = self._record_downtime(
                    job_id, last_up_p, rec_p, time.perf_counter())
                unknown_streak = 0
                continue
            if status is ClusterJobStatus.FAILED_SETUP:
                # Setup failure is deterministic (bad image, bad deps):
                # restarting re-runs the same broken setup, so it is
                # immediately terminal and does NOT count against
                # max_restarts_on_errors (reference:
                # recovery_strategy.should_restart_on_failure treats
                # FAILED_SETUP as non-restartable).
                self._snapshot_logs(cluster_name, cluster_job_id)
                state.set_status(
                    job_id, ManagedJobStatus.FAILED_SETUP,
                    f'cluster job {cluster_job_id} failed in setup')
                strategy.cleanup()
                return _TaskOutcome.FAILED
            if status is ClusterJobStatus.FAILED:
                # Genuine user-code failure on a healthy cluster: counts
                # against max_restarts_on_errors.
                n = state.bump_restarts_on_errors(job_id)
                if n > max_restarts:
                    self._snapshot_logs(cluster_name, cluster_job_id)
                    state.set_status(
                        job_id, ManagedJobStatus.FAILED,
                        f'cluster job {cluster_job_id} '
                        f'{status.value} (restarted {n - 1}x)')
                    strategy.cleanup()
                    return _TaskOutcome.FAILED
                metrics_lib.inc_counter('skytpu_jobs_recoveries_total',
                                        reason='user_failure')
                tracing.record_instant(f'job-{job_id}', 'jobs.recovery',
                                       reason='user_failure', attempt=n,
                                       cluster=cluster_name)
                logger.info(
                    f'Managed job {job_id}: user-code failure, '
                    f'restart {n}/{max_restarts}.')
                state.set_status(job_id, ManagedJobStatus.RECOVERING)
                rec_p = time.perf_counter()
                cluster_job_id = strategy.launch()  # cluster is UP;
                # launch reuses it and just resubmits the job.
                state.set_cluster(job_id, cluster_name, cluster_job_id)
                state.set_status(job_id, ManagedJobStatus.RUNNING)
                last_up_p = self._record_downtime(
                    job_id, rec_p, rec_p, time.perf_counter())
                unknown_streak = 0
                continue
            # RUNNING / PENDING / SETTING_UP on a healthy cluster (or a
            # transient agent hiccup): poll again (shutdown-interruptible).
            last_up_p = time.perf_counter()
            _shutdown.wait(_poll_interval())


# ----- controller manager (scheduler) ----------------------------------------

_manager_lock = threading.Lock()
_controllers: Dict[int, threading.Thread] = {}
_shutdown = threading.Event()


class _ControllerStopped(BaseException):
    """Raised inside a controller by the shutdown check.  BaseException
    on purpose: it must escape _run_all_tasks' status-writing handlers —
    a stopped controller leaves its job exactly as-is for re-adoption
    (maybe_start_controllers on the next server start)."""


def _check_shutdown() -> None:
    if _shutdown.is_set():
        raise _ControllerStopped()


def stop_all_controllers(timeout_s: float = 15.0) -> None:
    """Cooperatively stop every controller thread WITHOUT any job-status
    writes.  Server drain uses this; so do test teardowns — a controller
    outliving its environment keeps polling and mutates whatever jobs DB
    the new environment resolves to."""
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
        # Keep stragglers registered: a thread that outlived the join
        # (blocked in a long provision call) resumes once _shutdown
        # clears, and forgetting it would let maybe_start_controllers
        # spawn a DUPLICATE controller for the same job.
        stragglers = {jid: th for jid, th in _controllers.items()
                      if th.is_alive()}
        _controllers.clear()
        _controllers.update(stragglers)
    for jid in stragglers:
        logger.warning(f'jobs controller {jid} did not stop within '
                       f'{timeout_s}s; left registered')


def _max_parallel() -> int:
    return int(os.environ.get('SKYTPU_JOBS_MAX_PARALLEL', '16'))


def live_controllers() -> list:
    """Job ids with a live controller thread IN THIS PROCESS (dedicated
    mode keeps this empty in the API server — the daemon owns them)."""
    with _manager_lock:
        return [jid for jid, th in _controllers.items() if th.is_alive()]


def maybe_start_controllers() -> None:
    """Start controller threads for non-terminal jobs, newest-submitted
    last, up to the parallelism cap (parity:
    sky/jobs/scheduler.py:194 maybe_start_controllers)."""
    if _shutdown.is_set():
        return            # draining: do not resurrect controllers
    with _manager_lock:
        alive = {jid for jid, th in _controllers.items() if th.is_alive()}
        capacity = _max_parallel() - len(alive)
        if capacity <= 0:
            return
        for rec in state.nonterminal_jobs():
            if capacity <= 0:
                break
            jid = rec['job_id']
            if jid in alive:
                continue
            th = threading.Thread(
                target=JobController(jid).run,
                name=f'jobs-controller-{jid}', daemon=True)
            _controllers[jid] = th
            th.start()
            capacity -= 1


def controller_alive(job_id: int) -> bool:
    with _manager_lock:
        th = _controllers.get(job_id)
        return th is not None and th.is_alive()


def wait_job(job_id: int, timeout_s: float = 600.0) -> ManagedJobStatus:
    """Block until the job reaches a terminal state (SDK/test helper)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        rec = state.get(job_id)
        if rec is None:
            raise exceptions.JobNotFoundError(f'managed job {job_id}')
        if rec['status'].is_terminal():
            return rec['status']
        time.sleep(0.2)
    raise exceptions.ManagedJobStatusError(
        f'managed job {job_id} not terminal after {timeout_s}s '
        f'(status={state.get(job_id)["status"]})')  # type: ignore[index]
