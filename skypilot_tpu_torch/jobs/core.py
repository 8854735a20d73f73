"""Managed-jobs user API (parity: sky/jobs/server/core.py launch :244,
queue, cancel; logs via the task cluster's agent).

Two controller placements (parity: the reference's default launches
controllers on their own clusters, sky/jobs/server/core.py:494,:527;
consolidation mode keeps them in the API server):
- consolidation (default): controller threads live in this process;
- dedicated ("vm", config `jobs.controller.mode: vm`): a controller
  cluster is launched through the normal stack and every verb ships to
  it as a short agent job (jobs/remote_exec.py) against the
  controller-local state DB; a persistent daemon there
  (jobs/controller_daemon.py) keeps recovering jobs even when the API
  server dies.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.jobs import controller as controller_lib
from skypilot_tpu_torch.jobs import state
from skypilot_tpu_torch.jobs.recovery_strategy import (StrategyName,
                                                 task_recovery_config)

from skypilot_tpu_torch.controller_vm import (  # noqa: E402  (shared machinery)
    JOBS_CONTROLLER_CLUSTER)


def _controller_mode() -> str:
    from skypilot_tpu_torch import controller_vm
    return controller_vm.mode('jobs')


def _ensure_controller_cluster() -> None:
    from skypilot_tpu_torch import controller_vm
    controller_vm.ensure_cluster(JOBS_CONTROLLER_CLUSTER, 'jobs')


def _remote_call(args: List[str]) -> Dict[str, Any]:
    from skypilot_tpu_torch import controller_vm
    return controller_vm.remote_call(JOBS_CONTROLLER_CLUSTER, args)


def _recovery_config(task: task_lib.Task) -> Dict[str, Any]:
    """Parse `job_recovery` off the task's resources (single source of
    truth: recovery_strategy.task_recovery_config)."""
    strategy, max_restarts = task_recovery_config(
        task, StrategyName.FAILOVER.value, 0)
    return {'strategy': strategy, 'max_restarts_on_errors': max_restarts}


def launch(task_or_dag, name: Optional[str] = None) -> int:
    """Submit a managed (auto-recovering) job; returns the managed job id.

    Accepts a single Task or a chain Dag (a pipeline: the controller runs
    the tasks sequentially, each on its own ephemeral cluster, with
    per-task recovery — parity: sky/jobs/controller.py:98 iterating dag
    tasks).  On preemption the controller deletes the stale slice,
    re-provisions (failing over zones as needed) and re-runs the current
    task, which resumes from its latest checkpoint.
    """
    from skypilot_tpu_torch import dag as dag_lib
    if isinstance(task_or_dag, dag_lib.Dag):
        dag = task_or_dag
        dag.validate()
        if len(dag) > 1 and not dag.is_chain():
            raise exceptions.InvalidDagError(
                'managed jobs support single tasks or linear pipelines; '
                'general DAGs are not supported (same as the reference, '
                'sky/jobs/server/core.py)')
        tasks = dag.topological_order() if len(dag) > 1 else dag.tasks
        job_name = name or dag.name or (tasks[0].name if tasks else None)
    else:
        tasks = [task_or_dag]
        job_name = name or task_or_dag.name
    if not tasks:
        raise exceptions.InvalidDagError('managed job needs >= 1 task')
    if _controller_mode() == 'vm':
        for t in tasks:
            local_mounts = [src for src in (t.file_mounts or {}).values()
                            if isinstance(src, str) and
                            not src.startswith(('gs://', 's3://'))]
            if t.workdir or local_mounts:
                raise exceptions.InvalidTaskError(
                    'dedicated-controller (vm) mode cannot ship local '
                    'workdir/file_mounts to the controller host yet; '
                    'upload them to a bucket and use storage mounts '
                    '(gs://... / s3://...), or use consolidation mode.')
        _ensure_controller_cluster()
        spec = {'name': job_name,
                'tasks': [t.to_yaml_config() for t in tasks]}
        payload = base64.b64encode(
            json.dumps(spec).encode()).decode()
        return int(_remote_call(['launch', payload])['job_id'])
    # Job-level defaults come from the first task; tasks with their own
    # job_recovery override per task in the controller.
    rec = _recovery_config(tasks[0])
    StrategyName(rec['strategy'])  # validate early, before persisting
    for t in tasks[1:]:
        s, _ = task_recovery_config(t, rec['strategy'], 0)
        StrategyName(s)
    job_id = state.submit(job_name,
                          [t.to_yaml_config() for t in tasks],
                          recovery_strategy=rec['strategy'],
                          max_restarts_on_errors=rec[
                              'max_restarts_on_errors'])
    # On a dedicated controller host the persistent daemon drives the
    # job (remote_exec sets the skip: a controller thread started in the
    # short-lived verb process would die mid-provision with it).
    if os.environ.get('SKYTPU_JOBS_NO_CONTROLLERS') != '1':
        controller_lib.maybe_start_controllers()
    return job_id


def queue(refresh: bool = False,
          all_users: bool = False) -> List[Dict[str, Any]]:
    del refresh  # controller threads keep state fresh
    if _controller_mode() == 'vm' and \
            global_user_state.get_cluster(
                JOBS_CONTROLLER_CLUSTER) is not None:
        records = _remote_call(['queue', '1' if all_users else '0'])['jobs']
        # Same shape as the consolidation path: callers (REST handler,
        # CLI tables) expect enum statuses.
        return [dict(r, status=state.ManagedJobStatus(r['status']))
                for r in records]
    from skypilot_tpu_torch import users as users_lib
    from skypilot_tpu_torch import workspaces as workspaces_lib
    records = [r for r in state.list_jobs()
               if workspaces_lib.visible(r)]
    if not all_users:
        me = users_lib.current_user().name
        records = [r for r in records
                   if r.get('user_name') in (None, me)]
    return records


def cancel(job_id: int) -> bool:
    """Request cancellation; the controller cancels the cluster job and
    tears the cluster down."""
    if _controller_mode() == 'vm' and \
            global_user_state.get_cluster(
                JOBS_CONTROLLER_CLUSTER) is not None:
        return bool(_remote_call(['cancel', str(job_id)])['cancelled'])
    from skypilot_tpu_torch import users as users_lib
    from skypilot_tpu_torch import workspaces as workspaces_lib
    rec = state.get(job_id)
    if rec is None or not workspaces_lib.visible(rec):
        return False
    if rec.get('user_name') is not None:
        users_lib.check_cluster_op(
            {'name': f'managed job {job_id}',
             'user_name': rec['user_name']}, 'jobs cancel')
    ok = state.request_cancel(job_id)
    if ok and os.environ.get('SKYTPU_JOBS_NO_CONTROLLERS') != '1':
        # Adopt orphaned jobs (e.g. after an API-server restart) so the
        # cancel is actually processed.
        controller_lib.maybe_start_controllers()
    return ok


def snapshot_to_serve(rec: Dict[str, Any]) -> Optional[str]:
    """Single place for the jobs-logs serving policy, shared by the REST
    route and ``tail_logs``: once a job is terminal (its ephemeral
    cluster is always torn down) or its cluster record is gone, logs are
    served from the controller's snapshot (parity: the reference serves
    downloaded logs controller-side, sky/jobs/controller.py:201).
    Returns the snapshot path to serve, or None to use the live cluster.
    """
    record = None
    if rec['cluster_name'] is not None:
        record = global_user_state.get_cluster(rec['cluster_name'])
    if rec['status'].is_terminal() or record is None:
        snapshot = state.log_path(rec['job_id'])
        if os.path.exists(snapshot):
            return snapshot
        if record is None:
            raise exceptions.ClusterDoesNotExistError(
                f'cluster for managed job {rec["job_id"]} is not up and '
                f'no log snapshot exists '
                f'(status={rec["status"].value})')
    return None


def tail_logs(job_id: int, follow: bool = True, out=None) -> int:
    if _controller_mode() == 'vm' and \
            global_user_state.get_cluster(
                JOBS_CONTROLLER_CLUSTER) is not None:
        import sys
        import time as time_lib
        stream = out or sys.stdout
        offset = 0
        while True:
            # Offset rides to the remote verb so each poll ships only
            # the delta (not O(len(log)) per poll).
            result = _remote_call(['logs', str(job_id), str(offset)])
            if 'error' in result:
                raise exceptions.JobNotFoundError(f'managed job {job_id}')
            text = result.get('logs', '')
            if 'offset' in result:
                if text:
                    stream.write(text)
                    stream.flush()
                offset = int(result['offset'])
            elif text:
                # Controller cluster still running a pre-offset runtime
                # (it is reused while UP; runtime re-syncs at launch):
                # it returns the FULL log each poll — dedupe client-side
                # by character count.
                if len(text) > offset:
                    stream.write(text[offset:])
                    stream.flush()
                    offset = len(text)
            status = state.ManagedJobStatus(result['status'])
            if status.is_terminal():
                return 0 if status is \
                    state.ManagedJobStatus.SUCCEEDED else 1
            if not follow:
                return 0
            time_lib.sleep(2.0)
    rec = state.get(job_id)
    if rec is None:
        raise exceptions.JobNotFoundError(f'managed job {job_id}')
    snapshot = snapshot_to_serve(rec)
    if snapshot is not None:
        import sys
        stream = out or sys.stdout
        with open(snapshot, 'r', errors='replace') as f:
            stream.write(f.read())
        return 0
    if rec['cluster_job_id'] is None:
        raise exceptions.ClusterNotUpError(
            f'managed job {job_id} has not started yet '
            f'(status={rec["status"].value})')
    record = global_user_state.get_cluster(rec['cluster_name'])
    from skypilot_tpu_torch.backends import TpuVmBackend
    return TpuVmBackend().tail_logs(record['handle'],
                                    rec['cluster_job_id'], follow=follow)
