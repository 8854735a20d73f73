"""Managed-job state machine (parity: sky/jobs/state.py:411).

One sqlite table holds every managed job; the user-facing status enum
mirrors the reference's ManagedJobStatus.  Transitions are guarded in SQL
(single atomic UPDATE) so a cancel racing the controller can never be
overwritten: terminal states are sticky, and CANCELLING can only move to
CANCELLED or a FAILED_* state.
"""
from __future__ import annotations

import enum
import json
import os
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.utils import db_utils


class ManagedJobStatus(enum.Enum):
    PENDING = 'PENDING'            # submitted, controller not started
    STARTING = 'STARTING'          # controller provisioning the cluster
    RUNNING = 'RUNNING'            # task running on its cluster
    RECOVERING = 'RECOVERING'      # cluster lost (preemption); re-provision
    CANCELLING = 'CANCELLING'      # user cancel observed, cleanup running
    SUCCEEDED = 'SUCCEEDED'
    FAILED = 'FAILED'              # user code exited non-zero
    FAILED_SETUP = 'FAILED_SETUP'
    FAILED_NO_RESOURCE = 'FAILED_NO_RESOURCE'  # placements exhausted
    FAILED_CONTROLLER = 'FAILED_CONTROLLER'    # controller itself crashed
    CANCELLED = 'CANCELLED'

    def is_terminal(self) -> bool:
        return self in _TERMINAL

    def is_failed(self) -> bool:
        return self in (ManagedJobStatus.FAILED,
                        ManagedJobStatus.FAILED_SETUP,
                        ManagedJobStatus.FAILED_NO_RESOURCE,
                        ManagedJobStatus.FAILED_CONTROLLER)


_TERMINAL = (ManagedJobStatus.SUCCEEDED, ManagedJobStatus.FAILED,
             ManagedJobStatus.FAILED_SETUP,
             ManagedJobStatus.FAILED_NO_RESOURCE,
             ManagedJobStatus.FAILED_CONTROLLER, ManagedJobStatus.CANCELLED)

# For clients that see statuses as wire strings (CLI/SDK over REST).
TERMINAL_STATUS_VALUES = frozenset(s.value for s in _TERMINAL)


def _db_path() -> str:
    # Control-plane store: shared Postgres when SKYTPU_DB_URL is set,
    # per-host sqlite otherwise.
    return db_utils.control_plane_dsn('SKYTPU_JOBS_DB',
                                      '~/.skytpu/managed_jobs.db')


_DDL = [
    """CREATE TABLE IF NOT EXISTS managed_jobs (
        job_id INTEGER PRIMARY KEY AUTOINCREMENT,
        name TEXT,
        task_config TEXT,
        status TEXT,
        cluster_name TEXT,
        cluster_job_id INTEGER,
        submitted_at REAL,
        started_at REAL,
        ended_at REAL,
        recovery_count INTEGER DEFAULT 0,
        max_restarts_on_errors INTEGER DEFAULT 0,
        restarts_on_errors INTEGER DEFAULT 0,
        recovery_strategy TEXT DEFAULT 'FAILOVER',
        failure_reason TEXT,
        task_index INTEGER DEFAULT 0,
        num_tasks INTEGER DEFAULT 1
    )""",
    # Idempotent migrations for DBs created before pipeline support
    # (ensure_schema swallows duplicate-column errors).
    "ALTER TABLE managed_jobs ADD COLUMN task_index INTEGER DEFAULT 0",
    "ALTER TABLE managed_jobs ADD COLUMN num_tasks INTEGER DEFAULT 1",
    "ALTER TABLE managed_jobs ADD COLUMN user_name TEXT",
    "ALTER TABLE managed_jobs ADD COLUMN workspace TEXT",
]


def _ensure() -> str:
    path = _db_path()
    db_utils.ensure_schema(path, _DDL)
    return path


def log_path(job_id: int) -> str:
    """Controller-side snapshot of the job's run log, persisted before the
    ephemeral task cluster is torn down (parity: the reference controller
    downloads logs, sky/jobs/controller.py:201)."""
    # Log snapshots are FILES and stay host-local even when the job
    # TABLE lives in Postgres (anchored on the sqlite path's directory,
    # not the DSN).
    local = os.path.expanduser(
        os.environ.get('SKYTPU_JOBS_DB', '~/.skytpu/managed_jobs.db'))
    return os.path.join(os.path.dirname(local), 'managed_jobs_logs',
                        f'{job_id}.log')


def submit(name: Optional[str], task_config, recovery_strategy: str = 'FAILOVER',
           max_restarts_on_errors: int = 0) -> int:
    """Persist a new managed job.

    ``task_config`` is one task's YAML config (dict) or, for a pipeline
    (parity: the reference controller iterates dag tasks,
    sky/jobs/controller.py:98), a list of task configs executed as a
    chain.  ``recovery_strategy``/``max_restarts_on_errors`` are
    job-level defaults; tasks carrying their own ``job_recovery``
    override them per task.
    """
    configs = (list(task_config) if isinstance(task_config, list)
               else [task_config])
    if not configs:
        raise ValueError('managed job needs at least one task')
    from skypilot_tpu_torch import users
    from skypilot_tpu_torch import workspaces
    path = _ensure()
    with db_utils.transaction(path) as conn:
        cur = conn.execute(
            'INSERT INTO managed_jobs (name, task_config, status, '
            'submitted_at, recovery_strategy, max_restarts_on_errors, '
            'task_index, num_tasks, user_name, workspace) '
            'VALUES (?,?,?,?,?,?,0,?,?,?)',
            (name, json.dumps(configs),
             ManagedJobStatus.PENDING.value, time.time(),
             recovery_strategy, max_restarts_on_errors, len(configs),
             users.current_user().name, workspaces.active_workspace()))
        return int(cur.lastrowid)


def set_status(job_id: int, status: ManagedJobStatus,
               failure_reason: Optional[str] = None) -> bool:
    """Guarded transition; returns False if the guard rejected it."""
    path = _ensure()
    now = time.time()
    sets = ['status=?']
    params: List[Any] = [status.value]
    if status is ManagedJobStatus.RUNNING:
        sets.append('started_at=COALESCE(started_at, ?)')
        params.append(now)
    if status.is_terminal():
        sets.append('ended_at=?')
        params.append(now)
    if failure_reason is not None:
        sets.append('failure_reason=?')
        params.append(failure_reason)
    params.append(job_id)
    # Guards: terminal is sticky; CANCELLING only advances to terminal.
    where = 'WHERE job_id=? AND status NOT IN ({})'.format(
        ','.join('?' * len(_TERMINAL)))
    params.extend(s.value for s in _TERMINAL)
    if not status.is_terminal():
        where += ' AND status != ?'
        params.append(ManagedJobStatus.CANCELLING.value)
    with db_utils.transaction(path) as conn:
        cur = conn.execute(
            f'UPDATE managed_jobs SET {", ".join(sets)} {where}',
            tuple(params))
        return cur.rowcount > 0


def request_cancel(job_id: int) -> bool:
    """User cancel: non-terminal -> CANCELLING.  Returns False if the job
    is already terminal (or unknown)."""
    path = _ensure()
    params: List[Any] = [ManagedJobStatus.CANCELLING.value, job_id]
    params.extend(s.value for s in _TERMINAL)
    with db_utils.transaction(path) as conn:
        cur = conn.execute(
            'UPDATE managed_jobs SET status=? WHERE job_id=? AND status '
            'NOT IN ({})'.format(','.join('?' * len(_TERMINAL))),
            tuple(params))
        return cur.rowcount > 0


def set_cluster(job_id: int, cluster_name: str,
                cluster_job_id: Optional[int]) -> None:
    db_utils.execute(
        _ensure(), 'UPDATE managed_jobs SET cluster_name=?, '
        'cluster_job_id=? WHERE job_id=?',
        (cluster_name, cluster_job_id, job_id))


def advance_task(job_id: int, next_index: int) -> None:
    """Move a pipeline job to its next task: clears the finished task's
    cluster binding and the per-task restart counter (each task gets its
    own max_restarts_on_errors budget, like the reference's per-task
    strategy executors)."""
    db_utils.execute(
        _ensure(), 'UPDATE managed_jobs SET task_index=?, '
        'cluster_name=NULL, cluster_job_id=NULL, restarts_on_errors=0 '
        'WHERE job_id=?', (next_index, job_id))


def bump_recovery_count(job_id: int) -> int:
    path = _ensure()
    with db_utils.transaction(path) as conn:
        conn.execute(
            'UPDATE managed_jobs SET recovery_count=recovery_count+1 '
            'WHERE job_id=?', (job_id,))
        row = conn.execute(
            'SELECT recovery_count FROM managed_jobs WHERE job_id=?',
            (job_id,)).fetchone()
        return int(row[0]) if row else 0


def bump_restarts_on_errors(job_id: int) -> int:
    path = _ensure()
    with db_utils.transaction(path) as conn:
        conn.execute(
            'UPDATE managed_jobs SET restarts_on_errors='
            'restarts_on_errors+1 WHERE job_id=?', (job_id,))
        row = conn.execute(
            'SELECT restarts_on_errors FROM managed_jobs WHERE job_id=?',
            (job_id,)).fetchone()
        return int(row[0]) if row else 0


def get(job_id: int) -> Optional[Dict[str, Any]]:
    row = db_utils.query_one(
        _ensure(), 'SELECT * FROM managed_jobs WHERE job_id=?', (job_id,))
    return _row(row) if row else None


def list_jobs(limit: int = 1000) -> List[Dict[str, Any]]:
    rows = db_utils.query(
        _ensure(),
        'SELECT * FROM managed_jobs ORDER BY job_id DESC LIMIT ?',
        (limit,))
    return [_row(r) for r in rows]


def nonterminal_jobs() -> List[Dict[str, Any]]:
    params = tuple(s.value for s in _TERMINAL)
    rows = db_utils.query(
        _ensure(), 'SELECT * FROM managed_jobs WHERE status NOT IN ({}) '
        'ORDER BY job_id'.format(','.join('?' * len(_TERMINAL))), params)
    return [_row(r) for r in rows]


def _row(row) -> Dict[str, Any]:
    raw = json.loads(row['task_config'] or '{}')
    # Pre-pipeline rows stored a bare dict; canonical form is a list.
    task_configs = raw if isinstance(raw, list) else [raw]
    task_index = min(row['task_index'] or 0, len(task_configs) - 1)
    return {
        'job_id': row['job_id'],
        'name': row['name'],
        'task_configs': task_configs,
        'task_index': row['task_index'] or 0,
        'num_tasks': row['num_tasks'] or len(task_configs),
        # The *current* task's config (what the controller is running).
        'task_config': task_configs[task_index],
        'status': ManagedJobStatus(row['status']),
        'cluster_name': row['cluster_name'],
        'cluster_job_id': row['cluster_job_id'],
        'submitted_at': row['submitted_at'],
        'started_at': row['started_at'],
        'ended_at': row['ended_at'],
        'recovery_count': row['recovery_count'],
        'max_restarts_on_errors': row['max_restarts_on_errors'],
        'restarts_on_errors': row['restarts_on_errors'],
        'recovery_strategy': row['recovery_strategy'],
        'failure_reason': row['failure_reason'],
        'user_name': row['user_name'],
        'workspace': row['workspace'],
    }
