"""Serve state: services + replicas in sqlite
(capability parity: sky/serve/serve_state.py — replica/service tables,
ReplicaStatus).
"""
from __future__ import annotations

import enum
import json
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.utils import db_utils


class ServiceStatus(enum.Enum):
    STARTING = 'STARTING'          # controller bringing up first replicas
    READY = 'READY'                # >= 1 READY replica behind the LB
    NO_REPLICA = 'NO_REPLICA'      # controller alive, 0 ready replicas
    SHUTTING_DOWN = 'SHUTTING_DOWN'
    SHUTDOWN = 'SHUTDOWN'
    FAILED = 'FAILED'

    def is_terminal(self) -> bool:
        return self in (ServiceStatus.SHUTDOWN, ServiceStatus.FAILED)


class ReplicaStatus(enum.Enum):
    PROVISIONING = 'PROVISIONING'  # cluster being launched
    STARTING = 'STARTING'          # cluster up, readiness probe not yet ok
    READY = 'READY'
    NOT_READY = 'NOT_READY'        # was READY, probe failing
    PREEMPTED = 'PREEMPTED'        # cluster lost to the cloud
    FAILED = 'FAILED'              # provision or workload failure
    SHUTTING_DOWN = 'SHUTTING_DOWN'
    SHUTDOWN = 'SHUTDOWN'

    def is_terminal(self) -> bool:
        return self in (ReplicaStatus.SHUTDOWN, ReplicaStatus.FAILED,
                        ReplicaStatus.PREEMPTED)

    def counts_toward_target(self) -> bool:
        """Replicas the autoscaler counts as (becoming) capacity."""
        return self in (ReplicaStatus.PROVISIONING, ReplicaStatus.STARTING,
                        ReplicaStatus.READY, ReplicaStatus.NOT_READY)


def _db_path() -> str:
    # Control-plane store: shared Postgres when SKYTPU_DB_URL is set,
    # per-host sqlite otherwise.
    return db_utils.control_plane_dsn('SKYTPU_SERVE_DB',
                                      '~/.skytpu/services.db')


_DDL = [
    """CREATE TABLE IF NOT EXISTS services (
        name TEXT PRIMARY KEY,
        spec TEXT,
        task_config TEXT,
        status TEXT,
        lb_port INTEGER,
        policy TEXT,
        created_at REAL,
        failure_reason TEXT
    )""",
    """CREATE TABLE IF NOT EXISTS replicas (
        replica_id INTEGER,
        service_name TEXT,
        cluster_name TEXT,
        status TEXT,
        url TEXT,
        cluster_job_id INTEGER,
        is_spot INTEGER DEFAULT 0,
        zone TEXT,
        launched_at REAL,
        PRIMARY KEY (service_name, replica_id)
    )""",
    # Rolling updates (`serve update`): the service spec/task carry a
    # version; each replica records the version it was launched from,
    # and the controller drains older-version replicas as newer ones
    # turn READY (parity: sky/serve service versions).
    'ALTER TABLE services ADD COLUMN version INTEGER DEFAULT 1',
    'ALTER TABLE replicas ADD COLUMN version INTEGER DEFAULT 1',
    # Disaggregated prefill/decode pools: each replica records the role
    # it was launched for (NULL = monolithic), so the LB's pool-aware
    # routing and the per-pool autoscaler survive controller restarts.
    'ALTER TABLE replicas ADD COLUMN role TEXT',
]


def _ensure() -> str:
    path = _db_path()
    db_utils.ensure_schema(path, _DDL)
    return path


# Process-local replica-table mutation counter.  Every write path in
# this module bumps it; cached read views (replica_managers' ready
# view) key on it for exact same-process invalidation.  Writers in
# OTHER processes (the Postgres control plane shares the tables) are
# invisible to this counter — cache holders pair it with a short TTL.
_replicas_version_lock = threading.Lock()
_replicas_version = 0


def _bump_replicas_version() -> None:
    global _replicas_version
    with _replicas_version_lock:
        _replicas_version += 1


def replicas_version() -> int:
    """Monotonic count of replica-table writes made by this process."""
    return _replicas_version


# ----- services ---------------------------------------------------------------
def add_service(name: str, spec: Dict[str, Any],
                task_config: Dict[str, Any], lb_port: int) -> bool:
    """Returns False if a live service with this name already exists."""
    path = _ensure()
    with db_utils.transaction(path) as conn:
        row = conn.execute('SELECT status FROM services WHERE name=?',
                           (name,)).fetchone()
        if row is not None:
            if not ServiceStatus(row['status']).is_terminal():
                return False
            conn.execute('DELETE FROM services WHERE name=?', (name,))
            conn.execute('DELETE FROM replicas WHERE service_name=?',
                         (name,))
            _bump_replicas_version()
        conn.execute(
            'INSERT INTO services (name, spec, task_config, status, '
            'lb_port, created_at) VALUES (?,?,?,?,?,?)',
            (name, json.dumps(spec), json.dumps(task_config),
             ServiceStatus.STARTING.value, lb_port, time.time()))
        return True


def set_service_status(name: str, status: ServiceStatus,
                       failure_reason: Optional[str] = None) -> None:
    if failure_reason is not None:
        db_utils.execute(
            _ensure(), 'UPDATE services SET status=?, failure_reason=? '
            'WHERE name=?', (status.value, failure_reason, name))
    else:
        db_utils.execute(_ensure(),
                         'UPDATE services SET status=? WHERE name=?',
                         (status.value, name))


def get_service(name: str) -> Optional[Dict[str, Any]]:
    row = db_utils.query_one(
        _ensure(), 'SELECT * FROM services WHERE name=?', (name,))
    return _service_row(row) if row else None


def list_services() -> List[Dict[str, Any]]:
    rows = db_utils.query(_ensure(),
                          'SELECT * FROM services ORDER BY created_at')
    return [_service_row(r) for r in rows]


def remove_service(name: str) -> None:
    path = _ensure()
    with db_utils.transaction(path) as conn:
        conn.execute('DELETE FROM services WHERE name=?', (name,))
        conn.execute('DELETE FROM replicas WHERE service_name=?', (name,))
    _bump_replicas_version()


def _service_row(row) -> Dict[str, Any]:
    return {
        'name': row['name'],
        'spec': json.loads(row['spec'] or '{}'),
        'task_config': json.loads(row['task_config'] or '{}'),
        'status': ServiceStatus(row['status']),
        'lb_port': row['lb_port'],
        'created_at': row['created_at'],
        'failure_reason': row['failure_reason'],
        'version': int(row['version'] or 1),
    }


def update_service(name: str, spec: Dict[str, Any],
                   task_config: Dict[str, Any]) -> Optional[int]:
    """Store a new spec/task for a LIVE service, bumping its version;
    returns the new version (the controller rolls replicas to it), or
    None if the service does not exist / is terminal."""
    path = _ensure()
    with db_utils.transaction(path) as conn:
        row = conn.execute(
            'SELECT status, version FROM services WHERE name=?',
            (name,)).fetchone()
        if row is None or ServiceStatus(row['status']).is_terminal():
            return None
        new_version = int(row['version'] or 1) + 1
        conn.execute(
            'UPDATE services SET spec=?, task_config=?, version=? '
            'WHERE name=?',
            (json.dumps(spec), json.dumps(task_config), new_version,
             name))
        return new_version


# ----- replicas ---------------------------------------------------------------
def next_replica_id(service_name: str) -> int:
    path = _ensure()
    with db_utils.transaction(path) as conn:
        row = conn.execute(
            'SELECT MAX(replica_id) AS m FROM replicas '
            'WHERE service_name=?', (service_name,)).fetchone()
        return int(row['m'] or 0) + 1


def add_replica(service_name: str, replica_id: int, cluster_name: str,
                is_spot: bool = False, zone: Optional[str] = None,
                version: int = 1, role: Optional[str] = None) -> None:
    db_utils.execute(
        _ensure(), 'INSERT OR REPLACE INTO replicas (replica_id, '
        'service_name, cluster_name, status, is_spot, zone, launched_at, '
        'version, role) VALUES (?,?,?,?,?,?,?,?,?)',
        (replica_id, service_name, cluster_name,
         ReplicaStatus.PROVISIONING.value, int(is_spot), zone,
         time.time(), version, role))
    _bump_replicas_version()


def set_replica_status(service_name: str, replica_id: int,
                       status: ReplicaStatus) -> None:
    db_utils.execute(
        _ensure(), 'UPDATE replicas SET status=? WHERE service_name=? '
        'AND replica_id=?', (status.value, service_name, replica_id))
    _bump_replicas_version()


def set_replica_status_if(service_name: str, replica_id: int,
                          expected: ReplicaStatus,
                          status: ReplicaStatus) -> bool:
    """Atomic guarded transition; False if the replica was not in
    `expected` (e.g. terminated while its launch thread was running).

    Entering STARTING re-stamps launched_at: the readiness initial-delay
    grace must start when the replica's JOB starts, not when its row was
    created — provisioning (minutes on real clouds) would otherwise eat
    the whole readiness budget and every slow provision would be
    replaced the moment it finally came up."""
    path = _ensure()
    with db_utils.transaction(path) as conn:
        if status is ReplicaStatus.STARTING:
            cur = conn.execute(
                'UPDATE replicas SET status=?, launched_at=? '
                'WHERE service_name=? AND replica_id=? AND status=?',
                (status.value, time.time(), service_name, replica_id,
                 expected.value))
        else:
            cur = conn.execute(
                'UPDATE replicas SET status=? WHERE service_name=? AND '
                'replica_id=? AND status=?',
                (status.value, service_name, replica_id, expected.value))
        if cur.rowcount > 0:
            _bump_replicas_version()
        return cur.rowcount > 0


def set_replica_endpoint(service_name: str, replica_id: int, url: str,
                         cluster_job_id: Optional[int]) -> None:
    db_utils.execute(
        _ensure(), 'UPDATE replicas SET url=?, cluster_job_id=? '
        'WHERE service_name=? AND replica_id=?',
        (url, cluster_job_id, service_name, replica_id))
    _bump_replicas_version()


def get_replicas(service_name: str,
                 include_terminal: bool = False) -> List[Dict[str, Any]]:
    rows = db_utils.query(
        _ensure(), 'SELECT * FROM replicas WHERE service_name=? '
        'ORDER BY replica_id', (service_name,))
    out = [_replica_row(r) for r in rows]
    if not include_terminal:
        out = [r for r in out if not r['status'].is_terminal()]
    return out


def get_replica(service_name: str,
                replica_id: int) -> Optional[Dict[str, Any]]:
    row = db_utils.query_one(
        _ensure(), 'SELECT * FROM replicas WHERE service_name=? AND '
        'replica_id=?', (service_name, replica_id))
    return _replica_row(row) if row else None


def _replica_row(row) -> Dict[str, Any]:
    return {
        'replica_id': row['replica_id'],
        'service_name': row['service_name'],
        'cluster_name': row['cluster_name'],
        'status': ReplicaStatus(row['status']),
        'url': row['url'],
        'cluster_job_id': row['cluster_job_id'],
        'is_spot': bool(row['is_spot']),
        'zone': row['zone'],
        'launched_at': row['launched_at'],
        'version': int(row['version'] or 1),
        'role': row['role'] if 'role' in row.keys() else None,
    }
