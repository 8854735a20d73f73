"""Persisted async requests (parity: sky/server/requests/requests.py).

Every API call becomes a request row; clients poll `GET /requests/{id}`
(the reference's RequestId + stream_and_get pattern).  Persistence makes
requests resumable after client disconnects — the reference's chaos-proxy
tests exercise exactly this property.
"""
from __future__ import annotations

import enum
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.state import leases
from skypilot_tpu_torch.utils import db_utils


class RequestStatus(enum.Enum):
    PENDING = 'PENDING'
    RUNNING = 'RUNNING'
    SUCCEEDED = 'SUCCEEDED'
    FAILED = 'FAILED'
    CANCELLED = 'CANCELLED'

    def is_terminal(self) -> bool:
        return self in (RequestStatus.SUCCEEDED, RequestStatus.FAILED,
                        RequestStatus.CANCELLED)


def _db_path() -> str:
    # The shared queue: Postgres when SKYTPU_DB_URL is set (multi-NODE
    # API servers), per-host sqlite otherwise (multi-process per node).
    return db_utils.control_plane_dsn('SKYTPU_REQUESTS_DB',
                                      '~/.skytpu/requests.db')


def db_dsn() -> str:
    """The requests-queue DSN (public: app startup decides whether to
    run the lease heartbeat from it)."""
    return _ensure()


_DDL = [
    """CREATE TABLE IF NOT EXISTS requests (
        request_id TEXT PRIMARY KEY,
        name TEXT,
        status TEXT,
        created_at REAL,
        finished_at REAL,
        body TEXT,
        result TEXT,
        error TEXT,
        schedule_type TEXT
    )""",
    # Worker-process pid (NULL for thread-executed SHORT requests);
    # lets /requests/{id}/cancel address the right process.
    'ALTER TABLE requests ADD COLUMN pid INTEGER',
    # Which SERVER process dispatched this request (multi-worker: the
    # requests DB is the shared queue; claims stop two workers from
    # both dispatching one PENDING row on startup recovery), and when
    # it claimed (pid-recycling guard: a process that started after
    # the claim cannot be the claimer).
    'ALTER TABLE requests ADD COLUMN claim_pid INTEGER',
    'ALTER TABLE requests ADD COLUMN claim_at REAL',
    # Which server INSTANCE (host:pid:nonce, state/leases.py) claimed.
    # Pid liveness is only meaningful same-host; when the backend is
    # remote (Postgres, multi-node) claim liveness is the instance's
    # heartbeat lease instead.
    'ALTER TABLE requests ADD COLUMN claim_instance TEXT',
    # Worker peak RSS in KB, recorded at completion (parity:
    # sky/server/requests/executor.py:570 per-request memory
    # accounting) — the capacity-planning signal for sizing API hosts.
    'ALTER TABLE requests ADD COLUMN peak_rss_kb INTEGER',
    # Submitting user (RBAC: non-admins list only their own requests).
    'ALTER TABLE requests ADD COLUMN user TEXT',
    # Server-wide flags shared by every worker process (e.g. draining).
    """CREATE TABLE IF NOT EXISTS server_flags (
        key TEXT PRIMARY KEY,
        value TEXT
    )""",
]


def _ensure() -> str:
    path = _db_path()
    db_utils.ensure_schema(path, _DDL)
    return path


def create(name: str, body: Dict[str, Any],
           schedule_type: str = 'long',
           claim_pid: Optional[int] = None) -> str:
    """Insert a PENDING row; with claim_pid the row is born CLAIMED in the
    same INSERT.  Thread-pool work (executor.submit) must claim
    atomically: a row visible unclaimed for even a moment can be seen by
    a concurrently-booting sibling worker's recover() — which cannot run
    a thread closure — and marked FAILED while this worker executes it."""
    request_id = uuid.uuid4().hex[:16]
    now = time.time()
    path = _ensure()
    claim_instance = None
    if claim_pid is not None and leases.lease_mode(path):
        # Born-claimed under leases: the claim names our instance and
        # our heartbeat must already be fresh, or a sibling replica
        # could judge the brand-new claim stale and steal it.
        claim_instance = leases.instance_id()
        leases.ensure_heartbeat(path)
    db_utils.execute(
        path,
        'INSERT INTO requests (request_id, name, status, created_at, body, '
        'schedule_type, user, claim_pid, claim_at, claim_instance) '
        'VALUES (?,?,?,?,?,?,?,?,?,?)',
        (request_id, name, RequestStatus.PENDING.value, now,
         json.dumps(body), schedule_type, body.get('_user'), claim_pid,
         now if claim_pid is not None else None, claim_instance))
    return request_id


def set_status(request_id: str, status: RequestStatus,
               result: Any = None, error: Optional[str] = None,
               pid: Optional[int] = None) -> None:
    sets = ['status=?']
    params: list = [status.value]
    if status.is_terminal():
        sets.append('finished_at=?')
        params.append(time.time())
    if result is not None:
        sets.append('result=?')
        params.append(json.dumps(result, default=str))
    if error is not None:
        sets.append('error=?')
        params.append(error)
    if pid is not None:
        sets.append('pid=?')
        params.append(pid)
    params.append(request_id)
    # Terminal results are sticky: a worker's SUCCEEDED/FAILED landing
    # just after a cancel must not overwrite CANCELLED, and vice versa
    # (single guarded UPDATE, no check-then-write window).
    where = 'WHERE request_id=? AND status NOT IN (?,?,?)'
    params.extend([RequestStatus.SUCCEEDED.value,
                   RequestStatus.FAILED.value,
                   RequestStatus.CANCELLED.value])
    db_utils.execute(_ensure(), f'UPDATE requests SET {", ".join(sets)} '
                     + where, tuple(params))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:   # exists but not ours
        return True
    except TypeError:
        return False


def _pid_start_time(pid: int) -> Optional[float]:
    """Unix start time of `pid` (Linux /proc), or None if unknown."""
    try:
        with open(f'/proc/{pid}/stat', 'r', encoding='utf-8') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        start_ticks = int(fields[19])
        with open('/proc/uptime', 'r', encoding='utf-8') as f:
            uptime = float(f.read().split()[0])
        try:
            hz = float(os.sysconf('SC_CLK_TCK'))
        except (ValueError, OSError):
            hz = 100.0
        return time.time() - uptime + start_ticks / hz
    except (OSError, IndexError, ValueError):
        return None


def try_claim(request_id: str, pid: int) -> bool:
    """Claim a PENDING request for dispatch by server process `pid`.

    CAS on the previous claim value (NULL-safe `IS ?`): a claim held by
    a live claimer is respected; a dead claimer's row is stealable —
    that is what lets N workers run recovery concurrently without
    double-dispatching (the one write wins, rowcount tells the loser).

    Liveness of the previous claimer depends on the deployment shape:

    - same-host (sqlite backend): pid probe + /proc start-time guard —
      a pid that started AFTER the claim was made cannot be the claimer
      (pid recycling, e.g. post-reboot), or a PENDING row could hang
      forever behind an unrelated process;
    - multi-node (remote backend / lease mode): the claimer's heartbeat
      LEASE (state/leases.py) — a claim whose instance stopped beating
      one TTL ago is stealable (stale-lease takeover), and the CAS runs
      on the instance column so two replicas racing for the same stale
      row still produce exactly one winner.
    """
    path = _ensure()
    row = db_utils.query_one(
        path, 'SELECT claim_pid, claim_at, claim_instance, status '
        'FROM requests WHERE request_id=?', (request_id,))
    if row is None or row['status'] != RequestStatus.PENDING.value:
        return False
    if leases.lease_mode(path):
        mine = leases.instance_id()
        leases.ensure_heartbeat(path)
        old_inst = row['claim_instance']
        if old_inst is not None and old_inst != mine and \
                leases.is_live(path, old_inst):
            return False
        return db_utils.execute_rowcount(
            path, 'UPDATE requests SET claim_pid=?, claim_at=?, '
            'claim_instance=? '
            'WHERE request_id=? AND claim_instance IS ? AND status=?',
            (pid, time.time(), mine, request_id, old_inst,
             RequestStatus.PENDING.value)) == 1
    old = row['claim_pid']
    if old is not None and old != pid and _pid_alive(old):
        started = _pid_start_time(old)
        claimed_at = row['claim_at']
        recycled = (started is not None and claimed_at is not None and
                    started > claimed_at + 5.0)    # 5s clock slack
        if not recycled:
            return False
    return db_utils.execute_rowcount(
        path, 'UPDATE requests SET claim_pid=?, claim_at=? '
        'WHERE request_id=? AND claim_pid IS ? AND status=?',
        (pid, time.time(), request_id, old,
         RequestStatus.PENDING.value)) == 1


def set_flag(key: str, value: str) -> None:
    """Server-wide flag, visible to every worker process."""
    db_utils.execute(
        _ensure(), 'INSERT INTO server_flags (key, value) VALUES (?,?) '
        'ON CONFLICT(key) DO UPDATE SET value=excluded.value',
        (key, value))


def get_flag(key: str) -> Optional[str]:
    row = db_utils.query_one(
        _ensure(), 'SELECT value FROM server_flags WHERE key=?', (key,))
    return row['value'] if row else None


def get(request_id: str) -> Optional[Dict[str, Any]]:
    row = db_utils.query_one(
        _ensure(), 'SELECT * FROM requests WHERE request_id=?',
        (request_id,))
    return _record(row) if row is not None else None


def _record(row) -> Dict[str, Any]:
    return {
        'request_id': row['request_id'],
        'name': row['name'],
        'status': RequestStatus(row['status']),
        'created_at': row['created_at'],
        'finished_at': row['finished_at'],
        'body': json.loads(row['body'] or '{}'),
        'result': json.loads(row['result']) if row['result'] else None,
        'error': row['error'],
        'pid': row['pid'],
        'peak_rss_kb': row['peak_rss_kb'],
        'user': row['user'],
        'claim_pid': row['claim_pid'],
        'claim_at': row['claim_at'],
        'claim_instance': row['claim_instance'],
    }


def claim_is_live(claim_pid: Optional[int],
                  claim_at: Optional[float],
                  claim_instance: Optional[str] = None) -> bool:
    """True if the claiming server process is still the claimer.

    Lease mode (remote backend / SKYTPU_DB_LEASES): the claimer is live
    iff its instance's heartbeat lease is — the only check that means
    anything across hosts.  Same-host mode: pid alive and not recycled
    (a process that started after the claim was made cannot be the
    claimer)."""
    path = _ensure()
    if leases.lease_mode(path):
        # Rows claimed before the lease migration carry no instance;
        # fall through to the pid check for those legacy rows only.
        if claim_instance is not None:
            return leases.is_live(path, claim_instance)
    if not claim_pid or not _pid_alive(claim_pid):
        return False
    started = _pid_start_time(claim_pid)
    if started is not None and claim_at is not None and \
            started > claim_at + 5.0:
        return False
    return True


def record_peak_rss(request_id: str, kb: int) -> None:
    db_utils.execute(
        _ensure(), 'UPDATE requests SET peak_rss_kb=? WHERE request_id=?',
        (kb, request_id))


def list_requests(limit: int = 100) -> List[Dict[str, Any]]:
    # One query, full rows: the old id-list + per-id get() was 1+N
    # round-trips (and could see the requests-GC daemon prune a row
    # between the two reads); a single SELECT is one round-trip and
    # one consistent snapshot — which matters doubly now that the DB
    # can be a remote Postgres.
    rows = db_utils.query(
        _ensure(),
        'SELECT * FROM requests ORDER BY created_at DESC LIMIT ?',
        (limit,))
    return [_record(r) for r in rows]


def nonterminal_requests() -> List[Dict[str, Any]]:
    """PENDING/RUNNING rows — the persisted queue the server re-adopts
    after a restart, and the lease-recovery pump's periodic scan (so
    this is one round-trip, not 1+N: against Postgres it runs every
    TTL/2 on every replica)."""
    rows = db_utils.query(
        _ensure(), 'SELECT * FROM requests WHERE status IN (?,?) '
        'ORDER BY created_at',
        (RequestStatus.PENDING.value, RequestStatus.RUNNING.value))
    return [_record(r) for r in rows]


def prune(max_age_s: float) -> int:
    """Delete terminal requests older than max_age_s (requests-GC daemon;
    parity: the reference cleans finished requests periodically,
    sky/server/requests/requests.py clean_finished_requests)."""
    cutoff = time.time() - max_age_s
    path = _ensure()
    with db_utils.transaction(path) as conn:
        cur = conn.execute(
            'DELETE FROM requests WHERE status IN (?,?,?) AND '
            'finished_at IS NOT NULL AND finished_at < ?',
            (RequestStatus.SUCCEEDED.value, RequestStatus.FAILED.value,
             RequestStatus.CANCELLED.value, cutoff))
        return cur.rowcount
