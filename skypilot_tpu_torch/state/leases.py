"""Heartbeat leases: claim liveness for multi-NODE API servers.

The requests DB's claims originally proved liveness with
``os.kill(pid, 0)`` — correct only when every claimer shares one host.
With a remote backend (Postgres), two API-server replicas on different
nodes share the queue, and a pid means nothing across hosts.  Leases
replace pid-liveness whenever the backend is remote:

- every server process mints one **instance id**
  (``host:pid:nonce``) per lifetime;
- a ``server_instances`` heartbeat table is upserted every
  ``ttl/3`` seconds by a daemon thread (plus inline on claim, so a
  process that claims before its thread's first tick is never
  spuriously stale);
- a claim is **live** iff its instance's heartbeat is younger than the
  TTL; anything staler is stealable (stale-lease takeover) — that is
  what lets a surviving replica re-dispatch the work of a crashed one
  without ever double-dispatching against a healthy one.

Lease mode turns on automatically for ``postgresql://`` DSNs and can
be forced on sqlite with ``SKYTPU_DB_LEASES=1`` (the tier-1 tests use
this: the lease protocol is backend-agnostic, so its logic is tested
without a live Postgres).
"""
from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from typing import Dict, Optional

from skypilot_tpu_torch.utils import db_utils

_DDL = [
    """CREATE TABLE IF NOT EXISTS server_instances (
        instance_id TEXT PRIMARY KEY,
        host TEXT,
        pid INTEGER,
        started_at REAL,
        last_heartbeat REAL
    )""",
    # Cluster-wide singleton roles (one holder at a time): the jobs/
    # serve controller driver and the background daemons must run in
    # exactly ONE process across every replica sharing the backend.
    """CREATE TABLE IF NOT EXISTS singleton_leases (
        name TEXT PRIMARY KEY,
        instance_id TEXT,
        acquired_at REAL
    )""",
]

# Postgres is the multi-NODE backend: every node has its own clock,
# and comparing a reader's time.time() with a writer's makes a healthy
# replica look dead under clock skew >= TTL.  The database's clock is
# the one clock every replica shares, so on Postgres heartbeats are
# WRITTEN with now() and staleness is COMPUTED server-side.  sqlite is
# same-host (one clock) — local time is already authoritative.
_PG_NOW = 'EXTRACT(EPOCH FROM now())'

DEFAULT_LEASE_TTL_S = 15.0

_lock = threading.Lock()
# (pid, instance_id): regenerated after fork so a child never
# impersonates its parent's lease.
_instance: Optional[tuple] = None
# dsn -> monotonic time of the last inline heartbeat (rate limit).
_last_beat: Dict[str, float] = {}
# dsn -> heartbeat thread (daemon), stop event shared.
_hb_threads: Dict[str, threading.Thread] = {}
_hb_stop = threading.Event()
# DSNs this process has withdrawn from: heartbeats become no-ops, so a
# straggler heartbeat thread that outlives its join timeout can never
# resurrect the lease row withdraw() just deleted.
_withdrawn: set = set()


def lease_ttl_s() -> float:
    try:
        return float(os.environ.get('SKYTPU_LEASE_TTL_S',
                                    DEFAULT_LEASE_TTL_S))
    except ValueError:
        return DEFAULT_LEASE_TTL_S


def lease_mode(dsn: str) -> bool:
    """Leases govern claim liveness when the backend is remote (pid
    checks are meaningless across hosts), or when forced for tests."""
    if os.environ.get('SKYTPU_DB_LEASES', '') == '1':
        return True
    from skypilot_tpu_torch import state  # lazy: state does not import us
    return state.is_postgres_dsn(dsn)


def instance_id() -> str:
    """This server process's stable identity: ``host:pid:nonce``."""
    global _instance
    pid = os.getpid()
    with _lock:
        if _instance is None or _instance[0] != pid:
            _instance = (pid, f'{socket.gethostname()}:{pid}:'
                              f'{uuid.uuid4().hex[:8]}')
        return _instance[1]


def host_of(instance: str) -> str:
    return instance.rsplit(':', 2)[0]


def same_host(instance: Optional[str]) -> bool:
    """True if `instance` was minted on THIS host — the precondition
    for trusting any pid recorded alongside it."""
    if not instance:
        return False
    return host_of(instance) == socket.gethostname()


def _ensure(dsn: str) -> str:
    db_utils.ensure_schema(dsn, _DDL)
    return dsn


def _is_pg(dsn: str) -> bool:
    from skypilot_tpu_torch import state  # lazy: state does not import us
    return state.is_postgres_dsn(dsn)


def heartbeat(dsn: str, now: Optional[float] = None) -> None:
    """Upsert this instance's heartbeat row (DB-server clock on
    Postgres, local clock on same-host sqlite)."""
    now = time.time() if now is None else now
    with _lock:
        if dsn in _withdrawn:
            return         # departed: never re-insert our lease row
    inst = instance_id()
    if _is_pg(dsn):
        sql = (f'INSERT INTO server_instances (instance_id, host, pid, '
               f'started_at, last_heartbeat) '
               f'VALUES (?,?,?,?,{_PG_NOW}) '
               f'ON CONFLICT(instance_id) DO UPDATE SET '
               f'last_heartbeat={_PG_NOW}')
        params = (inst, socket.gethostname(), os.getpid(), now)
    else:
        sql = ('INSERT INTO server_instances (instance_id, host, pid, '
               'started_at, last_heartbeat) VALUES (?,?,?,?,?) '
               'ON CONFLICT(instance_id) DO UPDATE SET '
               'last_heartbeat=excluded.last_heartbeat')
        params = (inst, socket.gethostname(), os.getpid(), now, now)
    db_utils.execute(_ensure(dsn), sql, params)
    with _lock:
        _last_beat[dsn] = time.monotonic()
        departed = dsn in _withdrawn
    if departed:
        # withdraw() ran while our upsert was in flight (it passed the
        # top-of-function marker check before the marker existed) and
        # our commit may have landed AFTER withdraw's delete —
        # compensate so the departed instance never looks live.
        db_utils.execute(
            dsn, 'DELETE FROM server_instances WHERE instance_id=?',
            (inst,))


# monotonic time of the last GC sweep this process ran (rate limit:
# a sweep per heartbeat tick would be N replicas × a DELETE scan of
# the shared table every TTL/3 for a horizon measured in many TTLs).
_last_gc: Optional[float] = None


def gc_stale_instances(dsn: str, keep_ttls: float = 10.0,
                       force: bool = False) -> None:
    """Drop heartbeat rows dead for many TTLs — every server start
    mints a fresh instance id, so without GC the shared table grows
    forever.  Rows only a few TTLs stale are kept: claims may still
    reference them and 'row missing' and 'row stale' both read as dead,
    so deleting early loses nothing but deleting late costs nothing.
    Self-rate-limited to one sweep per horizon per process (callable
    freely from the heartbeat loop)."""
    global _last_gc
    horizon = lease_ttl_s() * keep_ttls
    with _lock:
        if not force and _last_gc is not None and \
                time.monotonic() - _last_gc < horizon:
            return
        _last_gc = time.monotonic()
    if _is_pg(dsn):
        db_utils.execute(
            _ensure(dsn),
            f'DELETE FROM server_instances '
            f'WHERE last_heartbeat < {_PG_NOW} - ?', (horizon,))
    else:
        db_utils.execute(
            _ensure(dsn),
            'DELETE FROM server_instances WHERE last_heartbeat < ?',
            (time.time() - horizon,))


def ensure_heartbeat(dsn: str) -> None:
    """Inline heartbeat, rate-limited to the thread interval — called
    on every claim so a claim is never made on a stale own-lease (e.g.
    before the heartbeat thread's first tick)."""
    interval = lease_ttl_s() / 3.0
    with _lock:
        last = _last_beat.get(dsn)
    if last is None or time.monotonic() - last >= interval:
        heartbeat(dsn)


def _heartbeat_age(dsn: str, instance: str) -> Optional[float]:
    """Age of `instance`'s last heartbeat, measured on the SAME clock
    that wrote it (the DB server's on Postgres); None if unknown."""
    if _is_pg(dsn):
        row = db_utils.query_one(
            _ensure(dsn),
            f'SELECT {_PG_NOW} - last_heartbeat AS age '
            f'FROM server_instances WHERE instance_id=?', (instance,))
        return None if row is None or row['age'] is None \
            else float(row['age'])
    row = db_utils.query_one(
        _ensure(dsn),
        'SELECT last_heartbeat FROM server_instances WHERE instance_id=?',
        (instance,))
    if row is None or row['last_heartbeat'] is None:
        return None
    return time.time() - row['last_heartbeat']


def is_live(dsn: str, instance: Optional[str],
            ttl_s: Optional[float] = None) -> bool:
    """True if `instance` holds a live lease: it is us, or its
    heartbeat is younger than the TTL."""
    if not instance:
        return False
    if instance == instance_id():
        return True
    ttl = lease_ttl_s() if ttl_s is None else ttl_s
    age = _heartbeat_age(dsn, instance)
    return age is not None and age < ttl


def try_acquire_singleton(dsn: str, name: str) -> bool:
    """Acquire (or re-affirm) the cluster-wide singleton role `name`.

    Exactly-one-holder across every replica sharing the backend: a
    role held by an instance whose lease is LIVE is respected; a dead
    holder's role is taken over through a CAS on the held value, so
    two replicas racing for a dead leader's role produce one winner.
    Used for the jobs/serve controller driver and the background
    daemons — the request queue's per-row claims make dispatch safe,
    but continuously-running controller threads need one owner.
    """
    with _lock:
        if dsn in _withdrawn:
            return False       # departing: never (re)take a role
    mine = instance_id()
    ensure_heartbeat(dsn)
    path = _ensure(dsn)
    row = db_utils.query_one(
        path, 'SELECT instance_id FROM singleton_leases WHERE name=?',
        (name,))
    if row is None:
        db_utils.execute(
            path, 'INSERT INTO singleton_leases (name, instance_id, '
            'acquired_at) VALUES (?,?,?) ON CONFLICT(name) DO NOTHING',
            (name, mine, time.time()))
        row = db_utils.query_one(
            path, 'SELECT instance_id FROM singleton_leases '
            'WHERE name=?', (name,))
    holder = row['instance_id'] if row is not None else None
    if holder == mine:
        acquired = True
    elif holder is not None and is_live(dsn, holder):
        acquired = False
    else:
        # Holder is dead (or vanished): CAS takeover on the held value.
        acquired = db_utils.execute_rowcount(
            path, 'UPDATE singleton_leases SET instance_id=?, '
            'acquired_at=? WHERE name=? AND instance_id IS ?',
            (mine, time.time(), name, holder)) == 1
    if acquired:
        with _lock:
            departed = dsn in _withdrawn
        if departed:
            # withdraw() raced our acquisition: release and refuse —
            # a departing instance must never end up holding the role.
            db_utils.execute(
                path, 'DELETE FROM singleton_leases '
                'WHERE instance_id=?', (mine,))
            return False
    return acquired


def start_heartbeat(dsn: str) -> None:
    """Start the per-process heartbeat daemon thread for `dsn`
    (idempotent).  Dies with the process — which is exactly the signal:
    a crashed server stops beating and its claims become stealable one
    TTL later."""
    with _lock:
        _withdrawn.discard(dsn)    # rejoining after a withdraw
        t = _hb_threads.get(dsn)
        if t is not None and t.is_alive():
            return

        def loop():
            while not _hb_stop.is_set():
                try:
                    heartbeat(dsn)
                    gc_stale_instances(dsn)
                except Exception:  # pylint: disable=broad-except
                    pass           # next tick retries; TTL >> interval
                if _hb_stop.wait(lease_ttl_s() / 3.0):
                    return

        t = threading.Thread(target=loop, name='skytpu-lease-heartbeat',
                             daemon=True)
        _hb_threads[dsn] = t
    t.start()


def _stop_heartbeat_threads() -> None:
    _hb_stop.set()
    with _lock:
        threads = list(_hb_threads.values())
    for t in threads:
        t.join(timeout=2.0)
    _hb_stop.clear()
    with _lock:
        _hb_threads.clear()
        _last_beat.clear()


def withdraw(dsn: str) -> None:
    """Graceful departure: stop heartbeating and DELETE this instance's
    lease rows (heartbeat + any singleton roles it holds).

    Without this, a cleanly replaced pod (RollingUpdate) looks live for
    a full TTL after it exits — its claims cannot be taken over and the
    controller role sits unowned — on every routine deploy.  Crash
    paths never run this, which is exactly right: the TTL is for
    crashes.  The withdrawn-marker comes first: even a heartbeat thread
    that outlives its join timeout (slow DB call in flight) can then
    never re-insert the row we are about to delete."""
    with _lock:
        _withdrawn.add(dsn)
    _stop_heartbeat_threads()
    inst = instance_id()
    try:
        db_utils.execute(
            _ensure(dsn),
            'DELETE FROM singleton_leases WHERE instance_id=?', (inst,))
        db_utils.execute(
            _ensure(dsn),
            'DELETE FROM server_instances WHERE instance_id=?', (inst,))
    except Exception:  # pylint: disable=broad-except
        pass           # best effort: the TTL is the fallback


def stop_heartbeats_for_tests() -> None:
    global _instance, _last_gc
    _stop_heartbeat_threads()
    with _lock:
        _instance = None
        _last_gc = None
        _withdrawn.clear()
