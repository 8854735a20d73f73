"""Postgres state backend (psycopg 3, import-guarded).

Selected when the control-plane DB URL starts with ``postgresql://``
(state.backend_for).  The four state modules keep speaking sqlite SQL;
every statement is translated by state/dialect.py on its way to the
server, and rows come back as :class:`Row` objects that behave like
``sqlite3.Row`` (index access, name access, ``.keys()``) so the
modules cannot tell the backends apart.

psycopg is imported lazily inside the backend: deployments on the
sqlite default (every agent VM, most dev laptops) never pay the import
and never need the dependency installed.  Connections come from a
BOUNDED per-URL pool (size ``SKYTPU_DB_POOL_SIZE``, default 8) rather
than one conn per thread: an N-worker API server — or the fleetsim's
N-virtual-server scenario — otherwise opens one server connection per
thread it ever runs a query on, and Postgres's max_connections is a
fleet-global budget.  Conns are autocommit by default (reads never pin
a transaction open); ``transaction()`` opens an explicit transaction
block so multi-statement read-modify-write sections keep their sqlite
semantics.  A thread re-entering the backend while it holds a pooled
conn (a query inside a ``transaction()`` block) reuses that conn, so
the pool can never self-deadlock on nested use.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.state import dialect

DEFAULT_POOL_SIZE = 8

# Thread-local: the pooled conn this thread currently holds, per URL —
# re-entrant use (query inside transaction()) must reuse it.
_local = threading.local()


class Row:
    """sqlite3.Row-compatible row: ``row[0]``, ``row['col']``,
    ``row.keys()``."""

    __slots__ = ('_cols', '_vals')

    def __init__(self, cols: Sequence[str], vals: Sequence[Any]) -> None:
        self._cols = cols
        self._vals = vals

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._vals[key]
        return self._vals[self._cols.index(key)]

    def keys(self) -> List[str]:
        return list(self._cols)

    def __iter__(self):
        return iter(self._vals)

    def __len__(self) -> int:
        return len(self._vals)

    def __repr__(self) -> str:
        return f'Row({dict(zip(self._cols, self._vals))!r})'


def _row_factory(cursor):
    def make(values):
        cols = [d.name for d in cursor.description] \
            if cursor.description else []
        return Row(cols, values)
    return make


class _Cursor:
    """Cursor facade exposing the sqlite surface the state modules use:
    rowcount, fetchone/fetchall, lastrowid (via lastval())."""

    def __init__(self, pg_cursor, pg_conn) -> None:
        self._cur = pg_cursor
        self._conn = pg_conn

    @property
    def rowcount(self) -> int:
        return self._cur.rowcount

    def fetchone(self) -> Optional[Row]:
        return self._cur.fetchone()

    def fetchall(self) -> List[Row]:
        return self._cur.fetchall()

    @property
    def lastrowid(self) -> int:
        # sqlite's cursor.lastrowid after an identity-column INSERT:
        # lastval() reads the same session's most recent sequence value.
        row = self._conn.execute('SELECT lastval()').fetchone()
        return int(row[0])


class _Conn:
    """Connection facade: translates every statement through the
    dialect before it reaches the server."""

    def __init__(self, pg_conn) -> None:
        self._pg = pg_conn

    def execute(self, sql: str, params: Tuple = ()) -> _Cursor:
        translated = dialect.to_postgres(sql)
        if translated is None:         # PRAGMA etc: no pg counterpart
            return _Cursor(self._pg.execute('SELECT 1'), self._pg)
        return _Cursor(self._pg.execute(translated, params), self._pg)


def pool_size() -> int:
    """Max server connections per URL for THIS process
    (``SKYTPU_DB_POOL_SIZE``): Postgres's max_connections is a
    fleet-global budget, so each API server caps its own draw."""
    try:
        return max(1, int(os.environ.get('SKYTPU_DB_POOL_SIZE',
                                         DEFAULT_POOL_SIZE)))
    except ValueError:
        return DEFAULT_POOL_SIZE


class _Pool:
    """Bounded blocking connection pool for one URL.

    Checkout returns an idle conn (discarding any the server closed)
    or dials a new one while under the cap; at the cap, checkout
    blocks until a conn is returned.  Connect happens OUTSIDE the
    lock so a slow dial never serializes the whole pool."""

    def __init__(self, psycopg_mod, url: str, size: int) -> None:
        self._psycopg = psycopg_mod
        self._url = url
        self.size = size
        self._cond = threading.Condition()
        self._idle: List[Any] = []
        self._total = 0

    def checkout(self):
        with self._cond:
            while True:
                while self._idle:
                    conn = self._idle.pop()
                    if getattr(conn, 'closed', False):
                        self._total -= 1
                        continue
                    return conn
                if self._total < self.size:
                    self._total += 1
                    break
                self._cond.wait()
        try:
            conn = self._psycopg.connect(self._url,
                                         row_factory=_row_factory)
            conn.autocommit = True
        except BaseException:
            with self._cond:
                self._total -= 1
                self._cond.notify()
            raise
        return conn

    def checkin(self, conn) -> None:
        with self._cond:
            if getattr(conn, 'closed', False):
                self._total -= 1
            else:
                self._idle.append(conn)
            self._cond.notify()

    def close_idle(self) -> None:
        with self._cond:
            idle, self._idle = self._idle, []
            self._total -= len(idle)
            self._cond.notify_all()
        for conn in idle:
            with contextlib.suppress(Exception):
                conn.close()


_pools_lock = threading.Lock()
_pools: Dict[str, _Pool] = {}


class PostgresBackend:
    name = 'postgres'

    def __init__(self, url: str) -> None:
        # Import here, not at module top: the sqlite default must work
        # on hosts without psycopg installed (agent VMs, dev machines).
        try:
            import psycopg  # pylint: disable=import-outside-toplevel
        except ImportError as e:
            raise RuntimeError(
                'SKYTPU_DB_URL points at Postgres but psycopg is not '
                'installed; pip install "psycopg[binary]" on the API '
                'server image (agents stay on sqlite and do not need '
                'it)') from e
        self._psycopg = psycopg
        self._url = url

    def _pool(self) -> _Pool:
        with _pools_lock:
            pool = _pools.get(self._url)
            if pool is None:
                pool = _pools[self._url] = _Pool(
                    self._psycopg, self._url, pool_size())
            return pool

    @contextlib.contextmanager
    def _lease(self) -> Iterator[Any]:
        """Borrow a pooled conn for the duration of one operation.

        Re-entrant per thread: an operation issued while this thread
        already holds a conn (query inside a transaction() block) runs
        on the SAME conn — both for sqlite-parity semantics (the read
        sees the open transaction's writes) and so nested use cannot
        deadlock a fully-checked-out pool."""
        held = getattr(_local, 'pg_held', None)
        if held is None:
            held = _local.pg_held = {}
        conn = held.get(self._url)
        if conn is not None and not getattr(conn, 'closed', False):
            yield conn
            return
        pool = self._pool()
        conn = pool.checkout()
        held[self._url] = conn
        try:
            yield conn
        finally:
            del held[self._url]
            pool.checkin(conn)

    # ----- the operation set ----------------------------------------------
    @contextlib.contextmanager
    def transaction(self) -> Iterator[_Conn]:
        with self._lease() as conn:
            with conn.transaction():
                yield _Conn(conn)

    def execute(self, sql: str, params: Tuple = ()) -> None:
        with self.transaction() as conn:
            conn.execute(sql, params)

    def execute_rowcount(self, sql: str, params: Tuple = ()) -> int:
        with self.transaction() as conn:
            return conn.execute(sql, params).rowcount

    def query(self, sql: str, params: Tuple = ()) -> List[Row]:
        with self._lease() as conn:
            return _Conn(conn).execute(sql, params).fetchall()

    def query_one(self, sql: str, params: Tuple = ()) -> Optional[Row]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    # Advisory-lock key serializing schema replay: Postgres's CREATE
    # TABLE IF NOT EXISTS is not concurrency-safe (two sessions racing
    # the same CREATE can abort one with a pg_type duplicate-key error)
    # and N replicas boot simultaneously on first deploy.
    _SCHEMA_LOCK_KEY = 0x5CE7A  # 'SCHEMA', arbitrary but stable

    def ensure_schema(self, ddl: List[str]) -> None:
        # Register first: the upsert rewrite needs every table's PK and
        # column set before any INSERT OR REPLACE translates.
        for stmt in ddl:
            dialect.register_ddl(stmt)
        with self.transaction() as conn:
            # Transaction-scoped advisory lock: released at commit, so
            # concurrent booting replicas replay DDL one at a time.
            conn.execute(
                f'SELECT pg_advisory_xact_lock({self._SCHEMA_LOCK_KEY})')
            for stmt in ddl:
                conn.execute(stmt)


def reset_connections_for_tests() -> None:
    with _pools_lock:
        pools = list(_pools.values())
        _pools.clear()
    for pool in pools:
        pool.close_idle()
    held = getattr(_local, 'pg_held', None)
    if held:
        for conn in held.values():
            with contextlib.suppress(Exception):
                conn.close()
        held.clear()
