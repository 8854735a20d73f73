"""Sqlite state backend: per-path-per-thread connection cache, WAL,
dict rows — the default (and the only option for agent-side VM-local
DBs, which never leave their host).

This is the former utils/db_utils.py connection layer moved behind the
StateBackend interface so Postgres can be selected by URL.  One
behavioral fix rides along: ``ensure_schema`` decides ADD COLUMN
idempotency by PRAGMA table_info introspection, not by matching
sqlite's 'duplicate column' error string (which is dialect- and
locale-fragile, and was the one sqlite-ism in the old funnel that
could not translate).

Counterpart of `skypilot_tpu/state/sqlite.py`: the same backend, but
`_connect` survives `database is locked` on the switch to WAL.  Turning
WAL on takes an exclusive lock, and sqlite answers a connection that
asks for it while another process opens the same fresh file with
SQLITE_BUSY without calling its busy handler, so the connection's 30 s
timeout does not cover it: the JAX module raises there.  This one retries
the pragma until that timeout runs out; any other error still raises.
"""
from __future__ import annotations

import contextlib
import os
import re
import sqlite3
import threading
import time
from typing import Iterator, List, Optional, Tuple

_local = threading.local()

# The connection's busy timeout, which also bounds the WAL switch's
# retries.
_TIMEOUT_S = 30.0

_ALTER_ADD_RE = re.compile(
    r'ALTER\s+TABLE\s+(\w+)\s+ADD\s+COLUMN\s+(\w+)', re.IGNORECASE)


class SqliteBackend:
    name = 'sqlite'

    def __init__(self, path: str) -> None:
        self._path = path

    # ----- connection management -----------------------------------------
    def _connect(self) -> sqlite3.Connection:
        conns = getattr(_local, 'conns', None)
        if conns is None:
            conns = _local.conns = {}
        conn = conns.get(self._path)
        if conn is None:
            os.makedirs(os.path.dirname(self._path) or '.', exist_ok=True)
            conn = sqlite3.connect(self._path, timeout=_TIMEOUT_S)
            conn.row_factory = sqlite3.Row
            _enable_wal(conn)
            conn.execute('PRAGMA synchronous=NORMAL')
            conns[self._path] = conn
        return conn

    # ----- the operation set ----------------------------------------------
    @contextlib.contextmanager
    def transaction(self) -> Iterator[sqlite3.Connection]:
        conn = self._connect()
        try:
            yield conn
            conn.commit()
        except Exception:
            conn.rollback()
            raise

    def execute(self, sql: str, params: Tuple = ()) -> None:
        with self.transaction() as conn:
            conn.execute(sql, params)

    def execute_rowcount(self, sql: str, params: Tuple = ()) -> int:
        with self.transaction() as conn:
            return conn.execute(sql, params).rowcount

    def query(self, sql: str, params: Tuple = ()) -> List[sqlite3.Row]:
        return self._connect().execute(sql, params).fetchall()

    def query_one(self, sql: str,
                  params: Tuple = ()) -> Optional[sqlite3.Row]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    def ensure_schema(self, ddl: List[str]) -> None:
        with self.transaction() as conn:
            for stmt in ddl:
                m = _ALTER_ADD_RE.match(stmt.strip())
                if m is not None:
                    # Idempotent migrations: ADD COLUMN re-runs on every
                    # startup; skip columns the catalog already has.
                    cols = {
                        r[1]
                        for r in conn.execute(
                            f'PRAGMA table_info({m.group(1)})')
                    }
                    if m.group(2) in cols:
                        continue
                conn.execute(stmt)


def _enable_wal(conn: sqlite3.Connection) -> None:
    """PRAGMA journal_mode=WAL, retried while another connection holds
    the lock it needs (see the module docstring), up to _TIMEOUT_S."""
    deadline = time.monotonic() + _TIMEOUT_S
    while True:
        try:
            conn.execute('PRAGMA journal_mode=WAL')
            return
        except sqlite3.OperationalError as e:
            if ('database is locked' not in str(e) or
                    time.monotonic() > deadline):
                raise
        time.sleep(0.01)


def reset_connections_for_tests() -> None:
    conns = getattr(_local, 'conns', None)
    if conns:
        for conn in conns.values():
            with contextlib.suppress(Exception):
                conn.close()
        conns.clear()
