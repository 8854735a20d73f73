"""The ONE database access layer (skytpu check: db-discipline).

Callers pass a DSN — a sqlite file path (default) or a
``postgresql://`` URL — and this module dispatches to the matching
backend in skypilot_tpu/state/ (sqlite: per-thread conns + WAL;
Postgres: psycopg with sqlite-dialect translation).  The operation set
is unchanged from the sqlite-only era, so the state modules are
backend-blind:

- ``transaction(dsn)`` — multi-statement atomic section;
- ``execute`` / ``execute_rowcount`` — the latter is the
  compare-and-swap primitive (UPDATE ... WHERE <expected old value>);
- ``query`` / ``query_one``;
- ``ensure_schema`` — idempotent DDL replay (ADD COLUMN re-runs are
  detected by catalog introspection, not error-string matching).

Every operation is timed into ``skytpu_db_op_seconds`` and failures
counted in ``skytpu_db_op_errors_total``, labeled
``backend=sqlite|postgres`` — the first signal that a control plane is
outgrowing its single sqlite writer is this histogram's tail.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, List, Optional, Set, Tuple

from skypilot_tpu_torch import state
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.state import control_plane_dsn  # noqa: F401  (re-export)

# ensure_schema is called by every state module before every operation
# (the _ensure() idiom).  Replaying DDL per sqlite op is microseconds;
# on Postgres it would be ~10 network round-trips plus a fleet-global
# advisory lock PER OPERATION — so a (dsn, ddl) pair replays once per
# process and is a no-op after.
_ensured_lock = threading.Lock()
_ensured: Set[Tuple[str, Tuple[str, ...]]] = set()


def _backend_label(dsn: str) -> str:
    return 'postgres' if state.is_postgres_dsn(dsn) else 'sqlite'


@contextlib.contextmanager
def _timed(op: str, dsn: str) -> Iterator[None]:
    backend = _backend_label(dsn)
    t0 = time.perf_counter()
    try:
        yield
    except Exception:
        metrics_lib.inc_counter('skytpu_db_op_errors_total',
                                backend=backend, op=op)
        raise
    finally:
        metrics_lib.observe_hist('skytpu_db_op_seconds',
                                 time.perf_counter() - t0,
                                 backend=backend, op=op)


@contextlib.contextmanager
def transaction(dsn: str) -> Iterator[Any]:
    # Timed as one op: the caller's whole atomic section IS the write
    # the DB serializes (sqlite: the writer lock window).
    with _timed('transaction', dsn):
        with state.backend_for(dsn).transaction() as conn:
            yield conn


def execute(dsn: str, sql: str, params: Tuple = ()) -> None:
    with _timed('execute', dsn):
        state.backend_for(dsn).execute(sql, params)


def execute_rowcount(dsn: str, sql: str, params: Tuple = ()) -> int:
    """Execute and return the affected-row count — the primitive for
    compare-and-swap claims (UPDATE ... WHERE <expected old value>)."""
    with _timed('execute', dsn):
        return state.backend_for(dsn).execute_rowcount(sql, params)


def query(dsn: str, sql: str, params: Tuple = ()) -> List[Any]:
    with _timed('query', dsn):
        return state.backend_for(dsn).query(sql, params)


def query_one(dsn: str, sql: str, params: Tuple = ()) -> Optional[Any]:
    with _timed('query', dsn):
        return state.backend_for(dsn).query_one(sql, params)


def ensure_schema(dsn: str, ddl: List[str]) -> None:
    key = (dsn, tuple(ddl))
    with _ensured_lock:
        if key in _ensured:
            return
    with _timed('ensure_schema', dsn):
        state.backend_for(dsn).ensure_schema(ddl)
    with _ensured_lock:
        _ensured.add(key)


def reset_connections_for_tests() -> None:
    state.reset_connections_for_tests()
    with _ensured_lock:
        _ensured.clear()
