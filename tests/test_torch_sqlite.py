"""The port's sqlite store opens one fresh database from many processes at
once without `database is locked`: its switch to WAL is retried within
the connection's timeout (the JAX package's `_connect` raises there).
Any other error still raises, and so does a lock held past the timeout.
"""
import os
import sqlite3
import subprocess
import sys
import time

import pytest

from skypilot_tpu_torch.state import sqlite as sqlite_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each process opens database r of the directory at t0 + r * dt, all
# processes together, creates its table and writes a row; it prints how
# many rounds raised and the first errors.
_OPENER = r'''
import os, sys, time
from skypilot_tpu_torch.state.sqlite import SqliteBackend
directory, t0, rounds, dt = (sys.argv[1], float(sys.argv[2]),
                             int(sys.argv[3]), float(sys.argv[4]))
errors = []
for r in range(rounds):
    while time.time() < t0 + r * dt:
        pass
    try:
        db = SqliteBackend(os.path.join(directory, f'db{r}.db'))
        db.ensure_schema(['CREATE TABLE IF NOT EXISTS t '
                          '(k TEXT PRIMARY KEY, v INTEGER)'])
        db.execute('INSERT OR REPLACE INTO t VALUES (?, ?)',
                   (str(os.getpid()), r))
    except Exception as e:
        errors.append(f'round {r}: {type(e).__name__}: {e}')
print(len(errors), errors[:3])
'''


def test_fresh_database_opened_by_many_processes_at_once(tmp_path):
    n_procs, rounds, dt = 8, 20, 0.05
    t0 = time.time() + 2.0
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, '-c', _OPENER, str(tmp_path), str(t0), str(rounds),
         str(dt)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(n_procs)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * n_procs, outs
    assert [out.split(' ', 1)[0] for out, _ in outs] == ['0'] * n_procs, outs
    for r in range(rounds):
        rows = sqlite_state.SqliteBackend(
            str(tmp_path / f'db{r}.db')).query('SELECT v FROM t')
        assert [row['v'] for row in rows] == [r] * n_procs


class _Conn:
    """A connection whose WAL pragma raises `error` `times` times."""

    def __init__(self, error, times):
        self.error, self.times, self.calls = error, times, 0

    def execute(self, sql):
        assert sql == 'PRAGMA journal_mode=WAL'
        self.calls += 1
        if self.calls <= self.times:
            raise self.error


def test_wal_switch_retries_only_a_lock_and_only_until_the_timeout(
        monkeypatch):
    locked = sqlite3.OperationalError('database is locked')
    conn = _Conn(locked, 3)
    sqlite_state._enable_wal(conn)  # pylint: disable=protected-access
    assert conn.calls == 4
    other = sqlite3.OperationalError('disk I/O error')
    conn = _Conn(other, 1)
    with pytest.raises(sqlite3.OperationalError, match='disk I/O'):
        sqlite_state._enable_wal(conn)  # pylint: disable=protected-access
    assert conn.calls == 1
    monkeypatch.setattr(sqlite_state, '_TIMEOUT_S', 0.2)
    conn = _Conn(locked, 10**9)
    t0 = time.monotonic()
    with pytest.raises(sqlite3.OperationalError, match='locked'):
        sqlite_state._enable_wal(conn)  # pylint: disable=protected-access
    assert 0.2 <= time.monotonic() - t0 < 5
