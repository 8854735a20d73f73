"""sqlite → Postgres SQL translation for the state-store funnel.

The four control-plane state modules (global_user_state, jobs/state,
serve/serve_state, server/requests_db) are written against sqlite SQL.
Rather than fork every statement per backend, this module translates
the sqlite dialect they speak into Postgres at execute time:

- ``?`` placeholders → ``%s`` (outside string literals; literal ``%``
  is doubled for psycopg's parser);
- ``expr IS ?`` (sqlite's NULL-safe equality against a parameter, the
  CAS guard in requests_db.try_claim) → ``expr IS NOT DISTINCT FROM %s``;
- ``INTEGER PRIMARY KEY AUTOINCREMENT`` → identity column;
- ``REAL`` → ``DOUBLE PRECISION`` (float4 would round unix timestamps
  to whole seconds — claim/lease ordering needs the fraction);
- ``ALTER TABLE .. ADD COLUMN`` → ``ADD COLUMN IF NOT EXISTS`` (the
  catalog-native idempotency; the sqlite backend gets the same property
  from PRAGMA introspection in state/sqlite.py);
- ``INSERT OR REPLACE`` → ``INSERT .. ON CONFLICT (<pk>) DO UPDATE``
  with REPLACE-faithful semantics: listed columns take EXCLUDED values,
  unlisted non-PK columns reset to their DDL DEFAULT, exactly like
  sqlite's delete-and-reinsert.

The upsert rewrite needs each table's primary key and full column set;
``register_ddl`` harvests both from the modules' own DDL (CREATE TABLE
+ ALTER TABLE ADD COLUMN), which every module replays through
``ensure_schema`` before issuing statements.  All functions are pure
string → string so the golden tests in tests/test_state_backend.py run
everywhere, with or without a live Postgres.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

_lock = threading.Lock()


class TableInfo:
    def __init__(self) -> None:
        self.pk: Tuple[str, ...] = ()
        # ordered column names (PK included)
        self.columns: List[str] = []


# table name -> TableInfo, harvested from DDL via register_ddl().
_TABLES: Dict[str, TableInfo] = {}

_CREATE_RE = re.compile(
    r'CREATE\s+TABLE\s+(?:IF\s+NOT\s+EXISTS\s+)?(\w+)\s*\((.*)\)\s*$',
    re.IGNORECASE | re.DOTALL)
_ALTER_ADD_RE = re.compile(
    r'ALTER\s+TABLE\s+(\w+)\s+ADD\s+COLUMN\s+(?:IF\s+NOT\s+EXISTS\s+)?'
    r'(\w+)', re.IGNORECASE)
_TABLE_PK_RE = re.compile(r'^PRIMARY\s+KEY\s*\(([^)]*)\)\s*$',
                          re.IGNORECASE)


def _split_columns(body: str) -> List[str]:
    """Split a CREATE TABLE body on top-level commas (commas inside
    parens — composite PRIMARY KEY (a, b) — do not split)."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == '(':
            depth += 1
        elif ch == ')':
            depth -= 1
        if ch == ',' and depth == 0:
            parts.append(''.join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = ''.join(cur).strip()
    if tail:
        parts.append(tail)
    return parts


def register_ddl(stmt: str) -> None:
    """Harvest table metadata (PK, column set) from one DDL statement.

    Called for every ensure_schema statement on the Postgres path, so
    the upsert rewrite always has the table's shape by the time any
    INSERT OR REPLACE runs (modules _ensure() before every operation).
    """
    m = _CREATE_RE.match(stmt.strip())
    if m is not None:
        name = m.group(1).lower()
        with _lock:
            info = _TABLES.setdefault(name, TableInfo())
            for part in _split_columns(m.group(2)):
                pk_m = _TABLE_PK_RE.match(part)
                if pk_m is not None:
                    info.pk = tuple(c.strip().lower()
                                    for c in pk_m.group(1).split(','))
                    continue
                first = part.split()[0].lower() if part.split() else ''
                if not first or first in ('unique', 'check', 'foreign',
                                          'constraint'):
                    continue
                if first not in info.columns:
                    info.columns.append(first)
                if re.search(r'\bPRIMARY\s+KEY\b', part,
                             re.IGNORECASE) and not info.pk:
                    info.pk = (first,)
        return
    m = _ALTER_ADD_RE.match(stmt.strip())
    if m is not None:
        name, col = m.group(1).lower(), m.group(2).lower()
        with _lock:
            info = _TABLES.setdefault(name, TableInfo())
            if col not in info.columns:
                info.columns.append(col)


def table_info(name: str) -> Optional[TableInfo]:
    with _lock:
        return _TABLES.get(name.lower())


def _convert_placeholders(sql: str) -> str:
    """``?`` → ``%s`` outside string literals; double literal ``%``
    (psycopg parses %-placeholders client-side)."""
    out: List[str] = []
    in_str: Optional[str] = None
    for ch in sql:
        if ch == '%':
            # psycopg's placeholder scanner sees the WHOLE query text,
            # string literals included — every literal % doubles.
            out.append('%%')
            continue
        if in_str is not None:
            out.append(ch)
            if ch == in_str:
                in_str = None
        elif ch in ('\'', '"'):
            in_str = ch
            out.append(ch)
        elif ch == '?':
            out.append('%s')
        else:
            out.append(ch)
    return ''.join(out)


_INSERT_OR_REPLACE_RE = re.compile(
    r'^\s*INSERT\s+OR\s+REPLACE\s+INTO\s+(\w+)\s*\(([^)]*)\)', re.IGNORECASE)


def _rewrite_upsert(sql: str) -> str:
    """INSERT OR REPLACE → ON CONFLICT upsert with REPLACE semantics."""
    m = _INSERT_OR_REPLACE_RE.match(sql)
    if m is None:
        return sql
    table = m.group(1)
    info = table_info(table)
    if info is None or not info.pk:
        raise ValueError(
            f'cannot translate INSERT OR REPLACE for table {table!r}: '
            f'its DDL was never registered (ensure_schema must run '
            f'before data statements)')
    listed = [c.strip().lower() for c in m.group(2).split(',')]
    sets = []
    for col in info.columns:
        if col in info.pk:
            continue
        if col in listed:
            sets.append(f'{col}=EXCLUDED.{col}')
        else:
            # sqlite REPLACE deletes + reinserts: unlisted columns fall
            # back to their DDL default.  SET col=DEFAULT reproduces it.
            sets.append(f'{col}=DEFAULT')
    head = re.sub(r'^(\s*)INSERT\s+OR\s+REPLACE\b', r'\1INSERT', sql,
                  count=1, flags=re.IGNORECASE)
    conflict = (f' ON CONFLICT ({", ".join(info.pk)}) '
                f'DO UPDATE SET {", ".join(sets)}')
    return head + conflict


def to_postgres(sql: str) -> Optional[str]:
    """Translate one sqlite statement to Postgres.

    Returns None for statements that have no Postgres counterpart and
    should be skipped (PRAGMA).
    """
    stripped = sql.strip()
    if stripped.upper().startswith('PRAGMA'):
        return None
    out = sql
    # DDL type/keyword rewrites (harmless no-ops on DML: the bare words
    # only appear in DDL in this codebase).
    out = re.sub(r'\bINTEGER\s+PRIMARY\s+KEY\s+AUTOINCREMENT\b',
                 'BIGINT GENERATED BY DEFAULT AS IDENTITY PRIMARY KEY',
                 out, flags=re.IGNORECASE)
    out = re.sub(r'\bREAL\b', 'DOUBLE PRECISION', out)
    out = re.sub(r'\b(ALTER\s+TABLE\s+\w+\s+ADD\s+COLUMN)\s+'
                 r'(?!IF\s+NOT\s+EXISTS)',
                 r'\1 IF NOT EXISTS ', out, flags=re.IGNORECASE)
    # NULL-safe parameter equality (the claim CAS guard).
    out = re.sub(r'\bIS\s+\?', 'IS NOT DISTINCT FROM ?', out,
                 flags=re.IGNORECASE)
    out = _rewrite_upsert(out)
    return _convert_placeholders(out)


def reset_for_tests() -> None:
    with _lock:
        _TABLES.clear()
