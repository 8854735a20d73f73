"""Chrome-trace timeline tracing (parity: sky/utils/timeline.py:85).

`@timeline.event('name')` / `with timeline.Event('name'):` record B/E
event pairs.  Tracing is off unless SKYTPU_TIMELINE_FILE points at a
path; events append there as JSON lines and `dump()` (also registered
atexit) wraps them into the Chrome trace-event array format, loadable in
chrome://tracing or Perfetto.

Applied on the hot control-plane paths: execution.launch stages, the
provision dispatch API, and failover attempts — the places where "why
did launch take 90 seconds" gets answered.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_registered = False
# Stable per-thread sequential track ids, held in thread-local storage.
# (Perfetto tracks key on tid; hashing/truncating threading.get_ident()
# — whose values the OS reuses and which collide under any modulus —
# can merge two threads' events into one garbled track.  TLS dies with
# its thread, so even ident REUSE cannot alias two threads.)
_tid_counter = 0
_tid_gen = 0          # bumped by reset_for_tests: invalidates old ids
_tls = threading.local()


def _tid() -> int:
    global _tid_counter
    rec = getattr(_tls, 'rec', None)
    if rec is None or rec[0] != _tid_gen:
        with _lock:
            rec = (_tid_gen, _tid_counter)
            _tid_counter += 1
        _tls.rec = rec
    return rec[1]


def enabled() -> bool:
    return bool(os.environ.get('SKYTPU_TIMELINE_FILE'))


def _record(name: str, phase: str, args: Optional[dict] = None) -> None:
    evt = {
        'name': name,
        'ph': phase,
        'ts': time.time() * 1e6,            # microseconds
        'pid': os.getpid(),
        'tid': _tid(),
    }
    if args:
        evt['args'] = args
    global _registered
    with _lock:
        _events.append(evt)
        if not _registered:
            atexit.register(dump)
            _registered = True


class Event(contextlib.AbstractContextManager):
    """Duration event: records B at enter, E at exit."""

    def __init__(self, name: str, **args: Any) -> None:
        self.name = name
        self.args = args

    def __enter__(self):
        if enabled():
            _record(self.name, 'B', self.args or None)
        return self

    def __exit__(self, exc_type, exc, tb):
        if enabled():
            _record(self.name, 'E',
                    {'error': repr(exc)} if exc is not None else None)
        return False


def event(name_or_fn=None, name: Optional[str] = None):
    """Decorator: wrap the function in an Event.  Usable bare
    (@timeline.event) or with a name (@timeline.event('provision'))."""
    def make(fn: Callable, evt_name: str) -> Callable:
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not enabled():
                return fn(*a, **kw)
            with Event(evt_name):
                return fn(*a, **kw)
        return wrapper

    if callable(name_or_fn):
        return make(name_or_fn, name_or_fn.__qualname__)
    evt_name = name_or_fn or name
    return lambda fn: make(fn, evt_name or fn.__qualname__)


def instant(name: str, **args: Any) -> None:
    """Zero-duration marker."""
    if enabled():
        evt_args = args or None
        _record(name, 'i', evt_args)


def trace_document(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wrap trace events into the Chrome trace-event document format
    (loadable in chrome://tracing and Perfetto).  Shared by dump() and
    the flight recorder's Chrome export (server/tracing.py), so every
    trace this system emits opens in the same tooling."""
    return {'traceEvents': list(events), 'displayTimeUnit': 'ms'}


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write accumulated events as a Chrome trace file; returns the path
    (None if tracing disabled and no explicit path given)."""
    path = path or os.environ.get('SKYTPU_TIMELINE_FILE')
    if not path:
        return None
    with _lock:
        events = list(_events)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(trace_document(events), f)
    return path


def reset_for_tests() -> None:
    global _tid_counter, _tid_gen
    with _lock:
        _events.clear()
        _tid_gen += 1     # live threads' cached ids become stale
        _tid_counter = 0
