"""Small shared helpers: ids, user, yaml io, retries, humanized output."""
from __future__ import annotations

import functools
import getpass
import hashlib
import json
import os
import re
import time
import uuid
from typing import Any, Callable, Dict, Optional, TypeVar

import yaml

T = TypeVar('T')

USER_HASH_LENGTH = 8


def _user_hash_file() -> str:
    # Expanded at call time so tests that monkeypatch $HOME stay isolated.
    return os.path.expanduser('~/.skytpu/user_hash')
CLUSTER_NAME_VALID_REGEX = re.compile(r'^[a-zA-Z]([-_.a-zA-Z0-9]*[a-zA-Z0-9])?$')


def get_user_hash() -> str:
    """Stable per-user hash used to namespace cluster names on the cloud."""
    env = os.environ.get('SKYTPU_USER_HASH')
    if env:
        return env[:USER_HASH_LENGTH]
    path = _user_hash_file()
    try:
        if os.path.exists(path):
            with open(path, encoding='utf-8') as f:
                h = f.read().strip()
                if h:
                    return h[:USER_HASH_LENGTH]
    except OSError:
        pass
    h = hashlib.md5(uuid.uuid4().bytes).hexdigest()[:USER_HASH_LENGTH]
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w', encoding='utf-8') as f:
            f.write(h)
    except OSError:
        pass
    return h


def get_user_name() -> str:
    try:
        return getpass.getuser()
    except Exception:  # pylint: disable=broad-except
        return 'unknown'


def find_free_port() -> int:
    """An OS-assigned free TCP port (racy by nature; callers bind fast)."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def generate_id(prefix: str = '', length: int = 8) -> str:
    suffix = uuid.uuid4().hex[:length]
    return f'{prefix}{suffix}' if prefix else suffix


def validate_cluster_name(name: str) -> None:
    from skypilot_tpu_torch import exceptions  # avoid cycle
    if not name or not CLUSTER_NAME_VALID_REGEX.match(name):
        raise exceptions.InvalidTaskError(
            f'Invalid cluster name {name!r}: must match '
            f'{CLUSTER_NAME_VALID_REGEX.pattern}')


def read_yaml(path: str) -> Dict[str, Any]:
    with open(os.path.expanduser(path), encoding='utf-8') as f:
        return yaml.safe_load(f) or {}


def read_yaml_all(path: str) -> list:
    with open(os.path.expanduser(path), encoding='utf-8') as f:
        return [c for c in yaml.safe_load_all(f) if c is not None]


def dump_yaml(path: str, config: Any) -> None:
    os.makedirs(os.path.dirname(os.path.expanduser(path)) or '.',
                exist_ok=True)
    with open(os.path.expanduser(path), 'w', encoding='utf-8') as f:
        yaml.safe_dump(config, f, default_flow_style=False, sort_keys=False)


def dump_yaml_str(config: Any) -> str:
    return yaml.safe_dump(config, default_flow_style=False, sort_keys=False)


def json_dumps_compact(obj: Any) -> str:
    return json.dumps(obj, separators=(',', ':'), default=str)


def retry(max_retries: int = 3,
          initial_backoff: float = 1.0,
          max_backoff: float = 30.0,
          exceptions_to_retry: tuple = (Exception,)) -> Callable:
    """Exponential-backoff retry decorator for cloud API calls."""

    def decorator(fn: Callable[..., T]) -> Callable[..., T]:

        @functools.wraps(fn)
        def wrapper(*args, **kwargs) -> T:
            backoff = initial_backoff
            for attempt in range(max_retries):
                try:
                    return fn(*args, **kwargs)
                except exceptions_to_retry:
                    if attempt == max_retries - 1:
                        raise
                    time.sleep(backoff)
                    backoff = min(backoff * 2, max_backoff)
            raise RuntimeError('unreachable')

        return wrapper

    return decorator


def format_float(x: Optional[float], precision: int = 2) -> str:
    if x is None:
        return '-'
    if x >= 1000:
        return f'{x:,.0f}'
    return f'{x:.{precision}f}'


def readable_time_duration(seconds: float) -> str:
    seconds = int(seconds)
    if seconds < 60:
        return f'{seconds}s'
    mins, secs = divmod(seconds, 60)
    if mins < 60:
        return f'{mins}m {secs}s'
    hours, mins = divmod(mins, 60)
    if hours < 24:
        return f'{hours}h {mins}m'
    days, hours = divmod(hours, 24)
    return f'{days}d {hours}h'


class Backoff:
    """Stateful exponential backoff with cap (hot loops: SSH wait, op poll)."""

    def __init__(self, initial: float = 1.0, factor: float = 1.6,
                 cap: float = 30.0) -> None:
        self._current = initial
        self._factor = factor
        self._cap = cap

    def current_backoff(self) -> float:
        cur = self._current
        self._current = min(self._current * self._factor, self._cap)
        return cur
