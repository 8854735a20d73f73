"""Lazy AWS SDK adaptor (parity: sky/adaptors/aws.py).

boto3 imports cost ~0.5s and the SDK may be absent entirely (this build
is TPU-first; AWS is the second substrate, used for controllers, CPU
tasks and S3 storage).  Everything AWS-shaped goes through here so the
import happens once, lazily, with a clear error when missing.  Sessions
are cached per (profile, region): boto3 sessions are not thread-safe to
CREATE concurrently, but cached ones are safe to share for clients.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from skypilot_tpu_torch import exceptions

_lock = threading.Lock()
_sessions: Dict[tuple, Any] = {}
_clients: Dict[tuple, Any] = {}


def boto3():
    try:
        import boto3 as boto3_lib  # pylint: disable=import-outside-toplevel
        return boto3_lib
    except ImportError as e:
        raise exceptions.ProvisionError(
            'boto3 is required for real AWS operations but is not '
            'installed (`pip install boto3`).  Tests and dryruns use the '
            'fake endpoints (SKYTPU_EC2_API_ENDPOINT / '
            'SKYTPU_FAKE_S3_ROOT) and do not need it.') from e


def _session_locked(region: Optional[str]):
    """Caller must hold _lock."""
    key = (None, region)
    if key not in _sessions:
        _sessions[key] = boto3().session.Session(region_name=region)
    return _sessions[key]


def session(region: Optional[str] = None):
    with _lock:
        return _session_locked(region)


def client(service: str, region: Optional[str] = None):
    """Cached per (service, region), CREATED under the lock: boto3
    sessions are not thread-safe to create clients from concurrently
    (botocore's loader/credential-resolver race); the finished client
    objects are thread-safe to share."""
    key = (service, region)
    with _lock:
        if key not in _clients:
            _clients[key] = _session_locked(region).client(service)
        return _clients[key]


def resource(service: str, region: Optional[str] = None):
    """A FRESH resource per call (created under the lock): boto3
    documents resources — unlike clients — as not safe to share across
    threads."""
    with _lock:
        return _session_locked(region).resource(service)


def reset_cache_for_tests() -> None:
    with _lock:
        _sessions.clear()
        _clients.clear()
