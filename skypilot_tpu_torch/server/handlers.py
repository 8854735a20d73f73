"""LONG-request handlers, runnable in a per-request worker process.

The reference executes every request in its own worker process
(sky/server/requests/process.py:16) so a hung provision can be killed
without poisoning a thread pool, and `POST /requests/{id}/cancel` is a
SIGTERM, not a cooperative flag nobody checks.  All state these handlers
touch lives in sqlite (cluster DB, requests DB, file locks), so a killed
worker leaks nothing in-process: OS-level file locks release on exit and
the cluster record stays reattachable.

Handlers take the validated request body and return a JSON-able result.
They are addressed BY NAME (module-level, picklable) from the executor.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

from skypilot_tpu_torch.server import requests_db
from skypilot_tpu_torch.server.requests_db import RequestStatus


def _launch(body: Dict[str, Any]) -> Dict[str, Any]:
    from skypilot_tpu_torch import execution
    from skypilot_tpu_torch import task as task_lib
    task = task_lib.Task.from_yaml_config(body['task'])
    job_id, handle = execution.launch(
        task, body.get('cluster_name'), detach_run=True,
        quiet_optimizer=True, dryrun=body.get('dryrun', False),
        retry_until_up=bool(body.get('retry_until_up', False)))
    return {'job_id': job_id,
            'cluster_name': handle.cluster_name if handle else None}


def _exec(body: Dict[str, Any]) -> Dict[str, Any]:
    from skypilot_tpu_torch import execution
    from skypilot_tpu_torch import task as task_lib
    task = task_lib.Task.from_yaml_config(body['task'])
    job_id, handle = execution.exec_(task, body['cluster_name'],
                                     detach_run=True)
    return {'job_id': job_id, 'cluster_name': handle.cluster_name}


def _down(body: Dict[str, Any]) -> Dict[str, Any]:
    from skypilot_tpu_torch import core
    core.down(body['cluster_name'])
    return {'down': body['cluster_name']}


def _stop(body: Dict[str, Any]) -> Dict[str, Any]:
    from skypilot_tpu_torch import core
    core.stop(body['cluster_name'])
    return {'stop': body['cluster_name']}


def _start(body: Dict[str, Any]) -> Dict[str, Any]:
    from skypilot_tpu_torch import core
    core.start(body['cluster_name'])
    return {'start': body['cluster_name']}


HANDLERS: Dict[str, Callable[[Dict[str, Any]], Any]] = {
    'launch': _launch,
    'exec': _exec,
    'down': _down,
    'stop': _stop,
    'start': _start,
}


def run_request(request_id: str, name: str, body: Dict[str, Any]) -> None:
    """Worker-process entry point: execute and record to the requests DB.
    Exit code is irrelevant — the DB row is the result channel."""
    # Re-create the caller's identity in this fresh process (the route
    # injected it; env is private to this per-request worker).
    user = body.pop('_user', None)
    workspace = body.pop('_workspace', None)
    if user:
        os.environ['SKYTPU_USER'] = user
    if workspace:
        os.environ['SKYTPU_WORKSPACE'] = workspace
    requests_db.set_status(request_id, RequestStatus.RUNNING,
                           pid=os.getpid())
    try:
        result = HANDLERS[name](body)
        requests_db.set_status(request_id, RequestStatus.SUCCEEDED,
                               result=result)
    except BaseException as e:  # pylint: disable=broad-except
        import traceback
        requests_db.set_status(
            request_id, RequestStatus.FAILED,
            error=f'{type(e).__name__}: {e}\n{traceback.format_exc()}')
    finally:
        # Peak RSS of this worker process: the capacity signal for
        # sizing API hosts (ref: sky/server/requests/executor.py:570).
        try:
            import resource
            import sys
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            if sys.platform == 'darwin':
                rss //= 1024      # macOS reports bytes, Linux KB
            requests_db.record_peak_rss(request_id, rss)
        except Exception:  # pylint: disable=broad-except
            pass
