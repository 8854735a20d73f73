"""Python SDK speaking REST to the API server (parity: sky/client/sdk.py).

Every mutating call returns a request id; `get(request_id)` blocks until
completion (the reference's `stream_and_get`).  If no server is reachable
the SDK auto-starts one locally (the reference does the same on first use).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import requests as requests_lib

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.server.constants import (API_VERSION,
                                                 API_VERSION_HEADER,
                                                 MIN_COMPATIBLE_API_VERSION)

DEFAULT_SERVER = 'http://127.0.0.1:8700'


def server_url() -> str:
    return os.environ.get('SKYTPU_API_SERVER', DEFAULT_SERVER).rstrip('/')


def request_headers() -> Dict[str, str]:
    """Auth + API-version + identity headers on every SDK call (shared
    with the async SDK).  The server acts as this user in this
    workspace (skypilot_tpu_torch/users.py, workspaces.py)."""
    from skypilot_tpu_torch import users as users_lib
    from skypilot_tpu_torch import workspaces as workspaces_lib
    from skypilot_tpu_torch.server.constants import (USER_HEADER,
                                                     WORKSPACE_HEADER)
    from skypilot_tpu_torch.utils import auth
    headers = {API_VERSION_HEADER: str(API_VERSION)}
    token = auth.get_auth_token()
    if token:
        headers['Authorization'] = f'Bearer {token}'
    headers[USER_HEADER] = users_lib.current_user().name
    headers[WORKSPACE_HEADER] = workspaces_lib.active_workspace()
    return headers


def check_server_compat(info: Dict[str, Any]) -> None:
    """Two-way handshake: refuse servers older than this client still
    understands (the server rejects too-old clients with 426)."""
    server_version = info.get('api_version')
    if server_version is not None and \
            int(server_version) < MIN_COMPATIBLE_API_VERSION:
        raise exceptions.ApiVersionMismatchError(
            f'API server {server_url()} speaks version {server_version}, '
            f'older than the oldest this client supports '
            f'({MIN_COMPATIBLE_API_VERSION}); upgrade the server.')


def api_info(timeout: float = 2.0) -> Optional[Dict[str, Any]]:
    try:
        resp = requests_lib.get(f'{server_url()}/api/health',
                                timeout=timeout)
        return resp.json()
    except requests_lib.RequestException:
        return None


def ensure_server_running(timeout_s: float = 30.0) -> None:
    info = api_info()
    if info is not None:
        check_server_compat(info)
        return
    url = server_url()
    if '127.0.0.1' not in url and 'localhost' not in url:
        raise exceptions.ApiServerError(
            f'API server {url} unreachable and not local — cannot '
            'auto-start it.')
    port = url.rsplit(':', 1)[-1]
    env = dict(os.environ)
    import skypilot_tpu_torch
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(skypilot_tpu_torch.__file__)))
    env['PYTHONPATH'] = (pkg_parent + os.pathsep +
                         env.get('PYTHONPATH', '')).rstrip(os.pathsep)
    subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.server.app', '--port', port],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        info = api_info()
        if info is not None:
            check_server_compat(info)
            return
        time.sleep(0.5)
    raise exceptions.ApiServerError('API server failed to start.')


def _post(path: str, body: Dict[str, Any]) -> Dict[str, Any]:
    ensure_server_running()
    resp = requests_lib.post(f'{server_url()}{path}', json=body,
                             headers=request_headers(), timeout=60)
    if resp.status_code >= 400:
        raise exceptions.ApiServerError(
            f'{path} failed ({resp.status_code}): {resp.text}')
    return resp.json()


def _get(path: str, **params) -> Any:
    ensure_server_running()
    resp = requests_lib.get(f'{server_url()}{path}', params=params,
                            headers=request_headers(), timeout=60)
    if resp.status_code >= 400:
        raise exceptions.ApiServerError(
            f'{path} failed ({resp.status_code}): {resp.text}')
    return resp.json()


def get(request_id: str, timeout_s: float = 3600.0) -> Any:
    """Block until the request finishes; return its result or raise."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        rec = _get(f'/requests/{request_id}')
        status = rec['status']
        if status == 'SUCCEEDED':
            return rec['result']
        if status == 'FAILED':
            raise exceptions.ApiServerError(
                rec.get('error') or 'request failed')
        if status == 'CANCELLED':
            raise exceptions.RequestCancelledError(request_id)
        time.sleep(0.5)
    raise exceptions.ApiServerError(f'request {request_id} timed out')


# ----- operations ------------------------------------------------------------
def launch(task: task_lib.Task, cluster_name: Optional[str] = None,
           dryrun: bool = False, retry_until_up: bool = False) -> str:
    return _post('/launch', {
        'task': task.to_yaml_config(),
        'cluster_name': cluster_name,
        'dryrun': dryrun,
        'retry_until_up': retry_until_up,
    })['request_id']


def exec_(task: task_lib.Task, cluster_name: str) -> str:
    return _post('/exec', {'task': task.to_yaml_config(),
                           'cluster_name': cluster_name})['request_id']


def status(cluster_names: Optional[List[str]] = None,
           refresh: bool = False,
           all_users: bool = False) -> List[Dict[str, Any]]:
    params: Dict[str, Any] = {'refresh': '1' if refresh else '0',
                              'all_users': '1' if all_users else '0'}
    if cluster_names:
        params['cluster'] = cluster_names
    return _get('/status', **params)


def down(cluster_name: str) -> str:
    return _post('/down', {'cluster_name': cluster_name})['request_id']


def stop(cluster_name: str) -> str:
    return _post('/stop', {'cluster_name': cluster_name})['request_id']


def start(cluster_name: str) -> str:
    return _post('/start', {'cluster_name': cluster_name})['request_id']


def autostop(cluster_name: str, idle_minutes: int,
             down_flag: bool = False) -> str:
    return _post('/autostop', {'cluster_name': cluster_name,
                               'idle_minutes': idle_minutes,
                               'down': down_flag})['request_id']


def queue(cluster_name: str) -> List[Dict[str, Any]]:
    return _get(f'/queue/{cluster_name}')


def cancel(cluster_name: str, job_id: int) -> bool:
    return _post('/cancel', {'cluster_name': cluster_name,
                             'job_id': job_id})['cancelled']


def tail_logs(cluster_name: str, job_id: int, follow: bool = True,
              out=None) -> None:
    """Stream logs through the server."""
    ensure_server_running()
    out = out or sys.stdout
    resp = requests_lib.get(
        f'{server_url()}/logs/{cluster_name}/{job_id}',
        params={'follow': '1' if follow else '0'}, stream=True,
        headers=request_headers(), timeout=None)
    if resp.status_code >= 400:
        raise exceptions.ApiServerError(
            f'logs failed ({resp.status_code}): {resp.text}')
    for chunk in resp.iter_content(chunk_size=None):
        out.write(chunk.decode(errors='replace'))
        out.flush()


# ----- managed jobs ----------------------------------------------------------
def jobs_launch(task_or_tasks, name: Optional[str] = None) -> str:
    """Launch a managed job: one Task, or a list of Tasks run as a
    chain pipeline (each on its own ephemeral cluster)."""
    if isinstance(task_or_tasks, (list, tuple)):
        body: Dict[str, Any] = {
            'tasks': [t.to_yaml_config() for t in task_or_tasks]}
    else:
        body = {'task': task_or_tasks.to_yaml_config()}
    body['name'] = name
    return _post('/jobs/launch', body)['request_id']


def jobs_queue(all_users: bool = False) -> List[Dict[str, Any]]:
    return _get('/jobs/queue', all_users='1' if all_users else '0')


def jobs_cancel(job_id: int) -> bool:
    return _post('/jobs/cancel', {'job_id': job_id})['cancelled']


def jobs_tail_logs(job_id: int, follow: bool = True, out=None) -> None:
    ensure_server_running()
    out = out or sys.stdout
    resp = requests_lib.get(
        f'{server_url()}/jobs/logs/{job_id}',
        params={'follow': '1' if follow else '0'}, stream=True,
        headers=request_headers(), timeout=None)
    if resp.status_code >= 400:
        raise exceptions.ApiServerError(
            f'jobs logs failed ({resp.status_code}): {resp.text}')
    for chunk in resp.iter_content(chunk_size=None):
        out.write(chunk.decode(errors='replace'))
        out.flush()


# ----- serve -----------------------------------------------------------------
def serve_up(task: task_lib.Task,
             service_name: Optional[str] = None) -> str:
    return _post('/serve/up', {'task': task.to_yaml_config(),
                               'name': service_name})['request_id']


def serve_update(task: task_lib.Task,
                 service_name: Optional[str] = None) -> str:
    """Rolling update of a live service to a new task/spec."""
    return _post('/serve/update', {'task': task.to_yaml_config(),
                                   'name': service_name})['request_id']


def serve_down(service_name: str, purge: bool = False) -> str:
    return _post('/serve/down', {'name': service_name,
                                 'purge': purge})['request_id']


def serve_status(
        service_names: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    params = {}
    if service_names:
        params['name'] = service_names
    return _get('/serve/status', **params)


def serve_replica_logs(service_name: str, replica_id: int,
                       follow: bool = False, out=None) -> None:
    ensure_server_running()
    out = out or sys.stdout
    resp = requests_lib.get(
        f'{server_url()}/serve/logs/{service_name}/{replica_id}',
        params={'follow': '1' if follow else '0'}, stream=True,
        headers=request_headers(), timeout=None)
    if resp.status_code >= 400:
        raise exceptions.ApiServerError(
            f'serve logs failed ({resp.status_code}): {resp.text}')
    for chunk in resp.iter_content(chunk_size=None):
        out.write(chunk.decode(errors='replace'))
        out.flush()


def volumes_apply(name: str, vtype: str, infra: str, size_gb: int,
                  config: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    body: Dict[str, Any] = {'name': name, 'vtype': vtype, 'infra': infra,
                            'size_gb': size_gb}
    if config:
        body['config'] = config
    return _post('/volumes/apply', body)


def volumes_list(all_users: bool = False) -> List[Dict[str, Any]]:
    return _get('/volumes', all_users='1' if all_users else '0')


def volumes_delete(name: str) -> Dict[str, Any]:
    return _post('/volumes/delete', {'name': name})


def cost_report() -> List[Dict[str, Any]]:
    return _get('/cost_report')


def accelerators(name_filter: Optional[str] = None) -> Dict[str, Any]:
    params = {'filter': name_filter} if name_filter else {}
    return _get('/accelerators', **params)


def check() -> Dict[str, Any]:
    # warnings=1: this client understands the reserved '_warnings' key
    # (older servers simply ignore the param).
    return _get('/check', warnings='1')


def catalog_staleness() -> Dict[str, Any]:
    return _get('/catalog/staleness')
