"""Async Python SDK (parity: the reference's async client surface,
sky/client/sdk.py — its sync SDK wraps an async core; here the sync SDK
is primary and this module is its asyncio twin for callers living in an
event loop, e.g. services embedding the client in aiohttp/fastapi apps).

Same REST protocol and semantics as `client.sdk`: mutating calls return
a request id, ``await get(request_id)`` polls to completion, streams
write to a file-like object.  Auth + API-version headers come from
`sdk.request_headers()` so the two SDKs can never drift.

Usage:
    async with sdk_async.Client() as client:
        request_id = await client.launch(task, 'my-cluster')
        result = await client.get(request_id)
"""
from __future__ import annotations

import asyncio
import sys
from typing import Any, Dict, List, Optional

import aiohttp

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.client import sdk as sync_sdk


class Client:
    """One aiohttp session speaking to the API server."""

    def __init__(self, server: Optional[str] = None) -> None:
        self._server = (server or sync_sdk.server_url()).rstrip('/')
        self._session: Optional[aiohttp.ClientSession] = None

    # ----- lifecycle ---------------------------------------------------------
    async def __aenter__(self) -> 'Client':
        self._session = aiohttp.ClientSession(
            headers=sync_sdk.request_headers())
        return self

    async def __aexit__(self, *_) -> None:
        await self.close()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    @property
    def session(self) -> aiohttp.ClientSession:
        if self._session is None:
            raise exceptions.ApiServerError(
                'Client not started: use `async with Client()` or call '
                '__aenter__')
        return self._session

    # ----- transport ---------------------------------------------------------
    async def _post(self, path: str, body: Dict[str, Any]) -> Any:
        async with self.session.post(f'{self._server}{path}',
                                     json=body) as resp:
            if resp.status >= 400:
                raise exceptions.ApiServerError(
                    f'{path} failed ({resp.status}): {await resp.text()}')
            return await resp.json()

    async def _get(self, path: str, **params) -> Any:
        async with self.session.get(f'{self._server}{path}',
                                    params=params) as resp:
            if resp.status >= 400:
                raise exceptions.ApiServerError(
                    f'{path} failed ({resp.status}): {await resp.text()}')
            return await resp.json()

    async def _stream(self, path: str, out, **params) -> None:
        out = out or sys.stdout
        async with self.session.get(f'{self._server}{path}',
                                    params=params,
                                    timeout=aiohttp.ClientTimeout(
                                        total=None)) as resp:
            if resp.status >= 400:
                raise exceptions.ApiServerError(
                    f'{path} failed ({resp.status}): {await resp.text()}')
            async for chunk in resp.content.iter_any():
                out.write(chunk.decode(errors='replace'))
                out.flush()

    # ----- meta --------------------------------------------------------------
    async def api_info(self) -> Dict[str, Any]:
        info = await self._get('/api/health')
        sync_sdk.check_server_compat(info)
        return info

    async def get(self, request_id: str,
                  timeout_s: float = 3600.0) -> Any:
        """Await a request's terminal state; return result or raise."""
        deadline = asyncio.get_event_loop().time() + timeout_s
        while asyncio.get_event_loop().time() < deadline:
            rec = await self._get(f'/requests/{request_id}')
            status = rec['status']
            if status == 'SUCCEEDED':
                return rec['result']
            if status == 'FAILED':
                raise exceptions.ApiServerError(
                    rec.get('error') or 'request failed')
            if status == 'CANCELLED':
                raise exceptions.RequestCancelledError(request_id)
            await asyncio.sleep(0.5)
        raise exceptions.ApiServerError(f'request {request_id} timed out')

    # ----- cluster ops -------------------------------------------------------
    async def launch(self, task, cluster_name: Optional[str] = None,
                     dryrun: bool = False,
                     retry_until_up: bool = False) -> str:
        body = {'task': task.to_yaml_config(),
                'cluster_name': cluster_name, 'dryrun': dryrun,
                'retry_until_up': retry_until_up}
        return (await self._post('/launch', body))['request_id']

    async def exec_(self, task, cluster_name: str) -> str:
        body = {'task': task.to_yaml_config(),
                'cluster_name': cluster_name}
        return (await self._post('/exec', body))['request_id']

    async def status(self, cluster_names: Optional[List[str]] = None,
                     refresh: bool = False) -> List[Dict[str, Any]]:
        params: Dict[str, Any] = {'refresh': '1' if refresh else '0'}
        if cluster_names:
            params['cluster'] = cluster_names
        return await self._get('/status', **params)

    async def down(self, cluster_name: str) -> str:
        return (await self._post(
            '/down', {'cluster_name': cluster_name}))['request_id']

    async def stop(self, cluster_name: str) -> str:
        return (await self._post(
            '/stop', {'cluster_name': cluster_name}))['request_id']

    async def start(self, cluster_name: str) -> str:
        return (await self._post(
            '/start', {'cluster_name': cluster_name}))['request_id']

    async def autostop(self, cluster_name: str, idle_minutes: int,
                       down_flag: bool = False) -> str:
        return (await self._post('/autostop', {
            'cluster_name': cluster_name, 'idle_minutes': idle_minutes,
            'down': down_flag}))['request_id']

    async def queue(self, cluster_name: str) -> List[Dict[str, Any]]:
        return await self._get(f'/queue/{cluster_name}')

    async def cancel(self, cluster_name: str, job_id: int) -> bool:
        return (await self._post('/cancel', {
            'cluster_name': cluster_name,
            'job_id': job_id}))['cancelled']

    async def tail_logs(self, cluster_name: str, job_id: int,
                        follow: bool = True, out=None) -> None:
        await self._stream(f'/logs/{cluster_name}/{job_id}', out,
                           follow='1' if follow else '0')

    # ----- managed jobs ------------------------------------------------------
    async def jobs_launch(self, task_or_tasks,
                          name: Optional[str] = None) -> str:
        if isinstance(task_or_tasks, (list, tuple)):
            body: Dict[str, Any] = {
                'tasks': [t.to_yaml_config() for t in task_or_tasks]}
        else:
            body = {'task': task_or_tasks.to_yaml_config()}
        body['name'] = name
        return (await self._post('/jobs/launch', body))['request_id']

    async def jobs_queue(self) -> List[Dict[str, Any]]:
        return await self._get('/jobs/queue')

    async def jobs_cancel(self, job_id: int) -> bool:
        return (await self._post(
            '/jobs/cancel', {'job_id': job_id}))['cancelled']

    async def jobs_tail_logs(self, job_id: int, follow: bool = True,
                             out=None) -> None:
        await self._stream(f'/jobs/logs/{job_id}', out,
                           follow='1' if follow else '0')

    # ----- serve -------------------------------------------------------------
    async def serve_up(self, task,
                       service_name: Optional[str] = None) -> str:
        return (await self._post('/serve/up', {
            'task': task.to_yaml_config(),
            'name': service_name}))['request_id']

    async def serve_down(self, service_name: str,
                         purge: bool = False) -> str:
        return (await self._post('/serve/down', {
            'name': service_name, 'purge': purge}))['request_id']

    async def serve_status(
            self, service_names: Optional[List[str]] = None
    ) -> List[Dict[str, Any]]:
        params = {}
        if service_names:
            params['name'] = service_names
        return await self._get('/serve/status', **params)

    # ----- misc --------------------------------------------------------------
    async def cost_report(self) -> List[Dict[str, Any]]:
        return await self._get('/cost_report')

    async def check(self) -> Dict[str, Any]:
        return await self._get('/check')
