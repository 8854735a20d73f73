"""REST API server (parity: sky/server/server.py FastAPI app).

aiohttp (fastapi is not in this environment).  Mutating calls return a
request id immediately; `GET /requests/{id}` polls; `GET /logs/...`
streams.  Run: python -m skypilot_tpu_torch.server.app --port 8700

Hardening (parity: sky/server/server.py:216-396 auth middleware,
requests/payloads.py validation, requests/process.py per-request
workers):
- bearer-token auth when SKYTPU_API_TOKEN (or api_server.auth_token in
  config) is set — every route except /api/health;
- jsonschema validation of every POST body (400, never a 500 KeyError);
- LONG requests run in per-request worker processes, cancellable via
  POST /requests/{id}/cancel.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import os
from typing import Any, Dict, Optional

from aiohttp import web

from skypilot_tpu_torch import core
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import execution
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.server import payloads
from skypilot_tpu_torch.server import requests_db
from skypilot_tpu_torch.server.constants import (API_VERSION,
                                                 API_VERSION_HEADER,
                                                 MIN_COMPATIBLE_API_VERSION,
                                                 USER_HEADER, WORKSPACE_HEADER)
from skypilot_tpu_torch.server.executor import RequestExecutor

logger = sky_logging.init_logger(__name__)


def _record_json(record: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(record)
    out['status'] = record['status'].value
    out['handle'] = dataclasses.asdict(record['handle'])
    return out


def _auth_token() -> Optional[str]:
    from skypilot_tpu_torch.utils import auth
    return auth.get_auth_token()


async def _json_body(request, schema_name: str) -> Dict[str, Any]:
    try:
        body = await request.json()
    except Exception as e:  # pylint: disable=broad-except
        raise exceptions.InvalidRequestError(
            f'request body is not valid JSON: {e}') from e
    payloads.validate(schema_name, body)
    return body


@web.middleware
async def _error_middleware(request, handler):
    """400 for invalid payloads, JSON (not HTML) for unhandled errors."""
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except exceptions.InvalidRequestError as e:
        return web.json_response({'error': str(e)}, status=400)
    except exceptions.InvalidTaskError as e:
        return web.json_response({'error': str(e)}, status=400)
    except exceptions.UserRequestRejectedByPolicy as e:
        return web.json_response({'error': str(e)}, status=403)
    except exceptions.PermissionDeniedError as e:
        return web.json_response({'error': str(e)}, status=403)
    except Exception as e:  # pylint: disable=broad-except
        logger.exception(f'unhandled error on {request.path}')
        return web.json_response(
            {'error': f'{type(e).__name__}: {e}'}, status=500)


@web.middleware
async def _auth_middleware(request, handler):
    from skypilot_tpu_torch.utils import auth
    proxy_cfg = auth.get_auth_proxy_config()
    if proxy_cfg is not None and request.path not in ('/api/health',):
        # Auth-proxy mode (parity: sky/server/auth/oauth2_proxy.py):
        # an authenticating reverse proxy did the OAuth2/OIDC flow and
        # vouches with a shared secret; its identity header IS the
        # user.  Per-user service tokens still work WITHOUT the proxy
        # (headless CI/SDK access, parity: service-account tokens
        # bypass the reference's oauth2-proxy) — they bind identity
        # themselves.  The shared auth_token does NOT bypass: it
        # authorizes without binding identity, which would reopen the
        # header-spoofing hole proxy mode closes.
        header = request.headers.get('Authorization', '')
        supplied = header[7:] if header.startswith('Bearer ') else ''
        if supplied:
            ok, user = auth.authenticate(supplied)
            if ok and user is not None:
                request['auth_user'] = user
                return await handler(request)
        ok, user = auth.authenticate_proxy(request.headers, proxy_cfg)
        if not ok:
            return web.json_response(
                {'error': 'unauthorized (requests must come through '
                          'the auth proxy, or carry a per-user service '
                          'token)'}, status=401)
        request['auth_user'] = user
        return await handler(request)
    auth_on = _auth_token() or auth.get_token_users()
    if auth_on and request.path not in ('/api/health', '/', '/dashboard'):
        header = request.headers.get('Authorization', '')
        supplied = header[7:] if header.startswith('Bearer ') else ''
        ok, user = auth.authenticate(supplied)
        if not ok:
            return web.json_response({'error': 'unauthorized'}, status=401)
        if user is not None:
            # Per-user token: the bearer IS the identity — it beats any
            # X-SkyTPU-User header the caller also sent.
            request['auth_user'] = user
    return await handler(request)


@web.middleware
async def _drain_middleware(request, handler):
    """Graceful restart step 1: a draining server refuses new mutations
    with 503 (clients retry against the replacement instance) while
    reads, request polls, and cancels keep working so in-flight work can
    finish and be observed."""
    if request.method == 'POST' and \
            not request.path.endswith('/cancel') and \
            request.path != '/api/drain' and \
            await _is_draining(request.app):
        return web.json_response(
            {'error': 'server is draining; retry shortly'}, status=503)
    return await handler(request)


_DRAIN_FLAG_TTL_S = 1.0


async def _is_draining(app) -> bool:
    """Local flag OR the shared server_flags row — a drain posted to any
    worker of a multi-worker deployment must gate ALL of them.  The DB
    read runs off-loop (sqlite can block behind a writer's transaction
    for seconds — freezing the event loop would stall exactly the reads
    draining promises to keep serving) and is TTL-cached."""
    if app.get('draining'):
        return True
    if not app.get('multi_worker'):
        return False
    import time as time_lib
    now = time_lib.monotonic()
    cached = app.get('_drain_flag_cache')
    if cached is not None and now - cached[0] < _DRAIN_FLAG_TTL_S:
        return cached[1]
    from skypilot_tpu_torch.server import requests_db
    value = await asyncio.get_event_loop().run_in_executor(
        None, lambda: requests_db.get_flag('draining') == '1')
    app['_drain_flag_cache'] = (now, value)
    return value


@web.middleware
async def _version_middleware(request, handler):
    """Reject clients older than this server still understands with 426
    Upgrade Required (parity: the reference's client/server API-version
    handshake, sky/server/constants.py).  Clients that send no version
    header are allowed (curl, probes); /api/health always answers so an
    old client can at least learn the server's versions."""
    header = request.headers.get(API_VERSION_HEADER)
    if header is not None and request.path != '/api/health':
        try:
            client_version = int(header)
        except ValueError:
            return web.json_response(
                {'error': f'invalid {API_VERSION_HEADER}: {header!r}'},
                status=400)
        if client_version < MIN_COMPATIBLE_API_VERSION:
            return web.json_response(
                {'error': f'client API version {client_version} is '
                          f'older than the oldest this server supports '
                          f'({MIN_COMPATIBLE_API_VERSION}); upgrade the '
                          f'client',
                 'api_version': API_VERSION,
                 'min_compatible_api_version':
                     MIN_COMPATIBLE_API_VERSION},
                status=426)
    return await handler(request)


def make_app() -> web.Application:
    from skypilot_tpu_torch.utils import auth
    auth.warn_if_spoofable_rbac(logger)
    app = web.Application(middlewares=[_auth_middleware,
                                       _version_middleware,
                                       _drain_middleware,
                                       _error_middleware])
    executor = RequestExecutor()
    app['executor'] = executor

    app['draining'] = False

    async def on_cleanup(app):
        if 'leadership_stop' in app:
            app['leadership_stop'].set()
        if 'daemons' in app:
            app['daemons'].stop()
        executor.shutdown()
        # Graceful departure under leases: withdraw our heartbeat row
        # and any singleton role so siblings take over IMMEDIATELY
        # (rolling updates must not leave claims and the controller
        # role unowned for a TTL; crashes still rely on expiry).
        from skypilot_tpu_torch.state import leases
        dsn = requests_db.db_dsn()
        if leases.lease_mode(dsn):
            await asyncio.get_event_loop().run_in_executor(
                None, lambda: leases.withdraw(dsn))

    app.on_cleanup.append(on_cleanup)

    async def on_startup(app):
        # Re-adopt everything a restart orphaned: queued/pending request
        # rows (the requests DB is the durable queue transport), then
        # managed-job and serve controllers (their threads live in this
        # process — consolidation mode).
        from skypilot_tpu_torch.jobs import controller as jobs_controller
        from skypilot_tpu_torch.serve import controller as serve_controller
        from skypilot_tpu_torch.state import leases
        loop = asyncio.get_event_loop()

        def start_lease_machinery():
            # Multi-node deployments (remote backend / forced lease
            # mode): our claims stay live only while we heartbeat, and
            # a DEAD replica's claims only get taken over if someone
            # rescans after its lease expires — both run here, not in
            # the optional daemons set (they are correctness, not
            # housekeeping).
            dsn = requests_db.db_dsn()
            if leases.lease_mode(dsn):
                leases.start_heartbeat(dsn)
                executor.start_periodic_recovery(
                    max(leases.lease_ttl_s() / 2.0, 1.0))

        await loop.run_in_executor(None, start_lease_machinery)
        await loop.run_in_executor(None, executor.recover)

        # Controller re-adoption and background daemons run in ONE
        # worker (index 0): two workers both re-adopting the same
        # unfinished jobs/serve controllers would double-drive them.
        # Fresh controllers still start in whichever worker accepts the
        # request — per-job/per-service threads are process-local.
        daemons_on = os.environ.get('SKYTPU_DAEMONS', '1') != '0'

        def become_controller_owner():
            jobs_controller.maybe_start_controllers()
            serve_controller.maybe_start_controllers()
            # Background daemons: requests GC, cloud-truth status
            # refresh, controller liveness.  SKYTPU_DAEMONS=0
            # disables (tests).
            if daemons_on and 'daemons' not in app:
                from skypilot_tpu_torch.server import daemons as daemons_lib
                app['daemons'] = daemons_lib.DaemonSet(
                    daemons_lib.default_daemons())
                app['daemons'].start()

        if app.get('worker_index', 0) != 0:
            return
        dsn = requests_db.db_dsn()
        if not leases.lease_mode(dsn):
            await loop.run_in_executor(None, become_controller_owner)
            return

        # Multi-REPLICA deployments (shared backend): worker-0-of-pod
        # is not enough — every pod has a worker 0, and N pods each
        # driving the same unfinished jobs/serve controllers would
        # double-drive them.  The 'controllers' singleton lease picks
        # exactly one owner across the fleet; the losers keep retrying
        # so the role fails over one TTL after the owner dies.  (A
        # partitioned ex-owner cannot be stopped remotely — its writes
        # stay bounded by the guarded CAS status transitions — and a
        # live owner re-affirms, so healthy leadership never moves.)
        import threading
        stop = app['leadership_stop'] = threading.Event()

        def leadership_loop():
            while not stop.is_set():
                try:
                    if leases.try_acquire_singleton(dsn, 'controllers'):
                        become_controller_owner()
                except Exception:  # pylint: disable=broad-except
                    logger.exception('controller leadership tick failed')
                if stop.wait(max(leases.lease_ttl_s() / 2.0, 1.0)):
                    return

        threading.Thread(target=leadership_loop,
                         name='skytpu-controller-leader',
                         daemon=True).start()

    app.on_startup.append(on_startup)

    # ----- health / meta -----------------------------------------------------
    async def health(request):
        return web.json_response({
            'status': 'draining' if await _is_draining(app)
                      else 'healthy',
            'api_version': API_VERSION,
            'min_compatible_api_version': MIN_COMPATIBLE_API_VERSION,
        })

    async def dashboard(request):
        """Operator dashboard: a dependency-free page over this same
        REST API (parity: sky/dashboard/).  The shell is auth-exempt
        (it holds no data); every data fetch it makes carries the
        bearer token the operator enters."""
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'static', 'dashboard.html')
        return web.FileResponse(path)

    async def drain(request):
        """Begin graceful shutdown: refuse new mutations, keep serving
        reads; in-flight worker processes run to completion (the
        process-level wait happens in on_shutdown / executor.drain).
        Multi-worker: the flag is written to the shared DB so every
        sibling worker drains too, whichever one served this POST —
        siblings pick it up within the flag cache TTL (~1s, eventual
        consistency; _is_draining)."""
        app['draining'] = True
        if app.get('multi_worker'):
            from skypilot_tpu_torch.server import requests_db
            await asyncio.get_event_loop().run_in_executor(
                None, lambda: requests_db.set_flag('draining', '1'))
        return web.json_response({'draining': True})

    async def metrics_route(request):
        from skypilot_tpu_torch.server import metrics as metrics_lib
        return web.Response(text=metrics_lib.render(),
                            content_type='text/plain')

    # Flight-recorder dump (server/tracing.py, shared handlers).  On
    # the API server this is the postmortem surface for the managed-job
    # controllers running in-process: preemption/recovery events record
    # here, so a crashed job can be explained from one dump even after
    # its cluster is gone.
    from skypilot_tpu_torch.server import tracing
    debug_requests, debug_request = tracing.make_debug_handlers()

    # ----- requests ----------------------------------------------------------
    async def get_request(request):
        rec = requests_db.get(request.match_info['request_id'])
        if rec is None:
            return web.json_response({'error': 'not found'}, status=404)
        if not _requests_visible_to(request, [rec]):
            return web.json_response(
                {'error': 'permission denied: not your request'},
                status=403)
        out = dict(rec)
        out['status'] = rec['status'].value
        return web.json_response(out, dumps=lambda o: json.dumps(
            o, default=str))

    def _requests_visible_to(request, records):
        """RBAC scoping: non-admins see their own requests plus
        unattributed ones (pre-RBAC rows, internal submissions); admins
        and RBAC-off deployments see everything."""
        from skypilot_tpu_torch import users as users_lib
        caller = request.get('auth_user') or \
            request.headers.get(USER_HEADER)
        with users_lib.override(caller):
            user = users_lib.current_user()
        if user.role == users_lib.ADMIN:
            return records
        return [r for r in records
                if r.get('user') in (None, user.name)]

    async def list_requests(request):
        out = []
        for rec in _requests_visible_to(request,
                                        requests_db.list_requests()):
            r = dict(rec)
            r['status'] = rec['status'].value
            out.append(r)
        return web.json_response(out, dumps=lambda o: json.dumps(
            o, default=str))

    # ----- cluster lifecycle (per-request worker processes) ------------------
    def _with_identity(request, fn):
        """Run `fn` as the caller (X-SkyTPU-User / X-SkyTPU-Workspace
        headers, forwarded by the SDK); header-less requests keep the
        server's ambient identity.  Used for work running on executor
        threads, where the route's own context does not follow."""
        user = request.get('auth_user') or request.headers.get(USER_HEADER)
        workspace = request.headers.get(WORKSPACE_HEADER)

        def wrapped(*args, **kwargs):
            from skypilot_tpu_torch import users as users_lib
            from skypilot_tpu_torch import workspaces as workspaces_lib
            with users_lib.override(user), \
                    workspaces_lib.override(workspace):
                return fn(*args, **kwargs)
        return wrapped

    def _inject_identity(request, body):
        """Worker processes re-create identity from the payload (they
        are fresh spawns; thread-local overrides cannot reach them)."""
        user = request.get('auth_user') or request.headers.get(USER_HEADER)
        workspace = request.headers.get(WORKSPACE_HEADER)
        if user:
            body['_user'] = user
        if workspace:
            body['_workspace'] = workspace

    def _apply_policy(request, body, operation, cluster_name=None):
        """Admin policy runs inline at the route so a rejection is a
        403 response, not a FAILED record discovered at poll time; the
        mutated task replaces the payload before it reaches the worker
        (execution.launch re-applies as defense in depth — policies are
        idempotent by contract)."""
        from skypilot_tpu_torch import admin_policy

        def run():
            task = task_lib.Task.from_yaml_config(body['task'])
            task = admin_policy.apply(task, operation,
                                      cluster_name=cluster_name,
                                      dryrun=bool(body.get('dryrun')))
            body['task'] = task.to_yaml_config()
        _with_identity(request, run)()

    async def launch(request):
        body = await _json_body(request, 'launch')
        # Validate task construction inline: a bad task is a 400 now, not
        # a FAILED request discovered at poll time.
        _apply_policy(request, body, 'launch', body.get('cluster_name'))
        _inject_identity(request, body)
        request_id = request.app['executor'].submit_process('launch', body)
        return web.json_response({'request_id': request_id})

    async def exec_(request):
        body = await _json_body(request, 'exec')
        _apply_policy(request, body, 'exec', body.get('cluster_name'))
        _inject_identity(request, body)
        request_id = request.app['executor'].submit_process('exec', body)
        return web.json_response({'request_id': request_id})

    async def cancel_request(request):
        ok = request.app['executor'].cancel(
            request.match_info['request_id'])
        if not ok:
            return web.json_response(
                {'error': 'request not found or already finished'},
                status=409)
        return web.json_response({'cancelled': True})

    async def status(request):
        names = request.query.getall('cluster', []) or None
        refresh = request.query.get('refresh', '0') == '1'
        all_users = request.query.get('all_users', '0') == '1'
        records = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(request, lambda: core.status(
                names, refresh=refresh, all_users=all_users)))
        return web.json_response([_record_json(r) for r in records])

    def _process_op(name: str):
        async def handler(request):
            body = await _json_body(request, 'cluster_op')
            _inject_identity(request, body)
            request_id = request.app['executor'].submit_process(name, body)
            return web.json_response({'request_id': request_id})
        return handler

    down = _process_op('down')
    stop = _process_op('stop')
    start = _process_op('start')

    async def autostop(request):
        body = await _json_body(request, 'autostop')
        cluster = body['cluster_name']
        _inject_identity(request, body)
        request_id = request.app['executor'].submit(
            'autostop', body,
            _with_identity(request, lambda: core.autostop(
                cluster, int(body.get('idle_minutes', 5)),
                bool(body.get('down', False)))),
            long=False)
        return web.json_response({'request_id': request_id})

    async def queue(request):
        cluster = request.match_info['cluster_name']
        jobs = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(request, lambda: core.queue(cluster)))
        return web.json_response(jobs)

    async def cancel(request):
        body = await _json_body(request, 'cancel')
        cluster = body['cluster_name']
        job_id = int(body['job_id'])
        ok = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(request,
                                 lambda: core.cancel(cluster, job_id)))
        return web.json_response({'cancelled': ok})

    async def _stream_cluster_job_logs(request, cluster: str, job_id: int,
                                       follow: bool):
        # Resolve under the caller's identity: workspace isolation must
        # hold for log reads exactly like every other route.
        record = _with_identity(
            request,
            lambda: core._get_handle(cluster))()  # pylint: disable=protected-access
        from skypilot_tpu_torch.backends import TpuVmBackend
        backend = TpuVmBackend()
        client = backend._agent_client(record['handle'])  # pylint: disable=protected-access
        resp = web.StreamResponse()
        resp.headers['Content-Type'] = 'text/plain'
        await resp.prepare(request)
        loop = asyncio.get_event_loop()
        try:
            offset = 0
            while True:
                chunk = await loop.run_in_executor(
                    None, lambda: client.read_logs(job_id, offset=offset))
                if chunk:
                    offset += len(chunk)
                    await resp.write(chunk)
                job = await loop.run_in_executor(
                    None, lambda: client.get_job(job_id))
                from skypilot_tpu_torch.agent.job_queue import JobStatus
                if job is None or JobStatus(job['status']).is_terminal():
                    chunk = await loop.run_in_executor(
                        None,
                        lambda: client.read_logs(job_id, offset=offset))
                    if chunk:
                        await resp.write(chunk)
                    break
                if not follow:
                    break
                await asyncio.sleep(0.5)
        finally:
            client.close()
            await resp.write_eof()
        return resp

    async def logs(request):
        """Chunked log streaming: server tails the cluster agent and
        relays (reference: CLI ← server ← cluster tail,
        cloud_vm_ray_backend.py:4357)."""
        cluster = request.match_info['cluster_name']
        job_id = int(request.match_info['job_id'])
        follow = request.query.get('follow', '1') == '1'
        return await _stream_cluster_job_logs(request, cluster, job_id,
                                              follow)

    # ----- managed jobs (controllers run consolidated in this process) -------
    async def jobs_launch(request):
        body = await _json_body(request, 'jobs_launch')

        def build_payload():
            from skypilot_tpu_torch import admin_policy
            if 'tasks' in body:
                # Pipeline: a chain Dag of tasks run sequentially.
                from skypilot_tpu_torch import dag as dag_lib
                dag = dag_lib.Dag(name=body.get('name'))
                prev = None
                for cfg in body['tasks']:
                    t = admin_policy.apply(
                        task_lib.Task.from_yaml_config(cfg), 'jobs')
                    dag.add(t)
                    if prev is not None:
                        dag.add_edge(prev, t)
                    prev = t
                return dag
            return admin_policy.apply(
                task_lib.Task.from_yaml_config(body['task']), 'jobs')

        payload = _with_identity(request, build_payload)()
        name = body.get('name')

        def work():
            from skypilot_tpu_torch import jobs as jobs_lib
            return {'job_id': jobs_lib.launch(payload, name)}

        _inject_identity(request, body)
        request_id = request.app['executor'].submit(
            'jobs_launch', body, _with_identity(request, work), long=False)
        return web.json_response({'request_id': request_id})

    async def jobs_queue(request):
        from skypilot_tpu_torch import jobs as jobs_lib
        all_users = request.query.get('all_users', '0') == '1'
        records = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(
                request, lambda: jobs_lib.queue(all_users=all_users)))
        out = []
        for r in records:
            r = dict(r)
            r['status'] = r['status'].value
            out.append(r)
        return web.json_response(out, dumps=lambda o: json.dumps(
            o, default=str))

    async def jobs_cancel(request):
        body = await _json_body(request, 'jobs_cancel')
        from skypilot_tpu_torch import jobs as jobs_lib
        job_id = int(body['job_id'])
        ok = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(request,
                                 lambda: jobs_lib.cancel(job_id)))
        return web.json_response({'cancelled': ok})

    async def jobs_logs(request):
        from skypilot_tpu_torch.jobs import state as jobs_state
        job_id = int(request.match_info['job_id'])
        follow = request.query.get('follow', '1') == '1'
        from skypilot_tpu_torch import exceptions as exc
        from skypilot_tpu_torch.jobs import core as jobs_core
        rec = jobs_state.get(job_id)
        from skypilot_tpu_torch import workspaces as workspaces_lib
        if rec is None or not _with_identity(
                request, lambda: workspaces_lib.visible(rec))():
            return web.json_response({'error': 'job logs unavailable'},
                                     status=404)
        try:
            snapshot = jobs_core.snapshot_to_serve(rec)
        except exc.ClusterDoesNotExistError:
            return web.json_response({'error': 'job logs unavailable'},
                                     status=404)
        if snapshot is not None:
            def _read():
                with open(snapshot, 'rb') as f:
                    return f.read()
            data = await asyncio.get_event_loop().run_in_executor(
                None, _read)
            return web.Response(body=data, content_type='text/plain')
        if rec['cluster_job_id'] is None:
            return web.json_response({'error': 'job logs unavailable'},
                                     status=404)
        return await _stream_cluster_job_logs(
            request, rec['cluster_name'], rec['cluster_job_id'], follow)

    # ----- serve (controllers run consolidated in this process) --------------
    async def serve_up(request):
        body = await _json_body(request, 'serve_up')

        def build_task():
            from skypilot_tpu_torch import admin_policy
            return admin_policy.apply(
                task_lib.Task.from_yaml_config(body['task']), 'serve')

        task = _with_identity(request, build_task)()
        name = body.get('name')

        def work():
            from skypilot_tpu_torch import serve as serve_lib
            return serve_lib.up(task, name)

        _inject_identity(request, body)
        request_id = request.app['executor'].submit(
            'serve_up', body, _with_identity(request, work), long=False)
        return web.json_response({'request_id': request_id})

    async def serve_update(request):
        body = await _json_body(request, 'serve_update')

        def build_task():
            from skypilot_tpu_torch import admin_policy
            return admin_policy.apply(
                task_lib.Task.from_yaml_config(body['task']), 'serve')

        task = _with_identity(request, build_task)()
        name = body.get('name')

        def work():
            from skypilot_tpu_torch import serve as serve_lib
            return serve_lib.update(task, name)

        _inject_identity(request, body)
        request_id = request.app['executor'].submit(
            'serve_update', body, _with_identity(request, work),
            long=False)
        return web.json_response({'request_id': request_id})

    async def serve_down(request):
        body = await _json_body(request, 'serve_down')
        name = body['name']
        purge = bool(body.get('purge', False))

        def work():
            from skypilot_tpu_torch import serve as serve_lib
            serve_lib.down(name, purge=purge)
            return {'down': name}

        _inject_identity(request, body)
        request_id = request.app['executor'].submit(
            'serve_down', body, work, long=False)
        return web.json_response({'request_id': request_id})

    async def serve_status(request):
        from skypilot_tpu_torch import serve as serve_lib
        names = request.query.getall('name', []) or None
        records = await asyncio.get_event_loop().run_in_executor(
            None, lambda: serve_lib.status(names))
        out = []
        for r in records:
            r = dict(r)
            r['status'] = r['status'].value
            r['replicas'] = [
                dict(rep, status=rep['status'].value)
                for rep in r['replicas']
            ]
            out.append(r)
        return web.json_response(out, dumps=lambda o: json.dumps(
            o, default=str))

    async def serve_replica_logs(request):
        from skypilot_tpu_torch.serve import serve_state as serve_state_lib
        service = request.match_info['service']
        replica_id = int(request.match_info['replica_id'])
        follow = request.query.get('follow', '0') == '1'
        rec = serve_state_lib.get_replica(service, replica_id)
        if rec is None or rec['cluster_job_id'] is None:
            return web.json_response({'error': 'replica logs unavailable'},
                                     status=404)
        from skypilot_tpu_torch import exceptions as exc
        try:
            return await _stream_cluster_job_logs(
                request, rec['cluster_name'], rec['cluster_job_id'],
                follow)
        except exc.ClusterDoesNotExistError:
            # Replica already torn down (scaled down / preempted).
            return web.json_response({'error': 'replica logs unavailable'},
                                     status=404)

    # ----- volumes -----------------------------------------------------------
    async def volumes_apply(request):
        body = await _json_body(request, 'volumes_apply')
        from skypilot_tpu_torch import volumes as volumes_lib

        def work():
            vol = volumes_lib.apply(body['name'], body['vtype'],
                                    body['infra'], body['size_gb'],
                                    body.get('config'))
            return dataclasses.asdict(vol)

        result = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(request, work))
        return web.json_response(result)

    async def volumes_list(request):
        from skypilot_tpu_torch import volumes as volumes_lib
        all_users = request.query.get('all_users', '0') == '1'
        vols = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(
                request,
                lambda: volumes_lib.list_volumes(all_users=all_users)))
        return web.json_response([dataclasses.asdict(v) for v in vols])

    async def volumes_delete(request):
        body = await _json_body(request, 'volumes_delete')
        from skypilot_tpu_torch import volumes as volumes_lib
        await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(
                request, lambda: volumes_lib.delete(body['name'])))
        return web.json_response({'deleted': body['name']})

    async def cost_report(request):
        all_users = request.query.get('all_users', '0') == '1'
        report = await asyncio.get_event_loop().run_in_executor(
            None, _with_identity(
                request, lambda: core.cost_report(all_users=all_users)))
        return web.json_response(report, dumps=lambda o: json.dumps(
            o, default=str))

    async def accelerators(request):
        from skypilot_tpu_torch import catalog
        name_filter = request.query.get('filter')
        out = {
            name: [dataclasses.asdict(o) for o in offs]
            for name, offs in catalog.list_accelerators(name_filter).items()
        }
        return web.json_response(out)

    async def check(request):
        from skypilot_tpu_torch import clouds as clouds_lib

        def run_checks():
            out = {}
            for name, cloud in clouds_lib.CLOUD_REGISTRY.items():
                ok, reason = cloud.check_credentials()
                s_ok, s_reason = cloud.check_storage_credentials(
                    compute_result=(ok, reason))
                # Compute and storage are separate capabilities
                # (sky/check.py:81): either can work without the other.
                out[name] = {'enabled': ok, 'reason': reason,
                             'storage': {'enabled': s_ok,
                                         'reason': s_reason}}
            # Config-level warnings ride along under a reserved key
            # (currently: RBAC enabled but identity spoofable by any
            # shared-token holder — also warned at server startup).
            from skypilot_tpu_torch.utils import auth
            # Config-level warnings are OPT-IN (?warnings=1): released
            # clients iterate /check's entries as clouds — the same
            # compat contract that keeps catalog staleness on its own
            # route — so a surprise non-cloud key would crash them.
            if request.query.get('warnings') == '1':
                warnings = []
                if auth.warn_if_spoofable_rbac(logger):
                    warnings.append(
                        'users: RBAC is enabled but only a shared '
                        'api_server.auth_token gates the API — any '
                        'token holder can act as any user; configure '
                        'per-user api_server.tokens.')
                out['_warnings'] = warnings
            return out

        out = await asyncio.get_event_loop().run_in_executor(None,
                                                             run_checks)
        return web.json_response(out)

    async def catalog_staleness_route(request):
        # Separate from /check so released clients iterating /check's
        # entries as clouds keep working.
        from skypilot_tpu_torch.catalog import common as catalog_common
        return web.json_response({
            fn: catalog_common.catalog_staleness(fn)
            for fn in ('gcp_tpus.csv', 'gcp_vms.csv')
        })

    app.router.add_get('/api/health', health)
    app.router.add_get('/metrics', metrics_route)
    app.router.add_get('/debug/requests', debug_requests)
    app.router.add_get('/debug/requests/{request_id}', debug_request)
    app.router.add_get('/requests/{request_id}', get_request)
    app.router.add_post('/requests/{request_id}/cancel', cancel_request)
    app.router.add_get('/requests', list_requests)
    app.router.add_post('/launch', launch)
    app.router.add_post('/exec', exec_)
    app.router.add_get('/status', status)
    app.router.add_post('/down', down)
    app.router.add_post('/stop', stop)
    app.router.add_post('/start', start)
    app.router.add_post('/autostop', autostop)
    app.router.add_get('/queue/{cluster_name}', queue)
    app.router.add_post('/cancel', cancel)
    app.router.add_get('/logs/{cluster_name}/{job_id}', logs)
    app.router.add_post('/jobs/launch', jobs_launch)
    app.router.add_get('/jobs/queue', jobs_queue)
    app.router.add_post('/jobs/cancel', jobs_cancel)
    app.router.add_get('/jobs/logs/{job_id}', jobs_logs)
    app.router.add_post('/serve/up', serve_up)
    app.router.add_post('/serve/update', serve_update)
    app.router.add_post('/serve/down', serve_down)
    app.router.add_get('/serve/status', serve_status)
    app.router.add_get('/serve/logs/{service}/{replica_id}',
                       serve_replica_logs)
    app.router.add_post('/volumes/apply', volumes_apply)
    app.router.add_get('/volumes', volumes_list)
    app.router.add_post('/volumes/delete', volumes_delete)
    app.router.add_get('/cost_report', cost_report)
    app.router.add_get('/accelerators', accelerators)
    app.router.add_get('/check', check)
    app.router.add_get('/catalog/staleness', catalog_staleness_route)
    app.router.add_post('/api/drain', drain)
    app.router.add_get('/dashboard', dashboard)
    app.router.add_get('/', dashboard)
    return app


def _serve_one(host: str, port: int, worker_index: int,
               n_workers: int) -> None:
    """One server process: the whole app on a SO_REUSEPORT socket (the
    kernel load-balances accepts across workers; parity:
    sky/server/uvicorn.py:86 multi-worker serving)."""
    app = make_app()
    app['worker_index'] = worker_index
    app['multi_worker'] = n_workers > 1

    async def on_shutdown(app):
        # SIGTERM/SIGINT → aiohttp shutdown: flip to draining and wait
        # for in-flight worker processes before cleanup tears them down.
        app['draining'] = True
        timeout = float(os.environ.get('SKYTPU_DRAIN_TIMEOUT', '300'))
        loop = asyncio.get_event_loop()
        drained = await loop.run_in_executor(
            None, lambda: app['executor'].drain(timeout))
        if not drained:
            logger.warning('drain timed out; terminating workers')
        # Stop in-process jobs/serve controller threads without status
        # writes — the next server's maybe_start_controllers re-adopts.
        from skypilot_tpu_torch.jobs import controller as jobs_controller
        from skypilot_tpu_torch.serve import controller as serve_controller
        await loop.run_in_executor(
            None, jobs_controller.stop_all_controllers)
        await loop.run_in_executor(
            None, serve_controller.stop_all_controllers)

    app.on_shutdown.append(on_shutdown)
    web.run_app(app, host=host, port=port,
                reuse_port=(n_workers > 1) or None,
                print=lambda *a: logger.info(
                    f'API server worker {worker_index}/{n_workers} '
                    f'on {host}:{port}'))


def main() -> None:
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('--port', type=int, default=8700)
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument(
        '--workers', type=int,
        default=int(os.environ.get('SKYTPU_SERVER_WORKERS', '1')),
        help='server processes sharing the port via SO_REUSEPORT; the '
        'requests DB is the shared queue (claims prevent double '
        'dispatch), worker 0 owns controller re-adoption and daemons')
    args = parser.parse_args()
    if args.workers <= 1:
        _serve_one(args.host, args.port, 0, 1)
        return
    import multiprocessing
    import signal as signal_lib
    import time as time_lib
    # A fresh deployment is not draining; clear any flag a previous
    # generation's drain left in the shared DB.  Done ONCE here, before
    # any worker exists — a per-worker clear would let a late-booting
    # worker erase a drain posted to an already-serving sibling.
    from skypilot_tpu_torch.server import requests_db
    requests_db.set_flag('draining', '0')
    ctx = multiprocessing.get_context('spawn')

    def spawn(i: int):
        p = ctx.Process(target=_serve_one,
                        args=(args.host, args.port, i, args.workers),
                        name=f'skytpu-api-worker-{i}')
        p.start()
        return p

    procs = [spawn(i) for i in range(args.workers)]
    stopping = {'flag': False}

    def forward(signum, _frame):
        stopping['flag'] = True
        for p in procs:
            if p.pid and p.is_alive():
                os.kill(p.pid, signum)

    signal_lib.signal(signal_lib.SIGTERM, forward)
    signal_lib.signal(signal_lib.SIGINT, forward)
    # Supervise: a dead worker is respawned (worker 0 exclusively owns
    # daemons + controller re-adoption — its silent death would disable
    # them for the whole deployment while /health still said healthy).
    while True:
        time_lib.sleep(1.0)
        if stopping['flag']:
            break
        for i, p in enumerate(procs):
            if not p.is_alive():
                logger.warning(
                    f'API worker {i} died (exit {p.exitcode}); '
                    f'respawning')
                procs[i] = spawn(i)
    for p in procs:
        p.join()


if __name__ == '__main__':
    main()
