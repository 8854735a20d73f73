"""API-version handshake, async SDK and admin policy over the port's
server: the cases of tests/test_client_server_compat.py against
`skypilot_tpu_torch.server.app`, with the port's SDKs and admin policy
(two local launches: the async SDK's and the mutating policy's)."""
import asyncio

import pytest
import requests as requests_lib

from skypilot_tpu_torch import admin_policy
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.server.app import make_app
from skypilot_tpu_torch.server.constants import (API_VERSION,
                                                 API_VERSION_HEADER,
                                                 MIN_COMPATIBLE_API_VERSION)
from skypilot_tpu_torch.task import Task

from torch_control import app_in_thread, port_home, reap_marked  # noqa: F401


@pytest.fixture
def api_server(port_home, monkeypatch):
    """The port's app on a free port under this case's $HOME, daemons
    off; its controllers are stopped on the way out (port_home)."""
    monkeypatch.setenv('SKYTPU_DAEMONS', '0')
    with app_in_thread(make_app) as url:
        monkeypatch.setenv('SKYTPU_API_SERVER', url)
        yield url


def _mk_local_task(run='echo api-hello'):
    t = Task('apitask', run=run)
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    return t


# ----- version handshake -----------------------------------------------------
def test_health_reports_versions(api_server):
    info = requests_lib.get(f'{api_server}/api/health', timeout=30).json()
    assert info['api_version'] == API_VERSION
    assert info['min_compatible_api_version'] == MIN_COMPATIBLE_API_VERSION


def test_current_client_version_accepted(api_server):
    resp = requests_lib.get(
        f'{api_server}/status',
        headers={API_VERSION_HEADER: str(API_VERSION)}, timeout=30)
    assert resp.status_code == 200


def test_too_old_client_gets_426(api_server):
    resp = requests_lib.get(
        f'{api_server}/status',
        headers={API_VERSION_HEADER:
                 str(MIN_COMPATIBLE_API_VERSION - 1)}, timeout=30)
    assert resp.status_code == 426
    body = resp.json()
    assert body['min_compatible_api_version'] == MIN_COMPATIBLE_API_VERSION


def test_garbage_version_header_is_400(api_server):
    resp = requests_lib.get(f'{api_server}/status',
                            headers={API_VERSION_HEADER: 'banana'},
                            timeout=30)
    assert resp.status_code == 400


def test_versionless_clients_still_work(api_server):
    # curl / probes send no header and must not be locked out.
    assert requests_lib.get(f'{api_server}/status',
                            timeout=30).status_code == 200


def test_sdk_refuses_too_old_server(api_server, monkeypatch):
    from skypilot_tpu_torch.client import sdk
    monkeypatch.setattr(
        sdk, 'api_info',
        lambda timeout=2.0: {'status': 'healthy', 'api_version': 0})
    with pytest.raises(exceptions.ApiVersionMismatchError):
        sdk.ensure_server_running()


# ----- async SDK -------------------------------------------------------------
def test_async_sdk_end_to_end(api_server):
    from skypilot_tpu_torch.client import sdk_async

    async def flow():
        async with sdk_async.Client() as client:
            info = await client.api_info()
            assert info['status'] == 'healthy'
            request_id = await client.launch(_mk_local_task(), 'asynce2e')
            result = await client.get(request_id)
            assert result['cluster_name'] == 'asynce2e'
            records = await client.status()
            assert records[0]['name'] == 'asynce2e'
            down_id = await client.down('asynce2e')
            await client.get(down_id)
            assert await client.status() == []

    asyncio.run(asyncio.wait_for(flow(), 240))


# ----- admin policy ----------------------------------------------------------
class _EnvInjector(admin_policy.AdminPolicy):
    """Mutates: stamps an env var on every task."""

    def validate_and_mutate(self, user_request):
        task = user_request.task
        task.update_envs({'POLICY_STAMP': 'applied'})
        return admin_policy.MutatedUserRequest(task=task)


class _RejectAll(admin_policy.AdminPolicy):

    def validate_and_mutate(self, user_request):
        raise exceptions.UserRequestRejectedByPolicy(
            f'{user_request.request_options.operation} is forbidden')


def _set_policy(home, name):
    cfg = home / '.skytpu.yaml'
    cfg.write_text(f'admin_policy: {__name__}.{name}\n')


def test_admin_policy_mutates_launch(port_home):
    from skypilot_tpu_torch import core
    from skypilot_tpu_torch import execution
    _set_policy(port_home, '_EnvInjector')
    out = port_home / 'stamp.txt'
    task = _mk_local_task(f'echo "stamp is $POLICY_STAMP" > {out}')
    try:
        _, handle = execution.launch(task, 'polic', detach_run=False)
        assert handle is not None
        assert out.read_text().strip() == 'stamp is applied'
    finally:
        core.down('polic')


def test_admin_policy_rejects(port_home):
    from skypilot_tpu_torch import execution
    _set_policy(port_home, '_RejectAll')
    with pytest.raises(exceptions.UserRequestRejectedByPolicy):
        execution.launch(_mk_local_task(), 'polic2')


class _RejectServeOnly(admin_policy.AdminPolicy):
    """Operation-selective policy: batch launches fine, serving not."""

    def validate_and_mutate(self, user_request):
        if user_request.request_options.operation == 'serve':
            raise exceptions.UserRequestRejectedByPolicy(
                'serving is not allowed in this org')
        return admin_policy.MutatedUserRequest(task=user_request.task)


def test_admin_policy_rejection_is_403_over_rest(api_server, port_home):
    _set_policy(port_home, '_RejectAll')
    body = {'task': _mk_local_task().to_yaml_config()}
    resp = requests_lib.post(f'{api_server}/launch', json=body, timeout=30)
    assert resp.status_code == 403
    assert 'forbidden' in resp.json()['error']


def test_admin_policy_sees_operation(api_server, port_home):
    _set_policy(port_home, '_RejectServeOnly')
    task = _mk_local_task().to_yaml_config()
    task['service'] = {'readiness_probe': '/', 'replicas': 1}
    resp = requests_lib.post(f'{api_server}/serve/up',
                             json={'task': task, 'name': 'svc'}, timeout=30)
    assert resp.status_code == 403
    # ...but a plain launch passes the same policy.
    resp = requests_lib.post(
        f'{api_server}/launch',
        json={'task': _mk_local_task().to_yaml_config(),
              'cluster_name': 'okc', 'dryrun': True}, timeout=30)
    assert resp.status_code == 200


def test_no_policy_is_noop(port_home):
    task = _mk_local_task()
    assert admin_policy.apply(task, 'launch') is task


def test_bad_policy_path_errors(port_home):
    cfg = port_home / '.skytpu.yaml'
    cfg.write_text('admin_policy: nonexistent_mod.Nope\n')
    with pytest.raises(exceptions.InvalidSkyConfigError):
        admin_policy.apply(_mk_local_task(), 'launch')
