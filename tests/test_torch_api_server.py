"""The port's REST API server, SDK and `skytpu-torch` CLI on the local
cloud: the cases of tests/test_api_server.py against
`skypilot_tpu_torch.server.app` (its two controller cases are in
tests/test_torch_api_server_controllers.py), the CLI over the port's
modules, and one REST sequence run against the JAX server and the port's
server, each under its own $HOME, with the same status codes, JSON keys
and job statuses.

One in-process server and one launched cluster serve the module (the
cases run in file order; the last CLI case brings the cluster down), so
the file makes three local launches of the port: the shared cluster, the
request wedged in setup that the cancellation cases kill, and the port's
half of the cross-package sequence.  Every wait has a deadline."""
import ast
import dataclasses
import io
import json
import os
import pathlib

import pytest
import requests as requests_lib
from click.testing import CliRunner

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import sky_config
from skypilot_tpu_torch.agent.job_queue import JobStatus
from skypilot_tpu_torch.client import sdk
from skypilot_tpu_torch.client.cli import cli
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.server import requests_db
from skypilot_tpu_torch.server.app import make_app
from skypilot_tpu_torch.server.constants import (API_VERSION_HEADER,
                                                 MIN_COMPATIBLE_API_VERSION)
from skypilot_tpu_torch.task import Task

from torch_control import (app_in_thread, kill_with_env, reap_marked,  # noqa: F401
                           stop_port_controllers, wait_for)

REPO = pathlib.Path(__file__).resolve().parents[1]
CLUSTER = 'apie2e'
REQUEST_TIMEOUT_S = 180.0


def _mk_local_task(run='echo api-hello', name='apitask'):
    t = Task(name, run=run)
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    return t


def _home_env(mp, home: pathlib.Path) -> None:
    """conftest's tmp_home settings for `home`, the local cloud as the
    one enabled cloud and the server's daemons off (their jittered ticks
    would race staged state)."""
    mp.setenv('HOME', str(home))
    mp.setenv('SKYTPU_GLOBAL_CONFIG', str(home / '.skytpu' / 'config.yaml'))
    mp.setenv('SKYTPU_PROJECT_CONFIG', str(home / '.skytpu.yaml'))
    mp.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
    mp.setenv('SKYTPU_DAEMONS', '0')


@pytest.fixture(scope='module')
def api_server(tmp_path_factory):
    """The port's app on a free port for the whole module, under a
    module $HOME; its controllers are stopped and every process started
    under that $HOME is killed on the way out."""
    home = tmp_path_factory.mktemp('torch-api') / 'home'
    home.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        _home_env(mp, home)
        sky_config.reset_cache_for_tests()
        try:
            with app_in_thread(make_app) as url:
                mp.setenv('SKYTPU_API_SERVER', url)
                yield url
        finally:
            stop_port_controllers()
            kill_with_env(f'HOME={home}')
            sky_config.reset_cache_for_tests()


@pytest.fixture(scope='module')
def launched(api_server):
    """The module's cluster: one echo task launched over REST."""
    request_id = sdk.launch(_mk_local_task(), CLUSTER)
    result = sdk.get(request_id, timeout_s=REQUEST_TIMEOUT_S)
    return {'request_id': request_id, **result}


def _wait_job_terminal(cluster, job_id, timeout_s=60.0):
    def probe():
        rec = next(j for j in sdk.queue(cluster) if j['job_id'] == job_id)
        return rec if JobStatus(rec['status']).is_terminal() else None
    return wait_for(probe, timeout_s, f'job {job_id} on {cluster}', 0.3)


def test_health_and_check(api_server):
    assert sdk.api_info()['status'] == 'healthy'
    checks = sdk.check()
    assert checks['local']['enabled']
    # The port registers the JAX package's six clouds.
    assert sorted(checks) == ['_warnings', 'aws', 'gcp', 'kubernetes',
                              'local', 'slurm', 'ssh']


def test_launch_via_sdk_end_to_end(launched):
    assert launched['cluster_name'] == CLUSTER
    job_id = launched['job_id']
    # Per-request memory accounting: the worker recorded its peak RSS.
    rec = sdk._get(f'/requests/{launched["request_id"]}')  # pylint: disable=protected-access
    assert rec.get('peak_rss_kb') and rec['peak_rss_kb'] > 0
    assert _wait_job_terminal(CLUSTER, job_id)['status'] == 'SUCCEEDED'
    records = sdk.status()
    assert records[0]['name'] == CLUSTER
    assert records[0]['status'] == 'UP'
    buf = io.StringIO()
    sdk.tail_logs(CLUSTER, job_id, follow=False, out=buf)
    assert 'api-hello' in buf.getvalue()
    assert sdk.cost_report()[0]['name'] == CLUSTER


def test_failed_request_surfaces_error(api_server):
    with pytest.raises(exceptions.ApiServerError) as err:
        sdk.get(sdk.exec_(_mk_local_task(), 'missing-cluster'),
                timeout_s=REQUEST_TIMEOUT_S)
    assert 'does not exist' in str(err.value)


def test_accelerators_endpoint(api_server):
    accs = sdk.accelerators('v5p')
    assert accs and all('v5p' in k for k in accs)


def test_requests_persisted(launched):
    rec = requests_db.get(launched['request_id'])
    assert rec is not None
    assert rec['status'].value == 'SUCCEEDED'
    assert rec['result']['cluster_name'] == CLUSTER


def test_payload_validation_400(api_server):
    # Garbage bodies are 400s with a message, never 500 KeyErrors.
    r = requests_lib.post(f'{api_server}/launch', data='not json',
                          timeout=30)
    assert r.status_code == 400
    assert 'JSON' in r.json()['error']
    r = requests_lib.post(f'{api_server}/launch', json={'bogus': 1},
                          timeout=30)
    assert r.status_code == 400
    assert 'task' in r.json()['error']
    r = requests_lib.post(f'{api_server}/down', json={}, timeout=30)
    assert r.status_code == 400
    r = requests_lib.post(f'{api_server}/cancel',
                          json={'cluster_name': 'c', 'job_id': 'NaN'},
                          timeout=30)
    assert r.status_code == 400


def test_bearer_auth(api_server, monkeypatch):
    monkeypatch.setenv('SKYTPU_API_TOKEN', 'sekrit')
    import asyncio
    from aiohttp.test_utils import TestClient, TestServer

    async def drive():
        client = TestClient(TestServer(make_app()))
        await client.start_server()
        try:
            r = await client.get('/api/health')      # exempt
            assert r.status == 200
            r = await client.get('/status')
            assert r.status == 401
            r = await client.get('/status', headers={
                'Authorization': 'Bearer wrong'})
            assert r.status == 401
            r = await client.get('/status', headers={
                'Authorization': 'Bearer sekrit'})
            assert r.status == 200
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(asyncio.wait_for(drive(), 60))
    finally:
        loop.close()


@pytest.fixture(scope='module')
def hung_request(api_server):
    """A LONG request wedged mid-setup (a stuck provision's analog): its
    record once RUNNING and its worker's pid, after the worker has
    provisioned the cluster and started the setup command."""
    t = _mk_local_task('echo hi', name='hang')
    t.setup = 'sleep 600'
    r = requests_lib.post(f'{api_server}/launch',
                          json={'task': t.to_yaml_config(),
                                'cluster_name': 'hangc'}, timeout=30)
    request_id = r.json()['request_id']

    def running():
        rec = requests_lib.get(f'{api_server}/requests/{request_id}',
                               timeout=30).json()
        return rec if rec['status'] == 'RUNNING' else None
    rec = wait_for(running, 60, 'the wedged launch RUNNING', 0.5)
    home = os.environ['HOME']
    wait_for(lambda: _processes_with((b'sleep\x00600', b'sleep 600'),
                                     f'HOME={home}'), 60,
             'the wedged setup command')
    yield request_id, rec
    if 'hangc' in [c['name'] for c in sdk.status()]:
        requests_lib.post(f'{api_server}/down',
                          json={'cluster_name': 'hangc'}, timeout=30)


def _processes_with(cmdline_parts, env_entry: str):
    """pids whose command line holds one of `cmdline_parts` and whose
    environment holds `env_entry`."""
    needle = b'\0' + env_entry.encode() + b'\0'
    found = []
    for entry in os.listdir('/proc'):
        if not entry.isdigit():
            continue
        try:
            with open(f'/proc/{entry}/cmdline', 'rb') as f:
                cmdline = f.read()
            if not any(part in cmdline for part in cmdline_parts):
                continue
            with open(f'/proc/{entry}/environ', 'rb') as f:
                if needle in b'\0' + f.read():
                    found.append(int(entry))
        except OSError:
            continue
    return found


def test_long_request_worker_imports_neither_torch_nor_jax(hung_request):
    """The request's worker process has run the port's launch path up to
    the setup command (execution, the optimizer, the provisioner, the
    backend), and no file of torch or JAX is mapped into it."""
    _, rec = hung_request
    with open(f'/proc/{rec["pid"]}/maps') as f:
        maps = f.read()
    with open(f'/proc/{rec["pid"]}/cmdline', 'rb') as f:
        assert b'multiprocessing' in f.read()
    assert '/torch/' not in maps
    assert '/jaxlib/' not in maps and '/jax/' not in maps


def test_request_cancellation(api_server, hung_request):
    # A hung LONG request (stuck provision analog) is killed by
    # POST /requests/{id}/cancel and its worker slot freed.
    request_id, rec = hung_request
    r = requests_lib.post(f'{api_server}/requests/{request_id}/cancel',
                          timeout=30)
    assert r.status_code == 200

    def cancelled():
        got = requests_lib.get(f'{api_server}/requests/{request_id}',
                               timeout=30).json()
        return got if got['status'] == 'CANCELLED' else None
    wait_for(cancelled, 15, 'the cancelled request', 0.3)
    wait_for(lambda: not os.path.exists(f'/proc/{rec["pid"]}'), 15,
             'the cancelled worker to exit')
    # cancelling a finished request is a 409
    r = requests_lib.post(f'{api_server}/requests/{request_id}/cancel',
                          timeout=30)
    assert r.status_code == 409
    # The half-provisioned local cluster exists; down it.
    sdk.get(sdk.down('hangc'), timeout_s=REQUEST_TIMEOUT_S)
    assert 'hangc' not in [c['name'] for c in sdk.status()]


# ----- the CLI over the port ---------------------------------------------------
def test_cli_status_queue_and_logs(launched):
    runner = CliRunner()
    result = runner.invoke(cli, ['status'])
    assert result.exit_code == 0, result.output
    assert CLUSTER in result.output and 'UP' in result.output
    _wait_job_terminal(CLUSTER, launched['job_id'])
    result = runner.invoke(cli, ['queue', CLUSTER])
    assert result.exit_code == 0, result.output
    assert 'SUCCEEDED' in result.output
    result = runner.invoke(cli, ['logs', CLUSTER, str(launched['job_id']),
                                 '--no-follow'])
    assert result.exit_code == 0, result.output
    assert 'api-hello' in result.output


def test_cli_check_json_has_no_findings():
    """`check --json` runs the port's analyzer over the port (no server)
    with the zero-findings result tests/test_torch_static_analysis.py
    gates."""
    result = CliRunner().invoke(cli, ['check', '--json'])
    assert result.exit_code == 0, result.output
    doc = json.loads(result.output)
    assert [f for f in doc['findings'] if not f['suppressed']] == []
    assert doc['summary']['total'] == 0
    assert doc['summary']['parse_errors'] == []
    assert any(e.startswith('skypilot_tpu_torch.')
               for e in doc['entry_points'])


@pytest.mark.parametrize('accelerator,model', [('H100:8', 'llama3-8b'),
                                               ('H100:1', 'llama3-70b')])
def test_cli_plan_equals_validate_placement(accelerator, model):
    from skypilot_tpu_torch.parallel import validate
    result = CliRunner().invoke(cli, ['plan', '--accelerator', accelerator,
                                      '--model', model])
    report = validate.validate_placement(accelerator, model_name=model)
    assert result.output == report.summary() + '\n'
    assert result.exit_code == (0 if report.fits else 1)


def _baseline(tmp_path, chip='tpu-v5p'):
    path = tmp_path / 'BENCH_r01.json'
    path.write_text(json.dumps({'n': 1, 'rc': 0, 'parsed': {'detail': {
        'train': {'chip': chip, 'mfu_pct': 40.0,
                  'tokens_per_s_per_chip': 1000.0},
        'serve': {'model': 'llama3-8b', 'out_tok_per_s': 500.0,
                  'tpot_median_ms': 10.0}}}}))
    return path


def test_cli_perf_over_baseline(tmp_path, monkeypatch):
    """`perf` runs the port's gate (its probe on the CPU here) against a
    baseline JSON: the same check names as the gate called directly, the
    ratio checks skipped as cross-host, and `--check` exits by `ok` (its
    second run reuses the first run's probe)."""
    from skypilot_tpu_torch.perf import gate
    baseline = _baseline(tmp_path)
    result = CliRunner().invoke(cli, ['perf', '--device', 'cpu',
                                      '--baseline', str(baseline),
                                      '--as-json'])
    assert result.exit_code == 0, result.output
    report = json.loads(result.output)
    direct = gate.run(str(baseline), probe_fn=lambda: report['probe'])
    assert ([(c['name'], c['status']) for c in report['checks']] ==
            [(c['name'], c['status']) for c in direct['checks']])
    assert report['probe']['chip'] == 'cpu'
    assert all(c['status'] == 'skip' for c in report['checks']
               if c['name'].startswith('tolerance:'))
    monkeypatch.setattr(gate, 'probe_serve',
                        lambda device: dict(report['probe'], device=device))
    result = CliRunner().invoke(cli, ['perf', '--device', 'cpu',
                                      '--baseline', str(baseline),
                                      '--check'])
    assert result.exit_code == (0 if report['ok'] else 1), result.output
    assert 'perf gate vs BENCH_r01.json' in result.output


@pytest.mark.parametrize('argv,what', [
    (['rotate-keys'], 'Key rotation complete'),
    (['catalog', 'refresh'], 'Catalogs refreshed')])
def test_cli_unported_commands_refuse(argv, what, tmp_path, monkeypatch):
    """The two commands the port refused until it had authentication.py
    and the catalog fetcher now run, as the JAX CLI's do (under a HOME
    of their own: they write keys and catalogs there)."""
    home = tmp_path / 'home'
    home.mkdir()
    _home_env(monkeypatch, home)
    monkeypatch.setenv('SKYTPU_BILLING_FIXTURE',
                       str(REPO / 'tests' / 'fixtures' /
                           'gcp_billing_skus.json'))
    sky_config.reset_cache_for_tests()
    try:
        result = CliRunner().invoke(cli, argv)
    finally:
        sky_config.reset_cache_for_tests()
    assert result.exit_code == 0, result.output
    assert what in result.output
    assert 'NotSupportedError' not in result.output


def test_cli_volumes_refused_and_nothing_recorded(api_server, monkeypatch):
    """A k8s PVC and a GCP disk, which the port refused until it had the
    kubernetes and gcp provisioners, are created and deleted over REST
    and through the module against the fake APIs (as
    tests/test_volumes.py does for the JAX package), and a bad spec is a
    400 that records nothing."""
    from skypilot_tpu_torch import volumes
    from tests.fake_gce_api import FakeGceApi
    from tests.fake_k8s_api import FakeK8sApi
    k8s, gce = FakeK8sApi(), FakeGceApi()
    try:
        monkeypatch.setenv('SKYTPU_K8S_API_ENDPOINT', k8s.endpoint)
        monkeypatch.setenv('SKYTPU_GCE_API_ENDPOINT', gce.endpoint)
        monkeypatch.setenv('SKYTPU_GCP_PROJECT', 'proj')
        result = CliRunner().invoke(cli, ['volumes', 'apply', 'vol1',
                                          '--type', 'k8s-pvc', '--infra',
                                          'kubernetes/main', '--size',
                                          '10'])
        assert result.exit_code == 0, result.output
        assert [v['name'] for v in sdk.volumes_list()] == ['vol1']
        assert k8s.pvc('default', 'vol1')['spec']['resources'][
            'requests']['storage'] == '10Gi'
        volumes.apply('disk1', 'gcp-disk', 'gcp/us-central1/us-central1-a',
                      5)
        assert gce.state.disks['us-central1-a/disk1']['sizeGb'] == '5'
        result = CliRunner().invoke(cli, ['volumes', 'delete', 'vol1'])
        assert result.exit_code == 0, result.output
        volumes.delete('disk1')
        assert 'us-central1-a/disk1' not in gce.state.disks
        with pytest.raises(KeyError):
            k8s.pvc('default', 'vol1')
    finally:
        k8s.close()
        gce.close()
    # Validation runs first: a bad spec is a 400 and records nothing.
    r = requests_lib.post(f'{api_server}/volumes/apply',
                          json={'name': 'v', 'vtype': 'k8s-pvc',
                                'infra': 'gcp/us-central1', 'size_gb': 1},
                          timeout=30)
    assert r.status_code == 400 and 'k8s-pvc' in r.json()['error']
    assert volumes.list_volumes() == []


def test_volumes_table_is_the_jax_modules():
    from skypilot_tpu import volumes as jax_volumes
    from skypilot_tpu_torch import volumes
    assert volumes._DDL == jax_volumes._DDL  # pylint: disable=protected-access
    assert volumes.VOLUME_TYPES == jax_volumes.VOLUME_TYPES
    assert ([(f.name, f.type) for f in dataclasses.fields(volumes.Volume)]
            == [(f.name, f.type)
                for f in dataclasses.fields(jax_volumes.Volume)])
    # The code the port keeps is the original's.
    keep = ('Volume', '_db_path', '_DDL', '_ensure', 'apply', 'get',
            'list_volumes', 'delete', 'validate_task_volumes', '_row')
    port = _top_level(REPO / 'skypilot_tpu_torch' / 'volumes.py')
    orig = _top_level(REPO / 'skypilot_tpu' / 'volumes.py')
    for name in keep:
        assert port[name] == orig[name], name


def _top_level(path):
    tree = ast.parse(path.read_text().replace('skypilot_tpu_torch',
                                              'skypilot_tpu'))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                out[getattr(target, 'id', None)] = ast.dump(node)
    return out


def test_cli_entrypoints(launched, tmp_path):
    runner = CliRunner()
    # accelerators listing straight through REST
    result = runner.invoke(cli, ['accelerators', 'v6e'])
    assert result.exit_code == 0, result.output
    assert 'tpu-v6e-8' in result.output
    result = runner.invoke(cli, ['check'])
    assert result.exit_code == 0
    assert 'local: enabled' in result.output
    # launch a YAML task end-to-end, onto the module's cluster
    yaml_path = tmp_path / 'task.yaml'
    yaml_path.write_text(
        'name: cliyaml\nresources:\n  infra: local\nrun: echo from-cli\n')
    result = runner.invoke(cli, ['launch', str(yaml_path), '-c', CLUSTER])
    assert result.exit_code == 0, result.output
    assert 'from-cli' in result.output
    result = runner.invoke(cli, ['status'])
    assert CLUSTER in result.output
    result = runner.invoke(cli, ['down', CLUSTER, '--yes'])
    assert result.exit_code == 0, result.output
    assert sdk.status() == []


# ----- one REST sequence, both packages --------------------------------------
_CANONICAL = ['INIT', 'PENDING', 'SETTING_UP', 'RUNNING', 'SUCCEEDED']


def _rest_sequence(url, headers, version_header, min_version, package):
    """Drive one REST sequence against `url`, the server of `package`
    ('jax' or 'torch', named in every wait's timeout); returns the record
    the two packages must agree on (status codes, JSON keys, request,
    cluster and job statuses) and the job statuses each poll saw."""
    out = []

    def call(step, method, path, **kwargs):
        kwargs.setdefault('headers', headers)
        r = requests_lib.request(method, f'{url}{path}', timeout=60,
                                 **kwargs)
        return step, r

    def rec(step, r, body=None):
        body = r.json() if body is None else body
        keys = sorted(body) if isinstance(body, dict) else sorted(
            {k for item in body for k in item})
        out.append((step, r.status_code, keys))
        return body

    def wait_request(rid):
        def done():
            r = requests_lib.get(f'{url}/requests/{rid}', headers=headers,
                                 timeout=60)
            return r if r.json()['status'] in (
                'SUCCEEDED', 'FAILED', 'CANCELLED') else None
        r = wait_for(done, REQUEST_TIMEOUT_S,
                     f'the {package} package\'s request {rid}', 0.3)
        body = rec('request', r)
        out.append(('request-status', body['status'],
                    sorted(body['result'] or {})))
        return body

    body = rec(*call('health', 'GET', '/api/health'))
    out.append(('health-status', body['status'], None))
    _, r = call('check', 'GET', '/check')
    rec('check', r)
    body = r.json()['local']
    out.append(('check-local', body['enabled'], sorted(body['storage'])))
    task = {'name': 'scen', 'run': 'echo scenario-out',
            'resources': {'infra': 'local'}}
    body = rec(*call('launch', 'POST', '/launch',
                     json={'task': task, 'cluster_name': 'scen'}))
    job_id = wait_request(body['request_id'])['result']['job_id']
    seen = []

    def job_terminal():
        _, r = call('queue', 'GET', '/queue/scen')
        jobs = r.json()
        status = next(j['status'] for j in jobs if j['job_id'] == job_id)
        if not seen or seen[-1] != status:
            seen.append(status)
        return r if status in ('SUCCEEDED', 'FAILED', 'CANCELLED') else None
    r = wait_for(job_terminal, 60,
                 f'the {package} package\'s scenario job {job_id}', 0.2)
    jobs = rec('queue', r)
    out.append(('queue-statuses', [j['status'] for j in jobs], None))
    _, r = call('logs', 'GET', f'/logs/scen/{job_id}',
                params={'follow': '0'})
    out.append(('logs', r.status_code, 'scenario-out' in r.text))
    body = rec(*call('status', 'GET', '/status'))
    out.append(('clusters', [(c['name'], c['status']) for c in body], None))
    body = rec(*call('down', 'POST', '/down', json={'cluster_name': 'scen'}))
    wait_request(body['request_id'])
    _, r = call('status-after-down', 'GET', '/status')
    out.append(('status-after-down', r.status_code, r.json()))
    rec(*call('invalid', 'POST', '/launch', json={'bogus': 1}))
    rec(*call('bad-token', 'GET', '/status',
              headers=dict(headers, Authorization='Bearer wrong')))
    rec(*call('old-client', 'GET', '/status',
              headers=dict(headers, **{version_header: str(min_version - 1)})))
    return out, seen


def _in_order(seen):
    idx = [_CANONICAL.index(s) for s in seen]
    return idx == sorted(idx) and seen[-1] == 'SUCCEEDED'


def test_same_rest_sequence_in_both_packages(api_server, tmp_path,
                                             monkeypatch):
    """The same REST sequence (health, check, launch, the request, the
    queue until SUCCEEDED, logs, status, down; then a payload that fails
    validation, a wrong bearer token and a client below the minimum API
    version) against the JAX package's server and the port's, each under
    its own $HOME: the same status codes, JSON keys, request, cluster and
    job statuses.  The port's /check lists the local cloud only, so the
    `local` entry is compared."""
    from skypilot_tpu import sky_config as jax_sky_config
    from skypilot_tpu.client import sdk as jax_sdk
    from skypilot_tpu.jobs import controller as jax_jobs_controller
    from skypilot_tpu.serve import controller as jax_serve_controller
    from skypilot_tpu.server import app as jax_app
    from skypilot_tpu.server import constants as jax_constants
    from skypilot_tpu_torch.server import constants
    assert (jax_constants.API_VERSION, jax_constants.API_VERSION_HEADER,
            jax_constants.MIN_COMPATIBLE_API_VERSION) == (
        constants.API_VERSION, API_VERSION_HEADER,
        MIN_COMPATIBLE_API_VERSION)
    monkeypatch.setenv('SKYTPU_API_TOKEN', 'scenario-token')
    runs = {}
    for name, pkg_make_app, pkg_sdk, reset in (
            ('jax', jax_app.make_app, jax_sdk,
             jax_sky_config.reset_cache_for_tests),
            ('torch', make_app, sdk, sky_config.reset_cache_for_tests)):
        home = tmp_path / name / 'home'
        home.mkdir(parents=True)
        _home_env(monkeypatch, home)
        reset()
        try:
            with app_in_thread(pkg_make_app) as url:
                monkeypatch.setenv('SKYTPU_API_SERVER', url)
                runs[name] = _rest_sequence(
                    url, pkg_sdk.request_headers(), API_VERSION_HEADER,
                    MIN_COMPATIBLE_API_VERSION, name)
        finally:
            jax_jobs_controller.stop_all_controllers()
            jax_serve_controller.stop_all_controllers()
            stop_port_controllers()
            kill_with_env(f'HOME={home}')
            reset()
    (jax_out, jax_seen), (port_out, port_seen) = runs['jax'], runs['torch']
    assert port_out == jax_out
    steps = [s for s, _, _ in port_out]
    assert steps == ['health', 'health-status', 'check', 'check-local',
                     'launch', 'request', 'request-status', 'queue',
                     'queue-statuses', 'logs', 'status', 'clusters', 'down',
                     'request', 'request-status', 'status-after-down',
                     'invalid', 'bad-token', 'old-client']
    codes = {s: c for s, c, _ in port_out}
    assert (codes['launch'], codes['invalid'], codes['bad-token'],
            codes['old-client']) == (200, 400, 401, 426)
    assert dict((s, c) for s, c, _ in port_out)['queue-statuses'] == [
        'SUCCEEDED']
    assert _in_order(jax_seen) and _in_order(port_seen), (jax_seen,
                                                          port_seen)


def test_jax_sdk_accepts_the_port_server(api_server, monkeypatch):
    """The REST API is the same, so the JAX package's SDK handshake
    accepts the port's server."""
    from skypilot_tpu.client import sdk as jax_sdk
    monkeypatch.setenv('SKYTPU_API_SERVER', api_server)
    info = jax_sdk.api_info()
    assert info == sdk.api_info()
    jax_sdk.check_server_compat(info)
    jax_sdk.ensure_server_running()
    assert jax_sdk.status() == sdk.status()
