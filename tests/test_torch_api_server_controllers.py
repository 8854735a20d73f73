"""The two controller cases of tests/test_api_server.py against the
port's server: a managed job and a service driven over REST, their
controllers (and the service's load balancer) running inside the server
process.  Split from tests/test_torch_api_server.py so that each file
makes at most three local launches and two xdist workers share them."""
import io

from click.testing import CliRunner

from skypilot_tpu_torch.client import sdk
from skypilot_tpu_torch.client.cli import cli

from test_torch_client_server_compat import _mk_local_task, api_server  # noqa: F401
from torch_control import port_home, reap_marked, wait_for  # noqa: F401

TERMINAL_JOB = ('SUCCEEDED', 'FAILED', 'FAILED_SETUP', 'FAILED_NO_RESOURCE',
                'FAILED_CONTROLLER', 'CANCELLED')


def test_managed_jobs_over_rest(api_server, monkeypatch):
    """jobs launch -> queue -> logs -> terminal SUCCEEDED, all via REST.

    The controller threads run inside the API-server process
    (consolidation mode); the client only ever polls REST.
    """
    monkeypatch.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
    result = sdk.get(sdk.jobs_launch(_mk_local_task('echo managed-rest'),
                                     name='mjrest'), timeout_s=180)
    job_id = result['job_id']

    def terminal():
        recs = [r for r in sdk.jobs_queue() if r['job_id'] == job_id]
        assert recs, 'job missing from queue'
        return recs[0]['status'] if recs[0]['status'] in TERMINAL_JOB \
            else None
    status = wait_for(terminal, 60, 'the managed job', 0.3)
    assert status == 'SUCCEEDED', status
    out = io.StringIO()
    sdk.jobs_tail_logs(job_id, follow=False, out=out)
    assert 'managed-rest' in out.getvalue()
    # cancel of a finished job is a clean no-op over REST too
    assert sdk.jobs_cancel(job_id) is False


def test_serve_over_rest(api_server, monkeypatch):
    """serve up -> READY behind the LB -> proxied request -> down, all
    via REST + CLI (controller + LB run inside the API-server process)."""
    monkeypatch.setenv('SKYTPU_SERVE_TICK_INTERVAL', '0.25')
    import urllib.request

    run_cmd = ('python3 -c "import http.server, os\n'
               'class H(http.server.BaseHTTPRequestHandler):\n'
               '    def do_GET(self):\n'
               '        self.send_response(200)\n'
               '        self.send_header(\'Content-Length\', \'2\')\n'
               '        self.end_headers()\n'
               '        self.wfile.write(b\'ok\')\n'
               '    def log_message(self, *a): pass\n'
               'http.server.HTTPServer((\'127.0.0.1\', '
               'int(os.environ[\'SKYTPU_SERVE_REPLICA_PORT\'])), '
               'H).serve_forever()"')
    task = _mk_local_task(run_cmd)
    task.service = {'readiness_probe': {'path': '/',
                                        'initial_delay_seconds': 30,
                                        'timeout_seconds': 2},
                    'replicas': 1}
    result = sdk.get(sdk.serve_up(task, 'restsvc'), timeout_s=180)
    assert result['name'] == 'restsvc'
    endpoint = result['endpoint']

    def settled():
        svcs = sdk.serve_status(['restsvc'])
        assert svcs, 'service missing from status'
        status = svcs[0]['status']
        return status if status in ('READY', 'FAILED', 'SHUTDOWN') else None
    status = wait_for(settled, 60, 'the service READY', 0.3)
    assert status == 'READY', status
    with urllib.request.urlopen(endpoint + '/x', timeout=5) as resp:
        assert resp.status == 200
        assert resp.read() == b'ok'
    # CLI status renders the replica table.
    out = CliRunner().invoke(cli, ['serve', 'status'])
    assert out.exit_code == 0, out.output
    assert 'restsvc' in out.output and 'READY' in out.output
    # replica logs over REST
    buf = io.StringIO()
    sdk.serve_replica_logs('restsvc', 1, follow=False, out=buf)
    sdk.get(sdk.serve_down('restsvc'), timeout_s=180)
    wait_for(lambda: sdk.serve_status(['restsvc'])[0]['status'] ==
             'SHUTDOWN', 60, 'the service SHUTDOWN', 0.3)
