"""The port's dedicated ("controller on VM") mode, e2e on the local cloud:
the three cases of tests/test_controller_vm.py through
`skypilot_tpu_torch` (verbs ship to the controller cluster as agent
jobs, a persistent daemon there drives recovery and services, and the
submitting process runs no controller), and what only the port has to
show: the daemon and the verbs the controller host runs are the port's
modules, never the JAX package's (which this machine could import, and
the card's machine could not).

Every process a case spawned is killed at the module's end
(`reap_marked`, tests/torch_control.py); each case kills its daemon.
"""
import io
import os
import signal
import time

import pytest

from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import sky_config
from skypilot_tpu_torch.jobs import controller as controller_lib
from skypilot_tpu_torch.jobs import controller_daemon
from skypilot_tpu_torch.jobs import core as jobs_core
from skypilot_tpu_torch.jobs.state import ManagedJobStatus
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.task import Task

from torch_control import cmdline_of, port_home, reap_marked  # noqa: F401


def _vm_config(home, namespace):
    config = home / '.skytpu' / 'config.yaml'
    config.parent.mkdir(parents=True, exist_ok=True)
    config.write_text(f'{namespace}:\n'
                      '  controller:\n'
                      '    mode: vm\n'
                      '    resources:\n'
                      '      infra: local\n')
    sky_config.reset_cache_for_tests()


def _kill_daemon():
    try:
        with open(controller_daemon.pid_file_path(), encoding='utf-8') as f:
            os.kill(int(f.read()), signal.SIGKILL)
    except (OSError, ValueError):
        pass


@pytest.fixture
def vm_mode(port_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
    _vm_config(port_home, 'jobs')
    yield port_home
    _kill_daemon()


@pytest.fixture
def serve_vm_mode(port_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
    monkeypatch.setenv('SKYTPU_SERVE_TICK_INTERVAL', '0.25')
    _vm_config(port_home, 'serve')
    yield port_home
    _kill_daemon()


def _local_task(run, name='vmjob'):
    t = Task(name, run=run)
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    return t


def _wait(job_id, statuses, timeout=120):
    deadline = time.time() + timeout
    recs = {}
    while time.time() < deadline:
        recs = {r['job_id']: r for r in jobs_core.queue(all_users=True)}
        rec = recs.get(job_id)
        if rec and ManagedJobStatus(rec['status']) in statuses:
            return rec
        time.sleep(0.5)
    raise TimeoutError(
        f'job {job_id} never reached {statuses}; queue={recs}')


def _daemon_pid():
    with open(controller_daemon.pid_file_path(), encoding='utf-8') as f:
        return int(f.read())


def test_vm_mode_end_to_end_and_recovery(vm_mode):
    job_id = jobs_core.launch(_local_task('echo done-one'))
    assert global_user_state.get_cluster(
        jobs_core.JOBS_CONTROLLER_CLUSTER) is not None
    # This process runs no controller thread: the daemon on the
    # controller cluster does.
    assert not controller_lib.live_controllers()
    _wait(job_id, (ManagedJobStatus.SUCCEEDED,))
    assert controller_daemon.daemon_alive()

    buf = io.StringIO()
    jobs_core.tail_logs(job_id, out=buf)
    assert 'done-one' in buf.getvalue()

    gate = vm_mode / 'gate'
    job2 = jobs_core.launch(_local_task(
        f'while [ ! -f {gate} ]; do sleep 0.1; done; echo done-two',
        name='recov'))
    rec = _wait(job2, (ManagedJobStatus.RUNNING,))
    from skypilot_tpu_torch.provision.local import instance as local_instance
    local_instance.inject_preemption(rec['cluster_name'])
    _wait(job2, (ManagedJobStatus.RECOVERING, ManagedJobStatus.RUNNING))
    gate.write_text('go')
    final = _wait(job2, (ManagedJobStatus.SUCCEEDED,))
    assert final['recovery_count'] >= 1


def test_vm_mode_cancel(vm_mode):
    gate = vm_mode / 'never'
    job_id = jobs_core.launch(_local_task(
        f'while [ ! -f {gate} ]; do sleep 0.1; done'))
    _wait(job_id, (ManagedJobStatus.RUNNING,))
    assert jobs_core.cancel(job_id)
    _wait(job_id, (ManagedJobStatus.CANCELLED,))


_REPLICA_RUN = (
    "python3 -c \"import http.server, os\n"
    "class H(http.server.BaseHTTPRequestHandler):\n"
    "    def do_GET(self):\n"
    "        self.send_response(200)\n"
    "        self.send_header('Content-Length', '2')\n"
    "        self.end_headers(); self.wfile.write(b'ok')\n"
    "    def log_message(self, *a): pass\n"
    "http.server.HTTPServer(('127.0.0.1', "
    "int(os.environ['SKYTPU_SERVE_REPLICA_PORT'])), H).serve_forever()\"")


def test_serve_vm_mode_end_to_end(serve_vm_mode):
    """The service controller and LB live on the dedicated controller
    cluster; this process runs no serve controller, yet the service
    comes up, answers through the controller host's endpoint, and tears
    down."""
    import urllib.request
    from skypilot_tpu_torch import serve as serve_lib
    from skypilot_tpu_torch.serve import controller as serve_ctl
    from skypilot_tpu_torch.serve.serve_state import ServiceStatus

    t = Task('vmsvc', run=_REPLICA_RUN, service={
        'readiness_probe': {'path': '/', 'initial_delay_seconds': 30},
        'replicas': 1})
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    result = serve_lib.up(t)
    assert 'endpoint' in result
    assert not serve_ctl.live_controllers()
    deadline = time.time() + 120
    records = []
    while time.time() < deadline:
        records = serve_lib.status('vmsvc')
        if records and records[0]['status'] is ServiceStatus.READY:
            break
        time.sleep(0.5)
    else:
        raise TimeoutError(f'never READY: {records}')
    assert controller_daemon.daemon_alive()
    body = urllib.request.urlopen(result['endpoint'], timeout=10).read()
    assert body == b'ok'
    serve_lib.down('vmsvc')
    deadline = time.time() + 60
    while time.time() < deadline:
        records = serve_lib.status('vmsvc')
        if not records or records[0]['status'] is ServiceStatus.SHUTDOWN:
            break
        time.sleep(0.5)
    else:
        raise TimeoutError(f'service never torn down: {records}')


def test_controller_host_runs_the_ports_modules(vm_mode, monkeypatch):
    """Every verb shipped to the controller cluster runs
    `python -m skypilot_tpu_torch.jobs.remote_exec`, and the daemon it
    spawns is `-m skypilot_tpu_torch.jobs.controller_daemon` (the live
    process's /proc/<pid>/cmdline), with neither torch nor JAX mapped
    (its /proc/<pid>/maps)."""
    from skypilot_tpu_torch import execution
    runs = []
    real_exec = execution.exec_

    def recording_exec(task, cluster, *args, **kwargs):
        runs.append(task.run)
        return real_exec(task, cluster, *args, **kwargs)

    monkeypatch.setattr(execution, 'exec_', recording_exec)
    job_id = jobs_core.launch(_local_task('echo which-daemon'))
    _wait(job_id, (ManagedJobStatus.SUCCEEDED,))
    assert runs and all(
        'python -m skypilot_tpu_torch.jobs.remote_exec ' in run
        for run in runs), runs
    pid = _daemon_pid()
    cmdline = cmdline_of(pid)
    assert '-m skypilot_tpu_torch.jobs.controller_daemon' in cmdline, cmdline
    with open(f'/proc/{pid}/maps', encoding='utf-8') as f:
        maps = f.read()
    assert '/torch/' not in maps and '/jaxlib/' not in maps
