"""The port's dedicated ("controller on VM") mode, e2e on the local cloud:
the cases of tests/test_controller_vm.py through `skypilot_tpu_torch`
(verbs ship to the controller cluster as agent jobs, a persistent daemon
there drives recovery and services, and the submitting process runs no
controller), and what only the port has to show: the daemon and the
verbs the controller host runs are the port's modules, never the JAX
package's (which a test host with JAX could import, and a host with
only the port could not).  Each verb is a process on the controller
cluster (~7 s on a loaded host), so the cases wait on the tables the
daemon writes (the local cloud's controller host shares the test
process's $HOME, so they are the same sqlite files) and read each
awaited status once more through the queue verb; and they are split over two files that two xdist workers
run side by side: this one holds the end-to-end recovery case and the
controller host's modules (sharing one $HOME, so one controller cluster
and one daemon), tests/test_torch_controller_vm_2.py the cancel and the
service cases, with the helpers of this one.

Every process a case spawned is killed at the module's end
(`reap_marked`, tests/torch_control.py); the daemon is killed when its
$HOME's fixture ends.
"""
import io
import os
import signal

import pytest

from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import sky_config
from skypilot_tpu_torch.jobs import controller as controller_lib
from skypilot_tpu_torch.jobs import controller_daemon
from skypilot_tpu_torch.jobs import core as jobs_core
from skypilot_tpu_torch.jobs import state as jobs_state
from skypilot_tpu_torch.jobs.state import ManagedJobStatus
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.task import Task

from torch_control import (cmdline_of, port_home, reap_marked,  # noqa: F401
                           stop_port_controllers, wait_for)


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


@pytest.fixture(scope='module')
def shared_vm_mode(tmp_path_factory):
    """`vm_mode` for this module's two cases together: one $HOME
    (conftest's tmp_home settings at module scope), so one jobs
    controller cluster and one daemon serve both."""
    home = tmp_path_factory.mktemp('jobs-vm') / 'home'
    home.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('HOME', str(home))
        mp.setenv('SKYTPU_GLOBAL_CONFIG',
                  str(home / '.skytpu' / 'config.yaml'))
        mp.setenv('SKYTPU_PROJECT_CONFIG', str(home / '.skytpu.yaml'))
        mp.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
        mp.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
        _vm_config(home, 'jobs')
        try:
            yield home
        finally:
            _kill_daemon()
            stop_port_controllers()
            sky_config.reset_cache_for_tests()


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


def _wait(job_id, statuses, timeout=120, until=None):
    """The job's record once its status is in `statuses` (and `until(rec)`
    holds), polled from the jobs table the daemon writes, then read once
    more through the queue verb, whose record is returned: the same
    status where it is terminal, else one still in `statuses` (callers
    wait only on states their job cannot leave before they act)."""
    def reached():
        rec = jobs_state.get(job_id)
        return rec if rec is not None and rec['status'] in statuses and (
            until is None or until(rec)) else None
    rec = wait_for(reached, timeout, f'job {job_id} in {statuses}', 0.1)
    recs = {r['job_id']: r for r in jobs_core.queue(all_users=True)}
    got = recs[job_id]
    if rec['status'].is_terminal():
        assert ManagedJobStatus(got['status']) is rec['status'], recs
    else:
        assert ManagedJobStatus(got['status']) in statuses, recs
        assert until is None or until(got), recs
    return got


def _daemon_pid():
    with open(controller_daemon.pid_file_path(), encoding='utf-8') as f:
        return int(f.read())


def test_vm_mode_end_to_end_and_recovery(shared_vm_mode):
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

    gate = shared_vm_mode / 'gate'
    job2 = jobs_core.launch(_local_task(
        f'while [ ! -f {gate} ]; do sleep 0.1; done; echo done-two',
        name='recov'))
    rec = _wait(job2, (ManagedJobStatus.RUNNING,))
    from skypilot_tpu_torch.provision.local import instance as local_instance
    local_instance.inject_preemption(rec['cluster_name'])
    # The daemon has seen the preemption (a recovery counted) before the
    # gate lets the job end: the old cluster's process would see it too.
    _wait(job2, (ManagedJobStatus.RECOVERING, ManagedJobStatus.RUNNING),
          until=lambda r: r['recovery_count'] >= 1)
    gate.write_text('go')
    final = _wait(job2, (ManagedJobStatus.SUCCEEDED,))
    assert final['recovery_count'] >= 1


def test_controller_host_runs_the_ports_modules(shared_vm_mode,
                                                monkeypatch):
    """Every verb shipped to the controller cluster runs
    `python -m skypilot_tpu_torch.jobs.remote_exec`, and the daemon
    there is `-m skypilot_tpu_torch.jobs.controller_daemon` (the live
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
