"""Background daemons, durable request-queue recovery and graceful drain
of the port's server: the cases of tests/test_server_daemons.py against
`skypilot_tpu_torch.server`, and tests/test_multiworker.py's lease
takeover on sqlite (a PENDING row claimed by a crashed instance is run
by a booting `python -m skypilot_tpu_torch.server.app`), moved here so
that each of the two files makes at most three local launches."""
import os
import subprocess
import sys
import threading
import time

import requests as requests_lib

from skypilot_tpu_torch.server import daemons as daemons_lib
from skypilot_tpu_torch.server import requests_db
from skypilot_tpu_torch.server.executor import RequestExecutor
from skypilot_tpu_torch.server.requests_db import RequestStatus

from test_torch_client_server_compat import _mk_local_task, api_server  # noqa: F401
from torch_control import (join_executor, port_home,  # noqa: F401
                           reap_marked, wait_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----- requests GC -----------------------------------------------------------
def test_prune_removes_only_old_terminal(port_home):
    old = requests_db.create('launch', {}, 'long')
    requests_db.set_status(old, RequestStatus.SUCCEEDED, result={})
    live = requests_db.create('launch', {}, 'long')       # PENDING
    fresh = requests_db.create('launch', {}, 'long')
    requests_db.set_status(fresh, RequestStatus.FAILED, error='x')
    # Age the old one: pretend it finished an hour ago.
    from skypilot_tpu_torch.utils import db_utils
    db_utils.execute(requests_db._ensure(),  # pylint: disable=protected-access
                     'UPDATE requests SET finished_at=? WHERE request_id=?',
                     (time.time() - 3600, old))
    assert requests_db.prune(max_age_s=600) == 1
    assert requests_db.get(old) is None
    assert requests_db.get(live) is not None
    assert requests_db.get(fresh) is not None


def test_requests_gc_daemon_fn(port_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_REQUESTS_RETENTION_HOURS', '0')
    rid = requests_db.create('launch', {}, 'long')
    requests_db.set_status(rid, RequestStatus.SUCCEEDED, result={})
    daemons_lib._requests_gc()  # pylint: disable=protected-access
    assert requests_db.get(rid) is None


# ----- durable queue recovery ------------------------------------------------
def test_recover_fails_orphaned_running(port_home):
    rid = requests_db.create('launch', {}, 'long')
    # Simulate a worker that died with the old server: RUNNING + dead pid.
    requests_db.set_status(rid, RequestStatus.RUNNING, pid=99999999)
    ex = RequestExecutor()
    try:
        ex.recover()
    finally:
        ex.shutdown()
    rec = requests_db.get(rid)
    assert rec['status'] is RequestStatus.FAILED
    assert 'restarted' in rec['error']


def test_recover_dispatches_queued_process_requests(port_home):
    body = {'task': _mk_local_task().to_yaml_config(),
            'cluster_name': 'requeued'}
    rid = requests_db.create('launch', body, 'long')     # queued, never ran
    ex = RequestExecutor()
    try:
        ex.recover()
        rec = wait_for(
            lambda: (lambda r: r if r['status'].is_terminal() else None)(
                requests_db.get(rid)), 60, 'the re-dispatched request', 0.3)
        assert rec['status'] is RequestStatus.SUCCEEDED, rec['error']
        assert rec['result']['cluster_name'] == 'requeued'
    finally:
        ex.shutdown()
        join_executor(ex)


def test_recover_fails_unrecoverable_thread_requests(port_home):
    rid = requests_db.create('jobs_launch', {}, 'short')  # closure is gone
    ex = RequestExecutor()
    try:
        ex.recover()
    finally:
        ex.shutdown()
    rec = requests_db.get(rid)
    assert rec['status'] is RequestStatus.FAILED
    assert 'resubmit' in rec['error']


def test_recover_adopts_live_worker_and_cancel_kills_it(port_home):
    proc = subprocess.Popen(['sleep', '300'])
    # Reap it as soon as it dies: a zombie child would look alive to the
    # executor's wait on the adopted pid for its whole 5 s grace.
    threading.Thread(target=proc.wait, daemon=True).start()
    rid = requests_db.create('launch', {}, 'long')
    requests_db.set_status(rid, RequestStatus.RUNNING, pid=proc.pid)
    ex = RequestExecutor()
    try:
        ex.recover()
        rec = requests_db.get(rid)
        assert rec['status'] is RequestStatus.RUNNING   # adopted, not failed
        assert ex.cancel(rid)
        proc.wait(timeout=10)                           # SIGTERMed
        assert requests_db.get(rid)['status'] is RequestStatus.CANCELLED
    finally:
        if proc.poll() is None:
            proc.kill()
        ex.shutdown()
        join_executor(ex)


# ----- graceful drain --------------------------------------------------------
def test_drain_refuses_new_mutations_allows_reads(api_server):
    resp = requests_lib.post(f'{api_server}/api/drain', json={}, timeout=30)
    assert resp.status_code == 200
    health = requests_lib.get(f'{api_server}/api/health', timeout=30).json()
    assert health['status'] == 'draining'
    # Mutations are 503 ...
    body = {'task': _mk_local_task().to_yaml_config()}
    resp = requests_lib.post(f'{api_server}/launch', json=body, timeout=30)
    assert resp.status_code == 503
    # ... reads still work.
    assert requests_lib.get(f'{api_server}/status',
                            timeout=30).status_code == 200


def test_executor_drain_waits_for_workers(port_home):
    ex = RequestExecutor()
    try:
        assert ex.drain(timeout_s=1.0)   # nothing in flight
    finally:
        ex.shutdown()


# ----- controller liveness ---------------------------------------------------
def test_controller_liveness_readopts_jobs(port_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
    from skypilot_tpu_torch.jobs import controller as controller_lib
    from skypilot_tpu_torch.jobs import state as jobs_state
    from skypilot_tpu_torch.jobs.state import ManagedJobStatus
    # A submitted job whose controller never started (e.g. the thread
    # died): PENDING with no live controller.
    jid = jobs_state.submit('orphan', _mk_local_task('echo o')
                            .to_yaml_config())
    assert not controller_lib.controller_alive(jid)
    daemons_lib._controller_liveness()  # pylint: disable=protected-access
    final = controller_lib.wait_job(jid, timeout_s=60)
    assert final is ManagedJobStatus.SUCCEEDED


# ----- lease takeover (tests/test_multiworker.py, sqlite) ---------------------
def server_env(home, agent_pid_file):
    """The environment of a `python -m skypilot_tpu_torch.server.app`
    subprocess under `home` (tests/test_chaos.py's `_server_env`)."""
    env = dict(os.environ)
    env.update({
        'HOME': str(home),
        'SKYTPU_GLOBAL_CONFIG': str(home / '.skytpu' / 'config.yaml'),
        'SKYTPU_PROJECT_CONFIG': str(home / '.skytpu.yaml'),
        'SKYTPU_ENABLED_CLOUDS': 'local',
        'SKYTPU_DAEMONS': '0',
        'SKYTPU_AGENT_PID_FILE': str(agent_pid_file),
        'PYTHONPATH': REPO,
    })
    return env


def start_server(port, env, workers=1, timeout_s=180.0):
    """The port's server on `port` with `workers` processes, once its
    /api/health answers (generous: spawned workers import under suite
    contention)."""
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.server.app', '--port',
         str(port), '--workers', str(workers)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)

    def healthy():
        if proc.poll() is not None:
            raise RuntimeError(f'server exited with {proc.returncode}')
        try:
            return requests_lib.get(f'http://127.0.0.1:{port}/api/health',
                                    timeout=1).ok
        except requests_lib.ConnectionError:
            return False
    try:
        wait_for(healthy, timeout_s, 'the API server healthy', 0.1)
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        raise
    return proc


def stop_server(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def test_dead_instance_lease_takeover_e2e(tmp_path, monkeypatch):
    """Kill-the-claim-holder recovery, end to end: a PENDING launch row
    claimed by a server instance that stopped heartbeating (crashed) is
    taken over and executed by a booting server once the lease expires
    (sqlite, lease mode forced)."""
    from skypilot_tpu_torch.parallel.group import free_port
    from skypilot_tpu_torch.state import leases
    from skypilot_tpu_torch.utils import db_utils
    home = tmp_path / 'home'
    home.mkdir()
    pid_file = tmp_path / 'agent-pids.txt'
    pid_file.touch()
    env = server_env(home, pid_file)
    monkeypatch.setenv('HOME', env['HOME'])
    monkeypatch.setenv('SKYTPU_LEASE_TTL_S', '2.0')
    env['SKYTPU_LEASE_TTL_S'] = '2.0'
    monkeypatch.delenv('SKYTPU_DB_URL', raising=False)
    monkeypatch.setenv('SKYTPU_DB_LEASES', '1')
    monkeypatch.setenv('SKYTPU_REQUESTS_DB',
                       os.path.join(env['HOME'], '.skytpu', 'requests.db'))
    env['SKYTPU_DB_LEASES'] = '1'
    env['SKYTPU_REQUESTS_DB'] = os.environ['SKYTPU_REQUESTS_DB']
    marker = tmp_path / 'takeover-ran.txt'
    rid = requests_db.create('launch', {
        'task': {'name': 'takeover',
                 'run': f'echo ran >> {marker}',
                 'resources': {'infra': 'local'}},
        'cluster_name': 'takec',
    })
    # Claimed by a "crashed" instance: claim row + heartbeat row whose
    # beat is already one TTL stale.
    now = time.time()
    dsn = requests_db.db_dsn()
    db_utils.ensure_schema(dsn, leases._DDL)  # pylint: disable=protected-access
    db_utils.execute(
        dsn, 'UPDATE requests SET claim_instance=?, claim_pid=?, '
        'claim_at=? WHERE request_id=?',
        ('crashedhost:1:dead', 424242, now, rid))
    db_utils.execute(
        dsn, 'INSERT INTO server_instances (instance_id, host, pid, '
        'started_at, last_heartbeat) VALUES (?,?,?,?,?)',
        ('crashedhost:1:dead', 'crashedhost', 424242, now - 60,
         now - 10.0))
    port = free_port()
    proc = start_server(port, env, workers=1)
    try:
        def terminal():
            rec = requests_lib.get(
                f'http://127.0.0.1:{port}/requests/{rid}', timeout=10).json()
            return rec if rec.get('status') in (
                'SUCCEEDED', 'FAILED', 'CANCELLED') else None
        rec = wait_for(terminal, 120, 'the taken-over request', 0.3)
        assert rec['status'] == 'SUCCEEDED', rec.get('error')
        assert rec['claim_instance'] != 'crashedhost:1:dead'
        wait_for(marker.exists, 30, 'the taken-over job')
        assert marker.read_text().splitlines() == ['ran']
    finally:
        stop_server(proc)
