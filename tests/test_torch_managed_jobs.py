"""Managed jobs of the port on the local cloud (`skypilot_tpu_torch.jobs`):
the ten cases of tests/test_managed_jobs.py against the port's jobs
controller, one scripted scenario run through both packages' managed
jobs (the same status sequence and recovery count), and a port Trainer
job preempted after a checkpoint that resumes from it with the
uninterrupted run's losses.

Every wait has a deadline; the port's controller threads are stopped
after each case (`port_home`) and every process a case spawned is
killed at the module's end (`reap_marked`, tests/torch_control.py).
"""
import json
import os
import sys
import time

import pytest

from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import jobs
from skypilot_tpu_torch.jobs import controller as controller_lib
from skypilot_tpu_torch.jobs import state as jobs_state
from skypilot_tpu_torch.jobs.state import ManagedJobStatus
from skypilot_tpu_torch.provision.local import instance as local_instance
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.task import Task

from torch_control import (bounded, kill_with_env, port_home,  # noqa: F401
                           reap_marked, wait_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jobs_env(port_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
    return port_home


def _local_task(run, name='mj', **kwargs):
    t = Task(name, run=run, **kwargs)
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    return t


def _wait_status(job_id, statuses, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rec = jobs_state.get(job_id)
        if rec['status'] in statuses:
            return rec
        time.sleep(0.1)
    raise TimeoutError(
        f'job {job_id} never reached {statuses}; '
        f'at {jobs_state.get(job_id)["status"]}')


def _wait_cluster_gone(name, timeout=30.0):
    deadline = time.time() + timeout
    while global_user_state.get_cluster(name) is not None:
        if time.time() > deadline:
            raise TimeoutError(f'cluster {name} still up after {timeout} s')
        time.sleep(0.2)


def _chain(*tasks):
    from skypilot_tpu_torch import dag as dag_lib
    dag = dag_lib.Dag('pipe')
    prev = None
    for t in tasks:
        dag.add(t)
        if prev is not None:
            dag.add_edge(prev, t)
        prev = t
    return dag


# ----- the ten cases of tests/test_managed_jobs.py ----------------------------
def test_managed_job_succeeds_and_cleans_up(jobs_env):
    job_id = jobs.launch(_local_task('echo managed-ok'))
    rec = controller_lib.wait_job(job_id, timeout_s=60)
    assert rec is ManagedJobStatus.SUCCEEDED
    cluster = jobs_state.get(job_id)['cluster_name']
    assert global_user_state.get_cluster(cluster) is None


def test_managed_job_recovers_from_preemption_and_resumes(jobs_env):
    """Train with checkpointing, preempt mid-run, the controller deletes
    the stale cluster, re-provisions, and the workload resumes from its
    checkpoint; the recovery's cost lands in the goodput ledger, bounded
    by the controller's flight-recorder spans, and `jobs top` shows
    it."""
    ckpt = jobs_env / 'ckpt-step.txt'
    run = f'''
step=$(cat {ckpt} 2>/dev/null || echo 0)
if [ "$step" -gt 0 ]; then echo "resumed from step $step"; fi
while [ "$step" -lt 20 ]; do
  step=$((step+1))
  echo "$step" > {ckpt}
  sleep 0.15
done
echo training-done
'''
    job_id = jobs.launch(_local_task(run, name='train'))
    _wait_status(job_id, (ManagedJobStatus.RUNNING,))
    deadline = time.time() + 15
    while time.time() < deadline:
        if ckpt.exists() and int(ckpt.read_text() or 0) >= 3:
            break
        time.sleep(0.1)
    assert ckpt.exists(), 'training never started'
    cluster = jobs_state.get(job_id)['cluster_name']
    local_instance.inject_preemption(cluster)
    step_at_preemption = int(ckpt.read_text())

    _wait_status(job_id, (ManagedJobStatus.RECOVERING,), timeout=20)
    final = controller_lib.wait_job(job_id, timeout_s=90)
    assert final is ManagedJobStatus.SUCCEEDED
    rec = jobs_state.get(job_id)
    assert rec['recovery_count'] >= 1
    assert int(ckpt.read_text()) == 20
    assert step_at_preemption >= 3

    from skypilot_tpu_torch.obs import goodput as goodput_lib
    from skypilot_tpu_torch.obs import jobs_top
    from skypilot_tpu_torch.server import tracing
    ledger = goodput_lib.GoodputLedger()
    totals = ledger.totals(str(job_id))
    assert totals.get(goodput_lib.PREEMPTION_DOWNTIME, 0.0) > 0
    assert totals.get(goodput_lib.RECOVERY_RELAUNCH, 0.0) > 0
    downtime = ledger.downtime_s(str(job_id))
    assert downtime == pytest.approx(
        totals[goodput_lib.PREEMPTION_DOWNTIME]
        + totals[goodput_lib.RECOVERY_RELAUNCH])
    down_iv = ledger.intervals(str(job_id),
                               goodput_lib.PREEMPTION_DOWNTIME)
    re_iv = ledger.intervals(str(job_id),
                             goodput_lib.RECOVERY_RELAUNCH)
    assert down_iv and re_iv
    assert down_iv[0]['t1'] == pytest.approx(re_iv[0]['t0'], abs=1e-6)
    spans = {e['attrs']['category']: e
             for e in tracing.events_for(f'job-{job_id}')
             if e['name'] == goodput_lib.DOWNTIME_SPAN}
    for cat, iv in ((goodput_lib.PREEMPTION_DOWNTIME, down_iv[0]),
                    (goodput_lib.RECOVERY_RELAUNCH, re_iv[0])):
        assert abs(spans[cat]['ts'] - iv['t0']) < 1.0
        assert abs(spans[cat]['dur_ms'] / 1e3
                   - (iv['t1'] - iv['t0'])) < 1.0
    # The port has no CLI yet: its `jobs top` frame is where the
    # recovery count and the downtime show.
    frame = jobs_top.render(jobs_top.snapshot(str(job_id), job_rec=rec))
    assert f'recoveries {rec["recovery_count"]}' in frame.splitlines()[0]
    assert 'RECOVERY TIMELINE:' in frame
    assert goodput_lib.PREEMPTION_DOWNTIME in frame


def test_managed_job_restarts_on_user_failure_then_fails(jobs_env):
    marker = jobs_env / 'attempts.txt'
    t = _local_task(f'echo x >> {marker}; exit 7', name='flaky')
    t.set_resources(Resources.from_yaml_config(
        {'infra': 'local',
         'job_recovery': {'strategy': 'FAILOVER',
                          'max_restarts_on_errors': 2}}))
    job_id = jobs.launch(t)
    final = controller_lib.wait_job(job_id, timeout_s=90)
    assert final is ManagedJobStatus.FAILED
    assert len(marker.read_text().splitlines()) == 3
    _wait_cluster_gone(jobs_state.get(job_id)['cluster_name'])


def test_managed_job_cancel(jobs_env):
    job_id = jobs.launch(_local_task('sleep 120', name='sleeper'))
    _wait_status(job_id, (ManagedJobStatus.RUNNING,))
    assert jobs.cancel(job_id)
    final = controller_lib.wait_job(job_id, timeout_s=30)
    assert final is ManagedJobStatus.CANCELLED
    rec = jobs_state.get(job_id)
    assert global_user_state.get_cluster(rec['cluster_name']) is None
    assert not jobs.cancel(job_id)


def test_managed_job_queue_lists_jobs(jobs_env):
    job_id = jobs.launch(_local_task('echo q'))
    controller_lib.wait_job(job_id, timeout_s=60)
    q = jobs.queue()
    assert any(r['job_id'] == job_id and
               r['status'] is ManagedJobStatus.SUCCEEDED for r in q)


def test_pipeline_runs_tasks_in_order(jobs_env):
    log = jobs_env / 'order.txt'
    t1 = _local_task(f'echo one >> {log}', name='stage-one')
    t2 = _local_task(f'echo two >> {log}', name='stage-two')
    job_id = jobs.launch(_chain(t1, t2))
    final = controller_lib.wait_job(job_id, timeout_s=90)
    assert final is ManagedJobStatus.SUCCEEDED
    assert log.read_text().split() == ['one', 'two']
    rec = jobs_state.get(job_id)
    assert rec['num_tasks'] == 2 and rec['task_index'] == 1
    for idx, t in enumerate((t1, t2)):
        name = controller_lib.cluster_name_for_job(job_id, t.name, idx, 2)
        assert global_user_state.get_cluster(name) is None


def test_pipeline_recovers_current_task_only(jobs_env):
    log = jobs_env / 'runs.txt'
    gate = jobs_env / 'gate'
    t1 = _local_task(f'echo first >> {log}', name='one')
    run2 = f'''
echo second >> {log}
while [ ! -f {gate} ]; do sleep 0.1; done
echo done-two'''
    t2 = _local_task(run2, name='two')
    job_id = jobs.launch(_chain(t1, t2))
    deadline = time.time() + 30
    while time.time() < deadline:
        rec = jobs_state.get(job_id)
        if rec['task_index'] == 1 and \
                rec['status'] is ManagedJobStatus.RUNNING and \
                log.exists() and 'second' in log.read_text():
            break
        time.sleep(0.1)
    rec = jobs_state.get(job_id)
    assert rec['task_index'] == 1, rec['status']
    local_instance.inject_preemption(rec['cluster_name'])
    _wait_status(job_id, (ManagedJobStatus.RECOVERING,), timeout=20)
    gate.write_text('go')
    final = controller_lib.wait_job(job_id, timeout_s=90)
    assert final is ManagedJobStatus.SUCCEEDED
    runs = log.read_text().split()
    assert runs.count('first') == 1
    assert runs.count('second') >= 2
    assert jobs_state.get(job_id)['recovery_count'] >= 1


def test_pipeline_fails_fast_on_task_failure(jobs_env):
    log = jobs_env / 'fail.txt'
    t1 = _local_task('exit 3', name='bad')
    t2 = _local_task(f'echo never >> {log}', name='after')
    job_id = jobs.launch(_chain(t1, t2))
    final = controller_lib.wait_job(job_id, timeout_s=90)
    assert final is ManagedJobStatus.FAILED
    assert not log.exists()
    assert jobs_state.get(job_id)['task_index'] == 0


def test_failed_setup_is_immediately_terminal(jobs_env):
    marker = jobs_env / 'setup-attempts.txt'
    t = _local_task('echo unreachable', name='badsetup')
    t.setup = f'echo x >> {marker}; exit 9'
    t.set_resources(Resources.from_yaml_config(
        {'infra': 'local',
         'job_recovery': {'strategy': 'FAILOVER',
                          'max_restarts_on_errors': 3}}))
    job_id = jobs.launch(t)
    final = controller_lib.wait_job(job_id, timeout_s=90)
    assert final is ManagedJobStatus.FAILED_SETUP
    assert len(marker.read_text().splitlines()) == 1


def test_state_guards(port_home):
    jid = jobs_state.submit('g', {'run': 'true'})
    assert jobs_state.get(jid)['status'] is ManagedJobStatus.PENDING
    assert jobs_state.request_cancel(jid)
    assert not jobs_state.set_status(jid, ManagedJobStatus.RUNNING)
    assert jobs_state.get(jid)['status'] is ManagedJobStatus.CANCELLING
    assert jobs_state.set_status(jid, ManagedJobStatus.CANCELLED)
    assert not jobs_state.set_status(jid, ManagedJobStatus.RUNNING)
    assert not jobs_state.request_cancel(jid)


# ----- one scenario through both packages -------------------------------------
def _package(name):
    """The modules a scenario drives, of `skypilot_tpu` or
    `skypilot_tpu_torch`."""
    import importlib

    def mod(rel):
        return importlib.import_module(f'{name}.{rel}')

    return {'jobs': mod('jobs'), 'state': mod('jobs.state'),
            'controller': mod('jobs.controller'),
            'instance': mod('provision.local.instance'),
            'Task': mod('task').Task,
            'Resources': mod('resources').Resources,
            'sky_config': mod('sky_config'),
            'global_user_state': mod('global_user_state')}


def _scenario(pkg, kind, home, monkeypatch):
    """Run one scripted managed job through `pkg` under `home`; returns
    (every status it passed through, in order, recovery_count).  Each wait
    names the package whose half it is."""
    state = pkg['state']
    package = pkg['jobs'].__name__.split('.')[0]
    seen = []
    set_status, request_cancel = state.set_status, state.request_cancel

    def recording_set_status(job_id, status, *args, **kwargs):
        ok = set_status(job_id, status, *args, **kwargs)
        if ok:
            seen.append(status.value)
        return ok

    def recording_request_cancel(job_id):
        ok = request_cancel(job_id)
        if ok:
            seen.append('CANCELLING')
        return ok

    monkeypatch.setattr(state, 'set_status', recording_set_status)
    monkeypatch.setattr(state, 'request_cancel', recording_request_cancel)
    gate, started = home / 'gate', home / 'started'
    runs = {
        'succeed': 'echo ok',
        'preempt': (f'echo x >> {started}; while [ ! -f {gate} ]; '
                    f'do sleep 0.05; done'),
        'fail': 'exit 3',
        'cancel': f'echo x >> {started}; sleep 60',
    }
    t = pkg['Task'](f'sc-{kind}', run=runs[kind])
    t.set_resources(pkg['Resources'].from_yaml_config(
        {'infra': 'local',
         'job_recovery': {'strategy': 'FAILOVER',
                          'max_restarts_on_errors': 1}}))
    job_id = pkg['jobs'].launch(t)
    ctl = pkg['controller']
    try:
        if kind == 'preempt':
            wait_for(lambda: started.exists() and 'RUNNING' in seen, 30,
                     f'{package}: the job RUNNING', 0.05)
            # The node is lost with its processes (the local provisioner's
            # terminate kills none): no agent of the old cluster outlives
            # the recovery's teardown and touches the state it removes.
            assert kill_with_env(f'HOME={home}') >= 2
            pkg['instance'].inject_preemption(
                state.get(job_id)['cluster_name'])
            wait_for(lambda: 'RECOVERING' in seen, 30,
                     f'{package}: RECOVERING', 0.05)
            gate.write_text('go')
        elif kind == 'cancel':
            wait_for(lambda: started.exists() and 'RUNNING' in seen, 30,
                     f'{package}: the job RUNNING', 0.05)
            assert pkg['jobs'].cancel(job_id)
        ctl.wait_job(job_id, timeout_s=60)
        rec = state.get(job_id)
        _wait_gone(pkg, rec['cluster_name'])
    finally:
        ctl.stop_all_controllers()
    return ['PENDING'] + seen, rec['recovery_count']

# launch, at most three 30 s waits, the 60 s wait_job and the 30 s wait
# for the cluster to go, with a margin for a loaded machine.
SCENARIO_TIMEOUT_S = 300


def _wait_gone(pkg, cluster):
    gus = pkg['global_user_state']
    wait_for(lambda: gus.get_cluster(cluster) is None, 30,
             f'{gus.__name__.split(".")[0]}: {cluster} gone', 0.05)


@pytest.mark.parametrize('kind', ['succeed', 'preempt', 'fail', 'cancel'])
def test_same_scenario_same_statuses_in_both_packages(kind, tmp_path,
                                                      monkeypatch):
    """Succeed, preempt-and-resume, fail with one restart, cancel: the
    JAX package's managed jobs and the port's, each under a HOME of its
    own, pass through the same statuses in the same order and count the
    same recoveries."""
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
    monkeypatch.setenv('SKYTPU_JOBS_POLL_INTERVAL', '0.25')
    out = {}
    for name in ('skypilot_tpu', 'skypilot_tpu_torch'):
        pkg = _package(name)
        home = tmp_path / name
        home.mkdir()
        monkeypatch.setenv('HOME', str(home))
        monkeypatch.setenv('SKYTPU_GLOBAL_CONFIG',
                           str(home / '.skytpu' / 'config.yaml'))
        monkeypatch.setenv('SKYTPU_PROJECT_CONFIG', str(home / '.skytpu.yaml'))
        pkg['sky_config'].reset_cache_for_tests()
        try:
            # One deadline over the whole scenario (each of its waits has
            # its own): a hang in either package fails this case, and its
            # processes are killed by HOME, rather than eat the run.
            out[name] = bounded(_scenario, pkg, kind, home, monkeypatch,
                                timeout=SCENARIO_TIMEOUT_S)
        finally:
            pkg['controller'].stop_all_controllers()
            kill_with_env(f'HOME={home}')
            pkg['sky_config'].reset_cache_for_tests()
    want = {
        'succeed': (['PENDING', 'STARTING', 'RUNNING', 'SUCCEEDED'], 0),
        'preempt': (['PENDING', 'STARTING', 'RUNNING', 'RECOVERING',
                     'RUNNING', 'SUCCEEDED'], 1),
        'fail': (['PENDING', 'STARTING', 'RUNNING', 'RECOVERING', 'RUNNING',
                  'FAILED'], 0),
        'cancel': (['PENDING', 'STARTING', 'RUNNING', 'CANCELLING',
                    'CANCELLED'], 0),
    }[kind]
    assert out['skypilot_tpu_torch'] == out['skypilot_tpu'] == want


# ----- a port Trainer job, preempted after a checkpoint -----------------------
def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_tiny_trainer_job_resumes_from_its_checkpoint(jobs_env):
    """chip_smoke's managed job at `tiny` on the CPU: 8 steps, a
    checkpoint every 2; the first attempt blocks after the checkpoint of
    step 4, its cluster's processes are killed (agent and job, as a lost
    VM would) and the node marked preempted.  The recovered attempt
    restores step 4 and its losses at steps 5-8 equal an uninterrupted
    port run's within 1e-6 relative; the goodput ledger holds the job's
    phases and the recovery, the downtime ending where the relaunch
    starts."""
    import torch
    from skypilot_tpu_torch.obs import goodput as goodput_lib
    cs = _chip_smoke()
    spec = dict(cs.MANAGED_JOB, model='tiny', n_layers=2, batch=2, seq=32,
                steps=8, checkpoint_every=2, preempt_at=4, block_s=120,
                device='cpu', ckpt_dir=str(jobs_env / 'ckpt'))
    task = _local_task(cs.MANAGED_JOB_RUN, name='tiny-train',
                       envs={'MANAGED_JOB_SPEC': json.dumps(spec)})
    job_id = jobs.launch(task)
    blocked = jobs_env / 'ckpt' / 'step_4'
    deadline = time.time() + 120
    while not blocked.is_dir():
        assert not jobs_state.get(job_id)['status'].is_terminal(), (
            jobs_state.get(job_id))
        assert time.time() < deadline, 'no checkpoint of step 4'
        time.sleep(0.1)
    cluster = jobs_state.get(job_id)['cluster_name']
    # Every process of this case so far is the first attempt's cluster.
    assert kill_with_env(f'HOME={jobs_env}') >= 2
    local_instance.inject_preemption(cluster)
    final = controller_lib.wait_job(job_id, timeout_s=120)
    rec = jobs_state.get(job_id)
    assert final is ManagedJobStatus.SUCCEEDED and rec['recovery_count'] == 1
    assert global_user_state.get_cluster(cluster) is None
    import io
    buf = io.StringIO()
    jobs.tail_logs(job_id, follow=False, out=buf)
    lines = [json.loads(line)['managed_job']
             for line in buf.getvalue().splitlines()
             if line.startswith('{"managed_job"')]
    assert len(lines) == 1, buf.getvalue()
    assert lines[0]['restored'] == 4

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer, cfg = cs.managed_trainer(spec, torch.device('cpu'))
        want = cs.managed_steps(trainer, cfg, spec, torch.device('cpu'), 0)
    finally:
        torch.set_num_threads(threads)
    got = lines[0]['losses']
    assert len(got) == 4
    for a, b in zip(got, want[4:]):
        assert abs(a - b) <= 1e-6 * abs(b), (got, want[4:])

    ledger = goodput_lib.GoodputLedger()
    totals = ledger.totals(str(job_id))
    for cat in (goodput_lib.PRODUCTIVE, goodput_lib.CHECKPOINT_SAVE,
                goodput_lib.CHECKPOINT_RESTORE,
                goodput_lib.PREEMPTION_DOWNTIME,
                goodput_lib.RECOVERY_RELAUNCH):
        assert totals.get(cat, 0.0) > 0, (cat, totals)
    down = ledger.intervals(str(job_id), goodput_lib.PREEMPTION_DOWNTIME)
    relaunch = ledger.intervals(str(job_id), goodput_lib.RECOVERY_RELAUNCH)
    assert len(down) == len(relaunch) == 1
    assert down[0]['t1'] == pytest.approx(relaunch[0]['t0'], abs=1e-6)
