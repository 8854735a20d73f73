"""The port's launch path on the local cloud: optimize → provision → agent
bootstrap → gang execute → logs → exec → queue → cancel → down, through
`skypilot_tpu_torch.execution` / `core`, the twin of
tests/test_execution_e2e.py, plus what only the port has to show: a
2-node gloo gang, the path run with JAX refused at import, a port job
serving the JAX package's weights with the JAX engine's tokens, and the
agent's scheduler surviving a failing iteration.

Every wait has a deadline (TimeoutError, never a hang) and every case
brings its cluster down in a `finally`.  The port's agents are reaped by
this module's own fixture: the session reaper in conftest.py matches
only the JAX agent's command line."""
import contextlib
import dataclasses
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch import core
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import execution
from skypilot_tpu_torch import global_user_state
from skypilot_tpu_torch import sky_config
from skypilot_tpu_torch.agent import job_queue
from skypilot_tpu_torch.agent import server as agent_server
from skypilot_tpu_torch.agent.job_queue import JobStatus
from skypilot_tpu_torch.global_user_state import ClusterStatus
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.task import Task
from skypilot_tpu_torch.train.checkpoint import CheckpointManager

from torch_control import bounded as _bounded

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_AGENT = b'skypilot_tpu_torch.agent.server'


@pytest.fixture(scope='module', autouse=True)
def reap_port_agents(tmp_path_factory):
    """This module's own SKYTPU_AGENT_PID_FILE; at teardown every listed
    PID whose command line still names the port's agent is SIGKILLed
    (the agents are detached, so a case that failed before its `down`
    would leak one)."""
    registry = tmp_path_factory.mktemp('torch-agents') / 'agent-pids.txt'
    registry.touch()
    old = os.environ.get('SKYTPU_AGENT_PID_FILE')
    os.environ['SKYTPU_AGENT_PID_FILE'] = str(registry)
    yield registry
    if old is None:
        os.environ.pop('SKYTPU_AGENT_PID_FILE', None)
    else:
        os.environ['SKYTPU_AGENT_PID_FILE'] = old
    for line in registry.read_text().splitlines():
        try:
            pid = int(line)
            with open(f'/proc/{pid}/cmdline', 'rb') as f:
                cmdline = f.read()
        except (ValueError, OSError):
            continue
        if PORT_AGENT in cmdline:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


@pytest.fixture
def home(tmp_home, monkeypatch):
    """conftest's isolated $HOME, the port's config cache reset, and the
    local cloud as the one enabled cloud (these cases launch there)."""
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
    sky_config.reset_cache_for_tests()
    yield tmp_home
    sky_config.reset_cache_for_tests()


@pytest.fixture
def local_task(home):
    def make(run='echo hello-from-skytpu', name='t', **kwargs):
        t = Task(name, run=run, **kwargs)
        t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
        return t
    return make


@contextlib.contextmanager
def _cluster(name):
    """Brings the cluster down on the way out, whatever happened."""
    try:
        yield name
    finally:
        if global_user_state.get_cluster(name) is not None:
            _bounded(core.down, name)


def _wait_job(cluster, job_id, timeout=30, until=JobStatus.is_terminal):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rec = next(j for j in core.queue(cluster) if j['job_id'] == job_id)
        if until(JobStatus(rec['status'])):
            return rec
        time.sleep(0.2)
    raise TimeoutError(f'job {job_id} on {cluster} still '
                       f'{rec["status"]} after {timeout}s')


def _alive(pid):
    """False once the process has exited (a zombie counts as exited)."""
    try:
        with open(f'/proc/{pid}/stat', encoding='utf-8') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except OSError:
        return False


def _wait_dead(pid, timeout=15):
    deadline = time.time() + timeout
    while _alive(pid):
        if time.time() > deadline:
            raise TimeoutError(f'process {pid} alive after {timeout}s')
        time.sleep(0.1)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


# ----- the ten cases of tests/test_execution_e2e.py --------------------------
def test_launch_end_to_end(local_task):
    with _cluster('e2e'):
        job_id, handle = _bounded(execution.launch, local_task(), 'e2e',
                                  quiet_optimizer=True)
        assert job_id is not None
        assert handle.cluster_name == 'e2e'
        rec = global_user_state.get_cluster('e2e')
        assert rec['status'] is ClusterStatus.UP
        job = _wait_job('e2e', job_id)
        assert JobStatus(job['status']) is JobStatus.SUCCEEDED
        # The agent ran a job without loading torch or JAX.
        pid = handle.extras['agent_pid']
        maps = pathlib.Path(f'/proc/{pid}/maps').read_text()
        assert '/torch/' not in maps and '/jaxlib/' not in maps
        _bounded(core.down, 'e2e')
        assert global_user_state.get_cluster('e2e') is None
        _wait_dead(pid)


def test_launch_reuses_cluster_and_exec(local_task):
    with _cluster('reuse'):
        _, handle1 = _bounded(execution.launch, local_task(), 'reuse',
                              quiet_optimizer=True)
        job2, handle2 = _bounded(execution.exec_,
                                 local_task(run='echo second'), 'reuse')
        assert handle2.agent_port == handle1.agent_port
        job = _wait_job('reuse', job2)
        assert JobStatus(job['status']) is JobStatus.SUCCEEDED


def test_setup_and_env_injection(local_task, home):
    out_file = home / 'gang_env.txt'
    t = local_task(
        run=f'echo "rank=$SKYTPU_NODE_RANK nodes=$SKYTPU_NUM_NODES '
            f'coord=$SKYTPU_COORDINATOR_ADDR myenv=$MYVAR '
            f'cards=$SKYTPU_NUM_TPU_CHIPS" >> {out_file}',
        name='envtest')
    # A GPU request: the card count rides SKYTPU_NUM_TPU_CHIPS.
    t.set_resources(Resources.from_yaml_config(
        {'infra': 'local', 'accelerators': 'H100:2'}))
    t.setup = f'echo setup-ran > {home}/setup.txt'
    t.update_envs({'MYVAR': 'hello42'})
    with _cluster('envt'):
        job_id, _ = _bounded(execution.launch, t, 'envt',
                             quiet_optimizer=True)
        _wait_job('envt', job_id)
        assert (home / 'setup.txt').read_text().strip() == 'setup-ran'
        content = out_file.read_text()
        assert 'rank=0' in content
        assert 'nodes=1' in content
        assert 'coord=127.0.0.1:8476' in content
        assert 'myenv=hello42' in content
        assert 'cards=2' in content


def test_failed_job_raises_and_logs(local_task, capsys):
    t = local_task(run='echo about-to-fail && exit 3', name='failing')
    with _cluster('failt'):
        with pytest.raises(exceptions.JobExitNonZeroError) as err:
            _bounded(execution.launch, t, 'failt', quiet_optimizer=True)
        assert err.value.returncode == 3
        captured = capsys.readouterr()
        assert 'about-to-fail' in captured.out


def test_cancel_running_job(local_task):
    t = local_task(run='sleep 60', name='sleeper')
    with _cluster('canc'):
        job_id, _ = _bounded(execution.launch, t, 'canc', detach_run=True,
                             quiet_optimizer=True)
        _wait_job('canc', job_id,
                  until=lambda s: s is JobStatus.RUNNING or s.is_terminal())
        assert _bounded(core.cancel, 'canc', job_id)
        job = _wait_job('canc', job_id)
        assert JobStatus(job['status']) is JobStatus.CANCELLED


def test_workdir_sync(local_task, tmp_path):
    workdir = tmp_path / 'proj'
    workdir.mkdir()
    (workdir / 'data.txt').write_text('payload123')
    t = Task('wd', run='cat data.txt', workdir=str(workdir))
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    with _cluster('wdt'):
        job_id, _ = _bounded(execution.launch, t, 'wdt', detach_run=True,
                             quiet_optimizer=True)
        job = _wait_job('wdt', job_id)
        assert JobStatus(job['status']) is JobStatus.SUCCEEDED


def test_exec_on_missing_cluster_raises(local_task):
    with pytest.raises(exceptions.ClusterDoesNotExistError):
        _bounded(execution.exec_, local_task(), 'nope')


def test_status_refresh_detects_preemption(local_task):
    from skypilot_tpu_torch.backends import backend_utils
    from skypilot_tpu_torch.provision.local import instance as local_instance
    with _cluster('preem'):
        _bounded(execution.launch, local_task(run=None), 'preem',
                 quiet_optimizer=True)
        local_instance.inject_preemption('preem')
        status = backend_utils.refresh_cluster_status('preem')
        assert status is ClusterStatus.INIT  # unhealthy


def test_dryrun_no_side_effects(local_task):
    job_id, handle = _bounded(execution.launch, local_task(), 'dry',
                              dryrun=True, quiet_optimizer=True)
    assert job_id is None and handle is None
    assert global_user_state.get_cluster('dry') is None


def test_multi_host_sync_is_parallel(home, monkeypatch):
    """Workdir sync fans out over hosts concurrently: 8 hosts at 0.2 s
    each take about one host's time, not 8x."""
    from skypilot_tpu_torch.backends.tpu_vm_backend import TpuVmBackend

    active = {'now': 0, 'peak': 0}
    lock = threading.Lock()
    synced = []

    class SlowRunner:
        def __init__(self, ip):
            self.ip = ip

        def rsync(self, src, dst, up=True, excludes=None):
            with lock:
                active['now'] += 1
                active['peak'] = max(active['peak'], active['now'])
            time.sleep(0.2)
            with lock:
                active['now'] -= 1
            synced.append(self.ip)

    backend = TpuVmBackend()
    monkeypatch.setattr(
        backend, '_host_runners',
        lambda handle: [SlowRunner(f'10.0.0.{i}') for i in range(8)])
    monkeypatch.setattr(backend, '_workdir_dest', lambda handle: '/wd')

    class H:
        cloud = 'fake'

    t0 = time.perf_counter()
    _bounded(backend.sync_workdir, H(), str(home))
    wall = time.perf_counter() - t0
    assert len(synced) == 8
    # Loose bounds (CPU contention staggers thread start): any overlap
    # shows concurrency; serial would be 8 x 0.2 s = 1.6 s.
    assert active['peak'] >= 2, f'not parallel (peak={active["peak"]})'
    assert wall < 1.3, f'serial-looking sync took {wall:.2f}s'


# ----- what only the port has to show ----------------------------------------
GANG_RUN = """python - <<'PY'
import torch
import torch.distributed as dist
from skypilot_tpu_torch.parallel import maybe_initialize_distributed

maybe_initialize_distributed(device='cpu', timeout_s=60)  # SKYTPU_* env
rank = dist.get_rank()
world = dist.get_world_size()
# The all-reduce across every rank of every node: each contributes its
# rank, so the sum is world * (world - 1) / 2.
total = torch.tensor([float(rank)])
dist.all_reduce(total)
if rank == 0:
    print(f'world={world} devices={world} allreduce={total}')
dist.destroy_process_group()
PY"""


def test_two_node_gang_allreduce_over_gloo(home, capsys):
    """The twin of examples/gang_collective.yaml on a 2-node local
    cluster: every host joins the gloo group from the gang's SKYTPU_*
    env and all-reduces; rank 0 prints the JAX example's line."""
    t = Task('gang-allreduce', run=GANG_RUN, num_nodes=2)
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    with _cluster('gang2'):
        job_id, _ = _bounded(execution.launch, t, 'gang2',
                             quiet_optimizer=True, timeout=120)
        job = _wait_job('gang2', job_id)
        assert JobStatus(job['status']) is JobStatus.SUCCEEDED
        out = capsys.readouterr().out
        assert 'world=2 devices=2 allreduce=tensor([1.])' in out, out


NO_JAX_LAUNCH = """
import sys


class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'skypilot_tpu'):
            raise ImportError(f'refused: {name}')
        return None


sys.meta_path.insert(0, RefuseJax())
from skypilot_tpu_torch import core, execution
from skypilot_tpu_torch.resources import Resources
from skypilot_tpu_torch.task import Task

t = Task('nojax', run='echo ran-without-jax')
t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
job_id, handle = execution.launch(t, 'nojax', quiet_optimizer=True)
try:
    status = [j['status'] for j in core.queue('nojax')
              if j['job_id'] == job_id]
finally:
    core.down('nojax')
print('status', status[0])
"""


def test_launch_runs_with_jax_refused(home):
    """launch → job → queue → down in a process whose imports of jax,
    flax and the JAX package raise: the path needs none of them."""
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(home))
    proc = subprocess.run([sys.executable, '-c', NO_JAX_LAUNCH], cwd=home,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ran-without-jax' in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == 'status SUCCEEDED'


# f32 compute on both sides so greedy ids do not hinge on bf16 ties; the
# job registers the same cut of `tiny` for the server's --model.
CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
PARITY_PROMPTS = [[5, 17, 3, 42, 9], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                                      200]]
PARITY_TOKENS = 8
SERVER_RUN = """python - <<'PY'
import dataclasses
import os

import torch

from skypilot_tpu_torch.inference import server
from skypilot_tpu_torch.models import llama

llama.LLAMA_CONFIGS['tiny-f32'] = dataclasses.replace(
    llama.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
server.main(['--model', 'tiny-f32', '--device', 'cpu', '--n-slots', '2',
             '--max-seq-len', '128', '--port', os.environ['SERVE_PORT'],
             '--checkpoint', os.environ['CKPT']])
PY"""


class _ParamsOnly:
    """A params-only checkpoint: `state_dict()` is the tensors alone."""

    def __init__(self, tensors):
        self.tensors = tensors

    def state_dict(self):
        return self.tensors


def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _wait_health(url, cluster, job_id, timeout=90):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                if resp.status == 200:
                    return
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        rec = next(j for j in core.queue(cluster) if j['job_id'] == job_id)
        if JobStatus(rec['status']).is_terminal():
            raise AssertionError(f'server job ended {rec["status"]}')
        time.sleep(0.3)
    raise TimeoutError(f'{url} not healthy after {timeout}s')


def _port_closed(port):
    with socket.socket() as s:
        return s.connect_ex(('127.0.0.1', port)) != 0


def test_port_job_serves_jax_weights_with_jax_tokens(home, tmp_path):
    """The JAX `tiny` params, carried into a port checkpoint, served by a
    port job through the server's --checkpoint on the CPU, give the JAX
    engine's greedy tokens; cancel ends the job and closes its port."""
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    ckpt = tmp_path / 'ckpt'
    CheckpointManager(str(ckpt)).save(
        0, _ParamsOnly(params_from_jax(jax.tree.map(np.asarray, params_j))))
    ref = jax_engine.DecodeEngine(
        model_j, params_j,
        jax_engine.EngineConfig(n_slots=2, prefill_buckets=(8, 16),
                                steps_per_call=4))
    reqs = [ref.submit(p, PARITY_TOKENS) for p in PARITY_PROMPTS]
    for _ in range(400):
        ref.step()
        if all(r.finished_at is not None for r in reqs):
            break
    want = [r.tokens() for r in reqs]

    port = _free_port()
    t = Task('serve-parity', run=SERVER_RUN,
             envs={'SERVE_PORT': str(port), 'CKPT': str(ckpt)})
    t.set_resources(Resources.from_yaml_config({'infra': 'local'}))
    with _cluster('parity'):
        job_id, _ = _bounded(execution.launch, t, 'parity', detach_run=True,
                             quiet_optimizer=True)
        base = f'http://127.0.0.1:{port}'
        _wait_health(base + '/health', 'parity', job_id)
        for prompt, tokens in zip(PARITY_PROMPTS, want):
            got = _post(base + '/v1/completions',
                        {'prompt_ids': prompt, 'max_tokens': PARITY_TOKENS})
            assert got['ids'] == tokens
            assert got['usage']['prompt_tokens'] == len(prompt)
            assert got['usage']['completion_tokens'] == PARITY_TOKENS
        assert _bounded(core.cancel, 'parity', job_id)
        job = _wait_job('parity', job_id)
        assert JobStatus(job['status']) is JobStatus.CANCELLED
        deadline = time.time() + 15
        while not _port_closed(port):
            if time.time() > deadline:
                raise TimeoutError(f'port {port} still open after cancel')
            time.sleep(0.2)


def test_scheduler_survives_a_failing_iteration(home, monkeypatch):
    """An exception out of `next_pending()` is logged and the loop goes
    on: the next job still runs (the JAX scheduler's thread would end)."""
    monkeypatch.setenv('SKYTPU_AGENT_HOME', str(home / 'agent'))
    real = job_queue.next_pending
    raised = []

    def flaky():
        if not raised:
            raised.append(True)
            raise RuntimeError('injected: queue database unreadable')
        return real()

    monkeypatch.setattr(job_queue, 'next_pending', flaky)
    job_id = job_queue.submit('after-fault', {
        'nodes': [['127.0.0.1']], 'is_local': True, 'chips_per_host': 0,
        'run': 'echo ran-after-fault'})
    sched = agent_server.AgentScheduler()
    sched.start()
    try:
        deadline = time.time() + 30
        while not job_queue.get(job_id)['status'].is_terminal():
            if time.time() > deadline:
                raise TimeoutError('job still pending after an iteration '
                                   'failed')
            time.sleep(0.1)
    finally:
        sched.stop()
        sched._thread.join(timeout=10)  # pylint: disable=protected-access
    assert not sched._thread.is_alive()  # pylint: disable=protected-access
    assert raised
    assert job_queue.get(job_id)['status'] is JobStatus.SUCCEEDED
    log = pathlib.Path(job_queue.log_dir(job_id)) / 'run-0.log'
    assert 'ran-after-fault' in log.read_text()
