"""The port's control plane against the JAX package's, on the same inputs:
every example task YAML parses to the same config, the optimizer picks
the same plans with the same estimates, the gang's env block differs only
as agent/gang.py documents, the backend's job spec carries a GPU's card
count, and the agent's job queue moves through the same states."""
import os
import pathlib

import pytest

from skypilot_tpu import dag as jax_dag
from skypilot_tpu import optimizer as jax_optimizer
from skypilot_tpu import resources as jax_resources
from skypilot_tpu import sky_config as jax_sky_config
from skypilot_tpu import task as jax_task
from skypilot_tpu.agent import gang as jax_gang
from skypilot_tpu.agent import job_queue as jax_job_queue
from skypilot_tpu.backends import tpu_vm_backend as jax_backend
from skypilot_tpu.global_user_state import ClusterHandle as JaxHandle
from skypilot_tpu.parallel import distributed as jax_distributed
from skypilot_tpu_torch import dag as torch_dag
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import optimizer as torch_optimizer
from skypilot_tpu_torch import resources as torch_resources
from skypilot_tpu_torch import sky_config as torch_sky_config
from skypilot_tpu_torch import task as torch_task
from skypilot_tpu_torch.agent import gang as torch_gang
from skypilot_tpu_torch.agent import job_queue as torch_job_queue
from skypilot_tpu_torch.backends import tpu_vm_backend as torch_backend
from skypilot_tpu_torch.global_user_state import (
    ClusterHandle as TorchHandle)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.name for p in (REPO / 'examples').glob('*.yaml'))


@pytest.fixture
def home(tmp_home, monkeypatch):
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'local')
    jax_sky_config.reset_cache_for_tests()
    torch_sky_config.reset_cache_for_tests()
    yield tmp_home
    jax_sky_config.reset_cache_for_tests()
    torch_sky_config.reset_cache_for_tests()


def _dag_config(dag):
    return dag.name, [(t.to_yaml_config(), sorted(map(repr, t.resources)))
                      for t in dag.tasks]


@pytest.mark.parametrize('name', EXAMPLES)
def test_examples_parse_alike(home, name):
    path = str(REPO / 'examples' / name)
    assert (_dag_config(torch_dag.load_chain_dag_from_yaml(path)) ==
            _dag_config(jax_dag.load_chain_dag_from_yaml(path)))
    if name != 'pipeline_managed_job.yaml':
        assert (torch_task.Task.from_yaml(path).to_yaml_config() ==
                jax_task.Task.from_yaml(path).to_yaml_config())


# Local tasks the port can place: a bare CPU task, a GPU request, a
# CPU/memory floor, and a two-task chain (the chain DP's path); each
# with a runtime estimate, which scales the cost.
LOCAL_TASKS = {
    'cpu': [{'name': 'a', 'run': 'echo a',
             'resources': {'infra': 'local'}}],
    'h100': [{'name': 'b', 'run': 'echo b',
              'resources': {'infra': 'local', 'accelerators': 'H100:1'}}],
    'floor': [{'name': 'c', 'run': 'echo c', 'num_nodes': 2,
               'resources': {'infra': 'local', 'cpus': '4+',
                             'memory': '8+'}}],
    'chain': [{'name': 'd', 'run': 'echo d',
               'resources': {'infra': 'local'}},
              {'name': 'e', 'run': 'echo e',
               'resources': {'infra': 'local', 'accelerators': 'H100:8'}}],
}


def _plan(task_mod, dag_mod, optimizer_mod, configs, minimize):
    dag = dag_mod.Dag('plan')
    prev = None
    for config in configs:
        t = task_mod.Task.from_yaml_config(config)
        t.estimated_runtime_s = 600.0
        dag.add(t)
        if prev is not None:
            dag.add_edge(prev, t)
        prev = t
    optimizer_mod.Optimizer.optimize(
        dag, minimize=optimizer_mod.OptimizeTarget(minimize), quiet=True)
    out = []
    for t in dag.tasks:
        metrics = [(c.to_yaml_config(), cost, time_s, hourly)
                   for c, cost, time_s, hourly in
                   optimizer_mod.Optimizer._candidates_with_metrics(  # pylint: disable=protected-access
                       t, None)]
        out.append((t.best_resources.to_yaml_config(), metrics))
    return out


@pytest.mark.parametrize('minimize', ['cost', 'time', 'cost_per_flop'])
@pytest.mark.parametrize('key', sorted(LOCAL_TASKS))
def test_optimizer_plans_local_tasks_alike(home, key, minimize):
    assert (_plan(torch_task, torch_dag, torch_optimizer, LOCAL_TASKS[key],
                  minimize) ==
            _plan(jax_task, jax_dag, jax_optimizer, LOCAL_TASKS[key],
                  minimize))


@pytest.mark.parametrize('accelerators', ['tpu-v5e-8', 'tpu-v5p-128',
                                          'tpu-v6e-16', 'tpu-v5e-16x2',
                                          'H100:8', 'A100:1'])
def test_effective_tflops_and_prices_alike(home, accelerators):
    config = {'accelerators': accelerators}
    if accelerators.startswith('tpu'):
        config['infra'] = 'gcp'
    r_t = torch_resources.Resources.from_yaml_config(dict(config))
    r_j = jax_resources.Resources.from_yaml_config(dict(config))
    for nodes in (1, 2):
        assert (torch_optimizer.effective_tflops(r_t, nodes) ==
                jax_optimizer.effective_tflops(r_j, nodes))
    if r_j.is_tpu:
        # The catalog copy prices a slice-hour as the JAX one does.
        assert r_t.get_cost(3600.0) == r_j.get_cost(3600.0) > 0


def test_only_local_is_registered(home, monkeypatch):
    """The port's registry is the JAX package's: the same six clouds, the
    same enabled set, and the same refusals of a cloud it does not
    know (the port registered only `local` until it had the other
    clouds' provisioners)."""
    from skypilot_tpu import clouds as jax_clouds
    from skypilot_tpu_torch import clouds
    assert sorted(clouds.CLOUD_REGISTRY) == sorted(
        jax_clouds.CLOUD_REGISTRY)
    assert type(clouds.get_cloud('gcp')).__name__ == 'GCP'
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'gcp,ssh,local')
    assert [c.NAME for c in clouds.enabled_clouds()] == [
        c.NAME for c in jax_clouds.enabled_clouds()]
    with pytest.raises(exceptions.InvalidInfraError, match='Unknown cloud'):
        clouds.get_cloud('azure')
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'azure,local')
    with pytest.raises(exceptions.InvalidInfraError, match='Unknown cloud'):
        clouds.enabled_clouds()
    from skypilot_tpu_torch import provision
    with pytest.raises(exceptions.InvalidInfraError,
                       match='No provisioner for cloud'):
        provision.query_instances('azure', 'c')


MEGASCALE_KEYS = set(jax_distributed.megascale_env_from_cluster(
    [['10.0.0.1'], ['10.0.0.2']], 0, 0))


@pytest.mark.parametrize('hosts', [1, 2, 4])
@pytest.mark.parametrize('chips', [0, 1, 8])
def test_gang_env_differs_only_as_documented(hosts, chips):
    ips = [f'10.0.0.{i}' for i in range(hosts)]
    extra = {'MYVAR': 'v'}
    for rank in range(hosts):
        got = torch_gang.build_host_env(ips, rank, chips, extra_env=extra)
        # One slice: the JAX block has no MEGASCALE part either.
        assert got == jax_gang.build_host_env(ips, rank, chips,
                                              extra_env=extra)
        # Every host its own slice: the JAX block adds libtpu's
        # multislice contract, which the port leaves out.
        multi = jax_gang.build_host_env(ips, rank, chips, extra_env=extra,
                                        slice_ips=[[ip] for ip in ips])
        if hosts > 1 and chips > 0:
            assert MEGASCALE_KEYS <= set(multi)
        assert got == {k: v for k, v in multi.items()
                       if k not in MEGASCALE_KEYS}


@pytest.mark.parametrize('accelerators,jax_chips,port_chips', [
    (None, 0, 0), ('tpu-v5e-8', 8, 8), ('tpu-v5p-16', 4, 4),
    ('H100:1', 0, 1), ('H100:8', 0, 8)])
def test_job_spec_carries_cards_per_host(home, accelerators, jax_chips,
                                         port_chips):
    """The job spec equals the JAX backend's but for chips_per_host,
    which also counts a GPU resource's cards."""
    config = {'infra': 'local'}
    if accelerators:
        config['accelerators'] = accelerators
    fields = dict(cluster_name='c', cloud='local', resources_config=config,
                  node_ips=[['127.0.0.1']])
    t_t = torch_task.Task('t', run='echo hi', envs={'A': '1'})
    t_j = jax_task.Task('t', run='echo hi', envs={'A': '1'})
    got = torch_backend.TpuVmBackend()._job_spec(  # pylint: disable=protected-access
        TorchHandle(**fields), t_t)
    want = jax_backend.TpuVmBackend()._job_spec(  # pylint: disable=protected-access
        JaxHandle(**fields), t_j)
    assert (want['chips_per_host'], got['chips_per_host']) == (jax_chips,
                                                               port_chips)
    want['chips_per_host'] = port_chips
    assert got == want


def test_docker_image_is_refused(home, monkeypatch):
    """A `docker:` image, which the port refused until it had
    provision/docker_utils.py, now reaches the gang: the job spec names
    the image, and the gang's first step is the container's bootstrap
    (here a `docker` that fails, so the job fails its setup)."""
    handle = TorchHandle(cluster_name='c', cloud='local',
                         resources_config={'infra': 'local',
                                           'image_id': 'docker:ubuntu'},
                         node_ips=[['127.0.0.1']])
    spec = torch_backend.TpuVmBackend()._job_spec(  # pylint: disable=protected-access
        handle, torch_task.Task('t', run='echo hi'))
    assert spec['docker_image'] == 'ubuntu' and 'docker_gpus' not in spec
    shim_dir = home / 'shim'
    shim_dir.mkdir()
    (shim_dir / 'docker').write_text('#!/usr/bin/env bash\nexit 7\n')
    (shim_dir / 'docker').chmod(0o755)
    monkeypatch.setenv('PATH', f'{shim_dir}{os.pathsep}{os.environ["PATH"]}')
    seen = []
    rc = torch_gang.run_gang_job(
        1, {'docker_image': 'ubuntu', 'run': 'x', 'is_local': True,
            'nodes': [['127.0.0.1']]}, str(home / 'logs'),
        lambda status, _rc: seen.append(status.value))
    assert rc == 7 and seen[-1] == 'FAILED_SETUP'
    assert (home / 'logs' / 'docker-init-0.log').exists()


def _queue_trace(mod, monkeypatch, agent_home):
    """The rows after each of a fixed sequence of calls, timestamps
    reduced to whether they are set."""
    monkeypatch.setenv('SKYTPU_AGENT_HOME', str(agent_home))
    S = mod.JobStatus
    trace = []

    def snap(label):
        rows = [{k: (v is not None if k.endswith('_at') else
                     v.value if isinstance(v, S) else v)
                 for k, v in row.items()} for row in mod.list_jobs()]
        pending = mod.next_pending()
        trace.append((label, rows,
                      pending['job_id'] if pending else None,
                      mod.any_active()))

    ids = [mod.submit(f'job{i}', {'run': f'echo {i}'}) for i in range(3)]
    snap('submitted')
    mod.set_status(ids[0], S.SETTING_UP)
    mod.set_status(ids[0], S.RUNNING)
    snap('first running')
    mod.set_status(ids[0], S.SUCCEEDED, 0)
    mod.set_status(ids[1], S.CANCELLED)
    snap('first done, second cancelled while pending')
    mod.set_status(ids[1], S.RUNNING)      # a late start of a cancelled job
    mod.set_status(ids[2], S.RUNNING)
    mod.set_status(ids[2], S.FAILED, 3)
    mod.set_status(ids[2], S.CANCELLED)    # a cancel after the end
    snap('all terminal')
    trace.append(('get', {k: (v is not None if k.endswith('_at') else v)
                          for k, v in mod.get(ids[2]).items()
                          if k != 'status'}, mod.get(999)))
    return trace


def test_job_queue_state_machine_alike(tmp_path, monkeypatch):
    got = _queue_trace(torch_job_queue, monkeypatch, tmp_path / 'port')
    want = _queue_trace(jax_job_queue, monkeypatch, tmp_path / 'jax')
    assert got == want
