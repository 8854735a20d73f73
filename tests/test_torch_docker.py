"""The Docker task runtime of the port against the JAX package's: the
image a resource asks for, the bootstrap and exec commands, the gang
running a task's phases inside the container through a `docker` shim
(which logs its argv and runs `exec` here), and the job spec the backend
builds for a docker task.  Everything is equal to the JAX package's but
one deliberate difference: a task on GPUs gets `--gpus all` where the
JAX runtime passes `--privileged` (mirrors tests/test_docker_runtime.py).
"""
import json
import os

import pytest

import chip_smoke
from tests.torch_parity import Pkg, run_both, shim

JAX, PORT = Pkg('skypilot_tpu'), Pkg('skypilot_tpu_torch')


@pytest.fixture
def docker_shim(tmp_path, monkeypatch):
    """The smoke's `docker` first on PATH: it logs each argv (JSON) to
    SMOKE_DOCKER_LOG, fails `inspect` (no container) and runs `exec`'s
    command here."""
    shim(tmp_path / 'shim', 'docker', chip_smoke.DOCKER_SHIM)
    monkeypatch.setenv('PATH',
                       f'{tmp_path / "shim"}{os.pathsep}{os.environ["PATH"]}')


@pytest.mark.parametrize('workdir', [None, '/wd'])
def test_commands_equal_but_the_gpu_flag(workdir):
    jax_du = JAX('provision.docker_utils')
    port_du = PORT('provision.docker_utils')
    for image_id in ('docker:python:3.11', 'projects/x/global/images/img',
                     None):
        assert (port_du.image_from_resources(image_id) ==
                jax_du.image_from_resources(image_id))
    jax_cmd = jax_du.bootstrap_command('myimg:latest', workdir)
    assert port_du.bootstrap_command('myimg:latest', workdir) == jax_cmd
    gpu_cmd = port_du.bootstrap_command('myimg:latest', workdir, gpus=True)
    assert '--privileged' in jax_cmd and '--privileged' not in gpu_cmd
    assert gpu_cmd == jax_cmd.replace('--privileged', '--gpus all')
    assert (port_du.wrap('echo $FOO', env={'FOO': 'bar'}, workdir=workdir)
            == jax_du.wrap('echo $FOO', env={'FOO': 'bar'}, workdir=workdir))
    assert port_du.CONTAINER_NAME == jax_du.CONTAINER_NAME


@pytest.mark.parametrize('gpus', [False, True])
def test_gang_runs_task_in_container(tmp_path, monkeypatch, docker_shim,
                                     gpus):
    """Setup and run go through `docker exec` with the rank env inside the
    container; the bootstrap has its own log.  The JAX gang ignores
    `docker_gpus`, so with it the docker argv differs by the flag alone."""
    def scenario(pkg):
        root = tmp_path / pkg.name
        out = root / 'rank-out'
        out.mkdir(parents=True)
        calls = root / 'docker-calls.log'
        monkeypatch.setenv('SMOKE_DOCKER_LOG', str(calls))
        spec = {
            'setup': 'echo setup-done',
            'run': (f'echo rank=$SKYTPU_NODE_RANK chips='
                    f'$SKYTPU_NUM_TPU_CHIPS > {out}/r$SKYTPU_NODE_RANK'),
            'nodes': [['127.0.0.1']], 'chips_per_host': 1, 'is_local': True,
            'envs': {}, 'docker_image': 'python:3.11-slim',
            'docker_gpus': gpus}
        seen = []
        rc = pkg('agent.gang').run_gang_job(
            1, spec, str(root / 'logs'),
            lambda s, r: seen.append((s.value, r)))
        return (rc, seen, (out / 'r0').read_text(),
                [json.loads(line.replace(str(root), 'ROOT'))
                 for line in calls.read_text().splitlines()],
                sorted(p.name for p in (root / 'logs').iterdir()))

    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    rc, seen, rank, argv, logs = port_side
    assert rc == 0 and seen[-1] == ('SUCCEEDED', 0)
    assert rank.strip() == 'rank=0 chips=1'
    assert logs == ['docker-init-0.log', 'run-0.log', 'setup-0.log']
    assert ['pull', 'python:3.11-slim'] in argv
    assert [a[:2] for a in argv][-2:] == [['exec', 'skytpu-ct']] * 2
    run = next(a for a in argv if a[0] == 'run')
    if gpus:
        assert run[2:4] == ['--gpus', 'all'] and '--privileged' not in run
        argv = [a[:2] + ['--privileged'] + a[4:] if a[0] == 'run' else a
                for a in argv]
        port_side = port_side[:3] + (argv, logs)
    else:
        assert run[2] == '--privileged'
    assert port_side == jax_side


def test_bootstrap_failure_is_setup_failure(tmp_path, monkeypatch):
    shim(tmp_path / 'shim', 'docker', '#!/usr/bin/env bash\nexit 7\n')
    monkeypatch.setenv('PATH',
                       f'{tmp_path / "shim"}{os.pathsep}{os.environ["PATH"]}')

    def scenario(pkg):
        spec = {'run': 'echo never', 'nodes': [['127.0.0.1']],
                'chips_per_host': 0, 'is_local': True, 'envs': {},
                'docker_image': 'broken:img'}
        seen = []
        rc = pkg('agent.gang').run_gang_job(
            2, spec, str(tmp_path / pkg.name / 'logs'),
            lambda s, r: seen.append((s.value, r)))
        return rc, seen

    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    assert port_side == jax_side
    assert port_side[0] != 0 and port_side[1][-1][0] == 'FAILED_SETUP'


@pytest.mark.parametrize('resources,gpus', [
    ({'infra': 'local', 'image_id': 'docker:img:1'}, False),
    ({'infra': 'gcp/us-east5/us-east5-a', 'accelerators': 'tpu-v5p-8',
      'image_id': 'docker:img:1'}, False),
    ({'infra': 'ssh/pool', 'accelerators': 'H100:1',
      'image_id': 'docker:img:1'}, True),
])
def test_backend_job_spec_for_a_docker_task(tmp_path, monkeypatch,
                                            resources, gpus):
    """The backend's spec for a docker task: the JAX one's, plus
    `docker_gpus` on a GPU resource (and that resource's card count as
    `chips_per_host`, the port's launch-path difference)."""
    def scenario(pkg):
        state = pkg('global_user_state')
        handle = state.ClusterHandle(
            'c', resources['infra'].split('/')[0], 'r', 'z', resources, 1,
            [['10.0.0.1']], ['c-0'])
        task = pkg('task').Task('t', run='echo hi', envs={'A': '1'})
        return pkg('backends.tpu_vm_backend').TpuVmBackend()._job_spec(  # pylint: disable=protected-access
            handle, task)

    jax_spec, port_spec = run_both(scenario, tmp_path, monkeypatch)
    assert port_spec['docker_image'] == jax_spec['docker_image'] == 'img:1'
    if gpus:
        assert port_spec.pop('docker_gpus') is True
        assert port_spec.pop('chips_per_host') == 1
        jax_spec.pop('chips_per_host')
    assert port_spec == jax_spec
