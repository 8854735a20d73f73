"""The Slurm cloud of the port against the JAX package's: the allocation
lifecycle through the real CLI construction, each scenario run through
both packages against its own copy of the fake sbatch/squeue/scancel/
scontrol shims (tests/fake_slurm.py) and compared exactly: records,
statuses, error classes and the fake's jobs (mirrors
tests/test_slurm.py)."""
import json
import os

import pytest

from tests import fake_slurm
from tests.torch_parity import outcome, run_both, statuses


@pytest.fixture(autouse=True)
def fast_polls(monkeypatch):
    monkeypatch.setenv('SKYTPU_PROVISION_POLL_S', '0.05')


def _config(pkg, cluster='hpc', nodes=2, partition='gpuq'):
    return pkg('provision.common').ProvisionConfig(
        cluster_name=cluster, num_nodes=nodes,
        resources_config={'infra': f'slurm/{partition}'}, region=partition)


def _install(pkg, tmp_path, monkeypatch):
    """This package's shims and state file; returns the state file."""
    shim = tmp_path / pkg.name / 'slurm-bin'
    state = tmp_path / pkg.name / 'slurm-state.json'
    fake_slurm.install(str(shim), str(state), pending_polls=2)
    monkeypatch.setenv('PATH', f'{shim}{os.pathsep}{os.environ["PATH"]}')
    return state


def _jobs(state):
    jobs = json.loads(state.read_text())['jobs']
    return {jid: {k: job[k] for k in ('name', 'nodes', 'partition', 'state')}
            for jid, job in jobs.items()}


def _both(scenario, tmp_path, monkeypatch):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    assert port_side == jax_side
    return port_side


def test_allocation_lifecycle(tmp_path, monkeypatch):
    def scenario(pkg):
        state = _install(pkg, tmp_path, monkeypatch)
        provision = pkg('provision')
        out = {}
        record = provision.run_instances('slurm', _config(pkg))
        out['pending'] = (record.instance_ids, statuses(
            provision.query_instances('slurm', 'hpc')))
        provision.wait_instances('slurm', 'hpc', timeout_s=10)
        info = provision.get_cluster_info('slurm', 'hpc')
        out['running'] = (
            statuses(provision.query_instances('slurm', 'hpc')),
            [i.external_ips for i in info.instances], info.ssh_key_path,
            [i.tags for i in info.instances])
        out['resumed'] = provision.run_instances('slurm',
                                                 _config(pkg)).resumed
        provision.terminate_instances('slurm', 'hpc')
        out['after_down'] = provision.query_instances('slurm', 'hpc')
        out['relaunch'] = provision.run_instances(
            'slurm', _config(pkg)).resumed
        out['jobs'] = _jobs(state)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['pending'] == (['hpc-0', 'hpc-1'],
                              {'hpc-0': 'PENDING', 'hpc-1': 'PENDING'})
    assert out['running'][:3] == ({'hpc-0': 'RUNNING', 'hpc-1': 'RUNNING'},
                                  [['fake0'], ['fake1']], None)
    assert out['resumed'] and not out['relaunch']
    assert out['after_down'] == {}


def test_refusals_and_other_users_jobs(tmp_path, monkeypatch):
    def scenario(pkg):
        state = _install(pkg, tmp_path, monkeypatch)
        provision = pkg('provision')
        out = {}
        provision.run_instances('slurm', _config(pkg, cluster='ns'))
        out['stop'] = outcome(provision.stop_instances, 'slurm', 'ns')
        provision.run_instances('slurm', _config(pkg, cluster='sz'))
        provision.wait_instances('slurm', 'sz', timeout_s=10)
        out['resize'] = outcome(provision.run_instances, 'slurm',
                                _config(pkg, cluster='sz', nodes=4))
        fake_slurm.add_foreign_job(str(state), 'skytpu-shared',
                                   'someoneelse')
        out['foreign'] = provision.query_instances('slurm', 'shared')
        out['not_theirs'] = provision.run_instances(
            'slurm', _config(pkg, cluster='shared', nodes=1)).resumed
        fake_slurm.set_behavior(str(state), 'queue_limit')
        out['queue_limit'] = outcome(provision.run_instances, 'slurm',
                                     _config(pkg, cluster='q'))
        out['jobs'] = _jobs(state)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['stop'] == ('raise', 'NotSupportedError')
    assert out['resize'] == ('raise', 'ProvisionError')
    assert out['foreign'] == {} and not out['not_theirs']
    assert out['queue_limit'] == ('raise', 'QuotaExceededError')


def test_cloud_feasibility_and_gates(tmp_path, monkeypatch):
    def scenario(pkg):
        _install(pkg, tmp_path, monkeypatch)
        clouds = pkg('clouds')
        cloud = clouds.get_cloud('slurm')
        res_cls = pkg('resources').Resources
        cands = cloud.get_feasible_resources(
            res_cls.from_yaml_config({'infra': 'slurm/gpuq'}))
        return (cloud.check_credentials(),
                [(c.region, cloud.hourly_cost(c)) for c in cands],
                [cloud.supports(getattr(clouds.CloudCapability, c))
                 for c in ('STOP', 'SPOT', 'MULTI_NODE')],
                cloud.get_feasible_resources(res_cls.from_yaml_config(
                    {'accelerators': 'tpu-v5e-8', 'infra': 'slurm'})),
                cloud.get_feasible_resources(
                    res_cls.from_yaml_config({'cpus': '2'})))

    assert _both(scenario, tmp_path, monkeypatch) == (
        (True, None), [('gpuq', 0.0)], [False, False, True], [], [])
