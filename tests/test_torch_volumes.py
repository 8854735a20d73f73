"""Volumes of the port against the JAX package's on the fakes: a
Kubernetes PVC and a GCP persistent disk created and deleted through
`volumes.apply`/`delete` (which the port refused until it had the
kubernetes and gcp provisioners), validation, and a volume attached to
a pod and to a Compute Engine VM, each scenario run through both packages
against fresh fakes and compared exactly (mirrors tests/test_volumes.py's
create, delete and attachment cases)."""
import pytest

from tests.fake_gce_api import FakeGceApi
from tests.fake_k8s_api import FakeK8sApi
from tests.fake_tpu_api import FakeTpuApi
from tests.torch_parity import outcome, record_calls, run_both

FAKES = ((FakeK8sApi, 'SKYTPU_K8S_API_ENDPOINT'),
         (FakeGceApi, 'SKYTPU_GCE_API_ENDPOINT'),
         (FakeTpuApi, 'SKYTPU_TPU_API_ENDPOINT'))


@pytest.fixture(autouse=True)
def cloud_env(monkeypatch):
    monkeypatch.setenv('SKYTPU_GCP_PROJECT', 'proj')


def _both(scenario, tmp_path, monkeypatch):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch, FAKES)
    assert port_side == jax_side
    return port_side


def test_pvc_and_disk_create_and_delete(tmp_path, monkeypatch):
    def scenario(pkg, k8s, gce, tpu):
        del tpu
        volumes = pkg('volumes')
        calls = {'k8s': record_calls(k8s), 'gce': record_calls(gce)}
        out = {}
        vol = volumes.apply('data', 'k8s-pvc', 'kubernetes/main', 50)
        out['pvc'] = (vol.status, k8s.pvc('default', 'data')['spec'],
                      [v.name for v in volumes.list_volumes()])
        out['reapply'] = outcome(volumes.apply, 'data', 'k8s-pvc',
                                 'kubernetes/main', 50)[0]
        out['conflict'] = outcome(volumes.apply, 'data', 'k8s-pvc',
                                  'kubernetes/main', 100)
        volumes.delete('data')
        out['pvc_gone'] = (volumes.list_volumes(),
                           outcome(k8s.pvc, 'default', 'data'))
        volumes.apply('ckpt', 'gcp-disk', 'gcp/us-central1/us-central1-a',
                      200)
        out['disk'] = dict(gce.state.disks['us-central1-a/ckpt'])
        volumes.delete('ckpt')
        out['disk_gone'] = 'us-central1-a/ckpt' in gce.state.disks
        out['invalid'] = [
            outcome(volumes.apply, 'x', 'nfs', 'gcp/r/z', 10),
            outcome(volumes.apply, 'x', 'k8s-pvc', 'gcp/us-central1', 10),
            outcome(volumes.apply, 'x', 'gcp-disk', 'gcp/us-central1', 10),
            outcome(volumes.delete, 'missing')]
        out['calls'] = {k: list(v) for k, v in calls.items()}
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['pvc'][0] == 'READY'
    assert out['pvc'][1]['resources']['requests']['storage'] == '50Gi'
    assert out['reapply'] == 'ok'
    assert out['conflict'] == ('raise', 'InvalidRequestError')
    assert out['pvc_gone'] == ([], ('raise', 'KeyError'))
    assert out['disk']['sizeGb'] == '200' and not out['disk_gone']
    assert [o[1] for o in out['invalid']] == [
        'InvalidRequestError', 'InvalidRequestError', 'InvalidRequestError',
        'StorageError']


def test_volumes_attach_to_pods_and_vms(tmp_path, monkeypatch):
    def scenario(pkg, k8s, gce, tpu):
        del tpu
        volumes = pkg('volumes')
        provision = pkg('provision')
        config_cls = pkg('provision.common').ProvisionConfig
        res_cls = pkg('resources').Resources
        out = {}
        volumes.apply('data', 'k8s-pvc', 'kubernetes/main', 10)
        provision.run_instances('kubernetes', config_cls(
            cluster_name='kv', num_nodes=1,
            resources_config={'cpus': '2', 'infra': 'kubernetes/main'},
            region='main', volumes={'/mnt/data': 'data'}))
        spec = k8s.pod('default', 'kv-0')['spec']
        out['pod'] = (spec['volumes'], spec['containers'][0]['volumeMounts'])
        task = pkg('task').Task('t', run='echo x',
                                volumes={'/mnt/data': 'data'})
        out['placement'] = [
            outcome(volumes.validate_task_volumes, task,
                    res_cls.from_yaml_config({'infra': infra}))
            for infra in ('kubernetes/main', 'gcp/us-central1',
                          'kubernetes/other')]
        volumes.apply('d1', 'gcp-disk', 'gcp/us-central1/us-central1-a', 10)
        provision.run_instances('gcp', config_cls(
            cluster_name='gv', num_nodes=1,
            resources_config={'cpus': '4',
                              'infra': 'gcp/us-central1/us-central1-a'},
            region='us-central1', zone='us-central1-a',
            volumes={'/mnt/data': 'd1'}))
        inst = gce.instance('us-central1-a', 'gv-0')
        out['vm'] = (inst['disks'], inst['metadata'])
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['pod'][0][0]['persistentVolumeClaim']['claimName'] == 'data'
    assert out['placement'][0] == ('ok', {'/mnt/data': 'data'})
    assert [o[1] for o in out['placement'][1:]] == ['InvalidTaskError'] * 2
    assert 'd1' in {d.get('deviceName') for d in out['vm'][0]}
