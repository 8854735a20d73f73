"""The Kubernetes cloud of the port against the JAX package's: its gates
and feasibility, the pod provisioner (CPU pods, TPU slices as host pods,
stockout, quota, eviction, spot) and the metrics scrape over its pods,
each scenario run through both packages against fresh instances of
tests/fake_k8s_api.py and compared exactly (mirrors
tests/test_kubernetes.py)."""
import pytest

from tests.fake_k8s_api import FakeK8sApi
from tests.torch_parity import (Pkg, outcome, record_calls, run_both,
                                statuses)

K8S = ((FakeK8sApi, 'SKYTPU_K8S_API_ENDPOINT'),)


@pytest.fixture(autouse=True)
def k8s_env(monkeypatch):
    monkeypatch.setenv('SKYTPU_K8S_UNSCHEDULABLE_GRACE_S', '0.5')
    # Where a scenario starts no fake, the API server refuses connections.
    monkeypatch.setenv('SKYTPU_K8S_API_ENDPOINT', 'http://127.0.0.1:9')


def _config(pkg, cluster='k1', num_nodes=1, **res):
    res.setdefault('infra', 'kubernetes/main')
    return pkg('provision.common').ProvisionConfig(
        cluster_name=cluster, num_nodes=num_nodes, resources_config=res,
        region='main')


def _both(scenario, tmp_path, monkeypatch, fakes=K8S):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch, fakes)
    assert port_side == jax_side
    return port_side


def test_cloud_gates_and_feasibility(tmp_path, monkeypatch):
    def scenario(pkg):
        clouds = pkg('clouds')
        cloud = clouds.get_cloud('kubernetes')
        res_cls = pkg('resources').Resources
        res = res_cls.from_yaml_config({'infra': 'kubernetes/main'})
        feas = cloud.get_feasible_resources(res)
        return ([cloud.supports(getattr(clouds.CloudCapability, c), res)
                 for c in ('STOP', 'AUTOSTOP', 'MULTI_NODE')],
                [f.region for f in feas], cloud.hourly_cost(feas[0]),
                cloud.get_feasible_resources(
                    res_cls.from_yaml_config({'cpus': '4'})))

    assert _both(scenario, tmp_path, monkeypatch, ()) == (
        [False, False, True], ['main'], 0.0, [])


def test_pod_lifecycle_and_tpu_slice(tmp_path, monkeypatch):
    def scenario(pkg, k8s):
        provision = pkg('provision')
        calls = record_calls(k8s)
        out = {}
        record = provision.run_instances('kubernetes', _config(
            pkg, cpus='4', memory='8'))
        provision.wait_instances('kubernetes', 'k1', timeout_s=10)
        info = provision.get_cluster_info('kubernetes', 'k1')
        pod = k8s.pod('default', 'k1-0')
        out['pod'] = (record.instance_ids,
                      statuses(provision.query_instances('kubernetes',
                                                         'k1')),
                      info.instances[0].internal_ips,
                      pod['metadata']['labels'], pod['spec'])
        out['stop'] = outcome(provision.stop_instances, 'kubernetes', 'k1')
        provision.terminate_instances('kubernetes', 'k1')
        out['after_down'] = provision.query_instances('kubernetes', 'k1')
        provision.run_instances('kubernetes', _config(
            pkg, cluster='ktpu', accelerators='tpu-v5litepod-16'))
        provision.wait_instances('kubernetes', 'ktpu', timeout_s=10)
        info = provision.get_cluster_info('kubernetes', 'ktpu')
        out['slice'] = ([k8s.pod('default', f'ktpu-{i}')['spec']
                         for i in range(4)],
                        statuses(provision.query_instances('kubernetes',
                                                           'ktpu')),
                        [i.internal_ips for i in info.instances])
        k8s.evict('default', 'ktpu-2')
        out['evicted'] = statuses(provision.query_instances('kubernetes',
                                                            'ktpu'))
        record = provision.run_instances('kubernetes', _config(
            pkg, cluster='ktpu', accelerators='tpu-v5litepod-16'))
        out['rerun'] = record.resumed
        provision.run_instances('kubernetes', _config(
            pkg, cluster='ks', cpus='4', use_spot=True))
        out['spot'] = k8s.pod('default', 'ks-0')['spec']
        out['calls'] = list(calls)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['pod'][:3] == (['k1-0'], {'k1-0': 'RUNNING'}, ['10.1.0.1'])
    assert out['stop'] == ('raise', 'NotSupportedError')
    assert out['after_down'] == {}
    assert out['slice'][1] == {'ktpu-0': 'RUNNING'}
    assert len(out['slice'][2][0]) == 4
    assert out['evicted'] == {'ktpu-0': 'PREEMPTED'}
    assert out['spot']['nodeSelector']['cloud.google.com/gke-spot'] == 'true'


def test_unschedulable_and_quota_classified(tmp_path, monkeypatch):
    def scenario(pkg, k8s):
        provision = pkg('provision')
        k8s.set_behavior('unschedulable')
        provision.run_instances('kubernetes', _config(pkg, cluster='kstock',
                                                      cpus='4'))
        stockout = outcome(provision.wait_instances, 'kubernetes',
                           'kstock', timeout_s=10)
        left = provision.query_instances('kubernetes', 'kstock')
        k8s.set_behavior('quota')
        quota = outcome(provision.run_instances, 'kubernetes',
                        _config(pkg, cluster='kq', cpus='4'))
        return stockout, left, quota

    assert _both(scenario, tmp_path, monkeypatch) == (
        ('raise', 'InsufficientCapacityError'), {},
        ('raise', 'QuotaExceededError'))


def test_k8s_metrics_scrape_gives_the_jax_rows(tmp_path, monkeypatch):
    """metrics_utils.scrape_once over the fake's pods: the port's rows and
    gauges are the JAX function's, on the same pods (the port's
    metrics_utils reaches provision/kubernetes, which it now has)."""
    fake = FakeK8sApi()
    try:
        monkeypatch.setenv('SKYTPU_K8S_API_ENDPOINT', fake.endpoint)
        Pkg('skypilot_tpu')('provision').run_instances(
            'kubernetes', _config(Pkg('skypilot_tpu'), 'metricsc',
                                  accelerators='tpu-v5e-4'))
        rows, gauges = [], []
        for name in ('skypilot_tpu', 'skypilot_tpu_torch'):
            pkg = Pkg(name)
            rows.append(sorted(pkg('metrics_utils').scrape_once(),
                               key=lambda r: r['pod']))
            gauges.append(sorted(
                line for line in pkg('server.metrics').render().splitlines()
                if line.startswith('skytpu_k8s_pod_')))
            pkg('metrics_utils').maybe_scrape()
    finally:
        fake.close()
    assert rows[1] == rows[0]
    assert gauges[1] == gauges[0]
    row = next(r for r in rows[1] if r['pod'] == 'metricsc-0')
    assert (row['cluster'], row['tpu_chips'], row['cpu_millicores'],
            row['memory_bytes']) == ('metricsc', 4, 250.0, 2**30)
    assert ('skytpu_k8s_pod_tpu_chips{cluster="metricsc",'
            'pod="metricsc-0"} 4') in gauges[1]
