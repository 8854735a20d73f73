"""The GCP cloud of the port against the JAX package's: the TPU-VM and
queued-resource provisioner, the Compute Engine provisioner, the failover
engine over GCP's zones, and multislice provisioning, each scenario run
through both packages against fresh fakes of the same APIs
(tests/fake_tpu_api.py, tests/fake_gce_api.py) and compared exactly:
records, statuses, error classes, the fake's nodes and the calls it
served (mirrors tests/test_provision.py and tests/test_multislice.py's
provisioner cases)."""
import threading
import time

import pytest

from tests.fake_gce_api import FakeGceApi
from tests.fake_tpu_api import FakeTpuApi
from tests.torch_parity import outcome, record_calls, run_both, statuses

# Both APIs are faked in every scenario: the provisioner reads the TPU
# and the Compute Engine sides of a cluster together, and a side left at
# its default endpoint would reach for Google's credentials.
FAKES = ((FakeTpuApi, 'SKYTPU_TPU_API_ENDPOINT'),
         (FakeGceApi, 'SKYTPU_GCE_API_ENDPOINT'))
# Where a scenario starts no fake, both endpoints refuse connections.
DEAD_ENDPOINT = 'http://127.0.0.1:9/v1'


@pytest.fixture(autouse=True)
def gcp_project(monkeypatch):
    monkeypatch.setenv('SKYTPU_GCP_PROJECT', 'test-project')
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'gcp,local')
    for _, env in FAKES:
        monkeypatch.setenv(env, DEAD_ENDPOINT)


def _tpu_config(pkg, cluster='c1', acc='tpu-v5p-8', zone='us-east5-a',
                spot=False, num_nodes=1):
    return pkg('provision.common').ProvisionConfig(
        cluster_name=cluster, num_nodes=num_nodes,
        resources_config={'accelerators': acc, 'use_spot': spot,
                          'infra': f'gcp/{zone.rsplit("-", 1)[0]}/{zone}'},
        region=zone.rsplit('-', 1)[0], zone=zone)


def _gce_config(pkg, cluster='cpu1', zone='us-central1-a', num_nodes=1,
                spot=False, **res):
    res.setdefault('cpus', '4')
    return pkg('provision.common').ProvisionConfig(
        cluster_name=cluster, num_nodes=num_nodes,
        resources_config={'use_spot': spot,
                          'infra': f'gcp/{zone.rsplit("-", 1)[0]}/{zone}',
                          **res},
        region=zone.rsplit('-', 1)[0], zone=zone)


def _node_view(node):
    return {k: node.get(k) for k in ('acceleratorType', 'runtimeVersion',
                                     'labels', 'state', 'metadata')}


def _both(scenario, tmp_path, monkeypatch, fakes=FAKES):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch, fakes)
    assert port_side == jax_side
    return port_side


def test_tpu_direct_create_and_spot_queued_resource(tmp_path, monkeypatch):
    def scenario(pkg, tpu, gce):
        del gce
        provision = pkg('provision')
        calls = record_calls(tpu)
        out = {}
        record = provision.run_instances('gcp', _tpu_config(pkg))
        provision.wait_instances('gcp', 'c1', zone='us-east5-a',
                                 timeout_s=30)
        info = provision.get_cluster_info('gcp', 'c1', zone='us-east5-a')
        out['direct'] = (record.instance_ids, record.resumed,
                         [i.external_ips for i in info.instances],
                         _node_view(tpu.node('us-east5-a', 'c1-0')))
        provision.terminate_instances('gcp', 'c1', zone='us-east5-a')
        out['after_down'] = provision.query_instances('gcp', 'c1',
                                                      zone='us-east5-a')
        record = provision.run_instances(
            'gcp', _tpu_config(pkg, cluster='spotc', spot=True))
        provision.wait_instances('gcp', 'spotc', zone='us-east5-a',
                                 timeout_s=60)
        out['spot'] = (record.instance_ids, statuses(
            provision.query_instances('gcp', 'spotc', zone='us-east5-a')))
        out['calls'] = list(calls)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['direct'][0] == ['c1-0']
    assert out['direct'][3]['acceleratorType'] == 'v5p-8'
    assert out['spot'] == (['spotc-0'], {'spotc-0': 'RUNNING'})
    assert any('queuedResources' in path for _, path in out['calls'])


def test_pod_stop_preemption_and_capacity_errors(tmp_path, monkeypatch):
    def scenario(pkg, tpu, gce):
        del gce
        provision = pkg('provision')
        out = {}
        provision.run_instances('gcp', _tpu_config(pkg, cluster='podc',
                                                   acc='tpu-v5p-16'))
        provision.wait_instances('gcp', 'podc', zone='us-east5-a',
                                 timeout_s=30)
        out['pod_stop'] = outcome(provision.stop_instances, 'gcp', 'podc',
                                  zone='us-east5-a')
        provision.run_instances('gcp', _tpu_config(pkg, cluster='pr'))
        provision.wait_instances('gcp', 'pr', zone='us-east5-a',
                                 timeout_s=30)
        tpu.preempt('us-east5-a', 'pr-0')
        out['preempted'] = statuses(provision.query_instances(
            'gcp', 'pr', zone='us-east5-a'))
        provision.run_instances('gcp', _tpu_config(pkg, cluster='pr'))
        out['recreated'] = statuses(provision.query_instances(
            'gcp', 'pr', zone='us-east5-a'))
        tpu.set_zone_behavior('us-east5-b', 'stockout')
        out['stockout'] = outcome(provision.run_instances, 'gcp',
                                  _tpu_config(pkg, cluster='s1',
                                              zone='us-east5-b'))
        tpu.set_zone_behavior('us-east5-b', 'quota')
        out['quota'] = outcome(provision.run_instances, 'gcp',
                               _tpu_config(pkg, cluster='s2',
                                           zone='us-east5-b'))
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['pod_stop'] == ('raise', 'NotSupportedError')
    assert out['preempted'] == {'pr-0': 'PREEMPTED'}
    assert out['recreated'] == {'pr-0': 'RUNNING'}
    assert out['stockout'] == ('raise', 'InsufficientCapacityError')
    assert out['quota'] == ('raise', 'QuotaExceededError')


def test_restart_grace_tolerates_stale_terminal_state(tmp_path,
                                                      monkeypatch):
    def scenario(pkg, tpu, gce):
        del gce
        provision = pkg('provision')
        gcp_instance = pkg('provision.gcp.instance')
        provision.run_instances('gcp', _tpu_config(pkg, cluster='gr'))
        provision.wait_instances('gcp', 'gr', zone='us-east5-a',
                                 timeout_s=30)
        node = tpu.node('us-east5-a', 'gr-0')
        node['state'] = 'TERMINATED'
        gcp_instance._recent_restarts.clear()  # pylint: disable=protected-access
        control = outcome(provision.wait_instances, 'gcp', 'gr',
                          zone='us-east5-a', timeout_s=30)
        try:
            gcp_instance._mark_restarting('gr-0')  # pylint: disable=protected-access

            def settle():
                time.sleep(0.5)
                node['state'] = 'READY'

            th = threading.Thread(target=settle)
            th.start()
            graced = outcome(provision.wait_instances, 'gcp', 'gr',
                             zone='us-east5-a', timeout_s=30)
            th.join(timeout=10)
        finally:
            gcp_instance._recent_restarts.clear()  # pylint: disable=protected-access
        return control, graced

    assert _both(scenario, tmp_path, monkeypatch) == (
        ('raise', 'InsufficientCapacityError'), ('ok', None))


def test_gce_vm_lifecycle_bulk_insert_and_spot(tmp_path, monkeypatch):
    def scenario(pkg, tpu, gce):
        del tpu
        provision = pkg('provision')
        calls = record_calls(gce)
        out = {}
        record = provision.run_instances('gcp', _gce_config(pkg))
        provision.wait_instances('gcp', 'cpu1', zone='us-central1-a',
                                 timeout_s=30)
        inst = gce.instance('us-central1-a', 'cpu1-0')
        out['created'] = (record.instance_ids, inst['machineType'],
                          inst['labels'], statuses(provision.query_instances(
                              'gcp', 'cpu1', zone='us-central1-a')))
        provision.stop_instances('gcp', 'cpu1', zone='us-central1-a')
        out['stopped'] = statuses(provision.query_instances(
            'gcp', 'cpu1', zone='us-central1-a'))
        record = provision.run_instances('gcp', _gce_config(pkg))
        out['resumed'] = (record.resumed, statuses(
            provision.query_instances('gcp', 'cpu1', zone='us-central1-a')))
        provision.terminate_instances('gcp', 'cpu1', zone='us-central1-a')
        record = provision.run_instances(
            'gcp', _gce_config(pkg, cluster='multi', num_nodes=3))
        out['bulk'] = (record.instance_ids, statuses(
            provision.query_instances('gcp', 'multi',
                                      zone='us-central1-a')))
        provision.run_instances(
            'gcp', _gce_config(pkg, cluster='spotvm', spot=True,
                               instance_type='n2-standard-8'))
        inst = gce.instance('us-central1-a', 'spotvm-0')
        out['spot'] = (inst['machineType'], inst['scheduling'])
        gce.set_zone_behavior('us-central1-b', 'stockout')
        out['stockout'] = outcome(provision.run_instances, 'gcp',
                                  _gce_config(pkg, cluster='so',
                                              zone='us-central1-b'))
        gce.set_zone_behavior('us-central1-b', 'quota')
        out['quota'] = outcome(provision.run_instances, 'gcp',
                               _gce_config(pkg, cluster='so2',
                                           zone='us-central1-b'))
        out['calls'] = list(calls)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['stopped'] == {'cpu1-0': 'STOPPED'}
    assert out['resumed'] == (True, {'cpu1-0': 'RUNNING'})
    assert out['bulk'][0] == ['multi-0', 'multi-1', 'multi-2']
    assert out['spot'][1]['provisioningModel'] == 'SPOT'
    assert out['stockout'] == ('raise', 'InsufficientCapacityError')
    assert out['quota'] == ('raise', 'QuotaExceededError')


def test_gce_restart_waits_and_tpu_clusters_coexist(tmp_path, monkeypatch):
    def scenario(pkg, tpu, gce):
        del tpu
        provision = pkg('provision')
        out = {}
        provision.run_instances('gcp', _gce_config(pkg, cluster='stg'))
        gce.set_status('us-central1-a', 'stg-0', 'STOPPING')

        def settle():
            time.sleep(0.5)
            gce.set_status('us-central1-a', 'stg-0', 'TERMINATED')

        th = threading.Thread(target=settle)
        th.start()
        record = provision.run_instances('gcp',
                                         _gce_config(pkg, cluster='stg'))
        th.join(timeout=10)
        out['restart'] = (record.resumed, statuses(
            provision.query_instances('gcp', 'stg', zone='us-central1-a')))
        provision.run_instances('gcp', _tpu_config(pkg, cluster='tpuc'))
        provision.run_instances('gcp', _gce_config(pkg, cluster='cpuc',
                                                   zone='us-east5-a'))
        out['both'] = [sorted(provision.query_instances(
            'gcp', c, zone='us-east5-a')) for c in ('tpuc', 'cpuc')]
        provision.terminate_instances('gcp', 'cpuc', zone='us-east5-a')
        out['after'] = [sorted(provision.query_instances(
            'gcp', c, zone='us-east5-a')) for c in ('tpuc', 'cpuc')]
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['restart'] == (True, {'stg-0': 'RUNNING'})
    assert out['both'] == [['tpuc-0'], ['cpuc-0']]
    assert out['after'] == [['tpuc-0'], []]


def _tpu_task(pkg, acc='tpu-v6e-8', **res):
    task = pkg('task').Task('train', run='echo hi')
    task.set_resources(pkg('resources').Resources.from_yaml_config(
        {'accelerators': acc, 'infra': 'gcp', **res}))
    return task


def test_failover_over_gcp_zones(tmp_path, monkeypatch):
    """The failover engine over the GCP catalog's placements: the zones
    tried, in order, on stockouts, on quota (one attempt per region) and
    on exhaustion, and the round-robin of retry_until_up."""
    monkeypatch.setenv('SKYTPU_RETRY_UNTIL_UP_GAP_S', '0')

    def scenario(pkg):
        failover = pkg('provision.failover')
        common = pkg('provision.common')
        exceptions = pkg('exceptions')
        out = {}
        for case, acc, fail_first, exc, rounds in (
                ('stockout', 'tpu-v6e-8', 2, 'InsufficientCapacityError', 1),
                ('quota', 'tpu-v2-8', 99, 'QuotaExceededError', 1),
                ('exhausted', 'tpu-v6e-8', 99, 'InsufficientCapacityError',
                 1),
                ('until_up', 'tpu-v6e-8', 3, 'InsufficientCapacityError',
                 3)):
            attempts = []

            def provision_fn(candidate, fail_first=fail_first, exc=exc,
                             attempts=attempts):
                attempts.append((candidate.region, candidate.zone))
                if len(attempts) <= fail_first:
                    raise getattr(exceptions, exc)('no capacity')
                return common.ProvisionRecord('gcp', 'c', candidate.region,
                                              candidate.zone, ['c-0'])

            result = outcome(failover.provision_with_retries,
                             _tpu_task(pkg, acc), 'c', provision_fn,
                             retry_until_up=rounds > 1, max_rounds=rounds)
            if result[0] == 'ok':
                result = ('ok', result[1].record.zone)
            out[case] = (attempts, result)
        return out

    out = _both(scenario, tmp_path, monkeypatch, ())
    assert len(out['stockout'][0]) == 3
    assert out['stockout'][1] == ('ok', out['stockout'][0][-1][1])
    regions = [r for r, _ in out['quota'][0]]
    assert len(regions) == len(set(regions))
    assert out['quota'][1] == ('raise', 'ResourcesUnavailableError')
    assert out['exhausted'][1] == ('raise', 'ResourcesUnavailableError')
    assert len(out['until_up'][0]) == 4


def test_queued_resource_timeout_fails_over(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_QUEUED_RESOURCE_WAIT_S', '2')

    def scenario(pkg, tpu, gce):
        del gce
        provision = pkg('provision')
        common = pkg('provision.common')
        zones_tried = []

        def provision_fn(candidate):
            zones_tried.append(candidate.zone)
            if len(zones_tried) == 1:
                tpu.set_zone_behavior(candidate.zone, 'qr_stuck')
            cfg = common.ProvisionConfig(
                cluster_name='qrw', num_nodes=1,
                resources_config={'accelerators': 'tpu-v6e-8',
                                  'use_spot': True,
                                  'infra': f'gcp/{candidate.region}/'
                                           f'{candidate.zone}'},
                region=candidate.region, zone=candidate.zone)
            provision.run_instances('gcp', cfg)
            provision.wait_instances('gcp', 'qrw', zone=candidate.zone,
                                     timeout_s=30)
            return common.ProvisionRecord('gcp', 'qrw', candidate.region,
                                          candidate.zone, ['qrw-0'])

        def cleanup_fn(candidate):
            provision.terminate_instances('gcp', 'qrw', zone=candidate.zone)

        result = pkg('provision.failover').provision_with_retries(
            _tpu_task(pkg, use_spot=True), 'qrw', provision_fn,
            cleanup_fn=cleanup_fn)
        left = sorted(k for k in tpu.state.queued
                      if k.startswith(f'{zones_tried[0]}/'))
        return zones_tried, result.record.zone, left

    zones, landed, left = _both(scenario, tmp_path, monkeypatch)
    assert len(zones) == 2 and landed == zones[1] and left == []


def _multislice_fns(pkg, task, cluster_name):
    """The backend's provision_fn and cleanup_fn: one provisioning node
    per slice."""
    provision = pkg('provision')

    def provision_fn(candidate):
        config = pkg('provision.common').ProvisionConfig(
            cluster_name=cluster_name,
            num_nodes=task.num_nodes * candidate.num_slices,
            resources_config=candidate.to_yaml_config(),
            region=candidate.region, zone=candidate.zone)
        record = provision.run_instances(candidate.cloud, config)
        provision.wait_instances(candidate.cloud, cluster_name,
                                 region=record.region, zone=record.zone,
                                 timeout_s=30)
        return record

    def cleanup_fn(candidate):
        provision.terminate_instances(candidate.cloud, cluster_name,
                                      region=candidate.region,
                                      zone=candidate.zone)
    return provision_fn, cleanup_fn


def test_multislice_provisions_and_fails_over_atomically(tmp_path,
                                                         monkeypatch):
    """tests/test_multislice.py's two provisioner cases: a 2-slice
    cluster is two nodes of the per-slice shape, and a zone where the
    second slice stocks out is cleaned to zero nodes before both slices
    land together in the next zone."""
    def scenario(pkg, tpu, gce):
        del gce
        provision = pkg('provision')
        out = {}
        config = pkg('provision.common').ProvisionConfig(
            cluster_name='ms', num_nodes=2,
            resources_config={'accelerators': 'tpu-v5e-8x2',
                              'infra': 'gcp/us-east5/us-east5-a'},
            region='us-east5', zone='us-east5-a')
        record = provision.run_instances('gcp', config)
        provision.wait_instances('gcp', 'ms', zone='us-east5-a',
                                 timeout_s=30)
        info = provision.get_cluster_info('gcp', 'ms', zone='us-east5-a')
        out['two_slices'] = (
            record.instance_ids,
            [tpu.node('us-east5-a', n)['acceleratorType']
             for n in ('ms-0', 'ms-1')], len(info.instances))
        tpu.set_zone_behavior('us-east5-a', 'stockout_after_1')
        task = _tpu_task(pkg, 'tpu-v5e-8x2')
        task.set_resources(pkg('resources').Resources.from_yaml_config(
            {'accelerators': 'tpu-v5e-8x2', 'infra': 'gcp/us-east5'}))
        provision_fn, cleanup_fn = _multislice_fns(pkg, task, 'msf')
        result = pkg('provision.failover').provision_with_retries(
            task, 'msf', provision_fn, cleanup_fn=cleanup_fn)
        out['failover'] = (
            result.record.zone,
            provision.query_instances('gcp', 'msf', zone='us-east5-a'),
            statuses(provision.query_instances('gcp', 'msf',
                                               zone='us-east5-b')))
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['two_slices'] == (['ms-0', 'ms-1'],
                                 ['v5litepod-8', 'v5litepod-8'], 2)
    assert out['failover'] == ('us-east5-b', {},
                               {'msf-0': 'RUNNING', 'msf-1': 'RUNNING'})


def test_gcp_cloud_offers_what_the_jax_cloud_offers(tmp_path, monkeypatch):
    """The GCP cloud's placements for TPU slices and CPU VMs, their
    prices, and no placement for a GPU (the catalog has none)."""
    def scenario(pkg):
        cloud = pkg('clouds').get_cloud('gcp')
        res_cls = pkg('resources').Resources
        out = {}
        for name, spec in (('tpu', {'accelerators': 'tpu-v5p-8'}),
                           ('spot', {'accelerators': 'tpu-v6e-8',
                                     'use_spot': True}),
                           ('cpu', {'cpus': '4'}),
                           ('gpu', {'accelerators': 'H100:1'})):
            feas = outcome(cloud.get_feasible_resources,
                           res_cls.from_yaml_config({'infra': 'gcp',
                                                     **spec}))
            if feas[0] == 'ok':
                feas = ('ok', [(str(r), r.region, r.zone,
                                cloud.hourly_cost(r)) for r in feas[1]])
            out[name] = feas
        return out

    out = _both(scenario, tmp_path, monkeypatch, ())
    assert out['tpu'][1] and out['cpu'][1]
    assert out['gpu'] == ('ok', [])


def test_gcp_adaptor_shared_token_cache(tmp_path, monkeypatch):
    """adaptors/gcp.py: one credential refresh serves every client, in
    both packages, through a stand-in google-auth."""
    import sys
    import types

    def scenario(pkg):
        gcp_adaptor = pkg('adaptors.gcp')
        gcp_adaptor.reset_cache_for_tests()
        calls = {'n': 0}

        class FakeCreds:
            token = 'tok-123'

            def refresh(self, _request):
                calls['n'] += 1

        fake_auth = types.SimpleNamespace(
            default=lambda scopes=None: (FakeCreds(), 'proj'),
            transport=types.SimpleNamespace(
                requests=types.SimpleNamespace(Request=lambda: None)))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, 'google',
                      types.SimpleNamespace(auth=fake_auth))
            m.setitem(sys.modules, 'google.auth', fake_auth)
            m.setitem(sys.modules, 'google.auth.transport',
                      fake_auth.transport)
            m.setitem(sys.modules, 'google.auth.transport.requests',
                      fake_auth.transport.requests)
            try:
                headers = [gcp_adaptor.auth_headers() for _ in range(2)]
            finally:
                gcp_adaptor.reset_cache_for_tests()
        return headers, calls['n']

    assert _both(scenario, tmp_path, monkeypatch, ()) == (
        [{'Authorization': 'Bearer tok-123'}] * 2, 1)
