"""The AWS cloud of the port against the JAX package's: the catalog,
feasibility and routing, the EC2 provisioner, failover across regions,
and the S3 and R2 stores, each scenario run through both packages
against fresh fakes (tests/fake_ec2_api.py, a fake S3 root) and compared
exactly (mirrors tests/test_aws.py)."""
import pytest

from tests.fake_ec2_api import FakeEc2Api
from tests.torch_parity import (normalized, outcome, record_calls, run_both,
                                statuses)

EC2 = ((FakeEc2Api, 'SKYTPU_EC2_API_ENDPOINT'),)


@pytest.fixture(autouse=True)
def aws_only(monkeypatch):
    monkeypatch.setenv('SKYTPU_ENABLED_CLOUDS', 'aws')
    # Where a scenario starts no fake, EC2 refuses connections.
    monkeypatch.setenv('SKYTPU_EC2_API_ENDPOINT', 'http://127.0.0.1:9')


def _config(pkg, cluster='awsc', region='us-east-1',
            instance_type='m6i.large', num_nodes=1, spot=False):
    return pkg('provision.common').ProvisionConfig(
        cluster_name=cluster, num_nodes=num_nodes,
        resources_config={'instance_type': instance_type,
                          'use_spot': spot, 'infra': f'aws/{region}'},
        region=region)


def _both(scenario, tmp_path, monkeypatch, fakes=EC2):
    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch, fakes)
    assert port_side == jax_side
    return port_side


def test_catalog_feasibility_and_routing(tmp_path, monkeypatch):
    def scenario(pkg):
        catalog = pkg('catalog.aws_catalog')
        cloud = pkg('clouds').get_cloud('aws')
        res_cls = pkg('resources').Resources
        task = pkg('task').Task('cpu', run='echo hi')
        task.set_resources(res_cls.from_yaml_config(
            {'infra': 'aws', 'cpus': '2', 'memory': '8'}))
        routed = pkg('optimizer').fill_in_launchable_resources(task, None)
        return {
            'spec': catalog.get_vm_spec('m6i.xlarge'),
            'prices': [catalog.get_vm_hourly_cost('m6i.xlarge', region,
                                                  use_spot=spot)
                       for region in ('us-east-1', 'eu-west-1')
                       for spot in (False, True)],
            'defaults': [catalog.get_default_instance_type('4', '16'),
                         catalog.get_default_instance_type('64+')],
            'regions': catalog.regions(),
            'feasible': [(c.region, c.instance_type)
                         for c in cloud.get_feasible_resources(
                             res_cls.from_yaml_config(
                                 {'infra': 'aws', 'cpus': '4'}))],
            'tpu': cloud.get_feasible_resources(
                res_cls.from_yaml_config({'accelerators': 'tpu-v5e-8'})),
            'routed': [(c.cloud, c.region, c.instance_type)
                       for c in next(iter(routed.values()))],
        }

    out = _both(scenario, tmp_path, monkeypatch, ())
    assert out['spec'] == (4, 16)
    assert out['defaults'] == ['m6i.xlarge', None]
    assert out['tpu'] == [] and out['routed'][0][0] == 'aws'


def test_ec2_lifecycle_interruption_and_capacity_errors(tmp_path,
                                                        monkeypatch):
    def scenario(pkg, ec2):
        provision = pkg('provision')
        calls = record_calls(ec2)
        out = {}
        record = provision.run_instances('aws', _config(pkg, num_nodes=2))
        provision.wait_instances('aws', 'awsc', region='us-east-1',
                                 timeout_s=30)
        info = provision.get_cluster_info('aws', 'awsc', region='us-east-1')
        out['created'] = (
            record.instance_ids, statuses(provision.query_instances(
                'aws', 'awsc', region='us-east-1')), len(info.instances),
            bool(info.head_ip),
            ec2.instance('us-east-1', 'awsc-0')['instance_type'])
        provision.stop_instances('aws', 'awsc', region='us-east-1')
        out['stopped'] = statuses(provision.query_instances(
            'aws', 'awsc', region='us-east-1'))
        record = provision.run_instances('aws', _config(pkg, num_nodes=2))
        provision.wait_instances('aws', 'awsc', region='us-east-1',
                                 timeout_s=30)
        out['resumed'] = record.resumed
        provision.terminate_instances('aws', 'awsc', region='us-east-1')
        out['after_down'] = provision.query_instances('aws', 'awsc',
                                                      region='us-east-1')
        provision.run_instances('aws', _config(pkg, cluster='spotc',
                                               spot=True))
        provision.wait_instances('aws', 'spotc', region='us-east-1',
                                 timeout_s=30)
        ec2.interrupt('us-east-1', 'spotc-0')
        out['interrupted'] = provision.query_instances('aws', 'spotc',
                                                       region='us-east-1')
        for behavior in ('stockout', 'quota'):
            ec2.set_region_behavior('us-west-2', behavior)
            out[behavior] = outcome(provision.run_instances, 'aws', _config(
                pkg, cluster=behavior, region='us-west-2'))
        out['calls'] = normalized(calls)
        return out

    out = _both(scenario, tmp_path, monkeypatch)
    assert out['created'][:2] == (['awsc-0', 'awsc-1'],
                                  {'awsc-0': 'RUNNING', 'awsc-1': 'RUNNING'})
    assert out['stopped'] == {'awsc-0': 'STOPPED', 'awsc-1': 'STOPPED'}
    assert out['resumed'] and out['after_down'] == {}
    assert out['interrupted'] == {}
    assert out['stockout'] == ('raise', 'InsufficientCapacityError')
    assert out['quota'] == ('raise', 'QuotaExceededError')


def test_cpu_task_fails_over_regions_on_fake_ec2(tmp_path, monkeypatch):
    def scenario(pkg, ec2):
        provision = pkg('provision')
        ec2.set_region_behavior('us-east-1', 'stockout')
        task = pkg('task').Task('cpu', run='echo hi')
        task.set_resources(pkg('resources').Resources.from_yaml_config(
            {'infra': 'aws', 'cpus': '2', 'memory': '8'}))
        tried = []

        def provision_fn(candidate):
            tried.append(candidate.region)
            config = pkg('provision.common').ProvisionConfig(
                cluster_name='fo', num_nodes=task.num_nodes,
                resources_config=candidate.to_yaml_config(),
                region=candidate.region, zone=candidate.zone)
            record = provision.run_instances(candidate.cloud, config)
            provision.wait_instances(candidate.cloud, 'fo',
                                     region=record.region, timeout_s=30)
            return record

        def cleanup_fn(candidate):
            provision.terminate_instances(candidate.cloud, 'fo',
                                          region=candidate.region)

        result = pkg('provision.failover').provision_with_retries(
            task, 'fo', provision_fn, cleanup_fn=cleanup_fn)
        return (tried, result.record.region,
                statuses(provision.query_instances('aws', 'fo',
                                                   region='us-west-2')),
                provision.query_instances('aws', 'fo', region='us-east-1'))

    tried, landed, west, east = _both(scenario, tmp_path, monkeypatch)
    assert tried[0] == 'us-east-1' and landed == 'us-west-2'
    assert west == {'fo-0': 'RUNNING'} and east == {}


def test_s3_and_r2_stores_and_commands(tmp_path, monkeypatch):
    def scenario(pkg):
        storage = pkg('data.storage')
        root = tmp_path / pkg.name / 's3root'
        root.mkdir(parents=True)
        src = tmp_path / pkg.name / 'src'
        (src / 'sub').mkdir(parents=True)
        (src / 'a.txt').write_text('A')
        (src / 'sub' / 'b.txt').write_text('B')
        (src / 'skip.pyc').write_text('x')
        (src / '.skyignore').write_text('*.pyc\n')
        out = {}
        with monkeypatch.context() as m:
            m.setenv('SKYTPU_FAKE_S3_ROOT', str(root))
            m.setenv('SKYTPU_FAKE_GCS_ROOT', str(tmp_path / 'gcs'))
            store = storage.S3Store('mybkt')
            seen = [store.exists()]
            store.create()
            seen.append(store.exists())
            store.sync_up(str(src))
            seen.append(store.list_prefix())
            down = tmp_path / pkg.name / 'down'
            store.sync_down(str(down))
            seen.append((down / 'sub' / 'b.txt').read_text())
            store.delete()
            seen.append(store.exists())
            out['s3'] = seen
            r2 = storage.R2Store('r2bkt')
            r2.create()
            r2.sync_up(str(src))
            out['r2'] = r2.list_prefix()
            out['routing'] = [type(storage.store_for_url(u)).__name__
                              for u in ('s3://b', 'gs://b', 'r2://b')]
            out['fake_cmds'] = [
                storage.copy_command('s3://bkt/ckpt', '/dst').replace(
                    str(root), 'ROOT'),
                storage.mount_command('s3://bkt', '/mnt/data').replace(
                    str(root), 'ROOT')]
            mount = storage.StorageMount.from_yaml_config(
                '/mnt/w', {'name': 'wbkt', 'source': str(src),
                           'store': 's3'})
            out['named'] = (mount.materialize(),
                            sorted(p.name for p in (root / 'wbkt').iterdir()))
        with monkeypatch.context() as m:
            m.delenv('SKYTPU_FAKE_S3_ROOT', raising=False)
            m.delenv('SKYTPU_R2_ENDPOINT_URL', raising=False)
            out['real_cmds'] = [
                storage.copy_command('s3://bkt/ckpt', '/dst'),
                storage.mount_command('s3://bkt', '/mnt/data'),
                storage.mount_command('s3://bkt', '/mnt/data', cached=True),
                outcome(storage.copy_command, 'r2://bkt/ckpt', '/dst')]
            m.setenv('SKYTPU_R2_ENDPOINT_URL',
                     'https://acct.r2.cloudflarestorage.com')
            out['r2_cmds'] = [
                storage.copy_command('r2://bkt/ckpt', '/dst'),
                storage.mount_command('r2://bkt', '/mnt/r2'),
                storage.mount_command('r2://bkt', '/mnt/r2', cached=True)]
        return out

    out = _both(scenario, tmp_path, monkeypatch, ())
    assert out['s3'] == [False, True, ['a.txt', 'sub/b.txt'], 'B', False]
    assert out['routing'] == ['S3Store', 'GcsStore', 'R2Store']
    assert out['named'][0] == 's3://wbkt'
    assert out['real_cmds'][3] == ('raise', 'StorageError')
    assert 'goofys' in out['r2_cmds'][1]


def test_aws_credential_check_modes(tmp_path, monkeypatch):
    def scenario(pkg):
        cloud = pkg('clouds').get_cloud('aws')
        with monkeypatch.context() as m:
            for var in ('SKYTPU_EC2_API_ENDPOINT', 'AWS_ACCESS_KEY_ID',
                        'AWS_SECRET_ACCESS_KEY', 'AWS_PROFILE'):
                m.delenv(var, raising=False)
            m.setenv('AWS_SHARED_CREDENTIALS_FILE', '/nonexistent')
            m.setenv('AWS_CONFIG_FILE', '/nonexistent')
            none = cloud.check_credentials()
            m.setenv('AWS_ACCESS_KEY_ID', 'AKIATEST')
            m.setenv('AWS_SECRET_ACCESS_KEY', 'secret')
            keys = cloud.check_credentials()
        return none, keys

    none, keys = _both(scenario, tmp_path, monkeypatch, ())
    assert not none[0] and 'credentials' in none[1].lower()
    assert keys == (True, None)
