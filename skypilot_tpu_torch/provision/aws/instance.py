"""AWS EC2 provisioner (parity: sky/provision/aws/instance.py).

Same contract as the GCP provisioners (provision/gcp/instance.py):
instances are named ``<cluster>-<i>``, tagged with ``skytpu-cluster``,
reused when already running, restarted when stopped, re-created when
terminated.  Region-scoped (EC2 placement is per-AZ but the API is
regional); ``zone`` pins an availability zone when given.

The transport is Ec2Client (ec2_client.py): boto3 for real AWS, a JSON
fake (tests/fake_ec2_api.py) under SKYTPU_EC2_API_ENDPOINT — the whole
lifecycle is hermetically testable like the GCE/TPU paths.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import resources as resources_lib
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.provision import common
from skypilot_tpu_torch.provision.aws import ec2_client as ec2_client_lib

logger = sky_logging.init_logger(__name__)

# EC2 instance states -> framework InstanceStatus.  A spot-interrupted
# instance surfaces as 'terminated' in describe results; list_instances
# keeps 'shutting-down' visible so reconciliation can observe it.
_STATE_MAP = {
    'pending': common.InstanceStatus.PENDING,
    'running': common.InstanceStatus.RUNNING,
    'stopping': common.InstanceStatus.STOPPED,
    'stopped': common.InstanceStatus.STOPPED,
    'shutting-down': common.InstanceStatus.TERMINATED,
    'terminated': common.InstanceStatus.TERMINATED,
}


def _node_id(cluster_name: str, index: int) -> str:
    return f'{cluster_name}-{index}'


def _client(region: Optional[str]) -> ec2_client_lib.Ec2Client:
    if not region:
        raise exceptions.ProvisionError('AWS provisioning needs a region.')
    return ec2_client_lib.Ec2Client(region)


def _poll_s(default: float = 5.0) -> float:
    return float(os.environ.get('SKYTPU_PROVISION_POLL_S', default))


def run_instances(config: common.ProvisionConfig) -> common.ProvisionRecord:
    res = resources_lib.Resources.from_yaml_config(config.resources_config)
    instance_type = res.instance_type
    if instance_type is None:
        from skypilot_tpu_torch.catalog import aws_catalog
        instance_type = aws_catalog.get_default_instance_type(
            res.cpus, res.memory)
    if instance_type is None:
        raise exceptions.ProvisionError(
            f'no EC2 instance type satisfies cpus={res.cpus} '
            f'memory={res.memory}')
    client = _client(config.region)
    existing = {i['name']: i for i in
                client.list_instances(config.cluster_name)}
    instance_ids = []
    to_create = []
    to_start = []
    resumed = False
    for i in range(config.num_nodes):
        name = _node_id(config.cluster_name, i)
        instance_ids.append(name)
        inst = existing.get(name)
        state = inst['state'] if inst else None
        if state in ('running', 'pending'):
            resumed = True
            continue
        if state in ('stopped', 'stopping'):
            # Only in-range nodes (starting the whole cluster tag would
            # also resurrect nodes beyond num_nodes on a shrunk
            # relaunch), batched into ONE start call after the loop.
            to_start.append(name)
            resumed = True
            continue
        if state == 'shutting-down':
            # Terminating from a prior down: wait out, then re-create.
            deadline = time.time() + 120
            while time.time() < deadline:
                cur = {x['name']: x for x in
                       client.list_instances(config.cluster_name)}
                if name not in cur:
                    break
                time.sleep(_poll_s(2.0))
        to_create.append(name)
    if to_start:
        client.start(config.cluster_name, names=to_start)
    if to_create:
        user_data = None
        if config.authorized_key:
            user_data = ('#!/bin/bash\n'
                         'mkdir -p /home/skytpu/.ssh\n'
                         f'echo "{config.authorized_key}" >> '
                         '/home/skytpu/.ssh/authorized_keys\n')
        client.run_instances(config.cluster_name, to_create,
                             instance_type=instance_type,
                             zone=config.zone,
                             use_spot=res.use_spot,
                             image_id=(res.image_id
                                       if isinstance(res.image_id, str)
                                       else None),
                             user_data=user_data)
    return common.ProvisionRecord(
        provider_name='aws', cluster_name=config.cluster_name,
        region=config.region, zone=config.zone,
        instance_ids=instance_ids, resumed=resumed)


def wait_instances(cluster_name: str, region=None, zone=None,
                   timeout_s: float = 1800.0) -> None:
    del zone
    client = _client(region)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        insts = client.list_instances(cluster_name)
        states = {i['name']: i['state'] for i in insts}
        if insts and all(s == 'running' for s in states.values()):
            return
        bad = {n: s for n, s in states.items() if s == 'terminated'}
        if bad:
            raise exceptions.ProvisionError(
                f'instances terminated while waiting: {bad}')
        time.sleep(_poll_s())
    raise exceptions.ProvisionError(
        f'timed out waiting for {cluster_name} instances: '
        f'{ {i["name"]: i["state"] for i in client.list_instances(cluster_name)} }')


def query_instances(cluster_name: str, region=None,
                    zone=None) -> Dict[str, common.InstanceStatus]:
    del zone
    client = _client(region)
    out: Dict[str, common.InstanceStatus] = {}
    for inst in client.list_instances(cluster_name):
        out[inst['name']] = _STATE_MAP.get(inst['state'],
                                           common.InstanceStatus.PENDING)
    return out


def stop_instances(cluster_name: str, region=None, zone=None) -> None:
    del zone
    _client(region).stop(cluster_name)


def terminate_instances(cluster_name: str, region=None, zone=None) -> None:
    del zone
    _client(region).terminate(cluster_name)


def get_cluster_info(cluster_name: str, region=None,
                     zone=None) -> common.ClusterInfo:
    del zone
    client = _client(region)
    instances = []
    insts = sorted(client.list_instances(cluster_name),
                   key=lambda i: i['name'])
    for inst in insts:
        instances.append(common.InstanceInfo(
            instance_id=inst['name'],
            internal_ips=[ip for ip in [inst.get('private_ip')] if ip],
            external_ips=[ip for ip in [inst.get('public_ip')] if ip],
            status=_STATE_MAP.get(inst['state'],
                                  common.InstanceStatus.PENDING),
            tags={},
        ))
    return common.ClusterInfo(provider_name='aws',
                              cluster_name=cluster_name,
                              instances=instances)
