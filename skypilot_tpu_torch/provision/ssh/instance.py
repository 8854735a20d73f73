"""SSH-pool provisioner: allocation instead of creation (parity:
sky/ssh_node_pools behind the generic provision API).

"Provisioning" reserves free hosts from the named pool
(skypilot_tpu/ssh_node_pools.py); nothing is created or destroyed.
Liveness is a TCP probe of the SSH port — an unreachable host reports
TERMINATED so the status reconciler and managed-jobs recovery see dead
machines the same way they see deleted VMs.
"""
from __future__ import annotations

import socket
from typing import Dict, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import ssh_node_pools
from skypilot_tpu_torch.provision import common


def _pool(region: Optional[str]) -> str:
    if not region:
        raise exceptions.InvalidInfraError(
            'ssh provisioning needs a pool: use infra ssh/<pool>')
    return region


def _host_alive(host: str, port: int = 22, timeout_s: float = 2.0) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout_s):
            return True
    except OSError:
        return False


def run_instances(config: common.ProvisionConfig) -> common.ProvisionRecord:
    pool = _pool(config.region)
    existing = ssh_node_pools.allocation(pool, config.cluster_name)
    hosts = ssh_node_pools.allocate(pool, config.cluster_name,
                                    config.num_nodes)
    return common.ProvisionRecord('ssh', config.cluster_name, pool, None,
                                  hosts, resumed=bool(existing))


def stop_instances(cluster_name: str, region=None, zone=None) -> None:
    raise exceptions.NotSupportedError(
        'ssh pool hosts are always on; down releases them')


def terminate_instances(cluster_name: str, region=None, zone=None) -> None:
    ssh_node_pools.release(_pool(region), cluster_name)


def wait_instances(cluster_name: str, region=None, zone=None,
                   timeout_s: float = 1800.0) -> None:
    del timeout_s
    statuses = query_instances(cluster_name, region, zone)
    dead = [h for h, s in statuses.items()
            if s is not common.InstanceStatus.RUNNING]
    if dead:
        # Release so the failover engine can try another pool; dead
        # hosts stay in the pool file for the operator to fix.
        ssh_node_pools.release(_pool(region), cluster_name)
        raise exceptions.InsufficientCapacityError(
            f'ssh hosts unreachable on port 22: {dead}')


def query_instances(cluster_name: str, region=None,
                    zone=None) -> Dict[str, common.InstanceStatus]:
    pool = _pool(region)
    port = ssh_node_pools.get_pool(pool)['port']
    out: Dict[str, common.InstanceStatus] = {}
    for host in ssh_node_pools.allocation(pool, cluster_name):
        out[host] = (common.InstanceStatus.RUNNING
                     if _host_alive(host, port)
                     else common.InstanceStatus.TERMINATED)
    return out


def get_cluster_info(cluster_name: str, region=None,
                     zone=None) -> common.ClusterInfo:
    pool = _pool(region)
    cfg = ssh_node_pools.get_pool(pool)
    instances = [
        common.InstanceInfo(
            instance_id=host,
            status=(common.InstanceStatus.RUNNING
                    if _host_alive(host, cfg['port'])
                    else common.InstanceStatus.TERMINATED),
            internal_ips=[host],
            external_ips=[],
        )
        for host in ssh_node_pools.allocation(pool, cluster_name)
    ]
    return common.ClusterInfo('ssh', cluster_name, instances,
                              ssh_user=cfg['user'], ssh_port=cfg['port'],
                              ssh_key_path=cfg.get('identity_file'))
