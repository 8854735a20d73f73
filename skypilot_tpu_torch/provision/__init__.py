"""Provider-agnostic provisioning API, routed by cloud name.

Parity: sky/provision/__init__.py:45 `_route_to_cloud_impl` — each function
dispatches to `skypilot_tpu_torch.provision.<cloud>.instance`.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.utils import timeline
from skypilot_tpu_torch.provision.common import (ClusterInfo, InstanceInfo,
                                           InstanceStatus, ProvisionConfig,
                                           ProvisionRecord)

__all__ = [
    'ClusterInfo', 'InstanceInfo', 'InstanceStatus', 'ProvisionConfig',
    'ProvisionRecord', 'run_instances', 'stop_instances',
    'terminate_instances', 'wait_instances', 'query_instances',
    'get_cluster_info', 'open_ports',
]


def _impl(cloud: str):
    try:
        return importlib.import_module(
            f'skypilot_tpu_torch.provision.{cloud}.instance')
    except ImportError as e:
        raise exceptions.InvalidInfraError(
            f'No provisioner for cloud {cloud!r}.') from e


def run_instances(cloud: str, config: ProvisionConfig) -> ProvisionRecord:
    """Create (or resume) the cluster's nodes.  Blocks until the creation
    request is accepted, NOT until instances are running — call
    wait_instances next."""
    with timeline.Event('provision.run_instances', cloud=cloud,
                        cluster=config.cluster_name):
        return _impl(cloud).run_instances(config)


def stop_instances(cloud: str, cluster_name: str,
                   region: Optional[str] = None,
                   zone: Optional[str] = None) -> None:
    return _impl(cloud).stop_instances(cluster_name, region, zone)


def terminate_instances(cloud: str, cluster_name: str,
                        region: Optional[str] = None,
                        zone: Optional[str] = None) -> None:
    with timeline.Event('provision.terminate_instances', cloud=cloud,
                        cluster=cluster_name):
        return _impl(cloud).terminate_instances(cluster_name, region, zone)


def wait_instances(cloud: str, cluster_name: str,
                   region: Optional[str] = None,
                   zone: Optional[str] = None,
                   timeout_s: float = 1800.0) -> None:
    """Block until every node is RUNNING (raises on PREEMPTED/TERMINATED)."""
    with timeline.Event('provision.wait_instances', cloud=cloud,
                        cluster=cluster_name):
        return _impl(cloud).wait_instances(cluster_name, region, zone,
                                           timeout_s)


def query_instances(
        cloud: str, cluster_name: str,
        region: Optional[str] = None,
        zone: Optional[str] = None) -> Dict[str, InstanceStatus]:
    """instance_id → status; the status-reconciliation primitive
    (reference: backend_utils._update_cluster_status → query_instances)."""
    return _impl(cloud).query_instances(cluster_name, region, zone)


def get_cluster_info(cloud: str, cluster_name: str,
                     region: Optional[str] = None,
                     zone: Optional[str] = None) -> ClusterInfo:
    return _impl(cloud).get_cluster_info(cluster_name, region, zone)


def open_ports(cloud: str, cluster_name: str, ports: List[str],
               region: Optional[str] = None,
               zone: Optional[str] = None) -> None:
    impl = _impl(cloud)
    if hasattr(impl, 'open_ports'):
        impl.open_ports(cluster_name, ports, region, zone)
