"""SSH cloud — bring-your-own machines from named node pools
(capability parity: the reference's `ssh` infra type, sky/clouds +
sky/ssh_node_pools; its k3s deployment is replaced by the framework's
own SSH bootstrap, the same path GCP VMs use).

`infra: ssh/<pool>`: the pool is the region; hosts are always-on, so
there is no stop/start lifecycle and the hourly cost is sunk ($0 —
explicit-request-only, like local/kubernetes).
"""
from __future__ import annotations

from typing import Dict, List, TYPE_CHECKING

from skypilot_tpu_torch.clouds import cloud as cloud_lib

if TYPE_CHECKING:
    from skypilot_tpu_torch import resources as resources_lib


class SSH(cloud_lib.Cloud):
    NAME = 'ssh'
    EGRESS_COST_PER_GB = 0.0

    def capabilities(self) -> frozenset:
        return frozenset({
            cloud_lib.CloudCapability.MULTI_NODE,
            cloud_lib.CloudCapability.OPEN_PORTS,
            cloud_lib.CloudCapability.STORAGE_MOUNTING,
            cloud_lib.CloudCapability.HOST_CONTROLLERS,
        })

    def unsupported_features_for(
            self, resources: 'resources_lib.Resources'
    ) -> Dict[cloud_lib.CloudCapability, str]:
        del resources
        return {
            cloud_lib.CloudCapability.STOP:
                'ssh pool hosts are always on; down releases them back '
                'to the pool',
            cloud_lib.CloudCapability.AUTOSTOP:
                'autostop implies stop; use autodown to release hosts',
        }

    def get_feasible_resources(
        self, resources: 'resources_lib.Resources'
    ) -> List['resources_lib.Resources']:
        if resources.cloud != self.NAME:
            return []   # explicit-request-only (sunk-cost $0)
        if resources.is_tpu:
            return []   # pools are plain machines, no TPU slices
        from skypilot_tpu_torch import ssh_node_pools
        pools = ssh_node_pools.load_pools()
        if resources.region:
            names = [resources.region] if resources.region in pools \
                else []
        else:
            names = sorted(pools)
        return [resources.copy(infra=f'ssh/{n}') for n in names]

    def hourly_cost(self, resources: 'resources_lib.Resources') -> float:
        del resources
        return 0.0

    def check_credentials(self) -> tuple:
        from skypilot_tpu_torch import ssh_node_pools
        pools = ssh_node_pools.load_pools()
        if pools:
            return True, None
        return False, (f'No ssh node pools defined '
                       f'({ssh_node_pools.pools_file()}).')
