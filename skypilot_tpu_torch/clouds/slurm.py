"""Slurm — HPC clusters as a compute substrate (capability parity:
sky/clouds/slurm.py).

Model: `infra: slurm[/partition]`.  A "cluster" is one Slurm ALLOCATION
held by a long-running sbatch job (`skytpu-<cluster>`); its nodes are
the framework's hosts — the agent bootstraps onto node 0 over SSH (HPC
sites share $HOME and allow SSH to allocated nodes; the user's own SSH
identity is used, like BYO ssh pools — the framework key is never
injected).  No prices (allocations are quota'd, not billed) and no
stop/spot/autostop: Slurm has no instance lifecycle — down (scancel)
releases the allocation.
"""
from __future__ import annotations

import shutil
from typing import Dict, List, TYPE_CHECKING

from skypilot_tpu_torch.clouds import cloud as cloud_lib

if TYPE_CHECKING:
    from skypilot_tpu_torch import resources as resources_lib

_CAPS = frozenset({
    cloud_lib.CloudCapability.MULTI_NODE,
    cloud_lib.CloudCapability.OPEN_PORTS,      # site-network managed
    cloud_lib.CloudCapability.HOST_CONTROLLERS,
})


class Slurm(cloud_lib.Cloud):
    NAME = 'slurm'
    EGRESS_COST_PER_GB = 0.0

    def capabilities(self) -> frozenset:
        return _CAPS

    def unsupported_features_for(
            self, resources: 'resources_lib.Resources'
    ) -> Dict[cloud_lib.CloudCapability, str]:
        del resources
        return {
            cloud_lib.CloudCapability.STOP:
                'Slurm allocations cannot be stopped; scancel (down) '
                'releases them',
            cloud_lib.CloudCapability.SPOT:
                'no preemptible pricing tier in Slurm',
        }

    def hourly_cost(self, resources: 'resources_lib.Resources') -> float:
        del resources
        return 0.0          # allocations are quota'd, not billed

    def get_feasible_resources(
        self, resources: 'resources_lib.Resources'
    ) -> List['resources_lib.Resources']:
        if resources.cloud != self.NAME:
            # Explicit requests only: $0/hr would win every COST
            # optimization and silently route cloud jobs onto the HPC
            # allocation (same guard as local/ssh).
            return []
        if resources.is_tpu or resources.accelerators:
            # GPU partitions would map through --gres; descoped for now
            # (TPU-first build: accelerators live on GCP).
            return []
        region = resources.region or 'default'
        return [resources.copy(infra=f'slurm/{region}')]

    def check_credentials(self) -> tuple:
        if shutil.which('sbatch') and shutil.which('squeue'):
            return True, None
        return False, ('sbatch/squeue not found on PATH; run from a '
                       'Slurm login node (or configure an SSH node '
                       'pool to one).')
