"""Kubernetes — pods as nodes, contexts as regions (capability parity:
sky/clouds/kubernetes.py; TPU-on-GKE shapes from the reference's GKE
support, sky/provision/kubernetes/utils.py GKE TPU labels).

The TPU-first reading of Kubernetes:

- a "node" is a pod; a multi-host TPU slice on GKE is a pod per host in
  the same node pool (the gang executor sees the same host fan-out as a
  direct TPU slice);
- pods cannot stop — like TPU pod slices, delete and re-provision is
  the only lifecycle (STOP/AUTOSTOP unsupported, autodown works);
- the "region" is the kubeconfig context (`infra: kubernetes/my-ctx`),
  there are no zones;
- the cluster is sunk cost: hourly_cost is 0, so like the local cloud
  it participates only when explicitly requested — otherwise every cost
  optimization would silently route to it.
"""
from __future__ import annotations

import os
from typing import Dict, List, TYPE_CHECKING

from skypilot_tpu_torch.clouds import cloud as cloud_lib

if TYPE_CHECKING:
    from skypilot_tpu_torch import resources as resources_lib


class Kubernetes(cloud_lib.Cloud):
    NAME = 'kubernetes'
    EGRESS_COST_PER_GB = 0.0

    def capabilities(self) -> frozenset:
        return frozenset({
            cloud_lib.CloudCapability.MULTI_NODE,
            cloud_lib.CloudCapability.SPOT,       # spot node pools
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
                'pods cannot be stopped; delete (down) and re-provision '
                'instead',
            cloud_lib.CloudCapability.AUTOSTOP:
                'autostop implies stop; use autodown (down: true)',
        }

    def get_feasible_resources(
        self, resources: 'resources_lib.Resources'
    ) -> List['resources_lib.Resources']:
        # Only when explicitly requested (see module docstring).
        if resources.cloud != self.NAME:
            return []
        if resources.is_tpu:
            # Feasibility is the right altitude for the GKE generation
            # check: unmapped generations (v2/v3 — no GKE node pools)
            # must not reach provisioning as a hard error.
            from skypilot_tpu_torch.provision.kubernetes import instance as \
                k8s_instance
            gen = resources.tpu.gen.name
            if gen not in k8s_instance.GKE_TPU_ACCELERATOR:
                return []
        context = resources.region or self._default_context()
        if context is None:
            return []
        return [resources.copy(infra=f'kubernetes/{context}')]

    def hourly_cost(self, resources: 'resources_lib.Resources') -> float:
        del resources
        return 0.0   # the cluster is paid for regardless

    @staticmethod
    def _default_context():
        """Explicit env override, else the kubeconfig's current-context
        (None when neither exists — the request is then infeasible)."""
        env = os.environ.get('SKYTPU_K8S_CONTEXT')
        if env:
            return env
        if os.environ.get('SKYTPU_K8S_API_ENDPOINT'):
            return 'default'   # fake/test endpoint has no contexts
        from skypilot_tpu_torch.provision.kubernetes import instance as \
            k8s_instance
        return k8s_instance.current_context()

    def check_credentials(self) -> tuple:
        if os.environ.get('SKYTPU_K8S_API_ENDPOINT'):
            return True, None
        kubeconfig = os.path.expanduser(
            os.environ.get('KUBECONFIG', '~/.kube/config'))
        if os.path.exists(kubeconfig):
            return True, None
        return False, ('No Kubernetes credentials: set '
                       'SKYTPU_K8S_API_ENDPOINT or provide a kubeconfig.')
