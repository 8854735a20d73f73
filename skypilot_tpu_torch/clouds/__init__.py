"""Cloud registry (parity: sky/utils/registry.py cloud registration)."""
from __future__ import annotations

from typing import Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.clouds.aws import AWS
from skypilot_tpu_torch.clouds.cloud import Cloud, CloudCapability
from skypilot_tpu_torch.clouds.gcp import GCP
from skypilot_tpu_torch.clouds.kubernetes import Kubernetes
from skypilot_tpu_torch.clouds.local import Local
from skypilot_tpu_torch.clouds.slurm import Slurm
from skypilot_tpu_torch.clouds.ssh import SSH

__all__ = ['AWS', 'Cloud', 'CloudCapability', 'GCP', 'Kubernetes',
           'Local', 'SSH', 'Slurm', 'get_cloud', 'enabled_clouds',
           'CLOUD_REGISTRY']

CLOUD_REGISTRY: Dict[str, Cloud] = {
    GCP.NAME: GCP(),
    AWS.NAME: AWS(),
    Kubernetes.NAME: Kubernetes(),
    Slurm.NAME: Slurm(),
    Local.NAME: Local(),
    SSH.NAME: SSH(),
}


def get_cloud(name: str) -> Cloud:
    cloud = CLOUD_REGISTRY.get(name.lower())
    if cloud is None:
        raise exceptions.InvalidInfraError(
            f'Unknown cloud {name!r}. Known: {sorted(CLOUD_REGISTRY)}')
    return cloud


_enabled_cache: Optional[List[Cloud]] = None


def enabled_clouds(reload: bool = False) -> List[Cloud]:
    """Clouds with working credentials (`sky check` analog).  Local always
    qualifies.  `SKYTPU_ENABLED_CLOUDS=gcp,local` overrides the credential
    probe — the analog of the reference's `enable_all_clouds` test fixture
    (tests/common_test_fixtures.py:176).  The probe (subprocess to gcloud)
    is cached; pass reload=True after credential changes."""
    import os
    override = os.environ.get('SKYTPU_ENABLED_CLOUDS')
    if override is not None:
        clouds = [get_cloud(n) for n in override.split(',') if n.strip()]
    else:
        global _enabled_cache
        if _enabled_cache is None or reload:
            _enabled_cache = [
                cloud for cloud in CLOUD_REGISTRY.values()
                if cloud.check_credentials()[0]
            ]
        clouds = list(_enabled_cache)
    # Config restrictions compose: global `allowed_clouds`, then the
    # active workspace's `allowed_clouds` (skypilot_tpu/workspaces.py).
    from skypilot_tpu_torch import sky_config
    from skypilot_tpu_torch import workspaces
    global_allowed = sky_config.get_nested(('allowed_clouds',), None)
    if global_allowed:
        global_allowed = [str(c).lower() for c in global_allowed]
    for restriction in (global_allowed, workspaces.allowed_clouds()):
        if restriction:
            clouds = [c for c in clouds
                      if c.NAME.lower() in restriction]
    return clouds


def cloud_in_iterable(cloud: Cloud, clouds) -> bool:
    return any(cloud.NAME == c.NAME for c in clouds)
