"""GCP — the TPU cloud (capability parity: sky/clouds/gcp.py).

TPU-specific semantics carried over from the reference:
- multi-host TPU pods cannot stop, only delete (sky/clouds/gcp.py:219-226);
- spot TPUs leave stale nodes behind after preemption that need manual
  cleanup (gcp.py:1095-1101) — handled by the provisioner's reconciler;
- TPU runtime version defaults per generation (sky/resources.py:837).
Unlike the reference there is no `TPU-VM` pseudo instance type: the slice is
the unit, host VMs come with it.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, List, TYPE_CHECKING

from skypilot_tpu_torch import catalog
from skypilot_tpu_torch.clouds import cloud as cloud_lib

if TYPE_CHECKING:
    from skypilot_tpu_torch import resources as resources_lib

_ALL = frozenset(cloud_lib.CloudCapability)


class GCP(cloud_lib.Cloud):
    NAME = 'gcp'
    EGRESS_COST_PER_GB = 0.12  # internet egress; intra-GCP handled separately

    def capabilities(self) -> frozenset:
        return _ALL

    def unsupported_features_for(
            self, resources: 'resources_lib.Resources'
    ) -> Dict[cloud_lib.CloudCapability, str]:
        out: Dict[cloud_lib.CloudCapability, str] = {}
        if resources.is_tpu_pod:
            reason = ('multi-host TPU pod slices cannot be stopped; '
                      'delete (down) and re-provision instead '
                      '(TPU API has no stop for pods)')
            out[cloud_lib.CloudCapability.STOP] = reason
            out[cloud_lib.CloudCapability.AUTOSTOP] = (
                'autostop implies stop; use autodown (down: true) for pods')
        return out

    def get_feasible_resources(
        self, resources: 'resources_lib.Resources'
    ) -> List['resources_lib.Resources']:
        candidates = []
        if resources.is_tpu:
            for off in catalog.list_offerings(resources):
                candidates.append(
                    resources.copy(infra=f'gcp/{off.region}/{off.zone}'))
            return candidates
        if resources.accelerators:
            return []  # GPU offerings: TPU-first build, none in catalog
        instance_type = resources.instance_type
        if instance_type is None:
            instance_type = catalog.get_default_instance_type(
                resources.cpus, resources.memory)
            if instance_type is None:
                return []
        region = resources.region or 'us-central1'
        return [
            resources.copy(infra=f'gcp/{region}',
                           instance_type=instance_type)
        ]

    def check_credentials(self) -> tuple:
        """Credentials present if ADC or gcloud auth is configured."""
        adc = os.path.expanduser(
            '~/.config/gcloud/application_default_credentials.json')
        if os.environ.get('GOOGLE_APPLICATION_CREDENTIALS') or \
                os.path.exists(adc):
            return True, None
        try:
            proc = subprocess.run(
                ['gcloud', 'auth', 'list', '--format=value(account)'],
                capture_output=True, text=True, timeout=10, check=False)
            if proc.returncode == 0 and proc.stdout.strip():
                return True, None
        except (FileNotFoundError, subprocess.TimeoutExpired):
            pass
        return False, ('No GCP credentials found. Run `gcloud auth '
                       'application-default login` or set '
                       'GOOGLE_APPLICATION_CREDENTIALS.')

    def check_storage_credentials(self, compute_result=None) -> tuple:
        """GCS access is a separate surface: gsutil/ADC can work while
        compute APIs are unauthorized and vice versa (the reference
        records the two capabilities independently, sky/check.py:81)."""
        fake = os.environ.get('SKYTPU_FAKE_GCS_ROOT')
        if fake:
            return True, None   # hermetic test stores
        try:
            proc = subprocess.run(['gsutil', 'version'],
                                  capture_output=True, text=True,
                                  timeout=10, check=False)
        except FileNotFoundError:
            return False, ('gsutil not found; GCS storage mounts and '
                           'bucket lifecycle need the Cloud SDK.')
        except subprocess.TimeoutExpired:
            return False, 'gsutil probe timed out'
        if proc.returncode != 0:
            return False, (f'gsutil is installed but failing: '
                           f'{(proc.stderr or proc.stdout).strip()[:200]}')
        ok, reason = (compute_result if compute_result is not None
                      else self.check_credentials())
        return ok, (None if ok else
                    f'gsutil present but no credentials: {reason}')
