"""AWS — the second compute substrate (capability parity: sky/clouds/aws.py).

CPU EC2 instances for controllers, CPU tasks and storage-adjacent work;
no accelerators (this build is TPU-first — the accelerator cloud is GCP).
S3 is the storage side (data/storage.py S3Store).  Credentials: standard
AWS env vars / ~/.aws config; the fake endpoints
(SKYTPU_EC2_API_ENDPOINT, SKYTPU_FAKE_S3_ROOT) count as configured for
hermetic tests, mirroring the GCS fake boundary.
"""
from __future__ import annotations

import configparser
import os
from typing import Dict, List, Optional, TYPE_CHECKING

from skypilot_tpu_torch.clouds import cloud as cloud_lib

if TYPE_CHECKING:
    from skypilot_tpu_torch import resources as resources_lib

_CAPS = frozenset({
    cloud_lib.CloudCapability.STOP,
    cloud_lib.CloudCapability.AUTOSTOP,
    cloud_lib.CloudCapability.MULTI_NODE,
    cloud_lib.CloudCapability.SPOT,
    cloud_lib.CloudCapability.OPEN_PORTS,
    cloud_lib.CloudCapability.STORAGE_MOUNTING,
    cloud_lib.CloudCapability.HOST_CONTROLLERS,
})


def _aws_config_has_credentials() -> bool:
    path = os.path.expanduser(
        os.environ.get('AWS_SHARED_CREDENTIALS_FILE', '~/.aws/credentials'))
    if not os.path.exists(path):
        return False
    parser = configparser.ConfigParser()
    try:
        parser.read(path)
    except configparser.Error:
        return False
    return any(parser.has_option(s, 'aws_access_key_id')
               for s in parser.sections())


class AWS(cloud_lib.Cloud):
    NAME = 'aws'
    EGRESS_COST_PER_GB = 0.09

    def capabilities(self) -> frozenset:
        return _CAPS

    def hourly_cost(self, resources: 'resources_lib.Resources') -> float:
        from skypilot_tpu_torch import exceptions
        from skypilot_tpu_torch.catalog import aws_catalog
        if resources.accelerators:
            raise exceptions.ResourcesUnavailableError(
                'AWS in this build is CPU-only (TPU-first: accelerators '
                'run on GCP TPUs).')
        instance_type = resources.instance_type
        if instance_type is None:
            instance_type = aws_catalog.get_default_instance_type(
                resources.cpus, resources.memory, region=resources.region)
        if instance_type is None:
            raise exceptions.ResourcesUnavailableError(
                f'No EC2 type satisfies cpus={resources.cpus} '
                f'memory={resources.memory}.')
        return aws_catalog.get_vm_hourly_cost(instance_type,
                                              region=resources.region,
                                              use_spot=resources.use_spot)

    def get_feasible_resources(
        self, resources: 'resources_lib.Resources'
    ) -> List['resources_lib.Resources']:
        from skypilot_tpu_torch.catalog import aws_catalog
        if resources.is_tpu or resources.accelerators:
            return []                    # no accelerators on this substrate
        regions = ([resources.region] if resources.region
                   else aws_catalog.regions())
        candidates = []
        for region in regions:
            instance_type = resources.instance_type
            if instance_type is None:
                instance_type = aws_catalog.get_default_instance_type(
                    resources.cpus, resources.memory, region=region)
                if instance_type is None:
                    continue
            candidates.append(resources.copy(infra=f'aws/{region}',
                                             instance_type=instance_type))
        return candidates

    def check_credentials(self) -> tuple:
        if os.environ.get('SKYTPU_EC2_API_ENDPOINT'):
            return True, None            # hermetic fake (tests)
        if os.environ.get('AWS_ACCESS_KEY_ID') and \
                os.environ.get('AWS_SECRET_ACCESS_KEY'):
            return True, None
        if _aws_config_has_credentials():
            return True, None
        # Profile / SSO / assumed-role setups: no static keys anywhere,
        # but ~/.aws/config carries the profile and boto3 resolves it.
        config_path = os.path.expanduser(
            os.environ.get('AWS_CONFIG_FILE', '~/.aws/config'))
        if os.environ.get('AWS_PROFILE') or os.path.exists(config_path):
            try:
                from skypilot_tpu_torch.adaptors import aws as aws_adaptor
                creds = aws_adaptor.session().get_credentials()
                if creds is not None:
                    return True, None
            except Exception:  # pylint: disable=broad-except
                pass
        return False, ('No AWS credentials found. Set AWS_ACCESS_KEY_ID/'
                       'AWS_SECRET_ACCESS_KEY, run `aws configure`, or '
                       'configure a profile/SSO in ~/.aws/config.')

    def check_storage_credentials(self, compute_result=None) -> tuple:
        if os.environ.get('SKYTPU_FAKE_S3_ROOT'):
            return True, None            # hermetic fake (tests)
        try:
            import boto3  # noqa: F401  pylint: disable=unused-import
        except ImportError:
            return False, ('boto3 not installed; S3 bucket lifecycle '
                           'needs it (`pip install boto3`).')
        ok, reason = (compute_result if compute_result is not None
                      else self.check_credentials())
        return ok, (None if ok else f'boto3 present but no '
                    f'credentials: {reason}')
