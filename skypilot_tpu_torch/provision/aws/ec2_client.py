"""EC2 client with two backends behind one narrow interface.

Real path: boto3 through the lazy adaptor (adaptors/aws.py) — the same
surface the reference drives via boto3 in sky/provision/aws/instance.py.
Fake path: with ``SKYTPU_EC2_API_ENDPOINT`` set, a plain JSON/HTTP
protocol against tests/fake_ec2_api.py (sibling of the fake GCE/TPU
servers) so the whole provisioner is testable hermetically — the same
pattern the GCE client uses (provision/gcp/gce_client.py).

The interface is deliberately tiny: instances are identified by their
``Name`` tag (``<cluster>-<i>``) and grouped by a ``skytpu-cluster`` tag,
mirroring the label scheme of the GCP provisioners.

Error taxonomy (feeds the failover blocklists, provision/failover.py):
  InsufficientInstanceCapacity / SpotMaxPriceTooLow -> stockout (zone)
  VcpuLimitExceeded / *LimitExceeded               -> quota (region)
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch import exceptions

CLUSTER_TAG = 'skytpu-cluster'

_STOCKOUT_CODES = ('InsufficientInstanceCapacity', 'SpotMaxPriceTooLow',
                   'InsufficientHostCapacity')
_QUOTA_CODES = ('VcpuLimitExceeded', 'MaxSpotInstanceCountExceeded',
                'InstanceLimitExceeded')


def classify_aws_error(code: str, message: str) -> Exception:
    """AWS error code -> typed provision error (reference analog:
    FailoverCloudErrorHandlerV2._aws_handler)."""
    if any(code.startswith(c) or c in message for c in _QUOTA_CODES):
        return exceptions.QuotaExceededError(f'{code}: {message}')
    if any(code.startswith(c) for c in _STOCKOUT_CODES):
        return exceptions.InsufficientCapacityError(f'{code}: {message}')
    return exceptions.ProvisionError(f'EC2 error {code}: {message}')


class Ec2Client:
    """Narrow EC2 surface: run/describe/terminate/stop/start by Name tag."""

    def __init__(self, region: str) -> None:
        self.region = region
        self._fake_endpoint = os.environ.get('SKYTPU_EC2_API_ENDPOINT')

    # ----- fake transport ----------------------------------------------------
    def _fake(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              params: Optional[Dict[str, str]] = None) -> Any:
        import requests
        url = f'{self._fake_endpoint.rstrip("/")}{path}'
        resp = requests.request(method, url, json=body, params=params,
                                timeout=30)
        if resp.status_code >= 400:
            err = resp.json().get('error', {})
            raise classify_aws_error(err.get('code', str(resp.status_code)),
                                     err.get('message', resp.text))
        return resp.json() if resp.text else {}

    # ----- real transport ----------------------------------------------------
    def _boto(self):
        from skypilot_tpu_torch.adaptors import aws as aws_adaptor
        return aws_adaptor.client('ec2', region=self.region)

    def _boto_call(self, fn_name: str, **kwargs) -> Any:
        client = self._boto()
        try:
            return getattr(client, fn_name)(**kwargs)
        except Exception as e:  # pylint: disable=broad-except
            code = getattr(e, 'response', {}).get(
                'Error', {}).get('Code', '')
            if code:
                raise classify_aws_error(code, str(e)) from e
            raise

    # ----- operations --------------------------------------------------------
    def run_instances(self, cluster_name: str, names: List[str],
                      instance_type: str, zone: Optional[str] = None,
                      use_spot: bool = False,
                      image_id: Optional[str] = None,
                      user_data: Optional[str] = None) -> List[Dict]:
        """Create one instance per name (idempotence is the caller's job:
        pass only the names that do not already exist)."""
        created = []
        for name in names:
            tags = [{'Key': 'Name', 'Value': name},
                    {'Key': CLUSTER_TAG, 'Value': cluster_name}]
            if self._fake_endpoint:
                inst = self._fake('POST', '/run_instances', body={
                    'region': self.region, 'zone': zone, 'name': name,
                    'cluster': cluster_name,
                    'instance_type': instance_type,
                    'use_spot': use_spot, 'image_id': image_id,
                })['instance']
            else:
                kwargs: Dict[str, Any] = dict(
                    MinCount=1, MaxCount=1, InstanceType=instance_type,
                    TagSpecifications=[{'ResourceType': 'instance',
                                        'Tags': tags}])
                if image_id:
                    kwargs['ImageId'] = image_id
                if zone:
                    kwargs['Placement'] = {'AvailabilityZone': zone}
                if use_spot:
                    kwargs['InstanceMarketOptions'] = {'MarketType': 'spot'}
                if user_data:
                    kwargs['UserData'] = user_data
                resp = self._boto_call('run_instances', **kwargs)
                inst = self._to_dict(resp['Instances'][0], name)
            created.append(inst)
        return created

    def list_instances(self, cluster_name: str) -> List[Dict]:
        """All non-terminated instances tagged with this cluster."""
        if self._fake_endpoint:
            return self._fake('GET', '/instances', params={
                'region': self.region, 'cluster': cluster_name,
            })['instances']
        resp = self._boto_call(
            'describe_instances',
            Filters=[{'Name': f'tag:{CLUSTER_TAG}',
                      'Values': [cluster_name]},
                     {'Name': 'instance-state-name',
                      'Values': ['pending', 'running', 'stopping',
                                 'stopped', 'shutting-down']}])
        out = []
        for resv in resp.get('Reservations', []):
            for inst in resv.get('Instances', []):
                name = next((t['Value'] for t in inst.get('Tags', [])
                             if t['Key'] == 'Name'), inst['InstanceId'])
                out.append(self._to_dict(inst, name))
        return out

    def _ids_for(self, cluster_name: str,
                 names: Optional[List[str]] = None) -> List[str]:
        return [i['instance_id'] for i in self.list_instances(cluster_name)
                if names is None or i['name'] in names]

    def terminate(self, cluster_name: str,
                  names: Optional[List[str]] = None) -> None:
        if self._fake_endpoint:
            self._fake('POST', '/terminate', body={
                'region': self.region, 'cluster': cluster_name,
                'names': names})
            return
        ids = self._ids_for(cluster_name, names)
        if ids:
            self._boto_call('terminate_instances', InstanceIds=ids)

    def stop(self, cluster_name: str) -> None:
        if self._fake_endpoint:
            self._fake('POST', '/stop', body={'region': self.region,
                                              'cluster': cluster_name})
            return
        ids = self._ids_for(cluster_name)
        if ids:
            self._boto_call('stop_instances', InstanceIds=ids)

    def start(self, cluster_name: str,
              names: Optional[List[str]] = None) -> None:
        if self._fake_endpoint:
            self._fake('POST', '/start', body={'region': self.region,
                                               'cluster': cluster_name,
                                               'names': names})
            return
        ids = self._ids_for(cluster_name, names)
        if ids:
            self._boto_call('start_instances', InstanceIds=ids)

    @staticmethod
    def _to_dict(inst: Dict[str, Any], name: str) -> Dict[str, Any]:
        return {
            'instance_id': inst.get('InstanceId'),
            'name': name,
            'state': inst.get('State', {}).get('Name', 'pending'),
            'public_ip': inst.get('PublicIpAddress'),
            'private_ip': inst.get('PrivateIpAddress'),
            'zone': inst.get('Placement', {}).get('AvailabilityZone'),
        }
