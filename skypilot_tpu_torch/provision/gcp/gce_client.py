"""REST client for Compute Engine (compute.googleapis.com, v1).

Parity: the reference's GCPComputeInstance provisioner
(sky/provision/gcp/instance_utils.py:311, bulk insert :788) which drives
the same API via discovery docs.  Plain REST with `requests` so tests can
point it at a fake server (`SKYTPU_GCE_API_ENDPOINT`).  CPU VMs carry the
control-plane workloads TPU slices can't: serve load balancers and
controllers, CPU-only tasks.

Shares the TPU client's auth + error-classification (same project, same
google.auth flow, same stockout/quota taxonomy feeding the failover
blocklists).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import requests

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.provision.gcp import tpu_client as tpu_client_lib
from skypilot_tpu_torch.utils import common_utils

_DEFAULT_ENDPOINT = 'https://compute.googleapis.com/compute/v1'

_DEFAULT_IMAGE = ('projects/debian-cloud/global/images/family/'
                  'debian-12')


class GceClient:
    def __init__(self, project: str,
                 endpoint: Optional[str] = None,
                 session: Optional[requests.Session] = None) -> None:
        self.project = project
        self.endpoint = (endpoint or
                         os.environ.get('SKYTPU_GCE_API_ENDPOINT',
                                        _DEFAULT_ENDPOINT)).rstrip('/')
        self._session = session or requests.Session()

    # ----- auth --------------------------------------------------------------
    def _headers(self) -> Dict[str, str]:
        if self.endpoint != _DEFAULT_ENDPOINT:
            return {}  # fake server in tests: no auth
        # Process-wide shared credential cache (adaptors/gcp.py).
        from skypilot_tpu_torch.adaptors import gcp as gcp_adaptor
        return gcp_adaptor.auth_headers()

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None,
                 params: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        url = f'{self.endpoint}/{path.lstrip("/")}'
        resp = self._session.request(method, url, json=body, params=params,
                                     headers=self._headers(), timeout=60)
        if resp.status_code >= 400:
            try:
                message = resp.json().get('error', {}).get('message',
                                                           resp.text)
            except Exception:  # pylint: disable=broad-except
                message = resp.text
            raise tpu_client_lib.classify_http_error(resp.status_code,
                                                     message)
        return resp.json() if resp.text else {}

    def _zone_path(self, zone: str) -> str:
        return f'projects/{self.project}/zones/{zone}'

    def wait_zone_operation(self, zone: str, op: Dict[str, Any],
                            timeout_s: float = 600.0) -> Dict[str, Any]:
        name = op.get('name')
        if name is None or op.get('status') == 'DONE':
            self._raise_op_error(op)
            return op
        backoff = common_utils.Backoff(initial=1.0, cap=10.0)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            cur = self._request(
                'GET', f'{self._zone_path(zone)}/operations/{name}')
            if cur.get('status') == 'DONE':
                self._raise_op_error(cur)
                return cur
            time.sleep(backoff.current_backoff())
        raise exceptions.ProvisionError(
            f'GCE operation {name} did not finish in {timeout_s}s')

    @staticmethod
    def _raise_op_error(op: Dict[str, Any]) -> None:
        errors = op.get('error', {}).get('errors', [])
        if errors:
            message = '; '.join(e.get('message', e.get('code', ''))
                                for e in errors)
            raise tpu_client_lib.classify_http_error(
                int(op.get('httpErrorStatusCode', 500)), message)

    # ----- instances ---------------------------------------------------------
    def _instance_body(self, zone: str, name: str, machine_type: str,
                       spot: bool,
                       labels: Optional[Dict[str, str]],
                       metadata: Optional[Dict[str, str]],
                       disk_size_gb: int,
                       attach_disks: Optional[List[str]] = None,
                       source_image: Optional[str] = None
                       ) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            'name': name,
            'machineType': f'zones/{zone}/machineTypes/{machine_type}',
            'disks': [{
                'boot': True,
                'autoDelete': True,
                'initializeParams': {
                    'sourceImage': source_image or _DEFAULT_IMAGE,
                    'diskSizeGb': str(disk_size_gb),
                },
            }] + [{
                # Named persistent-disk volumes (volumes.py): attached
                # non-boot, never auto-deleted — they outlive the VM.
                'boot': False,
                'autoDelete': False,
                'deviceName': disk,
                'source': f'{self._zone_path(zone)}/disks/{disk}',
            } for disk in (attach_disks or [])],
            'networkInterfaces': [{
                'network': 'global/networks/default',
                'accessConfigs': [{'type': 'ONE_TO_ONE_NAT',
                                   'name': 'External NAT'}],
            }],
            'labels': labels or {},
            'metadata': {
                'items': [{'key': k, 'value': v}
                          for k, v in (metadata or {}).items()],
            },
        }
        if spot:
            body['scheduling'] = {
                'provisioningModel': 'SPOT',
                'instanceTerminationAction': 'DELETE',
            }
        return body

    def create_instance(self, zone: str, name: str, machine_type: str,
                        spot: bool = False,
                        labels: Optional[Dict[str, str]] = None,
                        metadata: Optional[Dict[str, str]] = None,
                        disk_size_gb: int = 100,
                        attach_disks: Optional[List[str]] = None,
                        source_image: Optional[str] = None) -> None:
        body = self._instance_body(zone, name, machine_type, spot, labels,
                                   metadata, disk_size_gb, attach_disks,
                                   source_image)
        op = self._request('POST', f'{self._zone_path(zone)}/instances',
                           body=body)
        self.wait_zone_operation(zone, op)

    def bulk_create_instances(self, zone: str, names: List[str],
                              machine_type: str, spot: bool = False,
                              labels: Optional[Dict[str, str]] = None,
                              metadata: Optional[Dict[str, str]] = None,
                              disk_size_gb: int = 100,
                              source_image: Optional[str] = None) -> None:
        """One bulkInsert call for N homogeneous VMs (reference:
        instance_utils.py:788) — atomic-ish gang creation for multi-node
        CPU clusters."""
        props = self._instance_body(zone, '', machine_type, spot, labels,
                                    metadata, disk_size_gb,
                                    source_image=source_image)
        props.pop('name')
        body = {
            'count': str(len(names)),
            'perInstanceProperties': {n: {'name': n} for n in names},
            'instanceProperties': props,
        }
        op = self._request(
            'POST', f'{self._zone_path(zone)}/instances/bulkInsert',
            body=body)
        self.wait_zone_operation(zone, op)

    def get_instance(self, zone: str, name: str) -> Dict[str, Any]:
        return self._request('GET',
                             f'{self._zone_path(zone)}/instances/{name}')

    def list_instances(self, zone: str) -> List[Dict[str, Any]]:
        out = self._request('GET', f'{self._zone_path(zone)}/instances')
        return out.get('items', [])

    def delete_instance(self, zone: str, name: str) -> None:
        try:
            op = self._request(
                'DELETE', f'{self._zone_path(zone)}/instances/{name}')
        except exceptions.ProvisionError as e:
            if '404' in str(e) or 'not found' in str(e).lower():
                return
            raise
        self.wait_zone_operation(zone, op)

    # ----- persistent disks (volumes.py gcp-disk type) -----------------------
    def create_disk(self, zone: str, name: str, size_gb: int,
                    disk_type: str = 'pd-balanced') -> None:
        op = self._request(
            'POST', f'{self._zone_path(zone)}/disks',
            body={
                'name': name,
                'sizeGb': str(size_gb),
                'type': f'{self._zone_path(zone)}/diskTypes/{disk_type}',
                'labels': {'skytpu-volume': name},
            })
        self.wait_zone_operation(zone, op)

    def get_disk(self, zone: str, name: str) -> Dict[str, Any]:
        return self._request('GET',
                             f'{self._zone_path(zone)}/disks/{name}')

    def delete_disk(self, zone: str, name: str) -> None:
        try:
            op = self._request(
                'DELETE', f'{self._zone_path(zone)}/disks/{name}')
        except exceptions.ProvisionError as e:
            if '404' in str(e) or 'not found' in str(e).lower():
                return
            raise
        self.wait_zone_operation(zone, op)

    def stop_instance(self, zone: str, name: str) -> None:
        op = self._request(
            'POST', f'{self._zone_path(zone)}/instances/{name}/stop')
        self.wait_zone_operation(zone, op)

    def start_instance(self, zone: str, name: str) -> None:
        op = self._request(
            'POST', f'{self._zone_path(zone)}/instances/{name}/start')
        self.wait_zone_operation(zone, op)

    def resume_instance(self, zone: str, name: str) -> None:
        """SUSPENDED instances need resume, not start."""
        op = self._request(
            'POST', f'{self._zone_path(zone)}/instances/{name}/resume')
        self.wait_zone_operation(zone, op)

    def wait_instance_status(self, zone: str, name: str, statuses,
                             timeout_s: float = 300.0) -> str:
        """Poll until the instance reaches one of `statuses` (e.g. a
        STOPPING instance settling into TERMINATED before a restart)."""
        deadline = time.time() + timeout_s
        backoff = common_utils.Backoff(initial=1.0, cap=10.0)
        while True:
            status = self.get_instance(zone, name).get('status')
            if status in statuses:
                return status
            if time.time() > deadline:
                raise exceptions.ProvisionError(
                    f'instance {name} stuck in {status}, wanted one of '
                    f'{statuses}')
            time.sleep(backoff.current_backoff())
