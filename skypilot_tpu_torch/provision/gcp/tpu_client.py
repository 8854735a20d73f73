"""REST client for the Cloud TPU API (tpu.googleapis.com, v2).

Parity: the reference's GCPTPUVMInstance provisioner
(sky/provision/gcp/instance_utils.py:1205-1699) which drives the same API
via discovery docs.  This client speaks plain REST with `requests` so it can
be pointed at a fake server in tests (`SKYTPU_TPU_API_ENDPOINT`), covering:

- direct node create/get/list/delete (atomic multi-host slice creation);
- queued resources (create/get/delete) — the stockout-friendly path for
  large slices: the request parks in the TPU scheduler queue and turns
  ACTIVE when capacity frees, vs failing fast (wait-vs-failover tradeoff
  handled by the failover engine);
- operation polling with exponential backoff;
- error classification into the framework's typed provision errors
  (stockout vs quota vs bad request), feeding the failover blocklists.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import requests

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.utils import common_utils

_DEFAULT_ENDPOINT = 'https://tpu.googleapis.com/v2'

_STOCKOUT_MARKERS = (
    'RESOURCE_EXHAUSTED', 'ZONE_RESOURCE_POOL_EXHAUSTED', 'out of capacity',
    'Insufficient', 'stockout', 'no more capacity',
)
_QUOTA_MARKERS = ('QUOTA', 'quota exceeded', 'Quota')


def classify_http_error(status_code: int, message: str) -> Exception:
    """HTTP error → typed provision error (reference analog:
    FailoverCloudErrorHandlerV2._gcp_handler,
    cloud_vm_ray_backend.py:494)."""
    if any(m.lower() in message.lower() for m in _QUOTA_MARKERS):
        return exceptions.QuotaExceededError(message)
    if status_code == 429 or any(m.lower() in message.lower()
                                 for m in _STOCKOUT_MARKERS):
        return exceptions.InsufficientCapacityError(message)
    return exceptions.ProvisionError(f'TPU API error {status_code}: '
                                     f'{message}')


class TpuClient:
    def __init__(self, project: str,
                 endpoint: Optional[str] = None,
                 session: Optional[requests.Session] = None) -> None:
        self.project = project
        self.endpoint = (endpoint or
                         os.environ.get('SKYTPU_TPU_API_ENDPOINT',
                                        _DEFAULT_ENDPOINT)).rstrip('/')
        self._session = session or requests.Session()

    # ----- auth --------------------------------------------------------------
    def _headers(self) -> Dict[str, str]:
        if self.endpoint != _DEFAULT_ENDPOINT:
            return {}  # fake server in tests: no auth
        # Process-wide shared credential cache (adaptors/gcp.py): one
        # refresh serves every GCP client in this server.
        from skypilot_tpu_torch.adaptors import gcp as gcp_adaptor
        return gcp_adaptor.auth_headers()

    # ----- plumbing ----------------------------------------------------------
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
            raise classify_http_error(resp.status_code, message)
        return resp.json() if resp.text else {}

    def _zone_path(self, zone: str) -> str:
        return f'projects/{self.project}/locations/{zone}'

    def wait_operation(self, op: Dict[str, Any],
                       timeout_s: float = 900.0) -> Dict[str, Any]:
        """Poll an LRO until done (reference: _wait_for_operation,
        instance_utils.py:1226)."""
        name = op.get('name')
        if name is None or op.get('done'):
            return op
        backoff = common_utils.Backoff(initial=1.0, cap=15.0)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            cur = self._request('GET', name)
            if cur.get('done'):
                err = cur.get('error')
                if err:
                    raise classify_http_error(int(err.get('code', 500)),
                                              err.get('message', str(err)))
                return cur
            time.sleep(backoff.current_backoff())
        raise exceptions.QueuedResourceTimeoutError(
            f'operation {name} did not finish in {timeout_s}s')

    # ----- nodes (direct create: small slices / on-demand) -------------------
    def create_node(self, zone: str, node_id: str,
                    accelerator_type: str, runtime_version: str,
                    spot: bool = False,
                    labels: Optional[Dict[str, str]] = None,
                    metadata: Optional[Dict[str, str]] = None,
                    network: Optional[str] = None) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            'acceleratorType': accelerator_type,
            'runtimeVersion': runtime_version,
            'labels': labels or {},
            'metadata': metadata or {},
        }
        if spot:
            body['schedulingConfig'] = {'preemptible': True, 'spot': True}
        if network:
            body['networkConfig'] = {'network': network,
                                     'enableExternalIps': True}
        op = self._request('POST', f'{self._zone_path(zone)}/nodes',
                           body=body, params={'nodeId': node_id})
        return self.wait_operation(op)

    def get_node(self, zone: str, node_id: str) -> Dict[str, Any]:
        return self._request('GET',
                             f'{self._zone_path(zone)}/nodes/{node_id}')

    def list_nodes(self, zone: str) -> List[Dict[str, Any]]:
        out = self._request('GET', f'{self._zone_path(zone)}/nodes')
        return out.get('nodes', [])

    def delete_node(self, zone: str, node_id: str) -> None:
        try:
            op = self._request(
                'DELETE', f'{self._zone_path(zone)}/nodes/{node_id}')
        except exceptions.ProvisionError as e:
            if '404' in str(e) or 'not found' in str(e).lower():
                return
            raise
        self.wait_operation(op)

    def stop_node(self, zone: str, node_id: str) -> None:
        op = self._request('POST',
                           f'{self._zone_path(zone)}/nodes/{node_id}:stop')
        self.wait_operation(op)

    def start_node(self, zone: str, node_id: str) -> None:
        op = self._request('POST',
                           f'{self._zone_path(zone)}/nodes/{node_id}:start')
        self.wait_operation(op)

    # ----- queued resources (large slices / spot) ----------------------------
    def create_queued_resource(self, zone: str, qr_id: str, node_id: str,
                               accelerator_type: str, runtime_version: str,
                               spot: bool = False,
                               valid_until_s: Optional[float] = None,
                               labels: Optional[Dict[str, str]] = None,
                               metadata: Optional[Dict[str, str]] = None
                               ) -> Dict[str, Any]:
        node: Dict[str, Any] = {
            'acceleratorType': accelerator_type,
            'runtimeVersion': runtime_version,
            'labels': labels or {},
            'metadata': metadata or {},
        }
        body: Dict[str, Any] = {
            'tpu': {'nodeSpec': [{
                'parent': self._zone_path(zone),
                'nodeId': node_id,
                'node': node,
            }]},
        }
        if spot:
            body['spot'] = {}
        if valid_until_s is not None:
            body['queueingPolicy'] = {
                'validUntilDuration': f'{int(valid_until_s)}s'
            }
        op = self._request('POST',
                           f'{self._zone_path(zone)}/queuedResources',
                           body=body, params={'queuedResourceId': qr_id})
        return op

    def get_queued_resource(self, zone: str, qr_id: str) -> Dict[str, Any]:
        return self._request(
            'GET', f'{self._zone_path(zone)}/queuedResources/{qr_id}')

    def list_queued_resources(self, zone: str) -> List[Dict[str, Any]]:
        out = self._request('GET',
                            f'{self._zone_path(zone)}/queuedResources')
        return out.get('queuedResources', [])

    def delete_queued_resource(self, zone: str, qr_id: str,
                               force: bool = True) -> None:
        try:
            op = self._request(
                'DELETE',
                f'{self._zone_path(zone)}/queuedResources/{qr_id}',
                params={'force': str(force).lower()})
        except exceptions.ProvisionError as e:
            if '404' in str(e) or 'not found' in str(e).lower():
                return
            raise
        self.wait_operation(op)

    def wait_queued_resource_active(self, zone: str, qr_id: str,
                                    timeout_s: float = 1800.0
                                    ) -> Dict[str, Any]:
        """Wait until ACTIVE; FAILED/SUSPENDED → typed error so the
        failover engine can blocklist and move on."""
        backoff = common_utils.Backoff(initial=2.0, cap=30.0)
        deadline = time.time() + timeout_s
        state = 'UNKNOWN'
        while time.time() < deadline:
            qr = self.get_queued_resource(zone, qr_id)
            state = qr.get('state', {}).get('state', 'UNKNOWN')
            if state == 'ACTIVE':
                return qr
            if state in ('FAILED', 'SUSPENDED'):
                detail = str(qr.get('state', {}))
                raise exceptions.InsufficientCapacityError(
                    f'queued resource {qr_id} {state}: {detail}')
            time.sleep(backoff.current_backoff())
        raise exceptions.QueuedResourceTimeoutError(
            f'queued resource {qr_id} not ACTIVE within {timeout_s}s '
            f'(still {state})')


def default_project() -> str:
    project = os.environ.get('SKYTPU_GCP_PROJECT') or os.environ.get(
        'GOOGLE_CLOUD_PROJECT')
    if project:
        return project
    try:
        import google.auth
        _, project = google.auth.default()
        if project:
            return project
    except Exception:  # pylint: disable=broad-except
        pass
    raise exceptions.NoCloudAccessError(
        'No GCP project configured. Set SKYTPU_GCP_PROJECT or '
        'GOOGLE_CLOUD_PROJECT.')
