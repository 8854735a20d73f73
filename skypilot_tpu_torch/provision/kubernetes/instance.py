"""Kubernetes provisioner: one pod per node over the core v1 REST API
(parity: sky/provision/kubernetes/instance.py; GKE TPU shapes from
sky/provision/kubernetes/utils.py GKE_TPU_ACCELERATOR_TO_GENERATION).

Direct REST (no kubernetes client dependency): the surface used is four
endpoints — create/get/list/delete pod — authenticated by bearer token.
Endpoint resolution: SKYTPU_K8S_API_ENDPOINT env (tests point it at the
fake API server) else the current kubeconfig context's server.

TPU on GKE: a node requesting a TPU slice renders to GKE's TPU node
selectors (`cloud.google.com/gke-tpu-accelerator` + `-topology`) with
`google.com/tpu: <chips_per_host>` resource limits, one pod per slice
host — the same host fan-out the gang executor sees on a direct TPU VM
slice.  A pod stuck Unschedulable is this substrate's stockout: wait
classifies it as InsufficientCapacityError so the failover engine can
move on (other contexts / clouds).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import requests as requests_lib

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import resources as resources_lib
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.provision import common

logger = sky_logging.init_logger(__name__)

_LABEL_CLUSTER = 'skytpu-cluster'
_LABEL_NODE = 'skytpu-node'     # logical node (TPU slice) index
_LABEL_HOST = 'skytpu-host'     # host index within the node

# TPU generation -> GKE accelerator label value
# (sky/provision/kubernetes/utils.py GKE mapping).
GKE_TPU_ACCELERATOR = {
    'v4': 'tpu-v4-podslice',
    'v5litepod': 'tpu-v5-lite-podslice',
    'v5p': 'tpu-v5p-slice',
    'v6e': 'tpu-v6e-slice',
}


def _namespace() -> str:
    return os.environ.get('SKYTPU_K8S_NAMESPACE', 'default')


_kubeconfig_cache: dict = {}


def _kubeconfig_raw():
    """Parsed kubeconfig, cached by (path, mtime)."""
    path = os.path.expanduser(os.environ.get('KUBECONFIG', '~/.kube/config'))
    if not os.path.exists(path):
        return None
    try:
        key = (path, os.path.getmtime(path))
    except OSError:
        return None
    cached = _kubeconfig_cache.get('entry')
    if cached is not None and cached[0] == key:
        return cached[1]
    from skypilot_tpu_torch.utils import common_utils
    try:
        cfg = common_utils.read_yaml(path)
    except Exception:  # pylint: disable=broad-except
        return None
    _kubeconfig_cache['entry'] = (key, cfg)
    return cfg


def current_context() -> Optional[str]:
    cfg = _kubeconfig_raw()
    return cfg.get('current-context') if cfg else None


def _kubeconfig(context: Optional[str]):
    """(server, token, ca_path) for `context` (current-context when
    None).  Minimal static-token kubeconfigs; exec-auth plugins are out
    of scope for this build.  certificate-authority-data is materialized
    to a file for requests' `verify=`."""
    cfg = _kubeconfig_raw()
    if cfg is None:
        return None, None, None
    try:
        name = context or cfg.get('current-context')
        ctx = next((c['context'] for c in cfg.get('contexts', [])
                    if c['name'] == name), None)
        if ctx is None:
            return None, None, None
        cluster = next((c['cluster'] for c in cfg.get('clusters', [])
                        if c['name'] == ctx['cluster']), {})
        user = next((u['user'] for u in cfg.get('users', [])
                     if u['name'] == ctx.get('user')), {})
        ca_path = None
        ca_data = cluster.get('certificate-authority-data')
        if ca_data:
            import base64
            import hashlib
            import tempfile
            digest = hashlib.sha256(ca_data.encode()).hexdigest()[:16]
            ca_path = os.path.join(tempfile.gettempdir(),
                                   f'skytpu-k8s-ca-{digest}.crt')
            if not os.path.exists(ca_path):
                with open(ca_path, 'wb') as f:
                    f.write(base64.b64decode(ca_data))
        elif cluster.get('certificate-authority'):
            ca_path = os.path.expanduser(
                cluster['certificate-authority'])
        return cluster.get('server'), user.get('token'), ca_path
    except Exception:  # pylint: disable=broad-except
        return None, None, None


class _Client:
    """Resolved API access for one context (the `region`)."""

    def __init__(self, context: Optional[str]) -> None:
        env = os.environ.get('SKYTPU_K8S_API_ENDPOINT')
        if env:
            self.base = env.rstrip('/')
            token = os.environ.get('SKYTPU_K8S_TOKEN')
            self.verify = True
        else:
            server, token, ca_path = _kubeconfig(context)
            if not server:
                raise exceptions.NoCloudAccessError(
                    f'No Kubernetes API endpoint for context '
                    f'{context or "<current>"!r}: set '
                    f'SKYTPU_K8S_API_ENDPOINT or provide a kubeconfig '
                    f'defining it.')
            self.base = server.rstrip('/')
            self.verify = ca_path if ca_path else True
        self.headers = {'Content-Type': 'application/json'}
        if token:
            self.headers['Authorization'] = f'Bearer {token}'

    def url(self, path: str) -> str:
        return f'{self.base}/api/v1/namespaces/{_namespace()}{path}'

    def request(self, method: str, path: str, **kwargs):
        try:
            return requests_lib.request(
                method, self.url(path), headers=self.headers,
                verify=self.verify, timeout=30, **kwargs)
        except requests_lib.RequestException as e:
            # Keep transport failures inside the provision-error
            # taxonomy (SSL/conn errors otherwise escape the failover
            # engine's classification).
            raise exceptions.ProvisionError(
                f'k8s API unreachable ({type(e).__name__}): {e}') from e


def _pod_name(cluster_name: str, index: int) -> str:
    return f'{cluster_name}-{index}'


def _pod_spec(config: common.ProvisionConfig, index: int, node: int,
              host: int, res: resources_lib.Resources) -> dict:
    name = _pod_name(config.cluster_name, index)
    labels = {_LABEL_CLUSTER: config.cluster_name,
              _LABEL_NODE: str(node), _LABEL_HOST: str(host),
              **config.labels}
    container: dict = {
        'name': 'skytpu',
        # Task-pinned container image wins; env default otherwise
        # (resources.image_id — the docker-image story on this
        # substrate).
        'image': res.image_id or os.environ.get('SKYTPU_K8S_IMAGE',
                                                'python:3.11-slim'),
        # The runtime bootstrap (agent start) arrives via command_runner
        # after provisioning, mirroring the VM path; the pod just stays
        # up.
        'command': ['/bin/sh', '-c', 'sleep infinity'],
        'resources': {'requests': {}, 'limits': {}},
    }
    spec: dict = {'restartPolicy': 'Never', 'containers': [container]}
    if res.is_tpu:
        tpu = res.tpu
        gke_acc = GKE_TPU_ACCELERATOR.get(tpu.gen.name)
        if gke_acc is None:
            raise exceptions.InvalidAcceleratorError(
                f'no GKE TPU mapping for generation {tpu.gen.name!r}')
        # Honor an explicitly requested topology; default to the
        # most-square factorization otherwise.
        topology = tpu.topology or \
            'x'.join(str(d) for d in tpu.default_topology())
        spec['nodeSelector'] = {
            'cloud.google.com/gke-tpu-accelerator': gke_acc,
            'cloud.google.com/gke-tpu-topology': topology,
        }
        chips = str(tpu.chips_per_host)
        container['resources']['requests']['google.com/tpu'] = chips
        container['resources']['limits']['google.com/tpu'] = chips
    else:
        if res.cpus:
            container['resources']['requests']['cpu'] = \
                str(res.cpus).rstrip('+')
        if res.memory:
            container['resources']['requests']['memory'] = \
                f'{str(res.memory).rstrip("+")}Gi'
    if res.use_spot:
        spec.setdefault('nodeSelector', {})[
            'cloud.google.com/gke-spot'] = 'true'
        spec['tolerations'] = [{
            'key': 'cloud.google.com/gke-spot',
            'operator': 'Equal', 'value': 'true',
            'effect': 'NoSchedule',
        }]
    if config.volumes:
        # Named PVCs from the volume registry (skypilot_tpu/volumes.py).
        container['volumeMounts'] = [
            {'name': f'vol-{i}', 'mountPath': mount_path}
            for i, mount_path in enumerate(sorted(config.volumes))]
        spec['volumes'] = [
            {'name': f'vol-{i}',
             'persistentVolumeClaim': {
                 'claimName': config.volumes[mount_path]}}
            for i, mount_path in enumerate(sorted(config.volumes))]
    return {
        'apiVersion': 'v1',
        'kind': 'Pod',
        'metadata': {'name': name, 'labels': labels},
        'spec': spec,
    }


def _list_pods(client: _Client, cluster_name: str) -> List[dict]:
    resp = client.request(
        'GET', '/pods',
        params={'labelSelector': f'{_LABEL_CLUSTER}={cluster_name}'})
    if resp.status_code >= 400:
        raise exceptions.ProvisionError(
            f'k8s list pods failed ({resp.status_code}): {resp.text}')
    items = resp.json().get('items', [])
    # Numeric (node, host) order: rank assignment derives from it.
    def key(p):
        labels = p['metadata']['labels']
        return (int(labels.get(_LABEL_NODE, 1 << 30)),
                int(labels.get(_LABEL_HOST, 0)))
    return sorted(items, key=key)


def _group_by_node(pods: List[dict]) -> List[List[dict]]:
    """Host pods -> logical nodes (a multi-host TPU slice is one node)."""
    nodes: Dict[int, List[dict]] = {}
    for pod in pods:
        node = int(pod['metadata']['labels'].get(_LABEL_NODE, 0))
        nodes.setdefault(node, []).append(pod)
    return [nodes[k] for k in sorted(nodes)]


def _node_status(host_pods: List[dict]) -> common.InstanceStatus:
    """A node is as healthy as its sickest host (a TPU slice dies whole:
    one evicted host pod kills the slice's collectives)."""
    statuses = [_pod_status(p) for p in host_pods]
    for bad in (common.InstanceStatus.PREEMPTED,
                common.InstanceStatus.TERMINATED,
                common.InstanceStatus.PENDING):
        if any(s is bad for s in statuses):
            return bad
    return common.InstanceStatus.RUNNING


def _pod_status(pod: dict) -> common.InstanceStatus:
    if pod['metadata'].get('deletionTimestamp'):
        return common.InstanceStatus.TERMINATED
    phase = pod.get('status', {}).get('phase', 'Pending')
    if phase == 'Running':
        return common.InstanceStatus.RUNNING
    if phase == 'Pending':
        return common.InstanceStatus.PENDING
    if phase == 'Failed':
        reason = pod.get('status', {}).get('reason', '')
        # Node-pressure eviction / spot node reclaim present as Failed
        # pods with an eviction reason — the substrate's preemption.
        if reason in ('Evicted', 'Preempted', 'Shutdown'):
            return common.InstanceStatus.PREEMPTED
        return common.InstanceStatus.TERMINATED
    return common.InstanceStatus.TERMINATED


def _unschedulable(pod: dict) -> bool:
    for cond in pod.get('status', {}).get('conditions', []):
        if cond.get('type') == 'PodScheduled' and \
                cond.get('status') == 'False' and \
                cond.get('reason') == 'Unschedulable':
            return True
    return False


# ----- provision API ---------------------------------------------------------
def run_instances(config: common.ProvisionConfig) -> common.ProvisionRecord:
    client = _Client(config.region)
    res = resources_lib.Resources.from_yaml_config(
        dict(config.resources_config))
    existing = {p['metadata']['name']: p
                for p in _list_pods(client, config.cluster_name)}
    live = {common.InstanceStatus.RUNNING, common.InstanceStatus.PENDING}
    # A TPU slice node is one pod per host (GKE multi-host slices).
    pods_per_node = res.hosts_per_node if res.is_tpu else 1
    if config.volumes and config.num_nodes * pods_per_node > 1:
        # A ReadWriteOnce PVC multi-attached across nodes wedges the
        # second pod in ContainerCreating until the wait timeout; fail
        # fast like the GCP disk path does.
        from skypilot_tpu_torch import volumes as volumes_lib
        for vol_name in config.volumes.values():
            vol = volumes_lib.get(vol_name)
            mode = (vol.config.get('access_mode', 'ReadWriteOnce')
                    if vol else 'ReadWriteOnce')
            if mode != 'ReadWriteMany':
                raise exceptions.InvalidRequestError(
                    f'volume {vol_name!r} is {mode}; multi-pod tasks '
                    f'need access_mode ReadWriteMany (or use bucket '
                    f'mounts)')
    instance_ids = []
    resumed = any(_pod_status(p) in live for p in existing.values())
    for node in range(config.num_nodes):
        for host in range(pods_per_node):
            index = node * pods_per_node + host
            name = _pod_name(config.cluster_name, index)
            if host == 0:
                # One instance id per logical node (its head pod), like
                # the TPU path's one-id-per-slice.
                instance_ids.append(name)
            if name in existing:
                if _pod_status(existing[name]) in live:
                    continue
                # Stale Failed/Evicted pod objects block re-creation by
                # name (the GCP path deletes stale nodes the same way
                # before re-provisioning).
                _delete_pod(client, name)
            body = _pod_spec(config, index, node, host, res)
            resp = client.request('POST', '/pods', data=json.dumps(body))
            if resp.status_code == 409:
                continue                      # concurrent create
            if resp.status_code == 403 and 'quota' in resp.text.lower():
                raise exceptions.QuotaExceededError(
                    f'k8s namespace quota: {resp.text}')
            if resp.status_code >= 400:
                raise exceptions.ProvisionError(
                    f'k8s create pod {name} failed '
                    f'({resp.status_code}): {resp.text}')
    return common.ProvisionRecord('kubernetes', config.cluster_name,
                                  config.region, None, instance_ids,
                                  resumed=resumed)


def stop_instances(cluster_name: str, region=None, zone=None) -> None:
    raise exceptions.NotSupportedError(
        'Kubernetes pods cannot be stopped; use down (delete).')


def _delete_pod(client: _Client, name: str) -> None:
    resp = client.request('DELETE', f'/pods/{name}')
    if resp.status_code >= 400 and resp.status_code != 404:
        raise exceptions.ProvisionError(
            f'k8s delete pod {name} failed ({resp.status_code}): '
            f'{resp.text}')


def terminate_instances(cluster_name: str, region=None, zone=None) -> None:
    client = _Client(region)
    for pod in _list_pods(client, cluster_name):
        _delete_pod(client, pod['metadata']['name'])


def wait_instances(cluster_name: str, region=None, zone=None,
                   timeout_s: float = 1800.0) -> None:
    client = _Client(region)
    unschedulable_grace = float(os.environ.get(
        'SKYTPU_K8S_UNSCHEDULABLE_GRACE_S', '30'))
    deadline = time.time() + timeout_s
    started = time.time()
    while True:
        pods = _list_pods(client, cluster_name)
        if not pods:
            raise exceptions.ProvisionError(
                f'no pods found for cluster {cluster_name!r}')
        statuses = [_pod_status(p) for p in pods]
        if all(s is common.InstanceStatus.RUNNING for s in statuses) and \
                all(p.get('status', {}).get('podIP') for p in pods):
            return
        bad = [s for s in statuses
               if s in (common.InstanceStatus.TERMINATED,
                        common.InstanceStatus.PREEMPTED)]
        if bad:
            raise exceptions.ProvisionError(
                f'k8s pods for {cluster_name!r} failed: {statuses}')
        # Stockout detection: kept Unschedulable past the grace window
        # -> clean up and classify for the failover engine.
        if time.time() - started > unschedulable_grace and \
                any(_unschedulable(p) for p in pods):
            terminate_instances(cluster_name, region)
            raise exceptions.InsufficientCapacityError(
                f'k8s cannot schedule pods for {cluster_name!r} '
                f'(Unschedulable: no nodes with the requested '
                f'resources); treat as stockout and fail over')
        if time.time() > deadline:
            raise exceptions.ProvisionError(
                f'k8s pods for {cluster_name!r} not running after '
                f'{timeout_s}s: {statuses}')
        time.sleep(1.0)


def query_instances(cluster_name: str, region=None,
                    zone=None) -> Dict[str, common.InstanceStatus]:
    """Per *logical node* status, keyed by the node's head pod name —
    the same one-id-per-slice shape the TPU provisioner reports."""
    out: Dict[str, common.InstanceStatus] = {}
    client = _Client(region)
    for host_pods in _group_by_node(_list_pods(client, cluster_name)):
        out[host_pods[0]['metadata']['name']] = _node_status(host_pods)
    return out


def get_cluster_info(cluster_name: str, region=None,
                     zone=None) -> common.ClusterInfo:
    instances: List[common.InstanceInfo] = []
    client = _Client(region)
    for host_pods in _group_by_node(_list_pods(client, cluster_name)):
        ips = [p.get('status', {}).get('podIP') for p in host_pods]
        instances.append(common.InstanceInfo(
            instance_id=host_pods[0]['metadata']['name'],
            status=_node_status(host_pods),
            internal_ips=[ip for ip in ips if ip],
            external_ips=[],
            tags=dict(host_pods[0]['metadata'].get('labels', {})),
        ))
    return common.ClusterInfo('kubernetes', cluster_name, instances,
                              ssh_user='root')


def open_ports(cluster_name: str, ports: List[str], region=None,
               zone=None) -> None:
    """Pod IPs are cluster-internal; port exposure is a Service concern
    deliberately left to deployment manifests (the reference's LB story
    on k8s is similar)."""
    del cluster_name, ports, region, zone
