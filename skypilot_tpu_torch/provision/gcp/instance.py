"""GCP provisioner implementing the dispatch API: TPU slices + CPU VMs.

One logical node == one TPU resource (a whole slice; multi-host slices get
all their host VMs atomically from the TPU API — no per-VM gang scheduling
needed, unlike the reference's GPU path).  Node naming:
``<cluster>-<i>`` for node i; queued-resource ids mirror node ids.

Resources without a TPU route to Compute Engine (gce_client.py — the
reference's GCPComputeInstance, sky/provision/gcp/instance_utils.py:311):
serve LBs/controllers and CPU-only tasks.  The read/teardown paths
(query/stop/terminate/get_cluster_info) consult both services and merge,
since the dispatch API addresses clusters by name only.

TPU semantics carried from the reference:
- pods (multi-host) cannot stop — only delete (sky/clouds/gcp.py:219-226);
- preempted spot TPUs leave a stale PREEMPTED node that must be deleted
  before re-creating (gcp.py:1095-1101) — run_instances reconciles this;
- queued resources are used for spot and large slices, direct create for
  small on-demand slices (instance_utils.py:1501 retry-on-stockout analog).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import resources as resources_lib
from skypilot_tpu_torch.provision import common
from skypilot_tpu_torch.provision.gcp import gce_client as gce_client_lib
from skypilot_tpu_torch.provision.gcp import tpu_client as tpu_client_lib

# TPU node states → framework InstanceStatus.
_STATE_MAP = {
    'CREATING': common.InstanceStatus.PENDING,
    'STARTING': common.InstanceStatus.PENDING,
    'RESTARTING': common.InstanceStatus.PENDING,
    'REPAIRING': common.InstanceStatus.PENDING,
    'READY': common.InstanceStatus.RUNNING,
    'STOPPING': common.InstanceStatus.STOPPED,
    'STOPPED': common.InstanceStatus.STOPPED,
    'PREEMPTED': common.InstanceStatus.PREEMPTED,
    'TERMINATED': common.InstanceStatus.TERMINATED,
    'DELETING': common.InstanceStatus.TERMINATED,
}

# GCE instance states → framework InstanceStatus.  Note GCE reports a
# *stopped* VM as TERMINATED (the disk survives; the instance restarts).
_GCE_STATE_MAP = {
    'PROVISIONING': common.InstanceStatus.PENDING,
    'STAGING': common.InstanceStatus.PENDING,
    'REPAIRING': common.InstanceStatus.PENDING,
    'RUNNING': common.InstanceStatus.RUNNING,
    'STOPPING': common.InstanceStatus.STOPPED,
    'SUSPENDING': common.InstanceStatus.STOPPED,
    'SUSPENDED': common.InstanceStatus.STOPPED,
    'TERMINATED': common.InstanceStatus.STOPPED,
}

_CLUSTER_LABEL = 'skytpu-cluster'

# instances.start/resume (and delete-then-recreate of stale spot nodes)
# are async on the real APIs: for a while after we issue the call the
# instance still reports its old TERMINATED/SUSPENDED/STOPPED state.
# run_instances stamps such nodes here so wait_instances treats those
# states as in-flight (PENDING) instead of spuriously classifying the
# cluster as failed — which would send the failover engine off to delete
# a perfectly healthy restarting VM.
_RESUME_GRACE_S = 120.0
_recent_restarts: Dict[str, float] = {}


def _mark_restarting(node_id: str) -> None:
    now = time.time()
    for k in [k for k, t in _recent_restarts.items()
              if now - t >= _RESUME_GRACE_S]:
        del _recent_restarts[k]
    _recent_restarts[node_id] = now


def _in_restart_grace(node_id: str) -> bool:
    t = _recent_restarts.get(node_id)
    return t is not None and time.time() - t < _RESUME_GRACE_S


def _client() -> tpu_client_lib.TpuClient:
    return tpu_client_lib.TpuClient(tpu_client_lib.default_project())


def _gce_client() -> gce_client_lib.GceClient:
    return gce_client_lib.GceClient(tpu_client_lib.default_project())


def _node_id(cluster_name: str, i: int) -> str:
    return f'{cluster_name}-{i}'


def _cluster_nodes(client: tpu_client_lib.TpuClient, zone: str,
                   cluster_name: str) -> Dict[str, dict]:
    out = {}
    for node in client.list_nodes(zone):
        labels = node.get('labels', {})
        if labels.get(_CLUSTER_LABEL) == cluster_name:
            out[node['name'].rsplit('/', 1)[-1]] = node
    return out


def run_instances(config: common.ProvisionConfig) -> common.ProvisionRecord:
    if config.zone is None:
        raise exceptions.ProvisionError(
            'GCP TPU provisioning requires a concrete zone '
            '(the optimizer/failover engine supplies one).')
    res = resources_lib.Resources.from_yaml_config(
        dict(config.resources_config))
    tpu = res.tpu
    if tpu is None:
        return _run_gce_instances(config, res)
    if config.volumes:
        # Loud, not silent: TPU slices have no disk-attach path; data
        # that must survive the slice belongs on bucket mounts.
        raise exceptions.InvalidRequestError(
            'gcp-disk volumes cannot attach to TPU slices; use storage '
            '(bucket) mounts for checkpoints/datasets on TPUs')
    from skypilot_tpu_torch.provision import docker_utils
    if res.image_id and not docker_utils.image_from_resources(
            res.image_id):
        raise exceptions.InvalidRequestError(
            'image_id does not apply to TPU slices; their software '
            'stack is selected by the TPU runtime version (the '
            '`runtime_version` resources field).  `docker:<image>` IS '
            'supported — the task runs in a privileged container on '
            'each TPU VM host')
    client = _client()
    zone = config.zone
    existing = _cluster_nodes(client, zone, config.cluster_name)
    labels = dict(config.labels)
    labels[_CLUSTER_LABEL] = config.cluster_name
    metadata = {}
    if config.authorized_key:
        # TPU VMs honor ssh-keys metadata like GCE.
        metadata['ssh-keys'] = f'skytpu:{config.authorized_key}'

    instance_ids = []
    resumed = False
    use_qr = res.use_spot or tpu.is_pod   # queued path for spot/pods
    for i in range(config.num_nodes):
        node_id = _node_id(config.cluster_name, i)
        instance_ids.append(node_id)
        node = existing.get(node_id)
        state = node.get('state') if node else None
        if state == 'READY':
            resumed = True
            continue
        if state in ('CREATING', 'STARTING', 'RESTARTING', 'REPAIRING'):
            # In-flight from an interrupted launch: re-creating would 409
            # and blocklist a healthy zone; wait_instances will pick it up.
            resumed = True
            continue
        if state in ('STOPPED', 'STOPPING'):
            client.start_node(zone, node_id)
            _mark_restarting(node_id)
            resumed = True
            continue
        if state in ('PREEMPTED', 'TERMINATED', 'FAILED'):
            # Stale spot node: must delete before re-create
            # (reference: sky/clouds/gcp.py:1095-1101).
            client.delete_queued_resource(zone, node_id)
            client.delete_node(zone, node_id)
            _mark_restarting(node_id)
        if use_qr:
            client.delete_queued_resource(zone, node_id)
            client.create_queued_resource(
                zone, qr_id=node_id, node_id=node_id,
                accelerator_type=tpu.gcp_accelerator_type,
                runtime_version=res.tpu_runtime_version,
                spot=res.use_spot, labels=labels, metadata=metadata)
        else:
            client.create_node(
                zone, node_id,
                accelerator_type=tpu.gcp_accelerator_type,
                runtime_version=res.tpu_runtime_version,
                spot=False, labels=labels, metadata=metadata)
    return common.ProvisionRecord('gcp', config.cluster_name,
                                  config.region, zone, instance_ids,
                                  resumed=resumed)


def _gce_cluster_instances(client: gce_client_lib.GceClient, zone: str,
                           cluster_name: str) -> Dict[str, dict]:
    out = {}
    for inst in client.list_instances(zone):
        if inst.get('labels', {}).get(_CLUSTER_LABEL) == cluster_name:
            out[inst['name']] = inst
    return out


def _run_gce_instances(config: common.ProvisionConfig,
                       res: resources_lib.Resources
                       ) -> common.ProvisionRecord:
    """CPU-VM path (reference: GCPComputeInstance.create_instances,
    instance_utils.py:311-788)."""
    machine_type = res.instance_type
    if machine_type is None:
        from skypilot_tpu_torch.catalog import gcp_catalog
        machine_type = gcp_catalog.get_default_instance_type(
            res.cpus, res.memory)
    if machine_type is None:
        raise exceptions.ProvisionError(
            f'no GCE machine type satisfies cpus={res.cpus} '
            f'memory={res.memory}')
    client = _gce_client()
    zone = config.zone
    existing = _gce_cluster_instances(client, zone, config.cluster_name)
    labels = dict(config.labels)
    labels[_CLUSTER_LABEL] = config.cluster_name
    metadata = {}
    if config.authorized_key:
        metadata['ssh-keys'] = f'skytpu:{config.authorized_key}'
    attach_disks = sorted(config.volumes.values()) or None
    # docker:<image> is a task RUNTIME (container on the VM), not a VM
    # boot image — the gang executor handles it (agent/gang.py).
    from skypilot_tpu_torch.provision import docker_utils
    source_image = (None if docker_utils.image_from_resources(
        res.image_id) else res.image_id)
    disk_size_gb = int(res.disk_size)
    if attach_disks:
        # Format-if-new and mount each named disk at its mount_path on
        # boot (the k8s path gets this from the kubelet; VMs need it
        # spelled out).
        lines = ['#!/bin/bash']
        for mount_path, disk in sorted(config.volumes.items()):
            dev = f'/dev/disk/by-id/google-{disk}'
            lines += [
                f'if ! blkid {dev} >/dev/null 2>&1; then '
                f'mkfs.ext4 -m 0 -F {dev}; fi',
                f'mkdir -p {mount_path}',
                f'mount -o discard,defaults {dev} {mount_path}',
            ]
        metadata['startup-script'] = '\n'.join(lines)

    def _check_volumes_attached(inst: dict, name: str) -> None:
        """An existing instance must already carry every requested
        volume — new volumes cannot be hot-added to a reused VM."""
        if not attach_disks:
            return
        have = {d.get('deviceName') for d in inst.get('disks', [])}
        missing = [d for d in attach_disks if d not in have]
        if missing:
            raise exceptions.InvalidRequestError(
                f'instance {name} exists without volumes {missing} '
                f'attached; `skytpu down` the cluster and relaunch to '
                f'attach them')

    instance_ids = []
    to_create = []
    resumed = False
    for i in range(config.num_nodes):
        name = _node_id(config.cluster_name, i)
        instance_ids.append(name)
        inst = existing.get(name)
        status = inst.get('status') if inst else None
        if status in ('RUNNING', 'PROVISIONING', 'STAGING'):
            _check_volumes_attached(inst, name)
            resumed = True
            continue
        if status in ('TERMINATED', 'STOPPING'):
            # GCE TERMINATED == stopped-with-disk: restart in place.  An
            # in-flight stop must settle first — start on a STOPPING
            # instance is a 400 on the real API.
            _check_volumes_attached(inst, name)
            if status == 'STOPPING':
                client.wait_instance_status(zone, name, ('TERMINATED',))
            # No grace stamp needed: GCE stale post-start states
            # (TERMINATED/SUSPENDED) map to InstanceStatus.STOPPED, which
            # wait_instances already treats as in-flight.
            client.start_instance(zone, name)
            resumed = True
            continue
        if status in ('SUSPENDED', 'SUSPENDING'):
            _check_volumes_attached(inst, name)
            if status == 'SUSPENDING':
                client.wait_instance_status(zone, name, ('SUSPENDED',))
            client.resume_instance(zone, name)
            resumed = True
            continue
        to_create.append(name)
    if len(to_create) == 1:
        client.create_instance(zone, to_create[0], machine_type,
                               spot=res.use_spot, labels=labels,
                               metadata=metadata,
                               disk_size_gb=disk_size_gb,
                               attach_disks=attach_disks,
                               source_image=source_image)
    elif to_create:
        if attach_disks:
            # A zonal persistent disk attaches to one VM (ReadWriteOnce);
            # multi-node gangs must use bucket mounts instead.
            raise exceptions.InvalidRequestError(
                'gcp-disk volumes attach to single-node clusters only; '
                'use storage (bucket) mounts for multi-node tasks')
        client.bulk_create_instances(zone, to_create, machine_type,
                                     spot=res.use_spot, labels=labels,
                                     metadata=metadata,
                                     disk_size_gb=disk_size_gb,
                                     source_image=source_image)
    return common.ProvisionRecord('gcp', config.cluster_name,
                                  config.region, zone, instance_ids,
                                  resumed=resumed)


def _cluster_queued_resources(client: tpu_client_lib.TpuClient, zone: str,
                              cluster_name: str) -> List[str]:
    out = []
    for qr in client.list_queued_resources(zone):
        specs = qr.get('tpu', {}).get('nodeSpec', [])
        labels = specs[0].get('node', {}).get('labels', {}) if specs else {}
        if labels.get(_CLUSTER_LABEL) == cluster_name:
            out.append(qr['name'].rsplit('/', 1)[-1])
    return out


def _service_unconfigured(e: Exception) -> bool:
    """True iff the error means this deployment simply has no access to
    that service (no project/credentials) — by-design absence.  Anything
    else (500s, timeouts, auth blips) is a REAL error: treating it as
    'no instances' would let teardown silently leak billed resources and
    status refresh remove live clusters."""
    if isinstance(e, exceptions.NoCloudAccessError):
        return True
    # DefaultCredentialsError = no credentials at all (by-design absence).
    # RefreshError is NOT here: credentials exist but refresh failed —
    # a transient auth problem that must surface, not read as empty.
    return type(e).__name__ == 'DefaultCredentialsError'


def _query_both(cluster_name: str, zone: str):
    """(tpu_nodes, gce_instances).  A side whose service is not
    configured for this deployment (CPU-only: no TPU API; TPU-only: no
    GCE) reads as empty; a side that is configured but *fails* raises —
    callers must not mistake an outage for an empty cluster."""
    unconfigured = []
    tpu_nodes: Dict[str, dict] = {}
    gce_insts: Dict[str, dict] = {}
    try:
        tpu_nodes = _cluster_nodes(_client(), zone, cluster_name)
    except Exception as e:  # pylint: disable=broad-except
        if not _service_unconfigured(e):
            raise
        unconfigured.append(e)
    try:
        gce_insts = _gce_cluster_instances(_gce_client(), zone,
                                           cluster_name)
    except Exception as e:  # pylint: disable=broad-except
        if not _service_unconfigured(e):
            raise
        unconfigured.append(e)
    if len(unconfigured) == 2:
        raise unconfigured[0]
    return tpu_nodes, gce_insts


def _queued_resource_wait_s(default: float) -> float:
    """Wait-vs-failover policy knob (SURVEY hard-part (d); reference:
    retry-on-stockout loop, instance_utils.py:1501-1592): how long to park
    on a queued resource before abandoning the zone.  A long wait bets the
    zone frees up; a short one lets the failover engine try elsewhere.
    Config: `gcp.queued_resource_wait_s` (yaml) or
    SKYTPU_QUEUED_RESOURCE_WAIT_S (env, wins)."""
    env = os.environ.get('SKYTPU_QUEUED_RESOURCE_WAIT_S')
    if env is not None:
        return float(env)
    from skypilot_tpu_torch import sky_config
    return float(sky_config.get_nested(('gcp', 'queued_resource_wait_s'),
                                       default))


def wait_instances(cluster_name: str, region=None, zone=None,
                   timeout_s: float = 1800.0) -> None:
    # Queued-resource path first: wait until each QR is ACTIVE (the TPU
    # scheduler materializes the node atomically at that point).  On
    # timeout, QueuedResourceTimeoutError propagates to the failover
    # engine, which blocklists this zone, deletes the parked QR
    # (cleanup_fn) and tries the next placement.
    try:
        client = _client()
        qr_ids = _cluster_queued_resources(client, zone, cluster_name)
    except Exception as e:  # pylint: disable=broad-except
        if not _service_unconfigured(e):
            raise
        client, qr_ids = None, []   # CPU-only deployment: no TPU API
    qr_wait = _queued_resource_wait_s(timeout_s)
    for qr_id in qr_ids:
        client.wait_queued_resource_active(zone, qr_id,
                                           timeout_s=qr_wait)
    deadline = time.time() + timeout_s
    while True:
        statuses = query_instances(cluster_name, region, zone)
        if not statuses:
            raise exceptions.ProvisionError(
                f'no instances found for cluster {cluster_name} in {zone}')
        if all(s is common.InstanceStatus.RUNNING
               for s in statuses.values()):
            return
        bad = {k: s for k, s in statuses.items()
               if s in (common.InstanceStatus.PREEMPTED,
                        common.InstanceStatus.TERMINATED)
               and not _in_restart_grace(k)}
        if bad:
            raise exceptions.InsufficientCapacityError(
                f'instances failed during provisioning: {bad}')
        if time.time() > deadline:
            raise exceptions.QueuedResourceTimeoutError(
                f'cluster {cluster_name} not READY in {timeout_s}s: '
                f'{statuses}')
        time.sleep(float(os.environ.get('SKYTPU_PROVISION_POLL_S', '10')))
    del client


def query_instances(cluster_name: str, region=None,
                    zone=None) -> Dict[str, common.InstanceStatus]:
    tpu_nodes, gce_insts = _query_both(cluster_name, zone)
    out = {
        node_id: _STATE_MAP.get(node.get('state', ''),
                                common.InstanceStatus.PENDING)
        for node_id, node in tpu_nodes.items()
    }
    for name, inst in gce_insts.items():
        out[name] = _GCE_STATE_MAP.get(inst.get('status', ''),
                                       common.InstanceStatus.PENDING)
    return out


def stop_instances(cluster_name: str, region=None, zone=None) -> None:
    tpu_nodes, gce_insts = _query_both(cluster_name, zone)
    if tpu_nodes:
        client = _client()
        for node_id, node in tpu_nodes.items():
            accel = node.get('acceleratorType', '')
            # Multi-host slice: no stop support in the TPU API.
            from skypilot_tpu_torch import accelerators as acc_lib
            if acc_lib.is_tpu(f'tpu-{accel}') and \
                    acc_lib.parse_tpu(f'tpu-{accel}').is_pod:
                raise exceptions.NotSupportedError(
                    f'TPU pod slice {node_id} ({accel}) cannot be '
                    'stopped; use down instead.')
            client.stop_node(zone, node_id)
    if gce_insts:
        gce = _gce_client()
        for name in gce_insts:
            gce.stop_instance(zone, name)


def terminate_instances(cluster_name: str, region=None, zone=None) -> None:
    tpu_nodes, gce_insts = _query_both(cluster_name, zone)
    try:
        client = _client()
        qr_ids = _cluster_queued_resources(client, zone, cluster_name)
    except Exception as e:  # pylint: disable=broad-except
        if not _service_unconfigured(e):
            raise
        client, qr_ids = None, []
    # Parked queued-resources whose node never materialized need explicit
    # deletion too (otherwise they later claim capacity for a dead cluster).
    for qr_id in qr_ids:
        client.delete_queued_resource(zone, qr_id)
    for node_id in tpu_nodes:
        client.delete_queued_resource(zone, node_id)
        client.delete_node(zone, node_id)
    if gce_insts:
        gce = _gce_client()
        for name in gce_insts:
            gce.delete_instance(zone, name)


def get_cluster_info(cluster_name: str, region=None,
                     zone=None) -> common.ClusterInfo:
    tpu_nodes, gce_insts = _query_both(cluster_name, zone)
    instances: List[common.InstanceInfo] = []

    def _numeric_key(item):
        # '<cluster>-<i>': order by node index, not lexicographically
        # (lexicographic puts node 10 before node 2).
        node_id = item[0]
        suffix = node_id.rsplit('-', 1)[-1]
        return (int(suffix) if suffix.isdigit() else 1 << 30, node_id)

    for node_id, node in sorted(tpu_nodes.items(), key=_numeric_key):
        internal, external = [], []
        for ep in node.get('networkEndpoints', []):
            if ep.get('ipAddress'):
                internal.append(ep['ipAddress'])
            access = ep.get('accessConfig', {})
            if access.get('externalIp'):
                external.append(access['externalIp'])
        instances.append(
            common.InstanceInfo(
                instance_id=node_id,
                status=_STATE_MAP.get(node.get('state', ''),
                                      common.InstanceStatus.PENDING),
                internal_ips=internal,
                external_ips=external,
                tags=node.get('labels', {}),
            ))
    for name, inst in sorted(gce_insts.items(), key=_numeric_key):
        internal, external = [], []
        for nic in inst.get('networkInterfaces', []):
            if nic.get('networkIP'):
                internal.append(nic['networkIP'])
            for access in nic.get('accessConfigs', []):
                if access.get('natIP'):
                    external.append(access['natIP'])
        instances.append(
            common.InstanceInfo(
                instance_id=name,
                status=_GCE_STATE_MAP.get(inst.get('status', ''),
                                          common.InstanceStatus.PENDING),
                internal_ips=internal,
                external_ips=external,
                tags=inst.get('labels', {}),
            ))
    return common.ClusterInfo('gcp', cluster_name, instances,
                              ssh_user='skytpu')
