"""Volumes: named persistent storage managed by the framework (parity:
sky/volumes/ — Volume spec, apply/ls/delete server core; k8s PVCs as
the primary type).

TPU-first reading: checkpoints and datasets belong on GCS buckets
(data/storage.py), but two shapes need real block/filesystem volumes —
Kubernetes PVCs for pod workloads and GCP persistent disks attached to
CPU VMs (controllers, data-prep).  A volume is created once
(`skytpu volumes apply`), referenced from task YAML as
`volumes: {/mnt/data: my-vol}`, and survives cluster teardown.

Types:
- ``k8s-pvc``  — PersistentVolumeClaim in the context/namespace of
  `infra: kubernetes/<ctx>`; pods mount it via the provisioner.
- ``gcp-disk`` — zonal persistent disk (`infra: gcp/<region>/<zone>`),
  attached at instance insert for CPU VMs.

Rows are stamped with user/workspace like clusters and jobs.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.utils import db_utils
from skypilot_tpu_torch.utils import infra_utils

logger = sky_logging.init_logger(__name__)

VOLUME_TYPES = ('k8s-pvc', 'gcp-disk')


def _db_path() -> str:
    # Control-plane store: rides the shared Postgres backend when
    # SKYTPU_DB_URL is set (volume records must be visible to every
    # API-server replica), per-host sqlite otherwise.
    return db_utils.control_plane_dsn('SKYTPU_VOLUMES_DB',
                                      '~/.skytpu/volumes.db')


_DDL = [
    """CREATE TABLE IF NOT EXISTS volumes (
        name TEXT PRIMARY KEY,
        vtype TEXT,
        infra TEXT,
        size_gb INTEGER,
        status TEXT,
        created_at REAL,
        config TEXT,
        user_name TEXT,
        workspace TEXT
    )""",
]


def _ensure() -> str:
    path = _db_path()
    db_utils.ensure_schema(path, _DDL)
    return path


@dataclasses.dataclass
class Volume:
    name: str
    vtype: str
    infra: str
    size_gb: int
    status: str = 'READY'
    created_at: float = 0.0
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    user_name: Optional[str] = None
    workspace: Optional[str] = None

    def validate(self) -> None:
        if self.vtype not in VOLUME_TYPES:
            raise exceptions.InvalidRequestError(
                f'volume type must be one of {VOLUME_TYPES}, '
                f'got {self.vtype!r}')
        parsed = infra_utils.InfraInfo.from_str(self.infra)
        if self.vtype == 'k8s-pvc' and parsed.cloud != 'kubernetes':
            raise exceptions.InvalidRequestError(
                f'k8s-pvc volumes need infra kubernetes/<context>, '
                f'got {self.infra!r}')
        if self.vtype == 'gcp-disk' and (parsed.cloud != 'gcp'
                                         or not parsed.zone):
            raise exceptions.InvalidRequestError(
                f'gcp-disk volumes need infra gcp/<region>/<zone>, '
                f'got {self.infra!r}')
        if self.size_gb <= 0:
            raise exceptions.InvalidRequestError(
                f'volume size must be positive, got {self.size_gb}')


# ----- backing-store ops -----------------------------------------------------
def _k8s_create(volume: Volume) -> None:
    from skypilot_tpu_torch.provision.kubernetes import instance as k8s
    context = infra_utils.InfraInfo.from_str(volume.infra).region
    client = k8s._Client(context)  # pylint: disable=protected-access
    body = {
        'apiVersion': 'v1',
        'kind': 'PersistentVolumeClaim',
        'metadata': {'name': volume.name,
                     'labels': {'skytpu-volume': volume.name}},
        'spec': {
            'accessModes': [volume.config.get('access_mode',
                                              'ReadWriteOnce')],
            'resources': {'requests': {
                'storage': f'{volume.size_gb}Gi'}},
            **({'storageClassName': volume.config['storage_class']}
               if volume.config.get('storage_class') else {}),
        },
    }
    resp = client.request('POST', '/persistentvolumeclaims',
                          data=json.dumps(body))
    if resp.status_code == 409:
        raise exceptions.InvalidRequestError(
            f'PVC {volume.name!r} already exists in context '
            f'{context!r}')
    if resp.status_code >= 400:
        raise exceptions.StorageError(
            f'PVC create failed ({resp.status_code}): {resp.text}')


def _k8s_delete(volume: Volume) -> None:
    from skypilot_tpu_torch.provision.kubernetes import instance as k8s
    context = infra_utils.InfraInfo.from_str(volume.infra).region
    client = k8s._Client(context)  # pylint: disable=protected-access
    resp = client.request('DELETE',
                          f'/persistentvolumeclaims/{volume.name}')
    if resp.status_code >= 400 and resp.status_code != 404:
        raise exceptions.StorageError(
            f'PVC delete failed ({resp.status_code}): {resp.text}')


def _gcp_client(volume: Volume):
    del volume
    from skypilot_tpu_torch.provision.gcp import gce_client
    from skypilot_tpu_torch.provision.gcp import tpu_client
    return gce_client.GceClient(tpu_client.default_project())


def _gcp_create(volume: Volume) -> None:
    zone = infra_utils.InfraInfo.from_str(volume.infra).zone
    _gcp_client(volume).create_disk(zone, volume.name, volume.size_gb)


def _gcp_delete(volume: Volume) -> None:
    zone = infra_utils.InfraInfo.from_str(volume.infra).zone
    _gcp_client(volume).delete_disk(zone, volume.name)


# ----- public API ------------------------------------------------------------
def apply(name: str, vtype: str, infra: str, size_gb: int,
          config: Optional[Dict[str, Any]] = None) -> Volume:
    """Create the backing store and record the volume (idempotent on
    name: re-applying an identical spec is a no-op)."""
    from skypilot_tpu_torch import users
    from skypilot_tpu_torch import workspaces
    volume = Volume(name=name, vtype=vtype, infra=infra,
                    size_gb=int(size_gb), created_at=time.time(),
                    config=dict(config or {}),
                    user_name=users.current_user().name,
                    workspace=workspaces.active_workspace())
    volume.validate()
    existing = get(name)
    if existing is not None:
        if (existing.vtype, existing.infra, existing.size_gb) == \
                (volume.vtype, volume.infra, volume.size_gb):
            return existing
        raise exceptions.InvalidRequestError(
            f'volume {name!r} already exists with a different spec '
            f'({existing.vtype}, {existing.infra}, {existing.size_gb}Gi)')
    if vtype == 'k8s-pvc':
        _k8s_create(volume)
    else:
        _gcp_create(volume)
    db_utils.execute(
        _ensure(),
        'INSERT INTO volumes (name, vtype, infra, size_gb, status, '
        'created_at, config, user_name, workspace) '
        'VALUES (?,?,?,?,?,?,?,?,?)',
        (volume.name, volume.vtype, volume.infra, volume.size_gb,
         volume.status, volume.created_at, json.dumps(volume.config),
         volume.user_name, volume.workspace))
    logger.info(f'volume {name!r} ({vtype}, {size_gb}Gi) created on '
                f'{infra}')
    return volume


def get(name: str) -> Optional[Volume]:
    row = db_utils.query_one(_ensure(),
                             'SELECT * FROM volumes WHERE name=?', (name,))
    return _row(row) if row else None


def list_volumes(all_users: bool = False) -> List[Volume]:
    """Volumes in the active workspace; the caller's own by default."""
    from skypilot_tpu_torch import users
    from skypilot_tpu_torch import workspaces
    rows = [_row(r) for r in db_utils.query(
        _ensure(), 'SELECT * FROM volumes ORDER BY created_at')]
    rows = [v for v in rows
            if (v.workspace or 'default') == workspaces.active_workspace()]
    if not all_users:
        me = users.current_user().name
        rows = [v for v in rows if v.user_name in (None, me)]
    return rows


def delete(name: str) -> None:
    volume = get(name)
    if volume is None:
        raise exceptions.StorageError(f'volume {name!r} does not exist')
    from skypilot_tpu_torch import users
    from skypilot_tpu_torch import workspaces
    if (volume.workspace or 'default') != workspaces.active_workspace():
        raise exceptions.StorageError(f'volume {name!r} does not exist')
    if volume.user_name is not None:
        users.check_cluster_op({'name': f'volume {name}',
                                'user_name': volume.user_name}, 'delete')
    if volume.vtype == 'k8s-pvc':
        _k8s_delete(volume)
    else:
        _gcp_delete(volume)
    db_utils.execute(_ensure(), 'DELETE FROM volumes WHERE name=?',
                     (name,))
    logger.info(f'volume {name!r} deleted')


def validate_task_volumes(task, placement) -> Dict[str, str]:
    """Check every `volumes:` entry of a task against the registry and
    the chosen placement; returns {mount_path: volume_name}.

    A volume binds to its infra: a k8s-pvc made in context A cannot
    mount on GCP or in context B."""
    wanted = dict(getattr(task, 'volumes', None) or {})
    if not wanted:
        return {}
    for mount_path, vol_name in wanted.items():
        volume = get(vol_name)
        if volume is None:
            raise exceptions.InvalidTaskError(
                f'task volume {mount_path}: volume {vol_name!r} does '
                f'not exist; create it with `skytpu volumes apply`')
        vol_infra = infra_utils.InfraInfo.from_str(volume.infra)
        if vol_infra.cloud != placement.cloud or (
                vol_infra.region and placement.region and
                vol_infra.region != placement.region) or (
                vol_infra.zone and placement.zone and
                vol_infra.zone != placement.zone):
            # Zone matters: a zonal GCP disk only attaches in its own
            # zone — a same-region-different-zone placement would 404
            # at instance insert.
            raise exceptions.InvalidTaskError(
                f'task volume {vol_name!r} lives on {volume.infra} but '
                f'the task is placed on {placement.cloud}/'
                f'{placement.region}/{placement.zone}; volumes bind to '
                f'their infra')
    return wanted


def _row(row) -> Volume:
    return Volume(
        name=row['name'], vtype=row['vtype'], infra=row['infra'],
        size_gb=row['size_gb'], status=row['status'],
        created_at=row['created_at'],
        config=json.loads(row['config'] or '{}'),
        user_name=row['user_name'], workspace=row['workspace'])
