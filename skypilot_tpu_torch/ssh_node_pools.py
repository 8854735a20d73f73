"""SSH node pools: bring-your-own machines as a substrate (parity:
sky/ssh_node_pools/ — core.py pool CRUD over ~/.sky/ssh_node_pools.yaml;
the reference deploys k3s on the hosts, here they are first-class nodes
behind the same provision API as clouds, bootstrapped over SSH exactly
like GCP VMs).

Pool file (`~/.skytpu/ssh_node_pools.yaml`, env
SKYTPU_SSH_NODE_POOLS_FILE):

    my-pool:
      user: ubuntu
      identity_file: ~/.ssh/id_rsa
      hosts:
        - 10.0.0.1
        - 10.0.0.2

A pool is the `region` of the `ssh` cloud (`infra: ssh/my-pool`).
Provisioning allocates free hosts from the pool (a full pool is this
substrate's stockout → failover); terminate releases them.  Allocations
persist in sqlite so they survive restarts and are visible across
processes.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.utils import common_utils
from skypilot_tpu_torch.utils import db_utils


def pools_file() -> str:
    return os.path.expanduser(
        os.environ.get('SKYTPU_SSH_NODE_POOLS_FILE',
                       '~/.skytpu/ssh_node_pools.yaml'))


def _alloc_db() -> str:
    # Control-plane store: host allocations must be consistent across
    # API-server replicas, so this rides SKYTPU_DB_URL too.
    path = db_utils.control_plane_dsn('SKYTPU_SSH_ALLOC_DB',
                                      '~/.skytpu/ssh_alloc.db')
    db_utils.ensure_schema(path, [
        """CREATE TABLE IF NOT EXISTS allocations (
            pool TEXT,
            host TEXT,
            cluster TEXT,
            node_index INTEGER,
            PRIMARY KEY (pool, host)
        )""",
    ])
    return path


def load_pools() -> Dict[str, Dict[str, Any]]:
    path = pools_file()
    if not os.path.exists(path):
        return {}
    data = common_utils.read_yaml(path) or {}
    out = {}
    for name, cfg in data.items():
        cfg = dict(cfg or {})
        hosts = cfg.get('hosts') or []
        if not isinstance(hosts, list) or not hosts:
            raise exceptions.InvalidSkyConfigError(
                f'ssh node pool {name!r}: `hosts` must be a non-empty '
                f'list')
        out[str(name)] = {
            'hosts': [str(h) for h in hosts],
            'user': str(cfg.get('user', 'root')),
            'identity_file': cfg.get('identity_file'),
            'port': int(cfg.get('port', 22)),
        }
    return out


def get_pool(name: str) -> Dict[str, Any]:
    pools = load_pools()
    if name not in pools:
        raise exceptions.InvalidInfraError(
            f'unknown ssh node pool {name!r}; defined pools: '
            f'{sorted(pools) or "none"} (file: {pools_file()})')
    return pools[name]


# ----- allocation ------------------------------------------------------------
def allocate(pool: str, cluster: str, num_nodes: int) -> List[str]:
    """Reserve `num_nodes` hosts for `cluster` (idempotent: an existing
    allocation for the cluster is returned as-is).  Raises
    InsufficientCapacityError when the pool is exhausted — the failover
    engine treats it like a cloud stockout."""
    cfg = get_pool(pool)
    path = _alloc_db()
    with db_utils.transaction(path) as conn:
        rows = conn.execute(
            'SELECT host, node_index FROM allocations WHERE pool=? AND '
            'cluster=? ORDER BY node_index', (pool, cluster)).fetchall()
        if rows:
            if len(rows) != num_nodes:
                raise exceptions.ProvisionError(
                    f'cluster {cluster!r} already holds {len(rows)} '
                    f'hosts from pool {pool!r}, but {num_nodes} were '
                    f'requested')
            return [r['host'] for r in rows]
        taken = {r['host'] for r in conn.execute(
            'SELECT host FROM allocations WHERE pool=?', (pool,))}
        free = [h for h in cfg['hosts'] if h not in taken]
        if len(free) < num_nodes:
            raise exceptions.InsufficientCapacityError(
                f'ssh node pool {pool!r} has {len(free)} free of '
                f'{len(cfg["hosts"])} hosts; {num_nodes} requested')
        chosen = free[:num_nodes]
        for i, host in enumerate(chosen):
            conn.execute(
                'INSERT INTO allocations (pool, host, cluster, '
                'node_index) VALUES (?,?,?,?)', (pool, host, cluster, i))
        return chosen


def allocation(pool: str, cluster: str) -> List[str]:
    rows = db_utils.query(
        _alloc_db(), 'SELECT host FROM allocations WHERE pool=? AND '
        'cluster=? ORDER BY node_index', (pool, cluster))
    return [r['host'] for r in rows]


def release(pool: str, cluster: str) -> None:
    db_utils.execute(_alloc_db(),
                     'DELETE FROM allocations WHERE pool=? AND cluster=?',
                     (pool, cluster))


def pool_usage(pool: Optional[str] = None) -> List[Dict[str, Any]]:
    """Per-pool capacity view for `skytpu check` / CLI."""
    out = []
    for name, cfg in sorted(load_pools().items()):
        if pool is not None and name != pool:
            continue
        taken = db_utils.query(
            _alloc_db(), 'SELECT host, cluster FROM allocations WHERE '
            'pool=?', (name,))
        out.append({
            'pool': name,
            'hosts': len(cfg['hosts']),
            'in_use': len(taken),
            'clusters': sorted({r['cluster'] for r in taken}),
        })
    return out
