"""Slurm provisioner: one ALLOCATION per cluster (parity:
sky/clouds/slurm.py's allocation model, rebuilt on the framework's
provision API).

The allocation is held by a long-running sbatch job named
``skytpu-<cluster>``: `srun sleep infinity` keeps every node of the
allocation busy so Slurm cannot reclaim it between framework jobs (the
framework's OWN gang executor runs the real work over SSH — Slurm is
the node lease, not the job runner).  Mapping to the provision API:

  run_instances        sbatch -N num_nodes [-p region]
  wait_instances       squeue state PENDING (queued) -> RUNNING
  query_instances      squeue state -> one synthetic instance per node
  get_cluster_info     scontrol show job -> hostnames -> per-node hosts
  terminate_instances  scancel by job name
  stop_instances       NotSupportedError (no such lifecycle in Slurm)

All through the standard CLIs (sbatch/squeue/scancel/scontrol), so the
hermetic tests drive the REAL command construction against fake CLI
shims on PATH (tests/fake_slurm.py) — the same boundary style as the
fake HTTP control planes.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, List, Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.provision import common

logger = sky_logging.init_logger(__name__)

_JOB_PREFIX = 'skytpu-'

# Slurm job states -> framework InstanceStatus (applied to every node of
# the allocation: the allocation is atomic, nodes share its state).
_STATE_MAP = {
    'PENDING': common.InstanceStatus.PENDING,
    'CONFIGURING': common.InstanceStatus.PENDING,
    'RUNNING': common.InstanceStatus.RUNNING,
    'COMPLETING': common.InstanceStatus.TERMINATED,
    'COMPLETED': common.InstanceStatus.TERMINATED,
    'CANCELLED': common.InstanceStatus.TERMINATED,
    'FAILED': common.InstanceStatus.TERMINATED,
    'TIMEOUT': common.InstanceStatus.TERMINATED,
    'PREEMPTED': common.InstanceStatus.PREEMPTED,
    'NODE_FAIL': common.InstanceStatus.PREEMPTED,
}


def _run(argv: List[str]) -> str:
    # A wedged slurmctld must fail the provision attempt (and feed the
    # failover engine, which only catches ProvisionError subclasses),
    # not hang the controller tick forever.
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              check=False,
                              timeout=float(os.environ.get(
                                  'SKYTPU_SLURM_CMD_TIMEOUT_S', '120')))
    except subprocess.TimeoutExpired as e:
        raise exceptions.ProvisionError(
            f'slurm command timed out: {" ".join(argv)}') from e
    if proc.returncode != 0:
        msg = (proc.stderr or proc.stdout).strip()
        low = msg.lower()
        if 'queue' in low and 'limit' in low or 'qosmax' in low.replace(
                ' ', ''):
            raise exceptions.QuotaExceededError(msg)
        raise exceptions.ProvisionError(
            f'{argv[0]} failed (rc={proc.returncode}): {msg}')
    return proc.stdout


def _job_name(cluster_name: str) -> str:
    return f'{_JOB_PREFIX}{cluster_name}'


_DEAD_STATES = frozenset(
    s for s, mapped in _STATE_MAP.items()
    if mapped in (common.InstanceStatus.TERMINATED,
                  common.InstanceStatus.PREEMPTED))
_TERMINAL_STATES = frozenset(
    s for s, mapped in _STATE_MAP.items()
    if mapped is common.InstanceStatus.TERMINATED)


def _find_job(cluster_name: str,
              live_only: bool = False) -> Optional[Dict[str, str]]:
    """{'id':…, 'state':…} of the newest matching allocation job.

    Scoped to THE CURRENT USER (shared login nodes: another user's
    identically-named job must never be mistaken for ours).  Terminal
    states are always filtered client-side (real squeue keeps finished
    jobs visible for MinJobAge, ~5 min).  live_only additionally drops
    PREEMPTED/NODE_FAIL jobs — a provisioning call must submit a FRESH
    sbatch for those, while status reconciliation (live_only=False)
    must still SEE them to report the preemption."""
    import getpass
    out = _run(['squeue', '--name', _job_name(cluster_name),
                '--user', getpass.getuser(), '--noheader',
                '-o', '%i|%T'])
    drop = _DEAD_STATES if live_only else _TERMINAL_STATES
    jobs = []
    for line in out.splitlines():
        line = line.strip()
        if not line:
            continue
        job_id, state = line.split('|', 1)
        if state.strip() in drop:
            continue
        jobs.append({'id': job_id.strip(), 'state': state.strip()})
    return jobs[-1] if jobs else None


def run_instances(config: common.ProvisionConfig) -> common.ProvisionRecord:
    existing = _find_job(config.cluster_name, live_only=True)
    if existing is not None:
        # Reuse only a size-compatible allocation: Slurm cannot grow a
        # running job, so silently "resuming" a smaller allocation would
        # under-provision the gang.
        have = _requested_nodes(existing['id'])
        if have is not None and have != config.num_nodes:
            raise exceptions.ProvisionError(
                f'live slurm allocation for {config.cluster_name!r} has '
                f'{have} nodes but {config.num_nodes} were requested; '
                f'`down` the cluster first (allocations cannot resize)')
    if existing is None:
        argv = ['sbatch', '--parsable',
                '--job-name', _job_name(config.cluster_name),
                '-N', str(config.num_nodes),
                '--wrap', 'srun sleep infinity']
        if config.region and config.region != 'default':
            argv += ['-p', config.region]
        job_id = _run(argv).strip().split(';')[0]
        logger.info(f'slurm allocation {job_id} requested for '
                    f'{config.cluster_name!r} ({config.num_nodes} nodes)')
        resumed = False
    else:
        job_id = existing['id']
        resumed = True
    return common.ProvisionRecord(
        provider_name='slurm', cluster_name=config.cluster_name,
        region=config.region, zone=None,
        instance_ids=[f'{config.cluster_name}-{i}'
                      for i in range(config.num_nodes)],
        resumed=resumed)


def _poll_s(default: float = 5.0) -> float:
    return float(os.environ.get('SKYTPU_PROVISION_POLL_S', default))


def wait_instances(cluster_name: str, region=None, zone=None,
                   timeout_s: float = 1800.0) -> None:
    del region, zone
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        job = _find_job(cluster_name, live_only=True)
        if job is None:
            raise exceptions.ProvisionError(
                f'slurm allocation for {cluster_name!r} disappeared '
                f'while waiting (cancelled or preempted)')
        status = _STATE_MAP.get(job['state'],
                                common.InstanceStatus.PENDING)
        if status is common.InstanceStatus.RUNNING:
            return
        if status in (common.InstanceStatus.TERMINATED,
                      common.InstanceStatus.PREEMPTED):
            raise exceptions.ProvisionError(
                f'slurm allocation for {cluster_name!r} ended while '
                f'waiting: {job["state"]}')
        time.sleep(_poll_s())
    raise exceptions.ProvisionError(
        f'timed out waiting for slurm allocation of {cluster_name!r}')


def _job_details(job_id: str) -> 'tuple[List[str], Optional[int]]':
    """(hostnames, requested_node_count) from ONE scontrol invocation.

    Hostnames are [] while PENDING (real Slurm reports NodeList=(null)
    until placement); NumNodes is present either way."""
    out = _run(['scontrol', 'show', 'job', job_id])
    nodelist = None
    num_nodes: Optional[int] = None
    for token in out.replace('\n', ' ').split():
        if token.startswith('NodeList=') and not token.startswith(
                'NodeList=(null)'):
            nodelist = token.split('=', 1)[1]
        elif token.startswith('NumNodes='):
            # Real scontrol can print a range ('2-2'); take the floor.
            value = token.split('=', 1)[1].split('-')[0]
            try:
                num_nodes = int(value)
            except ValueError:
                pass
    hosts: List[str] = []
    if nodelist:
        raw = _run(['scontrol', 'show', 'hostnames', nodelist])
        hosts = [h.strip() for h in raw.splitlines() if h.strip()]
    return hosts, num_nodes


def _nodes(job_id: str) -> List[str]:
    return _job_details(job_id)[0]


def _requested_nodes(job_id: str) -> Optional[int]:
    return _job_details(job_id)[1]


def query_instances(cluster_name: str, region=None,
                    zone=None) -> Dict[str, common.InstanceStatus]:
    del region, zone
    job = _find_job(cluster_name)
    if job is None:
        return {}
    status = _STATE_MAP.get(job['state'], common.InstanceStatus.PENDING)
    if status is common.InstanceStatus.TERMINATED:
        return {}
    # A PENDING allocation has no NodeList yet; size from NumNodes so a
    # queued 2-node cluster reports BOTH nodes pending, not one.
    hosts, requested = _job_details(job['id'])
    n = len(hosts) or requested or 1
    return {f'{cluster_name}-{i}': status for i in range(n)}


def stop_instances(cluster_name: str, region=None, zone=None) -> None:
    raise exceptions.NotSupportedError(
        'Slurm allocations cannot be stopped; `down` (scancel) releases '
        'them')


def terminate_instances(cluster_name: str, region=None,
                        zone=None) -> None:
    del region, zone
    job = _find_job(cluster_name)
    if job is not None:
        _run(['scancel', job['id']])


def get_cluster_info(cluster_name: str, region=None,
                     zone=None) -> common.ClusterInfo:
    del region, zone
    job = _find_job(cluster_name)
    instances = []
    if job is not None:
        status = _STATE_MAP.get(job['state'],
                                common.InstanceStatus.PENDING)
        for i, host in enumerate(_nodes(job['id'])):
            instances.append(common.InstanceInfo(
                instance_id=f'{cluster_name}-{i}',
                internal_ips=[host], external_ips=[host],
                status=status, tags={'slurm_job_id': job['id']}))
    import getpass
    # BYO identity: HPC sites share $HOME; the user's own SSH key works
    # and the framework key is never injected (ssh-pool semantics).
    return common.ClusterInfo(provider_name='slurm',
                              cluster_name=cluster_name,
                              instances=instances,
                              ssh_user=getpass.getuser(),
                              ssh_key_path=None)
