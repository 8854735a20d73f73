"""Multi-host wiring for the PyTorch port: one `torch.distributed` group
from the gang executor's env vars.

Twin of `skypilot_tpu/parallel/distributed.py`.  The gang executor
(agent/gang.py) starts one process per host and injects
  SKYTPU_NUM_NODES, SKYTPU_NODE_RANK, SKYTPU_NODE_IPS,
  SKYTPU_COORDINATOR_ADDR (head host ip:port);
the `ENV_*` names and `distributed_env_from_cluster` are the JAX
module's, verbatim (a test pins them).  Its `megascale_env_from_cluster`
is not ported: the MEGASCALE_* / TPU_WORKER_* block is libtpu's DCN
contract, and nothing of PyTorch reads it.

JAX runs one process per host, which drives every local chip; PyTorch
runs one process per card.  So a host's process is its local rank 0 and
spawns ranks 1..L-1 itself (`LocalRanks`, the spawn machinery of
`parallel/group.py`); global rank = node_rank * L + local_rank, world
size = num_nodes * L, every rank joining at
tcp://<SKYTPU_COORDINATOR_ADDR>.  Backend: NCCL when the ranks run on
CUDA devices (local rank i on cuda:i), gloo on the CPU.

User code calls `maybe_initialize_distributed()` once; a single process
(one host, one local rank) is a no-op, so the same script runs on one
card and on a cluster.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.parallel import group as group_lib

ENV_NUM_NODES = 'SKYTPU_NUM_NODES'
ENV_NODE_RANK = 'SKYTPU_NODE_RANK'
ENV_NODE_IPS = 'SKYTPU_NODE_IPS'
ENV_COORDINATOR = 'SKYTPU_COORDINATOR_ADDR'
ENV_NUM_SLICES = 'SKYTPU_NUM_SLICES'
ENV_SLICE_ID = 'SKYTPU_SLICE_ID'
DEFAULT_COORDINATOR_PORT = 8476
DEFAULT_TIMEOUT_S = 600.0


def distributed_env_from_cluster(node_ips: List[str],
                                 node_rank: int,
                                 coordinator_port: int =
                                 DEFAULT_COORDINATOR_PORT) -> Dict[str, str]:
    """Env block the gang executor injects into every slice-host process."""
    return {
        ENV_NUM_NODES: str(len(node_ips)),
        ENV_NODE_RANK: str(node_rank),
        ENV_NODE_IPS: '\n'.join(node_ips),
        ENV_COORDINATOR: f'{node_ips[0]}:{coordinator_port}',
    }


def maybe_initialize_distributed(
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        local_rank: int = 0,
        local_ranks: int = 1,
        device: DeviceLike = None,
        timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to the group of `num_processes` hosts (default
    SKYTPU_NUM_NODES) x `local_ranks` processes per host as local rank
    `local_rank` of host `process_id` (default SKYTPU_NODE_RANK), at
    tcp://`coordinator_address` (default SKYTPU_COORDINATOR_ADDR); a
    no-op for a world of one.  `device`: the ranks' device kind (default
    the GPU, local rank i on cuda:i over NCCL; 'cpu' for gloo).  Returns
    True iff this process joined a group."""
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get(ENV_NUM_NODES, '1'))
    world = num_processes * local_ranks
    if world <= 1:
        return False
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if not coordinator_address:
        raise ValueError(f'{world} ranks need a coordinator address: pass '
                         f'one or set {ENV_COORDINATOR}')
    process_id = process_id if process_id is not None else int(
        os.environ.get(ENV_NODE_RANK, '0'))
    if not 0 <= local_rank < local_ranks:
        raise ValueError(f'local_rank {local_rank} not in [0, '
                         f'{local_ranks})')
    kind = resolve_device(device).type
    if kind == 'cuda':
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        'nccl' if kind == 'cuda' else 'gloo',
        init_method=f'tcp://{coordinator_address}', world_size=world,
        rank=process_id * local_ranks + local_rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _local_entry(local_rank, local_ranks, device, timeout_s, target, args):
    maybe_initialize_distributed(local_rank=local_rank,
                                 local_ranks=local_ranks, device=device,
                                 timeout_s=timeout_s)
    try:
        target(*args)
    finally:
        group_lib.leave()


class LocalRanks:
    """This host's local ranks 1..`local_ranks`-1, spawned (start method
    'spawn', the env inherited) running `target(*args)` once each has
    joined the group; construction then joins this process as local rank
    0 and returns once every rank of the world has joined.  `close()`
    waits for the spawned ranks to return and leaves the group."""

    def __init__(self, local_ranks: int, target: Callable,
                 args: Sequence[Any] = (), device: DeviceLike = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        device = resolve_device(device).type
        ctx = multiprocessing.get_context('spawn')
        self.procs = [ctx.Process(
            target=_local_entry, daemon=True,
            args=(i, local_ranks, device, timeout_s, target, tuple(args)),
            name=f'local-rank-{i}') for i in range(1, local_ranks)]
        for proc in self.procs:
            proc.start()
        try:
            maybe_initialize_distributed(local_ranks=local_ranks,
                                         device=device, timeout_s=timeout_s)
        except BaseException:
            self.close(0.0)
            raise

    def close(self, timeout_s: float = 30.0) -> None:
        group_lib.stop_processes(self.procs, timeout_s)
        group_lib.leave()
