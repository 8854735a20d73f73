"""Distributed init of the port (skypilot_tpu_torch/parallel/distributed.py)
against the JAX package's, and the tensor-parallel gradient pair of
parallel/sharding.py.

- `distributed_env_from_cluster` gives JAX's env block;
  `maybe_initialize_distributed` is a no-op for one process and joins
  env-driven processes (one per host, and hosts with local ranks spawned
  by `LocalRanks`) at the coordinator address on 127.0.0.1;
- the differentiable column entry / row exit / logits gather: a `tiny`
  Llama's gradients at tensor=2 equal one device's (a collective that
  all-reduced the gradient of the row exit again would double them).

Processes are spawned (gloo on the CPU, one intra-op thread each), every
wait bounded, under the rank-pool lock (`tests/torch_rank_lock.py`).
This module imports no JAX at its top: the spawned processes import it
by name.
"""
import dataclasses
import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_rank_lock

from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.parallel import distributed as tdist
from skypilot_tpu_torch.parallel import group as group_lib
from skypilot_tpu_torch.parallel.mesh import MeshPlan, build_mesh

torch.set_num_threads(1)

CFG = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
JOIN_TIMEOUT_S = 60.0
# f32: the tensor-parallel partial products and the all-reduced input
# gradients add in another order than one device's matmuls.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


# ----- in the spawned processes ----------------------------------------------
def _report(queue, node_rank):
    """One rank's view of the world it joined: every rank's (rank, world,
    node) gathered, and an all_reduce's sum."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (dist.get_rank(), dist.get_world_size(),
                                 node_rank))
    total = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(total)
    queue.put((dist.get_rank(), got, float(total)))


def host_process(env, queue, local_ranks):
    """A host's process as the gang executor starts it: its SKYTPU_* env,
    then maybe_initialize_distributed (and, with local ranks, the spawned
    rest of them)."""
    os.environ.update(env)
    os.nice(10)
    torch.set_num_threads(1)
    node = int(env[tdist.ENV_NODE_RANK])
    if local_ranks == 1:
        assert tdist.maybe_initialize_distributed(device='cpu',
                                                  timeout_s=JOIN_TIMEOUT_S)
        try:
            _report(queue, node)
        finally:
            group_lib.leave()
        return
    ranks = tdist.LocalRanks(local_ranks, _report, (queue, node),
                             device='cpu', timeout_s=JOIN_TIMEOUT_S)
    try:
        _report(queue, node)
    finally:
        ranks.close(JOIN_TIMEOUT_S)


def rank_tp_grads(full, tokens):
    """This rank's gradients of a `tiny` Llama's loss at tensor=2, and the
    gradient the row exit passes back for a partial."""
    from skypilot_tpu_torch.models.convert import shard_params
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train.trainer import lm_loss
    mesh = build_mesh(MeshPlan(tensor=2), devices=['cpu'] * 2,
                      backend='gloo')
    model = tl.Llama(CFG, shard_params(full, mesh), mesh).requires_grad_(True)
    toks = torch.from_numpy(tokens)
    loss = lm_loss(model(toks), toks)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    partial = torch.full((3,), 1.0 + mesh.rank, requires_grad=True)
    exit_sum = sharding.row_parallel_exit(partial, mesh.group('tensor'))
    (exit_sum * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    return {'rank': mesh.coordinate('tensor'), 'loss': float(loss),
            'grads': grads, 'exit_sum': exit_sum.tolist(),
            'exit_grad': partial.grad.tolist()}


# ----- helpers ---------------------------------------------------------------
def spawn_hosts(n_hosts, local_ranks):
    """n_hosts env-driven host processes, each with `local_ranks` ranks;
    the reports of every rank.  The hosts are not daemonic (a host spawns
    its local ranks); they are stopped within the wait's bound."""
    ctx = multiprocessing.get_context('spawn')
    with torch_rank_lock.hold('spawn_hosts'):
        queue = ctx.Queue()
        port = group_lib.free_port()
        ips = ['127.0.0.1'] * n_hosts
        procs = [ctx.Process(
            target=host_process,
            args=(tdist.distributed_env_from_cluster(ips, node, port), queue,
                  local_ranks)) for node in range(n_hosts)]
        for proc in procs:
            proc.start()
        try:
            reports = [queue.get(timeout=JOIN_TIMEOUT_S)
                       for _ in range(n_hosts * local_ranks)]
        finally:
            group_lib.stop_processes(procs, JOIN_TIMEOUT_S)
    assert all(proc.exitcode == 0 for proc in procs), [p.exitcode
                                                      for p in procs]
    return sorted(reports)


# ----- tests -----------------------------------------------------------------
@pytest.mark.parametrize('ips,rank,port', [
    (['10.0.0.1'], 0, None), (['10.0.0.1', '10.0.0.2'], 1, None),
    (['10.1.0.5', '10.1.0.6', '10.1.0.7'], 2, 9000)])
def test_distributed_env_matches_jax(ips, rank, port):
    from skypilot_tpu.parallel import distributed as jdist
    kw = {} if port is None else {'coordinator_port': port}
    assert (tdist.distributed_env_from_cluster(ips, rank, **kw) ==
            jdist.distributed_env_from_cluster(ips, rank, **kw))
    for name in ('ENV_NUM_NODES', 'ENV_NODE_RANK', 'ENV_NODE_IPS',
                 'ENV_COORDINATOR', 'ENV_NUM_SLICES', 'ENV_SLICE_ID',
                 'DEFAULT_COORDINATOR_PORT'):
        assert getattr(tdist, name) == getattr(jdist, name)


def test_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv(tdist.ENV_NUM_NODES, raising=False)
    assert tdist.maybe_initialize_distributed() is False
    monkeypatch.setenv(tdist.ENV_NUM_NODES, '1')
    assert tdist.maybe_initialize_distributed(device='cpu') is False
    assert not dist.is_initialized()


def test_missing_coordinator_is_refused(monkeypatch):
    monkeypatch.delenv(tdist.ENV_COORDINATOR, raising=False)
    with pytest.raises(ValueError, match='coordinator'):
        tdist.maybe_initialize_distributed(num_processes=2, device='cpu')
    assert not dist.is_initialized()


def test_entry_point_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tdist.maybe_initialize_distributed(
            coordinator_address='127.0.0.1:1', num_processes=2)
    assert not dist.is_initialized()


def test_mesh_devices_across_hosts(monkeypatch):
    """build_mesh's default devices: this host's cards, or, for a group of
    SKYTPU_NUM_NODES hosts of as many ranks as the host has cards, card
    r % cards for rank r (not a repeated card on one host)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cards = [torch.device('cuda', i) for i in range(2)]
    monkeypatch.setattr(mesh_lib, '_cuda_devices', lambda: list(cards))
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    monkeypatch.delenv(tdist.ENV_NUM_NODES, raising=False)
    assert mesh_lib._default_devices() == (cards, False)
    monkeypatch.setenv(tdist.ENV_NUM_NODES, '2')
    assert mesh_lib._default_devices() == (cards * 2, True)
    monkeypatch.setenv(tdist.ENV_NUM_NODES, '3')
    assert mesh_lib._default_devices() == (cards, False)


def test_two_env_driven_processes_join():
    """Two hosts of one process each, from the gang executor's env block:
    ranks 0 and 1 of a world of 2."""
    reports = spawn_hosts(2, 1)
    assert [r[0] for r in reports] == [0, 1]
    for _, world, total in reports:
        assert world == [(0, 2, 0), (1, 2, 1)]
        assert total == 3.0


def test_hosts_with_local_ranks():
    """Two hosts of two local ranks each: global rank = node * 2 + local
    rank, a world of 4."""
    reports = spawn_hosts(2, 2)
    assert [r[0] for r in reports] == [0, 1, 2, 3]
    for _, world, total in reports:
        assert world == [(0, 4, 0), (1, 4, 0), (2, 4, 1), (3, 4, 1)]
        assert total == 10.0


def test_tensor_parallel_gradients_equal_one_device():
    """tensor=2: the loss and every parameter's gradient (the slices put
    back together) equal one device's; the row exit passes the gradient
    through once (not summed again over the group)."""
    from skypilot_tpu_torch.train.trainer import lm_loss
    gen = torch.Generator().manual_seed(0)
    full = tl.init_params(CFG, 'cpu', gen)
    tokens = np.random.default_rng(3).integers(
        0, CFG.vocab_size, (4, 16)).astype(np.int64)
    one = tl.Llama(CFG, {k: v.clone() for k, v in full.items()})
    one.requires_grad_(True)
    toks = torch.from_numpy(tokens)
    want_loss = lm_loss(one(toks), toks)
    want_loss.backward()
    want_loss = want_loss.detach()
    want = {n: p.grad.numpy() for n, p in one.named_parameters()}
    with torch_rank_lock.hold('tensor-parallel gradients'), \
            group_lib.RankPool(2, 'gloo', timeout_s=JOIN_TIMEOUT_S,
                               threads=1) as pool:
        pool.run(os.nice, 10, timeout_s=JOIN_TIMEOUT_S)
        out = pool.run(rank_tp_grads, full, tokens, timeout_s=JOIN_TIMEOUT_S)
    from skypilot_tpu_torch.parallel import sharding
    for o in out:
        np.testing.assert_allclose(o['loss'], want_loss.item(), rtol=1e-6)
        assert o['exit_sum'] == [3.0] * 3
        assert o['exit_grad'] == [1.0, 2.0, 3.0]
    by_rank = sorted(out, key=lambda o: o['rank'])
    for name, g in want.items():
        spec = sharding.tensor_spec(name, g.shape, {'tensor': 2, 'fsdp': 1,
                                                    'data': 1, 'dcn': 1,
                                                    'expert': 1,
                                                    'pipeline': 1})
        dims = [d for d, a in enumerate(spec) if a == 'tensor']
        got = (np.concatenate([o['grads'][name] for o in by_rank], dims[0])
               if dims else by_rank[0]['grads'][name])
        if not dims:
            np.testing.assert_allclose(by_rank[1]['grads'][name], got,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(got, g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
