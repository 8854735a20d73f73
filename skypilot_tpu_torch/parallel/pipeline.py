"""GPipe-style pipeline parallelism over the mesh's `pipeline` axis
(PyTorch).

Twin of `skypilot_tpu/parallel/pipeline.py`, in the reference's SPMD
form: every rank of a pipeline group runs the same program.

- Stage weights are STACKED with a leading [n_stages] dim
  (`stack_stage_params`); a rank holds its stage's slice ([1, ...] of
  each leaf, `stage_param_sharding`, the counterpart of
  `PartitionSpec('pipeline', None, ...)`).
- `pipeline_apply` runs the classic loop of n_microbatches + n_stages - 1
  steps on every rank: at step t each rank passes the activation it
  holds one rank on around the group (the hop), stage 0 feeds
  microbatch t, every stage applies its layer, and the last stage keeps
  output t - (n_stages - 1).  The bubble is (n_stages - 1) / (n_micro +
  n_stages - 1), as there.
- The hop is one `torch.autograd.Function`: forward it sends to rank
  (i + 1) % n and receives from (i - 1) % n; backward it sends the
  gradient the other way round, `ppermute`'s transpose.  Every rank
  records the same hops in the same order, each one's output feeding
  its stage (stage 0 selects its feed with `torch.where`, so the hop's
  gradient, zero there, still flows), and each hop's backward waits for
  the next one's: autograd replays the collectives in reverse order on
  every rank, and the backward cannot deadlock.
- Transport: `batch_isend_irecv` on the mesh's 'pipeline' group (the
  ring of `parallel/ring_attention.py`); a gloo group over CUDA tensors
  stages each hop through pinned host buffers, decided from the group's
  backend.
- x enters through `sharding.column_parallel_entry` (identity forward,
  its gradient summed over the group backward): only stage 0 reads x, so
  the sum hands every rank x's whole gradient, as JAX's transpose of a
  P() input does.
- The outputs reach every rank as in the reference: every stage but the
  last contributes zeros to a sum over the group.  That sum's backward
  is the identity (`sharding.row_parallel_exit`): when every rank takes
  the loss of the replicated output, the last stage gets ONE copy of its
  gradient (an all-reduce backward would give it n_stages).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch.utils import _pytree as pytree

from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.ring_attention import _Ring


def stack_stage_params(per_stage_params: List[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim (a rank keeps its slice with `stage_param_sharding`)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def stage_param_sharding(mesh, tree: Any) -> Any:
    """This rank's stage of every leaf of a stacked tree: the [1, ...]
    slice at its 'pipeline' coordinate (a view; the leaves' leading dim
    under PartitionSpec('pipeline', None, ...))."""
    def local(x):
        spec = sharding.P('pipeline', *([None] * (x.dim() - 1)))
        return sharding.local_slice(x, spec, mesh)
    return pytree.tree_map(local, tree)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    ring = _Ring(group, x.device, shift)
    return ring.finish(ring.start([x.contiguous()]))[0]


class _Hop(torch.autograd.Function):
    """One step of the pipeline ring: to the next stage forward, the
    gradient to the previous one backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _stage_slice(p: torch.Tensor, n_stages: int, stage: int) -> torch.Tensor:
    if p.shape[0] == n_stages:
        return p[stage]
    if p.shape[0] == 1:
        return p[0]
    raise ValueError(f'a stacked leaf leads with {p.shape[0]}: expected '
                     f'{n_stages} stages or this rank\'s slice of 1')


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any,
                   x: torch.Tensor,
                   *,
                   mesh,
                   n_microbatches: int) -> torch.Tensor:
    """Run `n_stages` chained applications of stage_fn over x, pipelined
    over the 'pipeline' axis of `mesh` (a `parallel.mesh.RankMesh`; call
    it on every rank of the group with the same x).

    stage_fn(params_i, activation) -> activation (shape-preserving
    between stages); stacked_params leaves lead with n_stages (=
    mesh.shape['pipeline']) or with this rank's slice of 1
    (`stage_param_sharding`); x [B, ...] with B % n_microbatches == 0.
    Equal (numerically) to folding stage_fn over the stages in order, on
    every rank; differentiable in the params and in x (every rank gets
    x's whole gradient)."""
    n_stages = mesh.shape['pipeline']
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f'batch {b} not divisible by '
                         f'{n_microbatches} microbatches')
    stage = mesh.coordinate('pipeline')
    last = n_stages - 1
    params_i = pytree.tree_map(
        lambda p: _stage_slice(p, n_stages, stage), stacked_params)
    group = mesh.group('pipeline')
    x = sharding.column_parallel_entry(x, group)
    micro = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    first = torch.tensor(stage == 0, device=x.device)
    state = torch.zeros_like(micro[0])
    outs = []
    for t in range(n_microbatches + last):
        recv = _Hop.apply(state, group) if n_stages > 1 else state
        feed = micro[min(t, n_microbatches - 1)]
        state = stage_fn(params_i, torch.where(first, feed, recv))
        if t >= last:
            outs.append(state)
    outputs = torch.stack(outs)
    # Only the last stage holds real outputs; the sum over the group
    # broadcasts them (every other stage contributes zeros, and keeps its
    # outputs in the graph so its hops' backward runs).
    outputs = torch.where(torch.tensor(stage == last, device=x.device),
                          outputs, torch.zeros_like(outputs))
    outputs = sharding.row_parallel_exit(outputs, group)
    return outputs.reshape((b,) + outputs.shape[2:])
