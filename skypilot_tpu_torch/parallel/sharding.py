"""Logical-axis sharding rules, the port's parameter layout, and the two
collectives of a tensor-parallel forward.

`DEFAULT_RULES`, `rules_to_dict` and `logical_to_spec` are the JAX
package's (`skypilot_tpu/parallel/sharding.py`), verbatim; a spec is a
`PartitionSpec`, here a tuple with one entry per tensor dim: None
(replicated), a mesh axis name, or a tuple of them.

`PARAM_AXES` is this package's counterpart of the Flax model's
`nn.with_logical_partitioning` annotations: each Llama parameter name
(the names `models/llama.py` loads) -> the logical axis of each dim of
its torch tensor (weights are [out, in], the transpose of a Flax
kernel).  `param_spec` maps it through the rules and keeps the rule of
`skypilot_tpu/inference/weights.py::serving_shardings`: a dim the mesh
does not divide stays replicated.

Collectives of the serving forward (the group is the mesh's tensor
group; no gradient, in place), one rule for every backend:
- `row_parallel_linear`: a row-parallel product, each rank's partial in
  the compute dtype, added over the group by one all_reduce;
- `gather_dim`: a dim sharded over the group, gathered whole on every
  rank in rank order (one all_gather_into_tensor).

The training forward's counterparts are differentiable, each collective
in one direction only (Megatron's f and g):
- `column_parallel_entry`: identity forward, the gradient all-reduced
  backward (the input of q/k/v, gate/up and a vocab-sharded lm_head,
  whose per-rank partial gradients add up to the whole);
- `row_parallel_exit`: all-reduce forward, identity backward (o/down and
  the vocab-sharded embedding's masked lookup);
- `gather_dim_exit`: `gather_dim` forward, this rank's slice of the
  gradient backward (the vocab-sharded logits).
(`torch.distributed.nn.functional.all_reduce` is not the exit: its
backward all-reduces the gradient again, multiplying it by the degree.)

The expert exchange of a MoE block (`models/moe.py`): `all_to_all`,
dim 0 in equal chunks over the 'expert' group, its own inverse, so its
backward is the same exchange of the gradient.

Training layouts (JAX `batch_sharding` and `_constrain_activations`):
`batch_slice` gives this rank's rows of a global batch over
('dcn', 'data', 'fsdp', 'expert'); under context parallelism (ring
attention) `context_slice` gives its rows over ('dcn', 'data') and its
chunk of the sequence over 'fsdp'.
"""
from __future__ import annotations

import math
import re
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


class PartitionSpec(tuple):
    """Per-dim mesh axes (None = replicated), as `jax.sharding.
    PartitionSpec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


# logical axis -> mesh axis (or None = replicated).
# 'embed' shards over fsdp (ZeRO-3-style param sharding); 'mlp'/'heads'
# shard over tensor; 'batch' over (data, fsdp); 'seq' over fsdp for
# context parallelism (ring attention).
DEFAULT_RULES: Tuple[Tuple[str, Optional[object]], ...] = (
    # 'dcn' leads the batch group: on multislice clusters the batch is
    # split across slices first (pure DP over DCN — gradient all-reduce
    # is the only collective that crosses the inter-slice network).
    ('batch', ('dcn', 'data', 'fsdp', 'expert')),
    ('seq', None),
    ('embed', 'fsdp'),
    ('mlp', 'tensor'),
    ('heads', 'tensor'),
    ('kv', None),
    ('vocab', 'tensor'),
    # MoE experts shard over their own mesh axis; tokens are sharded over
    # it too (batch rule above), so the dispatch/combine einsums become
    # all_to_alls under pjit.  Non-MoE params ignore the axis (replicated
    # over it) and their grads all-reduce across it automatically.
    ('expert', 'expert'),
    ('conv_in', None),
    ('conv_out', 'tensor'),
)


def rules_to_dict(rules: Sequence[Tuple[str, Optional[object]]]) -> dict:
    return dict(rules)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Sequence] = None) -> P:
    """('embed', 'mlp') -> PartitionSpec('fsdp', 'tensor')."""
    table = rules_to_dict(rules or DEFAULT_RULES)
    return P(*[table.get(a) if a is not None else None
               for a in logical_axes])


# Parameter name -> logical axis per dim of the torch tensor.  The Flax
# kernels' axes, transposed: q/k/v [D, H, hd] ('embed', 'heads', 'kv')
# -> [H*hd, D]; o [H, hd, D] -> [D, H*hd]; gate/up [D, F] ('embed',
# 'mlp') -> [F, D]; down -> [D, F]; embedding [V, D] and the lm_head
# kernel [D, V] ('embed', 'vocab') -> [V, D]; norm scales ('embed',).
# The MoE block's (`skypilot_tpu/models/moe.py`): the router kernel
# [D, E] ('embed', None) -> [E, D]; the expert weights keep the Flax
# layout, w_gate/w_up [E, D, F] ('expert', None, 'mlp') and w_down
# [E, F, D] ('expert', 'mlp', None).
PARAM_AXES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r'embed\.weight', ('vocab', 'embed')),
    (r'layers\.\d+\.attn\.[qkv]_proj\.weight', ('heads', 'embed')),
    (r'layers\.\d+\.attn\.o_proj\.weight', ('embed', 'heads')),
    (r'layers\.\d+\.mlp\.(gate|up)_proj\.weight', ('mlp', 'embed')),
    (r'layers\.\d+\.mlp\.down_proj\.weight', ('embed', 'mlp')),
    (r'layers\.\d+\.moe_mlp\.router\.weight', (None, 'embed')),
    (r'layers\.\d+\.moe_mlp\.w_(gate|up)', ('expert', None, 'mlp')),
    (r'layers\.\d+\.moe_mlp\.w_down', ('expert', 'mlp', None)),
    (r'layers\.\d+\.(attn|mlp)_norm\.scale', ('embed',)),
    (r'final_norm\.scale', ('embed',)),
    (r'lm_head\.weight', ('vocab', 'embed')),
)


def param_axes(name: str) -> Tuple[Optional[str], ...]:
    """The logical axes of the Llama parameter `name`."""
    for pattern, axes in PARAM_AXES:
        if re.fullmatch(pattern, name):
            return axes
    raise KeyError(f'{name!r} has no sharding annotation (a Llama '
                   f'parameter is expected)')


def is_expert_param(name: str) -> bool:
    """True for a MoE block's expert weights (split over 'expert')."""
    return param_axes(name)[0] == 'expert'


def _axis_names(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def splits_over(axes, axis: str) -> bool:
    """True when one dim's spec entry `axes` names mesh axis `axis`."""
    return axes is not None and axis in _axis_names(axes)


def param_spec(name: str, shape: Sequence[int], mesh_shape: Mapping[str, int],
               rules: Optional[Sequence] = None) -> PartitionSpec:
    """The spec of the FULL tensor `name` of `shape` on a mesh of
    `mesh_shape`: its logical axes through `rules`, with every dim that
    the mesh axes' size does not divide kept replicated (a split over
    axes of size 1 stays in the spec, as a NamedSharding keeps it)."""
    spec = logical_to_spec(param_axes(name), rules)
    kept = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            kept.append(None)
            continue
        size = math.prod(mesh_shape[a] for a in _axis_names(axes))
        kept.append(axes if dim % size == 0 else None)
    return P(*kept)


def _index(spec_axes, mesh) -> Tuple[int, int]:
    """(index, count) of this rank's shard along a dim split over
    `spec_axes` (row-major over the named axes, as a NamedSharding)."""
    index, count = 0, 1
    for a in _axis_names(spec_axes):
        index = index * mesh.shape[a] + mesh.coordinate(a)
        count *= mesh.shape[a]
    return index, count


def local_box(shape: Sequence[int], spec: PartitionSpec,
              mesh) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offsets, sizes) of this rank's shard of a tensor of `shape` under
    `spec`."""
    offsets, sizes = [0] * len(shape), list(shape)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        index, count = _index(axes, mesh)
        sizes[dim] = shape[dim] // count
        offsets[dim] = index * sizes[dim]
    return tuple(offsets), tuple(sizes)


def local_slice(full: torch.Tensor, spec: PartitionSpec,
                mesh) -> torch.Tensor:
    """This rank's shard of `full` under `spec` (a view)."""
    out = full
    for dim, (start, size) in enumerate(zip(*local_box(full.shape, spec,
                                                       mesh))):
        if size != full.shape[dim]:
            out = out.narrow(dim, start, size)
    return out


LOCAL_AXES = ('tensor', 'expert')


def tensor_spec(name: str, shape: Sequence[int],
                mesh_shape: Mapping[str, int],
                rules: Optional[Sequence] = None) -> PartitionSpec:
    """`param_spec` kept to the axes a rank holds as a local tensor
    (`LOCAL_AXES`): its tensor-parallel slice and, for expert weights,
    its E / expert experts.  The 'embed' -> fsdp sharding of a training
    mesh is FSDP's, on top of it (`train/trainer.py`)."""
    return P(*[axes if axes in LOCAL_AXES else None
               for axes in param_spec(name, shape, mesh_shape, rules)])


def shard_factor(spec: PartitionSpec, mesh_shape: Mapping[str, int]) -> int:
    """How many shards `spec` cuts a tensor into (global numel / local)."""
    return math.prod(math.prod(mesh_shape[a] for a in _axis_names(axes))
                     for axes in spec if axes is not None)


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor,
                        group) -> torch.Tensor:
    """x @ w^T where x's last dim and w's input dim are this rank's shard:
    each rank's partial product in x's dtype, summed over `group`."""
    out = F.linear(x, w)
    dist.all_reduce(out, group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole of a dim sharded in rank order over `group`, on every
    rank, bit for bit."""
    t = dist.get_world_size(group)
    dim = dim % x.dim()
    full = x.new_empty((t * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(full, x.contiguous(), group=group)
    if dim == 0:
        return full
    shape = list(x.shape)
    shape[dim] *= t
    return full.view(t, *x.shape).movedim(0, dim).reshape(shape)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`all_to_all` forward; the same exchange of the gradient backward
    (the exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of `x` in n equal chunks over the n ranks of `group`: chunk
    i goes to rank i, and chunk i of the result is what rank i sent this
    rank.  Differentiable.  gloo runs it on CUDA tensors as they are
    (unlike point to point; chip_smoke.py's expert_parallel probe), so
    every backend takes the device tensors."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


class _ColumnParallelEntry(torch.autograd.Function):
    """Identity forward; the gradient summed over `group` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _RowParallelExit(torch.autograd.Function):
    """The partials summed over `group` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDimExit(torch.autograd.Function):
    """`gather_dim` forward; this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim = dim % x.dim()
        ctx.size = x.shape[ctx.dim]
        ctx.rank = dist.get_group_rank(group, dist.get_rank())
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


# Each is the identity over a group of one rank.


def column_parallel_entry(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient all-reduced over `group`."""
    if dist.get_world_size(group) == 1:
        return x
    return _ColumnParallelEntry.apply(x, group)


def row_parallel_exit(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` (a copy); its gradient passed through."""
    if dist.get_world_size(group) == 1:
        return x
    return _RowParallelExit.apply(x, group)


def gather_dim_exit(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`gather_dim(x, dim, group)`; the gradient of this rank's slice."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherDimExit.apply(x, dim, group)


BATCH_AXES = ('dcn', 'data', 'fsdp', 'expert')
CONTEXT_ROW_AXES = ('dcn', 'data')


def _rows(tokens: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    index, count = _index(tuple(axes), mesh)
    if tokens.shape[0] % count:
        raise ValueError(f'a batch of {tokens.shape[0]} rows does not '
                         f'split over {tuple(axes)} ({count} shards)')
    size = tokens.shape[0] // count
    return tokens.narrow(0, index * size, size)


def batch_slice(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of the global batch `tokens` [B, ...], B split
    over ('dcn', 'data', 'fsdp', 'expert') in that order (the JAX
    `batch_sharding`)."""
    return _rows(tokens, BATCH_AXES, mesh)


def context_slice(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the global batch `tokens` [B, S] under
    context parallelism: rows over ('dcn', 'data'), the sequence in
    chunks over 'fsdp' (chunk i holds positions i*S/fsdp ..)."""
    rows = _rows(tokens, CONTEXT_ROW_AXES, mesh)
    n = mesh.shape['fsdp']
    if rows.shape[1] % n:
        raise ValueError(f'a sequence of {rows.shape[1]} does not split '
                         f'into {n} fsdp chunks')
    size = rows.shape[1] // n
    return rows.narrow(1, mesh.coordinate('fsdp') * size, size)
