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

Collectives (the group is the mesh's tensor group), one rule for every
backend:
- `row_parallel_linear`: a row-parallel product, each rank's partial in
  the compute dtype, added over the group by one all_reduce;
- `gather_dim`: a dim sharded over the group, gathered whole on every
  rank in rank order (one all_gather_into_tensor).
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
PARAM_AXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    (r'embed\.weight', ('vocab', 'embed')),
    (r'layers\.\d+\.attn\.[qkv]_proj\.weight', ('heads', 'embed')),
    (r'layers\.\d+\.attn\.o_proj\.weight', ('embed', 'heads')),
    (r'layers\.\d+\.mlp\.(gate|up)_proj\.weight', ('mlp', 'embed')),
    (r'layers\.\d+\.mlp\.down_proj\.weight', ('embed', 'mlp')),
    (r'layers\.\d+\.(attn|mlp)_norm\.scale', ('embed',)),
    (r'final_norm\.scale', ('embed',)),
    (r'lm_head\.weight', ('vocab', 'embed')),
)


def param_axes(name: str) -> Tuple[str, ...]:
    """The logical axes of the Llama parameter `name`."""
    for pattern, axes in PARAM_AXES:
        if re.fullmatch(pattern, name):
            return axes
    raise KeyError(f'{name!r} has no sharding annotation (a dense Llama '
                   f'parameter is expected)')


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


def local_slice(full: torch.Tensor, spec: PartitionSpec,
                mesh) -> torch.Tensor:
    """This rank's shard of `full` under `spec` (a view)."""
    out = full
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        index, count = _index(axes, mesh)
        size = full.shape[dim] // count
        out = out.narrow(dim, index * size, size)
    return out


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
