"""Mixture-of-Experts MLP (PyTorch), on one device or a mesh.

Twin of `skypilot_tpu/models/moe.py`: GShard-style top-k routing with a
fixed per-expert capacity, expressed as dense one-hot dispatch and
combine products, so every shape is static and nothing reads back to the
host (the engine captures its decode call as a CUDA graph): no `.item()`,
no `nonzero`, no boolean-mask indexing; one-hots are comparisons against
`arange`.  The same semantics, point for point:

- capacity comes from the S of the call: `max(1, int(capacity_factor *
  S * top_k / E))`, counted per batch row (the bucket-padded prefill, a
  chunk, the speculative verify's k+1 and the decode step's 1 each get
  their own, so the port drops exactly the tokens the JAX engine drops);
- selection is greedy per token (k rounds of argmax, the first maximum
  on ties); slots fill in (round, token) order; a token past an
  expert's capacity is dropped for that expert (the residual around the
  block carries it);
- the selected gates renormalize to sum 1 over a differentiable sum
  clamped at 1e-9, so gradients reach the router through each gate and
  its normaliser;
- the router runs in f32 on an f32 input; dispatch and combine are cast
  to the compute dtype before their products.

The load-balancing loss (E x mean router prob . mean assigned fraction)
is computed only when the caller asks (`return_aux=True`), the
counterpart of flax's `sow` into a mutable `intermediates` collection;
the train step does not add it to its loss, as the JAX trainer does not.

Under a mesh (`mesh`, a `parallel.mesh.RankMesh`) a rank holds its
slices of the expert weights (`parallel/sharding.py` PARAM_AXES, the
Flax annotations' counterpart: w_gate/w_up [E, D, F] on ('expert', None,
'mlp'), w_down [E, F, D] on ('expert', 'mlp', None)); the router stays
whole on every rank, so every rank routes alike.
- Tensor parallelism: each expert's F is split over 'tensor', w_gate
  and w_up column-parallel, w_down row-parallel; one reduce over the
  tensor group after w_down, the dense MLP's collectives (in place
  without a gradient, the differentiable pair with one).  Only the
  expert path passes the column-parallel entry: the router's input
  gradient is the same on every rank and is not summed.
- Expert parallelism (training): each rank holds E / expert experts.
  Dispatch stays the dense one-hot product over the rank's own rows
  (capacity per row, from the call's S), then one all_to_all over the
  'expert' group turns [E, b_local, C, D] into [E/ep, ep*b_local, C, D],
  the rank's experts run on every row of the group, and a second
  all_to_all sends the results back before the combine: what the JAX
  module's `_constrain` makes XLA emit.  Both are
  `sharding.all_to_all`, an autograd Function whose backward is the same
  exchange of the gradient (the exchange is its own inverse).
Nothing reads back to the host under a mesh either.
"""
from __future__ import annotations

from typing import Any, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.models.llama import Dense, _entry, _param
from skypilot_tpu_torch.parallel import sharding


def top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard top-k routing.

    probs [B, S, E] (f32) -> (dispatch [B,S,E,C] 0/1, combine [B,S,E,C]).
    """
    b, s, e = probs.shape
    experts = torch.arange(e, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    masks = []
    p = probs
    for _ in range(top_k):
        idx = p.argmax(dim=-1)                              # [B, S]
        mask = (idx[..., None] == experts).to(probs.dtype)  # [B, S, E]
        masks.append(mask)
        p = p * (1.0 - mask)
    gate_sum = sum((probs * m).sum(-1) for m in masks)      # [B, S]
    gate_sum = torch.clamp_min(gate_sum, 1e-9)

    dispatch = probs.new_zeros((b, s, e, capacity))
    combine = probs.new_zeros((b, s, e, capacity))
    counts = probs.new_zeros((b, 1, e))                     # slots used
    for mask in masks:
        pos = torch.cumsum(mask, dim=1) - mask + counts     # [B, S, E]
        counts = counts + mask.sum(dim=1, keepdim=True)
        keep = mask * (pos < capacity)
        pos_oh = ((pos.long()[..., None] == slots).to(probs.dtype) *
                  keep[..., None])
        gate = (probs * mask).sum(-1) / gate_sum            # [B, S]
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh * gate[..., None, None]
    return dispatch, combine


def load_balancing_loss(probs: torch.Tensor,
                        dispatch: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E * mean_prob_e . mean_assigned_frac_e."""
    e = probs.shape[-1]
    mean_prob = probs.mean(dim=(0, 1))                      # [E]
    assigned = dispatch.sum(-1).mean(dim=(0, 1))            # [E]
    return e * torch.sum(mean_prob * assigned)


def capacity_of(s: int, n_experts: int, top_k: int,
                capacity_factor: float) -> int:
    """Slots per expert and batch row for a call over S tokens."""
    return max(1, int(capacity_factor * s * top_k / n_experts))


def _to_experts(t: torch.Tensor, group) -> torch.Tensor:
    """[E, b, C, D] of this rank's rows -> [E/n, n*b, C, D]: its experts'
    slots of every row of the n-rank expert group (rows in rank order)."""
    n = dist.get_world_size(group)
    e, b = t.shape[:2]
    y = sharding.all_to_all(t, group).view(n, e // n, b, *t.shape[2:])
    return y.transpose(0, 1).reshape(e // n, n * b, *t.shape[2:])


def _from_experts(t: torch.Tensor, group) -> torch.Tensor:
    """The inverse of `_to_experts`: [E/n, n*b, C, D] -> [E, b, C, D]."""
    n = dist.get_world_size(group)
    e_local, nb = t.shape[:2]
    y = t.view(e_local, n, nb // n, *t.shape[2:]).transpose(0, 1)
    return sharding.all_to_all(
        y.reshape(n * e_local, nb // n, *t.shape[2:]), group)


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP; expert weights
    w_gate, w_up [E, D, F] and w_down [E, F, D], as the Flax module's
    (under `mesh`, this rank's slices of them)."""

    def __init__(self, dim: int, ffn_dim: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 mesh: Any = None) -> None:
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.tp_group = self.ep_group = None
        n_local, ffn_local = n_experts, ffn_dim
        if mesh is not None:
            ep, tp = mesh.shape['expert'], mesh.shape['tensor']
            if n_experts % ep:
                raise ValueError(f'{n_experts} experts do not split over '
                                 f'expert={ep}')
            spec = sharding.param_spec('layers.0.moe_mlp.w_gate',
                                       (n_experts, dim, ffn_dim), mesh.shape)
            if ep > 1:
                self.ep_group = mesh.group('expert')
                n_local = n_experts // ep
            if tp > 1 and sharding.splits_over(spec[2], 'tensor'):
                self.tp_group = mesh.group('tensor')
                ffn_local = ffn_dim // tp
        # Router in f32: routing decisions are the one place bf16 noise
        # visibly changes the computation graph.
        self.router = Dense(dim, n_experts, torch.float32, param_dtype)
        self.w_gate = _param((n_local, dim, ffn_local), param_dtype)
        self.w_up = _param((n_local, dim, ffn_local), param_dtype)
        self.w_down = _param((n_local, ffn_local, dim), param_dtype)

    def forward(self, x: torch.Tensor, return_aux: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x [B, S, D] -> [B, S, D] in x's dtype; with `return_aux`, also
        the load-balancing loss (an f32 scalar)."""
        capacity = capacity_of(x.shape[1], self.n_experts, self.top_k,
                               self.capacity_factor)
        probs = torch.softmax(self.router(x), dim=-1)       # [B, S, E]
        dispatch, combine = top_k_dispatch(probs, self.top_k, capacity)
        dt = self.dtype
        xin = _entry(x.to(dt), self.tp_group)
        expert_in = torch.einsum('bsec,bsd->ebcd', dispatch.to(dt), xin)
        if self.ep_group is not None:
            expert_in = _to_experts(expert_in, self.ep_group)
        h = (F.silu(torch.einsum('ebcd,edf->ebcf', expert_in,
                                 self.w_gate.to(dt))) *
             torch.einsum('ebcd,edf->ebcf', expert_in, self.w_up.to(dt)))
        expert_out = torch.einsum('ebcf,efd->ebcd', h, self.w_down.to(dt))
        if self.tp_group is not None:
            if torch.is_grad_enabled():
                expert_out = sharding.row_parallel_exit(expert_out,
                                                        self.tp_group)
            else:
                dist.all_reduce(expert_out, group=self.tp_group)
        if self.ep_group is not None:
            expert_out = _from_experts(expert_out, self.ep_group)
        out = torch.einsum('ebcd,bsec->bsd', expert_out,
                           combine.to(dt)).to(x.dtype)
        if return_aux:
            return out, load_balancing_loss(probs, dispatch)
        return out
