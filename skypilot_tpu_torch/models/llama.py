"""Llama-family decoder, dense-cache serving subset (PyTorch).

Twin of `skypilot_tpu/models/llama.py`: same configs, same math (split-
half RoPE in f32, f32 RMSNorm, f32 logits, compute in `cfg.dtype` with
params cast at use when `param_dtype` differs), same parameter tree
(`models/convert.py` maps the Flax tree onto this module's state dict).

The KV cache is explicit: a list with one (k, v) pair per layer, each
[B, n_kv_heads, max_seq_len, head_dim] in `cfg.dtype`.  `forward(...,
decode=True)` without a cache is the fresh prefill (prompt K/V written at
[:S], causal attention over the prompt: the flash kernel when
`attention_impl == 'flash'`, `mha_reference` when 'xla'); with a cache,
S > 1 is a chunk of a long prompt (position-scatter, attend over the whole
cache) and S == 1 a decode step (scatter at each row's own position).
Cache tensors are updated in place: the engine owns them, as the JAX
engine donates its cache buffers.

With `decode=True` and a `page_table` [B, pages_per_slot], the cache is
the engine's page POOL instead: per layer (k, v), each [n_pages,
n_kv_heads, page_size, head_dim] (or a `kv_quant.QuantPages` pair under
int8 pages), and `_paged_attend` scatters the S new rows into the slot's
pages and gathers its pages back into position order before attending
(S == 1 decode, S == k+1 speculative verify).

The non-decode forward is the training forward: differentiable (the
flash op is an autograd Function over the forward and backward kernels)
and, with `cfg.remat`, checkpointed per block as the JAX model's
`nn.remat` does: policy 'none' keeps only each block's input, 'dots'
also keeps the projection products (`aten.mm`, the counterpart of
`dots_with_no_batch_dims_saveable`); attention is recomputed under both.

With `n_experts > 0` every block's MLP is the top-k mixture of experts
of `models/moe.py` (`moe_mlp` in place of `mlp`, as in the Flax tree);
`forward(..., return_aux=True)` also returns each MoE layer's
load-balancing loss, the counterpart of applying the Flax model with
`intermediates` mutable.  Under remat the expert products (`bmm`, a
batch dimension) are recomputed under both policies, as
`dots_with_no_batch_dims_saveable` does not save them.

Tensor parallelism (`Llama(cfg, params, mesh)`, `mesh` a
`parallel.mesh.RankMesh`): each rank of the mesh's tensor group holds its
slices (`parallel/sharding.py` PARAM_AXES, the Flax annotations'
counterpart): q/k/v and gate/up column-parallel over its n_heads/t,
n_kv_heads/t and ffn/t, o/down row-parallel, their partial products
summed over the group in the compute dtype; the embedding and the
lm_head (tied or not) over vocab/t rows.  The embedding lookup is a
masked gather of the rank's own rows, summed over the group (the
counterpart of the JAX model's `OneHotEmbed`: exact, every other rank
adds zeros), and the logits are gathered whole on every rank before
anyone samples.  A dim the degree
does not divide (ffn, vocab) stays whole on every rank.  Attention, the
dense and the paged cache run on the rank's kv heads unchanged.  A
mixture-of-experts block under a mesh holds its slices of the expert
weights (each expert's F over 'tensor', the experts over 'expert') and
exchanges its dispatched slots over the 'expert' group
(`models/moe.py`).

The training forward under a mesh (grad enabled) uses the differentiable
pair of `parallel/sharding.py` instead of the in-place collectives: the
input of q/k/v, gate/up and a vocab-sharded lm_head passes a
column-parallel entry (its gradient all-reduced over the tensor group),
o/down and the embedding's masked lookup a row-parallel exit
(all-reduce forward), and the vocab-sharded logits a gathering exit
(this rank's slice of the gradient).  Parameters are the rank's tensor
slices, whole over the other axes; `train/trainer.py` shards them
further over 'fsdp' with FSDP2.

`attention_impl='ring'` is context parallelism (`parallel/
ring_attention.py`): the model's tokens are this rank's chunk of the
sequence over the mesh's 'fsdp' axis, RoPE takes the chunk's absolute
positions (chunk index * S_local + i), and attention is the ring over
the flash kernels.  It is a training forward: the serving paths
(decode=True) refuse it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.inference import kv_quant
from skypilot_tpu_torch.ops import attention as attn_lib
from skypilot_tpu_torch.parallel import ring_attention as ring_lib
from skypilot_tpu_torch.parallel import sharding

LayerCache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16          # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True                   # checkpoint each block (training)
    remat_policy: str = 'none'           # 'none' | 'dots'
    attention_impl: str = 'flash'        # 'flash' | 'xla' | 'ring'
    n_experts: int = 0                   # MoE (models/moe.py) if > 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self) -> float:
        """Approx dense fwd+bwd FLOPs/token (6N + attention term) for MFU."""
        n_params = self.num_params()
        attn = 12 * self.n_layers * self.dim * self.max_seq_len
        return 6 * n_params + attn

    def num_params(self) -> int:
        d, f = self.dim, self.ffn_dim
        if self.n_experts > 0:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts  # +router
        else:
            ffn = 3 * d * f                          # gate, up, down
        per_layer = (d * d * 2                       # q, o proj
                     + 2 * d * (self.n_kv_heads * self.head_dim)  # k, v
                     + ffn
                     + 2 * d)                        # norms
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d


LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    # test-size model: exercises GQA (4 q heads over 2 kv heads)
    'tiny': LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                        remat=False, rope_theta=10000.0),
    'llama3-1b': LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                             n_heads=32, n_kv_heads=8, ffn_dim=8192,
                             tie_embeddings=True),
    'bench-600m': LlamaConfig(vocab_size=32768, dim=1536, n_layers=16,
                              n_heads=12, n_kv_heads=4, ffn_dim=6144,
                              max_seq_len=2048),
    'bench-1b': LlamaConfig(vocab_size=32768, dim=2048, n_layers=14,
                            n_heads=16, n_kv_heads=8, ffn_dim=8192,
                            max_seq_len=4096, tie_embeddings=True),
    'llama-250m': LlamaConfig(vocab_size=32000, dim=1024, n_layers=16,
                              n_heads=16, n_kv_heads=8, ffn_dim=4096,
                              max_seq_len=2048, remat=False),
    'llama3-8b': LlamaConfig(),
    'llama3-70b': LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, ffn_dim=28672),
    'llama2-7b': LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=32, ffn_dim=11008,
                             rope_theta=10000.0, max_seq_len=4096),
}


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary position embedding (split halves, not interleaved), in f32.
    x: [B, H, S, D], positions: [B, S]."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta**exps)
    angles = positions[:, None, :, None].float() * freqs          # B1SF
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _param(shape, dtype) -> nn.Parameter:
    # Created on the meta device: real tensors arrive by
    # load_state_dict(assign=True), so a 7B model is never materialized
    # twice (or in f32 on the host).
    return nn.Parameter(torch.empty(shape, dtype=dtype, device='meta'),
                        requires_grad=False)


class Dense(nn.Module):
    """Projection, weight [out, in], bias-free unless `bias`; input and
    params are cast to the compute dtype at use (Flax Dense's
    dtype/param_dtype split).  With `reduce_group` it is row-parallel: its
    input dim is this rank's shard and the partial products are summed
    over the group (in place when no gradient is recorded, through the
    differentiable exit when one is)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, bias: bool = False,
                 reduce_group: Any = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = _param((out_features, in_features), param_dtype)
        self.bias = _param((out_features,), param_dtype) if bias else None
        self.reduce_group = reduce_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.reduce_group is None:
            return F.linear(x, w, bias)
        if torch.is_grad_enabled():
            y = sharding.row_parallel_exit(F.linear(x, w), self.reduce_group)
        else:
            y = sharding.row_parallel_linear(x, w, self.reduce_group)
        return y if bias is None else y + bias


class TensorShards:
    """Where a tensor-parallel Llama splits on `mesh`: the tensor group,
    its size `t` and this rank's index; attention heads always split (the
    degree is validated against both head counts), ffn and vocab only
    where the degree divides them."""

    def __init__(self, cfg: 'LlamaConfig', mesh) -> None:
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        self.t = mesh.shape['tensor']
        mesh_lib.validate_tensor_parallel(self.t, n_heads=cfg.n_heads,
                                          n_kv_heads=cfg.n_kv_heads)
        self.group = mesh.group('tensor')
        self.rank = mesh.coordinate('tensor')

        def split(name, shape):
            return sharding.splits_over(
                sharding.param_spec(name, shape, mesh.shape)[0], 'tensor')

        self.ffn = split('layers.0.mlp.gate_proj.weight',
                         (cfg.ffn_dim, cfg.dim))
        self.vocab = split('embed.weight', (cfg.vocab_size, cfg.dim))

    def part(self, n: int, split: bool = True) -> int:
        return n // self.t if split else n


def _entry(x: torch.Tensor, group) -> torch.Tensor:
    """The column-parallel entry of a training forward (a no-op without a
    group or without autograd recording)."""
    if group is None or not torch.is_grad_enabled():
        return x
    return sharding.column_parallel_entry(x, group)


class RMSNorm(nn.Module):

    def __init__(self, dim: int, eps: float, dtype, param_dtype) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = _param((dim,), param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + self.eps)
        return (out * self.scale.float()).to(self.dtype)


class Attention(nn.Module):

    def __init__(self, cfg: LlamaConfig,
                 tp: Optional[TensorShards] = None,
                 ring_mesh: Any = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.ring_mesh = ring_mesh
        self.tp_group = tp.group if tp else None
        hd = cfg.head_dim
        # This rank's heads (all of them without a mesh).
        self.n_heads = tp.part(cfg.n_heads) if tp else cfg.n_heads
        self.n_kv_heads = tp.part(cfg.n_kv_heads) if tp else cfg.n_kv_heads
        self.q_proj = Dense(cfg.dim, self.n_heads * hd, cfg.dtype,
                            cfg.param_dtype)
        self.k_proj = Dense(cfg.dim, self.n_kv_heads * hd, cfg.dtype,
                            cfg.param_dtype)
        self.v_proj = Dense(cfg.dim, self.n_kv_heads * hd, cfg.dtype,
                            cfg.param_dtype)
        self.o_proj = Dense(self.n_heads * hd, cfg.dim, cfg.dtype,
                            cfg.param_dtype,
                            reduce_group=tp.group if tp else None)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                decode: bool = False,
                cache: Optional[LayerCache] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[LayerCache]]:
        cfg = self.cfg
        if decode and cfg.attention_impl == 'ring':
            raise ValueError("attention_impl 'ring' is the context-parallel "
                             "training forward; serve with 'flash' or 'xla'")
        b, s, _ = x.shape
        hd = cfg.head_dim
        x = _entry(x, self.tp_group)
        # [B, S, H*D] -> [B, H, S, D]
        q = self.q_proj(x).view(b, s, self.n_heads, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, s, self.n_kv_heads, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, s, self.n_kv_heads, hd).transpose(1, 2)
        q = _rope(q, positions, cfg.rope_theta).contiguous()
        k = _rope(k, positions, cfg.rope_theta).contiguous()
        v = v.contiguous()
        if decode and page_table is not None:
            cache, attn_out = self._paged_attend(q, k, v, positions, cache,
                                                 page_table)
        elif decode:
            cache, attn_out = self._decode_attend(q, k, v, positions, cache)
        else:
            attn_out = self._attend(q, k, v)
        out = attn_out.transpose(1, 2).reshape(b, s, self.n_heads * hd)
        return self.o_proj(out), cache

    def _attend(self, q, k, v):
        """Causal self-attention over the sequence itself (under 'ring',
        over the whole sequence the mesh's 'fsdp' axis holds in chunks)."""
        if self.cfg.attention_impl == 'ring':
            return ring_lib.ring_attention(q, k, v, self.ring_mesh,
                                           causal=True)
        if self.cfg.attention_impl == 'flash':
            return attn_lib.flash_attention(q, k, v, True)
        return attn_lib.mha_reference(q, k, v, causal=True)

    def _decode_attend(self, q, k, v, positions,
                       cache: Optional[LayerCache]):
        """Attention with a KV cache (serving path), driven entirely by
        the caller-supplied per-row `positions` [B, S].

        Invariant that makes bucket-padded prefill safe: every step
        attends only k_pos <= q_pos, writes at q_pos, and inserts
        overwrite a slot's whole cache, so padding garbage always lives
        at k_pos > q_pos and is masked until overwritten.
        """
        cfg = self.cfg
        max_len = cfg.max_seq_len
        b, _, s, _ = q.shape
        if cache is None:
            # Fresh prefill: prompts are left-aligned, so the prompt
            # occupies cache[:S]; attend causally over the prompt itself.
            shape = (b, self.n_kv_heads, max_len, cfg.head_dim)
            ck = k.new_zeros(shape)
            cv = v.new_zeros(shape)
            ck[:, :, :s] = k
            cv[:, :, :s] = v
            return (ck, cv), self._attend(q, k, v)
        ck, cv = cache
        if s > 1:
            # Chunked prefill: the chunk's rows land at their absolute
            # positions; positions >= max_len (padding past the cache
            # end) are dropped explicitly: they match no cache row.
            hit = positions[:, :, None] == torch.arange(
                max_len, device=positions.device)               # [B, S, L]
            written = hit.any(dim=1)[:, None, :, None]          # [B,1,L,1]
            src = hit.to(torch.uint8).argmax(dim=1)             # [B, L]
            idx = src[:, None, :, None]
            for buf, new in ((ck, k), (cv, v)):
                rows = torch.gather(
                    new, 2, idx.expand(b, new.shape[1], max_len, new.shape[3]))
                buf.copy_(torch.where(written, rows, buf))
        else:
            # Decode step: each row writes its k/v at its own position
            # (the engine clamps positions below max_len).
            pos = positions[:, 0]
            b_idx = torch.arange(b, device=q.device)
            ck[b_idx, :, pos, :] = k[:, :, 0, :]
            cv[b_idx, :, pos, :] = v[:, :, 0, :]
        k_pos = torch.arange(max_len, device=q.device)[None, :].expand(
            b, max_len)
        out = attn_lib.mha_reference(q, ck, cv, causal=True,
                                     segment_positions=positions,
                                     kv_positions=k_pos)
        return (ck, cv), out

    def _paged_attend(self, q, k, v, positions, pool, page_table):
        """Attention against the PAGED cache: `pool` is this layer's
        (k, v) page pool [n_pages, n_kv_heads, page_size, D] and
        `page_table` [B, pages_per_slot] maps each slot's logical page
        -> physical page (shared prefix pages included).  Each call
        scatters its S rows into the slot's OWN pages (shared pages end
        at the match boundary and writes land past it), then gathers the
        slot's pages back into position order and attends exactly like
        the dense path: same shapes, same masks.

        S == 1 is the decode step; S > 1 is speculative verify (k drafts
        plus the committed last token, every row written before the
        gather).  Rejected draft rows leave garbage past the accepted
        length, unread under the causal mask until overwritten.

        Under int8 pages (`kv_quant.QuantPages`) rows are quantized at
        scatter time and dequantized in the gather.
        """
        if pool is None:
            raise ValueError(
                'paged attention is the steady-state decode path: the '
                'engine supplies the page pool as the cache')
        ck, cv = pool
        quant = isinstance(ck, kv_quant.QuantPages)
        ps = (ck.data if quant else ck).shape[2]
        b = q.shape[0]
        n_logical = page_table.shape[1] * ps
        page_ids = torch.gather(page_table, 1, positions // ps)   # [B, S]
        off = positions % ps                                      # [B, S]

        # Write this call's K/V rows at (page, in-page offset).  The two
        # advanced indices around a slice put [B, S] first, so the rows
        # go in as [B, S, H, D].  Distinct live slots never share their
        # write pages; inactive slots all point at the trash page
        # (duplicate-index garbage the masks keep unread).
        def scatter(leaf, rows):
            rows = rows.transpose(1, 2)                   # [B, S, H, D]
            if quant:
                qd, s = kv_quant.quantize_kv(rows)
                leaf.data[page_ids, :, off, :] = qd
                leaf.scale[page_ids, :, off] = s
            else:
                leaf[page_ids, :, off, :] = rows

        scatter(ck, k)
        scatter(cv, v)

        def gather(leaf):
            if quant:
                g = kv_quant.dequantize_kv(leaf.data[page_table],
                                           leaf.scale[page_table],
                                           self.cfg.dtype)  # [B, P, H, ps, D]
            else:
                g = leaf[page_table]                        # [B, P, H, ps, D]
            g = g.transpose(1, 2)                           # [B, H, P, ps, D]
            return g.reshape(b, g.shape[1], n_logical, g.shape[4])

        k_pos = torch.arange(n_logical, device=q.device)[None, :].expand(
            b, n_logical)
        out = attn_lib.mha_reference(q, gather(ck), gather(cv), causal=True,
                                     segment_positions=positions,
                                     kv_positions=k_pos)
        return pool, out


class MLP(nn.Module):

    def __init__(self, cfg: LlamaConfig,
                 tp: Optional[TensorShards] = None) -> None:
        super().__init__()
        split = tp is not None and tp.ffn
        self.tp_group = tp.group if split else None
        ffn = tp.part(cfg.ffn_dim) if split else cfg.ffn_dim
        self.gate_proj = Dense(cfg.dim, ffn, cfg.dtype, cfg.param_dtype)
        self.up_proj = Dense(cfg.dim, ffn, cfg.dtype, cfg.param_dtype)
        self.down_proj = Dense(ffn, cfg.dim, cfg.dtype, cfg.param_dtype,
                               reduce_group=tp.group if split else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _entry(x, self.tp_group)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):

    def __init__(self, cfg: LlamaConfig,
                 tp: Optional[TensorShards] = None,
                 ring_mesh: Any = None, mesh: Any = None) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                 cfg.param_dtype)
        self.attn = Attention(cfg, tp, ring_mesh)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                cfg.param_dtype)
        self.is_moe = cfg.n_experts > 0
        if self.is_moe:
            from skypilot_tpu_torch.models.moe import MoEMLP
            self.moe_mlp = MoEMLP(
                cfg.dim, cfg.ffn_dim, cfg.n_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, mesh=mesh)
        else:
            self.mlp = MLP(cfg, tp)

    def forward(self, x, positions, decode=False, cache=None,
                page_table=None, return_aux=False):
        """-> (x, cache, aux): aux is the MoE layer's load-balancing loss
        when `return_aux` is set, else None."""
        h, cache = self.attn(self.attn_norm(x), positions, decode, cache,
                             page_table)
        x = x + h
        h, aux = self.mlp_norm(x), None
        if self.is_moe:
            h = self.moe_mlp(h, return_aux=return_aux)
            if return_aux:
                h, aux = h
        else:
            h = self.mlp(h)
        return x + h, cache, aux


class Llama(nn.Module):
    """The decoder over a given parameter dict (`init_params` or
    `models/convert.py`); the tensors are adopted, not copied, so two
    modules built over one dict (e.g. attention_impl 'flash' and 'xla')
    share their weights.  Under a `mesh` the dict holds this rank's
    slices (`init_params(..., mesh=)`, `convert.shard_params`,
    `load_serving_params(..., mesh=)`)."""

    def __init__(self, cfg: LlamaConfig,
                 params: Mapping[str, torch.Tensor],
                 mesh: Any = None) -> None:
        super().__init__()
        if cfg.attention_impl not in ('flash', 'xla', 'ring'):
            raise ValueError(f'attention_impl {cfg.attention_impl!r} not in '
                             f"('flash', 'xla', 'ring')")
        if cfg.attention_impl == 'ring' and mesh is None:
            raise ValueError("attention_impl 'ring' needs a mesh (the "
                             "sequence is sharded over its 'fsdp' axis)")
        if cfg.remat_policy not in ('none', 'dots'):
            raise ValueError(f'remat_policy {cfg.remat_policy!r} not in '
                             f"('none', 'dots')")
        self.cfg = cfg
        self.mesh = mesh
        self.tp = TensorShards(cfg, mesh) if mesh is not None else None
        vocab = (self.tp.part(cfg.vocab_size, self.tp.vocab) if self.tp
                 else cfg.vocab_size)
        self.embed = nn.Embedding(vocab, cfg.dim, device='meta',
                                  dtype=cfg.param_dtype)
        ring_mesh = mesh if cfg.attention_impl == 'ring' else None
        self.layers = nn.ModuleList(Block(cfg, self.tp, ring_mesh, mesh)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                  cfg.param_dtype)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.dim, vocab, cfg.dtype, cfg.param_dtype)
        self.load_state_dict(params, strict=True, assign=True)
        # Serving needs no gradient; a trainer turns them on for the model
        # it trains (load_state_dict(assign=True) keeps the module's
        # requires_grad, not the given tensors').
        self.requires_grad_(False)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                decode: bool = False,
                cache: Optional[List[LayerCache]] = None,
                page_table: Optional[torch.Tensor] = None,
                return_aux: bool = False,
                logits_at: Optional[torch.Tensor] = None):
        """tokens [B, S] -> f32 logits [B, S, V]; with decode=True returns
        (logits, cache), the cache being a list of per-layer (k, v) (the
        page pool when `page_table` is given).  `return_aux` appends the
        list of the MoE layers' load-balancing losses (empty for a dense
        model) to what is returned: (logits, aux) or (logits, cache,
        aux).  `logits_at` [B] names one position per row: the logits
        are computed there only, [B, 1, V] (a prefill samples from its
        last prompt position).  Under 'ring' attention `tokens` is this
        rank's chunk of the sequence and the default positions are the
        chunk's absolute ones."""
        cfg = self.cfg
        if positions is None:
            if cfg.attention_impl == 'ring':
                positions = ring_lib.chunk_positions(
                    self.mesh, tokens.shape[1], tokens.device)
            else:
                positions = torch.arange(tokens.shape[1],
                                         device=tokens.device)
            positions = positions[None, :].expand(tokens.shape)
        x = self._embed(tokens)
        new_cache: List[LayerCache] = []
        aux: List[torch.Tensor] = []
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x, layer_cache, layer_aux = checkpoint_lib.checkpoint(
                    layer, x, positions, return_aux=return_aux,
                    use_reentrant=False,
                    context_fn=_REMAT_CONTEXTS[cfg.remat_policy])
            else:
                x, layer_cache, layer_aux = layer(
                    x, positions, decode, None if cache is None else cache[i],
                    page_table, return_aux)
            new_cache.append(layer_cache)
            if layer_aux is not None:
                aux.append(layer_aux)
        if logits_at is not None:
            x = x[torch.arange(x.shape[0], device=x.device), logits_at]
            x = x[:, None]
        x = self.final_norm(x)
        vocab_group = (self.tp.group if self.tp is not None and self.tp.vocab
                       else None)
        x = _entry(x, vocab_group)
        if cfg.tie_embeddings:
            logits = F.linear(x, self.embed.weight.to(cfg.dtype))
        else:
            logits = self.lm_head(x)
        logits = logits.float()
        if vocab_group is not None:
            # Vocab-sharded: every rank samples from the whole row.
            if torch.is_grad_enabled():
                logits = sharding.gather_dim_exit(logits, -1, vocab_group)
            else:
                logits = sharding.gather_dim(logits, -1, vocab_group)
        if decode:
            return (logits, new_cache, aux) if return_aux else (logits,
                                                                new_cache)
        return (logits, aux) if return_aux else logits

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding lookup in the compute dtype.  Vocab-sharded, each
        rank looks up the tokens whose rows it holds, zeros elsewhere, and
        the group sums the results (exact: one rank holds each row)."""
        w = self.embed.weight
        if self.tp is None or not self.tp.vocab:
            return F.embedding(tokens, w).to(self.cfg.dtype)
        local = tokens - self.tp.rank * w.shape[0]
        mine = (local >= 0) & (local < w.shape[0])
        x = F.embedding(local.clamp(0, w.shape[0] - 1), w).to(self.cfg.dtype)
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        if torch.is_grad_enabled():
            return sharding.row_parallel_exit(x, self.tp.group)
        dist.all_reduce(x, group=self.tp.group)
        return x


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat 'dots': keep the projection
    products, recompute everything else."""
    del ctx, args, kwargs
    return (checkpoint_lib.CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.mm.default else
            checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE)


# remat_policy -> checkpoint context_fn ('none' saves only block inputs).
_REMAT_CONTEXTS = {
    'none': checkpoint_lib.noop_context_fn,
    'dots': functools.partial(
        checkpoint_lib.create_selective_checkpoint_contexts, _save_dots),
}


def _lecun_normal(shape, fan_in: int, dtype, device,
                  generator) -> torch.Tensor:
    """Flax lecun_normal: truncated normal at +-2 std, std corrected for
    the truncation (1/sqrt(fan_in) / .8796...)."""
    std = (1.0 / fan_in)**0.5 / .87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return w.to(dtype)


def init_params(cfg: LlamaConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                mesh: Any = None) -> Dict[str, torch.Tensor]:
    """Random weights for `Llama(cfg, params)`, made directly on `device`
    (default: the GPU, or the mesh's device; raises without one) in
    `cfg.param_dtype`, one weight at a time.  `generator` (on `device`)
    fixes the draw; default seed 0.  Under a `mesh` every weight is drawn
    whole (the same draw on every rank) and only this rank's slice is
    kept (its tensor slice, and its experts of a MoE leaf), so the whole
    tree never exists at once."""
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn_dim

    def dense(n_in, n_out):
        return _lecun_normal((n_out, n_in), n_in, cfg.param_dtype, device,
                             generator)

    params = _KeepSlices(mesh)
    embed = torch.empty((cfg.vocab_size, d), dtype=torch.float32,
                        device=device)
    embed.normal_(0.0, 1.0, generator=generator)
    params['embed.weight'] = embed.to(cfg.param_dtype)
    del embed
    for i in range(cfg.n_layers):
        p = f'layers.{i}.'
        params[p + 'attn_norm.scale'] = torch.ones(
            d, dtype=cfg.param_dtype, device=device)
        params[p + 'attn.q_proj.weight'] = dense(d, cfg.n_heads * hd)
        params[p + 'attn.k_proj.weight'] = dense(d, cfg.n_kv_heads * hd)
        params[p + 'attn.v_proj.weight'] = dense(d, cfg.n_kv_heads * hd)
        params[p + 'attn.o_proj.weight'] = dense(cfg.n_heads * hd, d)
        params[p + 'mlp_norm.scale'] = torch.ones(
            d, dtype=cfg.param_dtype, device=device)
        if cfg.n_experts > 0:
            # Flax's lecun_normal over a 3-D kernel counts the expert
            # axis into the fan-in: d*e for [E, D, F], f*e for [E, F, D].
            e = cfg.n_experts
            params[p + 'moe_mlp.router.weight'] = dense(d, e)
            for name, shape in (('w_gate', (e, d, f)), ('w_up', (e, d, f)),
                                ('w_down', (e, f, d))):
                params[p + 'moe_mlp.' + name] = _lecun_normal(
                    shape, shape[1] * e, cfg.param_dtype, device, generator)
        else:
            params[p + 'mlp.gate_proj.weight'] = dense(d, f)
            params[p + 'mlp.up_proj.weight'] = dense(d, f)
            params[p + 'mlp.down_proj.weight'] = dense(f, d)
    params['final_norm.scale'] = torch.ones(d, dtype=cfg.param_dtype,
                                            device=device)
    if not cfg.tie_embeddings:
        params['lm_head.weight'] = dense(d, cfg.vocab_size)
    return dict(params)


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """The whole shape of every parameter of `Llama(cfg, ...)`, by name,
    in `init_params`' order."""
    d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn_dim
    shapes = {'embed.weight': (cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f'layers.{i}.'
        shapes[p + 'attn_norm.scale'] = (d,)
        shapes[p + 'attn.q_proj.weight'] = (cfg.n_heads * hd, d)
        shapes[p + 'attn.k_proj.weight'] = (cfg.n_kv_heads * hd, d)
        shapes[p + 'attn.v_proj.weight'] = (cfg.n_kv_heads * hd, d)
        shapes[p + 'attn.o_proj.weight'] = (d, cfg.n_heads * hd)
        shapes[p + 'mlp_norm.scale'] = (d,)
        if cfg.n_experts > 0:
            e = cfg.n_experts
            shapes[p + 'moe_mlp.router.weight'] = (e, d)
            shapes[p + 'moe_mlp.w_gate'] = (e, d, f)
            shapes[p + 'moe_mlp.w_up'] = (e, d, f)
            shapes[p + 'moe_mlp.w_down'] = (e, f, d)
        else:
            shapes[p + 'mlp.gate_proj.weight'] = (f, d)
            shapes[p + 'mlp.up_proj.weight'] = (f, d)
            shapes[p + 'mlp.down_proj.weight'] = (d, f)
    shapes['final_norm.scale'] = (d,)
    if not cfg.tie_embeddings:
        shapes['lm_head.weight'] = (cfg.vocab_size, d)
    return shapes


class _KeepSlices(dict):
    """A state dict that keeps only this rank's local slice of each weight
    set into it under `mesh` (`sharding.tensor_spec`; a copy: the whole
    weight is freed)."""

    def __init__(self, mesh) -> None:
        super().__init__()
        self.mesh = mesh

    def __setitem__(self, name: str, full: torch.Tensor) -> None:
        if self.mesh is not None:
            spec = sharding.tensor_spec(name, full.shape, self.mesh.shape)
            full = sharding.local_slice(full, spec, self.mesh).clone()
        super().__setitem__(name, full)
