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

Not in this ported package yet: the one-hot embedding, MoE and ring
attention.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.device import DeviceLike, resolve_device
from skypilot_tpu_torch.inference import kv_quant
from skypilot_tpu_torch.ops import attention as attn_lib

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
    attention_impl: str = 'flash'        # 'flash' | 'xla' ('ring' later)
    n_experts: int = 0                   # MoE: not in this slice
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
    """Bias-free projection, weight [out, in]; input and weight are cast
    to the compute dtype at use (Flax Dense's dtype/param_dtype split)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = _param((out_features, in_features), param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


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

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = Dense(cfg.dim, cfg.n_heads * hd, cfg.dtype,
                            cfg.param_dtype)
        self.k_proj = Dense(cfg.dim, cfg.n_kv_heads * hd, cfg.dtype,
                            cfg.param_dtype)
        self.v_proj = Dense(cfg.dim, cfg.n_kv_heads * hd, cfg.dtype,
                            cfg.param_dtype)
        self.o_proj = Dense(cfg.n_heads * hd, cfg.dim, cfg.dtype,
                            cfg.param_dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                decode: bool = False,
                cache: Optional[LayerCache] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[LayerCache]]:
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        # [B, S, H*D] -> [B, H, S, D]
        q = self.q_proj(x).view(b, s, cfg.n_heads, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
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
        out = attn_out.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
        return self.o_proj(out), cache

    def _attend(self, q, k, v):
        """Causal self-attention over the sequence itself."""
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
            shape = (b, cfg.n_kv_heads, max_len, cfg.head_dim)
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

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.gate_proj = Dense(cfg.dim, cfg.ffn_dim, cfg.dtype,
                               cfg.param_dtype)
        self.up_proj = Dense(cfg.dim, cfg.ffn_dim, cfg.dtype, cfg.param_dtype)
        self.down_proj = Dense(cfg.ffn_dim, cfg.dim, cfg.dtype,
                               cfg.param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                 cfg.param_dtype)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                cfg.param_dtype)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, decode=False, cache=None,
                page_table=None):
        h, cache = self.attn(self.attn_norm(x), positions, decode, cache,
                             page_table)
        x = x + h
        x = x + self.mlp(self.mlp_norm(x))
        return x, cache


class Llama(nn.Module):
    """The decoder over a given parameter dict (`init_params` or
    `models/convert.py`); the tensors are adopted, not copied, so two
    modules built over one dict (e.g. attention_impl 'flash' and 'xla')
    share their weights."""

    def __init__(self, cfg: LlamaConfig,
                 params: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        if cfg.attention_impl not in ('flash', 'xla'):
            raise ValueError(
                f'attention_impl {cfg.attention_impl!r}: this package has '
                f"'flash' and 'xla' (ring attention comes with the "
                f'context-parallel port)')
        if cfg.n_experts > 0:
            raise ValueError('MoE comes with the model-zoo port')
        if cfg.remat_policy not in ('none', 'dots'):
            raise ValueError(f'remat_policy {cfg.remat_policy!r} not in '
                             f"('none', 'dots')")
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, device='meta',
                                  dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                  cfg.param_dtype)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.dim, cfg.vocab_size, cfg.dtype,
                                 cfg.param_dtype)
        self.load_state_dict(params, strict=True, assign=True)
        # Serving needs no gradient; a trainer turns them on for the model
        # it trains (load_state_dict(assign=True) keeps the module's
        # requires_grad, not the given tensors').
        self.requires_grad_(False)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                decode: bool = False,
                cache: Optional[List[LayerCache]] = None,
                page_table: Optional[torch.Tensor] = None):
        """tokens [B, S] -> f32 logits [B, S, V]; with decode=True returns
        (logits, cache), the cache being a list of per-layer (k, v) (the
        page pool when `page_table` is given)."""
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            positions = positions[None, :].expand(tokens.shape)
        x = F.embedding(tokens, self.embed.weight).to(cfg.dtype)
        new_cache: List[LayerCache] = []
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x, layer_cache = checkpoint_lib.checkpoint(
                    layer, x, positions, use_reentrant=False,
                    context_fn=_REMAT_CONTEXTS[cfg.remat_policy])
            else:
                x, layer_cache = layer(x, positions, decode,
                                       None if cache is None else cache[i],
                                       page_table)
            new_cache.append(layer_cache)
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            logits = F.linear(x, self.embed.weight.to(cfg.dtype))
        else:
            logits = self.lm_head(x)
        logits = logits.float()
        return (logits, new_cache) if decode else logits


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


def _lecun_normal(shape, fan_in: int, cfg: LlamaConfig, device,
                  generator) -> torch.Tensor:
    """Flax lecun_normal: truncated normal at +-2 std, std corrected for
    the truncation (1/sqrt(fan_in) / .8796...)."""
    std = (1.0 / fan_in)**0.5 / .87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return w.to(cfg.param_dtype)


def init_params(cfg: LlamaConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Random weights for `Llama(cfg, params)`, made directly on `device`
    (default: the GPU; raises without one) in `cfg.param_dtype`, one
    weight at a time.  `generator` (on `device`) fixes the draw; default
    seed 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn_dim

    def dense(n_in, n_out):
        return _lecun_normal((n_out, n_in), n_in, cfg, device, generator)

    embed = torch.empty((cfg.vocab_size, d), dtype=torch.float32,
                        device=device)
    embed.normal_(0.0, 1.0, generator=generator)
    params = {'embed.weight': embed.to(cfg.param_dtype)}
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
        params[p + 'mlp.gate_proj.weight'] = dense(d, f)
        params[p + 'mlp.up_proj.weight'] = dense(d, f)
        params[p + 'mlp.down_proj.weight'] = dense(f, d)
    params['final_norm.scale'] = torch.ones(d, dtype=cfg.param_dtype,
                                            device=device)
    if not cfg.tie_embeddings:
        params['lm_head.weight'] = dense(d, cfg.vocab_size)
    return params
