"""Attention ops: the plain reference and the flash-attention kernels.

PyTorch twin of `skypilot_tpu/ops/attention.py`.  `mha_reference` is the
plain implementation (runs anywhere; the ground truth of the tests).
`flash_attention` is a `torch.autograd.Function` (the counterpart of the
JAX package's `jax.custom_vjp`): its forward is the hand-written Hopper
forward kernel, its backward the dq and dk/dv kernels
(`ops/cuda/flash_attention.py`), on CUDA tensors; CPU tensors take the
kernels' plain versions in both directions.

Shapes: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D]; grouped-query attention is
expressed by Hq = G * Hkv (query heads grouped over kv heads).
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops.cuda import flash_attention as cuda_fa


def _expand_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads ([h0, h0, h1, h1, ...],
    the layout of jnp.repeat(axis=1))."""
    h_kv = k.shape[1]
    if h_kv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // h_kv, dim=1)


def mha_reference(q: torch.Tensor,
                  k: torch.Tensor,
                  v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None,
                  segment_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain multi-head attention: f32 logits, -inf causal masking, NaN
    rows (fully masked) set to 0, probabilities cast to the value dtype
    before P.V with f32 accumulation.

    segment_positions/kv_positions: optional absolute positions
    [B, Sq] / [B, Sk] for causal masking when q attends over a cache
    longer than itself (the serving decode and chunked-prefill paths).
    """
    orig_dtype = q.dtype
    scale = scale if scale is not None else q.shape[-1]**-0.5
    k = _expand_kv(k, q.shape[1])
    v = _expand_kv(v, q.shape[1])
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * scale
    if causal:
        if segment_positions is None:
            q_pos = torch.arange(q.shape[2], device=q.device)[None, :]
            k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        else:
            q_pos = segment_positions
            k_pos = (kv_positions if kv_positions is not None
                     else segment_positions)
        mask = q_pos[:, None, :, None] >= k_pos[:, None, None, :]
        logits = logits.masked_fill(~mask, float('-inf'))
    probs = torch.softmax(logits, dim=-1)
    # Fully-masked rows produce NaN from softmax(-inf row); zero them.
    probs = probs.masked_fill(torch.isnan(probs), 0.0)
    out = torch.einsum('bhqk,bhkd->bhqd', probs.to(v.dtype).float(),
                       v.float())
    return out.to(orig_dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with residuals (q, k, v, out, lse) saved; backward
    is delta = rowsum(dO * O) and the two backward kernels, dk/dv already
    at Hkv heads.  `causal` and `block_size` take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_size):
        ctx.causal, ctx.block_size = causal, block_size
        if not any(ctx.needs_input_grad[:3]):
            return cuda_fa.flash_attention_fwd(q, k, v, causal=causal,
                                               block_size=block_size)
        out, lse = cuda_fa.flash_attention_fwd(
            q, k, v, causal=causal, block_size=block_size,
            return_residuals=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # The incoming gradient is usually a transposed view (the model
        # reshapes [B, H, S, D] to [B, S, H*D]); the kernels take
        # contiguous tensors.
        dq, dk, dv = cuda_fa.flash_attention_bwd(
            q, k, v, out, lse, g.contiguous(), causal=ctx.causal,
            block_size=ctx.block_size)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor,
                    k: torch.Tensor,
                    v: torch.Tensor,
                    causal: bool = True,
                    block_size: int = 512) -> torch.Tensor:
    """Flash attention, differentiable in q, k and v: the Hopper kernels
    on CUDA tensors, their plain versions on CPU tensors."""
    return _FlashAttention.apply(q, k, v, causal, block_size)
