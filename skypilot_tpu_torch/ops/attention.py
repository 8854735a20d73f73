"""Attention ops: the plain reference and the flash-forward kernel.

PyTorch twin of `skypilot_tpu/ops/attention.py`.  `mha_reference` is the
plain implementation (runs anywhere; the ground truth of the tests).
`flash_attention` runs the hand-written Hopper forward kernel
(`ops/cuda/flash_attention.py`) on CUDA tensors and its plain version on
CPU tensors.  It is forward-only in this package: the autograd Function
and the two backward kernels come with the training port.

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


def flash_attention(q: torch.Tensor,
                    k: torch.Tensor,
                    v: torch.Tensor,
                    causal: bool = True,
                    block_size: int = 512) -> torch.Tensor:
    """Flash attention forward: the Hopper kernel on CUDA tensors, its
    plain version on CPU tensors.  Forward only: inputs that need a
    gradient are refused rather than silently detached by the kernel."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            'flash_attention has no backward in this package yet (the '
            'training port brings the dq and dk/dv kernels); run it under '
            'torch.no_grad()')
    return cuda_fa.flash_attention_fwd(q, k, v, causal=causal,
                                       block_size=block_size)
