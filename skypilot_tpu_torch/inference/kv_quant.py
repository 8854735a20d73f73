"""Int8 KV-page quantization: the device-side counterpart of paging.py.

PyTorch twin of `skypilot_tpu/inference/kv_quant.py`.  paging.py owns
page *bookkeeping*; this module owns the page *payload* when
``EngineConfig.kv_dtype == 'int8'``.  A quantized pool stores each
(layer, K|V) cache as a :class:`QuantPages` pair instead of a single
dense tensor:

- ``data``:  int8  ``[n_pages, n_kv_heads, page_size, head_dim]``
- ``scale``: f32   ``[n_pages, n_kv_heads, page_size]``

i.e. symmetric absmax quantization along ``head_dim``, one scale per
(page, kv-head, position): dequantization is one multiply inside the
attention gather, and the int8 payload halves decode's dominant memory
stream (the f32 scales add ``4 / head_dim`` bytes per element, ~3% at
head_dim 128).

On the wire (inference/kv_transfer.py) and in the engine's leaf order a
``QuantPages`` is two leaves, ``data`` then ``scale``, as the JAX
pytree node flattens.

The arithmetic is the JAX module's, operation for operation: an f32
absmax over ``head_dim`` divided by 127, an f32 division by the scale
(floored at 1e-8), round half to even (``torch.round`` and
``jnp.round`` agree) and a clamp to +-127, so the same f32 input gives
bit-identical ``(q, s)`` in both packages.  Quantization is idempotent
under round trip in f32: absmax of ``q * s`` is ``127 * s``.
"""
from __future__ import annotations

import dataclasses

import torch

# Guard against zero scales on all-zero rows (e.g. freshly zeroed
# pool pages round-tripped through dequant/requant).
_EPS = 1e-8


@dataclasses.dataclass
class QuantPages:
    """An int8 page pool leaf: quantized payload + per-position scales.

    ``data``  int8 ``[..., page_size, head_dim]``
    ``scale`` f32  ``[..., page_size]`` (one absmax scale per row of
    ``head_dim`` elements).
    """
    data: torch.Tensor
    scale: torch.Tensor


def quantize_kv(x: torch.Tensor):
    """Symmetric absmax int8 quantization along the last axis.

    Returns ``(q, s)`` with ``q`` int8 of ``x.shape`` and ``s`` f32 of
    ``x.shape[:-1]`` such that ``q * s[..., None] ~= x``.
    """
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    q = torch.clamp(torch.round(x32 / torch.clamp(s, min=_EPS)[..., None]),
                    -127.0, 127.0).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (up to rounding), cast to
    ``dtype`` for the attention matmul."""
    return (q.float() * s[..., None]).to(dtype)
