"""Static per-dispatch device-cost model for the decode engine (PyTorch).

Twin of `skypilot_tpu/perf/cost_model.py`: the same formulas over the
same inputs, all quantities the HOST already knows (model config, the
byte size of the weights, the KV element width, batch occupancy, mean
context length), so the engine loop attributes FLOPs and HBM bytes to
every decoded token without touching the device.  The conventions match
`train/flops.py` (2N forward dense FLOPs per token; the trainer's 6N is
the fwd+bwd triple), so the live `skytpu_engine_mfu` gauge and the
trainer's MFU report the same quantity.  For a MoE model N counts every
expert (`cfg.num_params()`, as the JAX package does), so its MFU is the
dense-equivalent rate, not the share of the FLOPs top-k routing does.

The bytes side is the decode roofline: each decode step streams the
full weight set once (amortized over the active batch) and reads the KV
history of every active sequence plus one position's write.  The KV term
scales with the CACHE ELEMENT WIDTH, so an int8 page pool shows up as a
measured bytes/token drop, not a recalibration.

Under tensor parallelism (`n_chips` = the mesh's size) the bytes are
the whole model's, as the JAX package's cost model reads its global
arrays: bytes per token stay the replica's, and MFU and the roofline
divide by every chip's peak (per chip, the bytes are 1/n_chips of them).

The bandwidth table holds the card this package runs on, not the TPU
chips; the peak FLOP/s come from `train/flops.py`'s table.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from skypilot_tpu_torch.train import flops as flops_lib

# HBM bandwidth per device, GB/s: the H100 SXM 80 GB's HBM3 rate (NVIDIA
# data sheet); 'cpu' is nominal so accounting runs anywhere, the same
# convention as PEAK_BF16_TFLOPS['cpu'].
HBM_GBPS = {
    'h100': 3350.0,
    'cpu': 100.0,
}


def _distinct_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of `tensors`, each storage view counted once: a tied weight
    listed under two names (a state dict lists it under both) or passed
    twice is one tensor in memory.  Reads metadata only (pointers,
    shapes, element sizes), never values."""
    seen = set()
    total = 0
    for t in tensors:
        key = (t.device, t.untyped_storage().data_ptr(), t.storage_offset(),
               tuple(t.shape), tuple(t.stride()), t.dtype)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass(frozen=True)
class EngineCostModel:
    """Per-dispatch FLOP/byte attribution for one decode engine.

    Frozen: every field is static for the engine's lifetime (weights
    and cache geometry are fixed at construction), so the loop-thread
    evaluations below are pure arithmetic on python scalars.
    """
    n_params: int           # model parameters (embeddings included)
    n_layers: int
    dim: int
    n_kv_heads: int
    head_dim: int
    param_bytes: int        # total bytes of the installed weights
    kv_dtype_bytes: int     # element width of the KV cache / page pool
    n_chips: int = 1
    chip: str = 'cpu'
    # Quantization-scale overhead, bytes per token position across all
    # layers (int8 pools store one f32 absmax scale per (layer, K|V,
    # kv_head, position) alongside the int8 payload; 0.0 for dense
    # pools).  Folded into kv_bytes_per_pos.
    kv_scale_bytes_per_pos: float = 0.0

    @classmethod
    def from_engine_state(cls, cfg, params: Iterable[torch.Tensor],
                          cache_leaves, n_chips: int = 1,
                          chip: Optional[str] = None,
                          kv_dtype: Optional[str] = None,
                          param_bytes: Optional[int] = None
                          ) -> 'EngineCostModel':
        """Build from live engine state.  Reads only tensor METADATA
        (numel, element size, dtype, storage pointer), never values, so
        no device sync.  Each storage view counts once (`_distinct_bytes`:
        tied embeddings).

        ``kv_dtype``: the engine's DECLARED page-pool element type
        ('bf16'/'int8').  The declaration is authoritative over leaf
        inspection: an int8 pool holds int8 data beside f32 scales
        (`kv_quant.QuantPages`), and inferring the width from whichever
        leaf comes first would misreport bytes/token.  None (unpaged
        engines / direct callers) takes the first cache tensor's element
        width.  ``param_bytes`` overrides the bytes of ``params``: a
        tensor-parallel rank holds slices and passes the whole
        weights'."""
        scale_bytes = 0.0
        if kv_dtype is not None:
            kv_bytes = {'bf16': 2, 'int8': 1}[kv_dtype]
            if kv_dtype == 'int8':
                # One f32 scale per (layer, K|V, kv_head, position).
                scale_bytes = 2.0 * cfg.n_layers * cfg.n_kv_heads * 4
        else:
            kv_bytes = (cache_leaves[0].element_size() if cache_leaves
                        else 2)
        return cls(n_params=cfg.num_params(), n_layers=cfg.n_layers,
                   dim=cfg.dim, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim,
                   param_bytes=(param_bytes if param_bytes is not None
                                else _distinct_bytes(params)),
                   kv_dtype_bytes=int(kv_bytes), n_chips=n_chips,
                   chip=chip or flops_lib.chip_kind(),
                   kv_scale_bytes_per_pos=scale_bytes)

    # ----- FLOPs -----------------------------------------------------
    def decode_flops_per_token(self, context_len: float) -> float:
        """Forward model FLOPs to decode one token at the given KV
        context length: 2N dense + the causal-attention term (the
        forward third of flops_lib.train_flops_per_token's 6N+6LSD)."""
        return 2.0 * self.n_params + \
            2.0 * self.n_layers * context_len * self.dim

    # ----- HBM bytes -------------------------------------------------
    def kv_bytes_per_pos(self) -> float:
        """Bytes of K+V held per token position across all layers
        (payload at the pool's element width + any quantization-scale
        overhead)."""
        return (2.0 * self.n_layers * self.n_kv_heads * self.head_dim *
                self.kv_dtype_bytes + self.kv_scale_bytes_per_pos)

    def decode_hbm_bytes_per_token(self, context_len: float,
                                   n_active: int) -> float:
        """HBM traffic attributed to one decoded token: the weight
        stream (read once per step, amortized over the batch) plus
        this sequence's KV history read and its one-position write."""
        weights = self.param_bytes / max(1, n_active)
        kv_read = self.kv_bytes_per_pos() * context_len
        kv_write = self.kv_bytes_per_pos()
        return weights + kv_read + kv_write

    def arith_intensity(self, context_len: float, n_active: int) -> float:
        """FLOPs per HBM byte at the given occupancy: distance from the
        device's roofline ridge point."""
        return (self.decode_flops_per_token(context_len) /
                self.decode_hbm_bytes_per_token(context_len, n_active))

    # ----- roofline --------------------------------------------------
    def _peaks(self):
        peak_flops = (flops_lib.PEAK_BF16_TFLOPS.get(self.chip, 0.0) *
                      1e12 * self.n_chips)
        hbm_bytes_s = HBM_GBPS.get(self.chip, 0.0) * 1e9 * self.n_chips
        return peak_flops, hbm_bytes_s

    def mfu(self, tokens_per_s: float, context_len: float) -> float:
        """Achieved decode model FLOPs as % of the devices' peak."""
        peak_flops, _ = self._peaks()
        if peak_flops <= 0 or tokens_per_s <= 0:
            return 0.0
        return (100.0 * tokens_per_s *
                self.decode_flops_per_token(context_len) / peak_flops)

    def roofline_decode_tokens_per_s(self, context_len: float,
                                     n_active: int) -> float:
        """Decode-throughput ceiling at this occupancy: the lower of
        the compute-bound and bandwidth-bound token rates."""
        peak_flops, hbm = self._peaks()
        if peak_flops <= 0 or hbm <= 0:
            return 0.0
        compute_bound = peak_flops / self.decode_flops_per_token(
            context_len)
        bw_bound = hbm / self.decode_hbm_bytes_per_token(context_len,
                                                         n_active)
        return min(compute_bound, bw_bound)

    def prefill_seconds(self, bucket: int) -> float:
        """Roofline lower bound for one prefill dispatch of `bucket`
        tokens: dense FLOPs over every prompt token (mean attention
        context bucket/2) vs one weight stream + the KV write."""
        peak_flops, hbm = self._peaks()
        if peak_flops <= 0 or hbm <= 0:
            return 0.0
        fl = bucket * (2.0 * self.n_params +
                       2.0 * self.n_layers * (bucket / 2.0) * self.dim)
        by = self.param_bytes + self.kv_bytes_per_pos() * bucket
        return max(fl / peak_flops, by / hbm)
