// Flash-attention forward at head_dim 80 and 96: the mma.sync kernel of
// flash_attention_fwd_mma.cuh (its design, bounds and the Pallas kernel it
// replaces are described there) at the attention widths of Phi-2 (80) and
// Phi-3-mini (96), which the wgmma kernel's 64-element swizzled rows do
// not take.  (bf16/fp16 at 256 has a wgmma kernel of its own,
// flash_attention_fwd_256.cu.)  Any other head_dim up to 256 that no
// kernel takes reaches a kernel zero-padded to the next width by the
// wrapper (skypilot_tpu_torch/ops/cuda/flash_attention.py).

#include "flash_attention_fwd_mma.cuh"

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_fwd at head_dim 80 or 96.  q [B,Hq,S,D], k/v
// [B,Hkv,S,D], o [B,Hq,S,D] contiguous, 16-byte aligned; lse [B,Hq,S] f32
// or null.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_fwd_wide(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int hq, int hkv, int s_len, int head_dim, int dtype, float scale,
    int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!flash_mma::fwd_args_ok(b, hq, hkv, s_len))
    return int(cudaErrorInvalidValue);
  if (head_dim == 80)
    return int(flash_mma::launch_fwd<80>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         dtype, scale, causal, st));
  if (head_dim == 96)
    return int(flash_mma::launch_fwd<96>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         dtype, scale, causal, st));
  return int(cudaErrorInvalidValue);
}
