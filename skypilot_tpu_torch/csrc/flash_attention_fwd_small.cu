// Flash-attention forward at head_dim 16 and 32: the mma.sync kernel of
// flash_attention_fwd_mma.cuh (its design, bounds and the Pallas kernel it
// replaces are described there) at the head dims of the `tiny` configs.
// The same kernel at head_dim 80, 96 and 256 is flash_attention_fwd_wide.cu,
// a source of its own so that nvcc compiles the two in parallel.

#include "flash_attention_fwd_mma.cuh"

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_fwd at head_dim 16 or 32.  q [B,Hq,S,D], k/v
// [B,Hkv,S,D], o [B,Hq,S,D] contiguous, 16-byte aligned; lse [B,Hq,S] f32
// or null.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_fwd_small(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int hq, int hkv, int s_len, int head_dim, int dtype, float scale,
    int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!flash_mma::fwd_args_ok(b, hq, hkv, s_len))
    return int(cudaErrorInvalidValue);
  if (head_dim == 16)
    return int(flash_mma::launch_fwd<16>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         dtype, scale, causal, st));
  if (head_dim == 32)
    return int(flash_mma::launch_fwd<32>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         dtype, scale, causal, st));
  return int(cudaErrorInvalidValue);
}
