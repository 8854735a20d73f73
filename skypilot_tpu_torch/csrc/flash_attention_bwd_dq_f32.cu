// Flash-attention backward, dq kernel, in f32: the mma.sync kernel of
// flash_attention_bwd_dq_mma.cuh (its design, bounds and the Pallas kernel
// it replaces are described there) with f32 inputs and dq, its products in
// 3xTF32 (f32-class error, sm80_mma.cuh), at every kernel width: 16, 32, 64
// and 128 here, 80, 96 and 256 in flash_attention_bwd_dq_f32_wide.cu (a
// source of its own so that nvcc compiles the two in parallel).  Any other
// head_dim up to 256 reaches a kernel zero-padded to the next width by the
// wrapper (skypilot_tpu_torch/ops/cuda/flash_attention.py).

#include "flash_attention_bwd_dq_mma.cuh"

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_bwd_dq in f32 at head_dim 16, 32, 64, 80, 96, 128
// or 256.  q, dout, dq [B,Hq,S,D] and k, v [B,Hkv,S,D] f32, contiguous,
// 16-byte aligned; lse, delta [B,Hq,S] f32.  dtype: 2 = f32 (the one this
// entry takes).  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int s_len, int head_dim, int dtype, float scale, int causal,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 2 || !flash_mma::dq_args_ok(b, hq, hkv, s_len))
    return int(cudaErrorInvalidValue);
  switch (head_dim) {
    case 16:
      return int(flash_mma::launch_dq_typed<float, 16>(
          q, k, v, dout, lse, delta, dq, b, hq, hkv, s_len, scale, causal,
          st));
    case 32:
      return int(flash_mma::launch_dq_typed<float, 32>(
          q, k, v, dout, lse, delta, dq, b, hq, hkv, s_len, scale, causal,
          st));
    case 64:
      return int(flash_mma::launch_dq_typed<float, 64>(
          q, k, v, dout, lse, delta, dq, b, hq, hkv, s_len, scale, causal,
          st));
    case 128:
      return int(flash_mma::launch_dq_typed<float, 128>(
          q, k, v, dout, lse, delta, dq, b, hq, hkv, s_len, scale, causal,
          st));
    default:
      return int(flash_mma::launch_dq_f32_wide(q, k, v, dout, lse, delta, dq,
                                               b, hq, hkv, s_len, head_dim,
                                               scale, causal, st));
  }
}
