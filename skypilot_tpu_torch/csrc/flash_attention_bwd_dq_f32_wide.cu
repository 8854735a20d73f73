// Flash-attention backward, dq kernel, in f32 at head_dim 80, 96 and 256:
// the 3xTF32 mma.sync kernel of flash_attention_bwd_dq_mma.cuh, reached
// through the C entry of flash_attention_bwd_dq_f32.cu (which takes 16,
// 32, 64 and 128 itself); a source of its own so that nvcc compiles the
// two in parallel.

#include "flash_attention_bwd_dq_mma.cuh"

namespace flash_mma {

cudaError_t launch_dq_f32_wide(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int hq,
                               int hkv, int s_len, int head_dim, float scale,
                               int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 80:
      return launch_dq_typed<float, 80>(q, k, v, dout, lse, delta, dq, b, hq,
                                        hkv, s_len, scale, causal, stream);
    case 96:
      return launch_dq_typed<float, 96>(q, k, v, dout, lse, delta, dq, b, hq,
                                        hkv, s_len, scale, causal, stream);
    case 256:
      return launch_dq_typed<float, 256>(q, k, v, dout, lse, delta, dq, b,
                                         hq, hkv, s_len, scale, causal,
                                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash_mma
