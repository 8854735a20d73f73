// Flash-attention forward in f32 at head_dim 80, 96 and 256: the 3xTF32
// mma.sync kernel of flash_attention_fwd_mma.cuh, reached through the C
// entry of flash_attention_fwd_f32.cu (which takes 16, 32, 64 and 128
// itself); a source of its own so that nvcc compiles the two in parallel.

#include "flash_attention_fwd_mma.cuh"

namespace flash_mma {

cudaError_t launch_fwd_f32_wide(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int hq, int hkv,
                                int s_len, int head_dim, float scale,
                                int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 80:
      return launch_fwd_typed<float, 80>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         scale, causal, stream);
    case 96:
      return launch_fwd_typed<float, 96>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         scale, causal, stream);
    case 256:
      return launch_fwd_typed<float, 256>(q, k, v, o, lse, b, hq, hkv, s_len,
                                          scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash_mma
