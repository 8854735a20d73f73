// Flash-attention backward, dq kernel, for small head dims (D = 16, 32) on
// Hopper (sm_90a): mma.sync m16n8k16, K/V tiles through shared memory by
// cp.async, dS in f32 registers.  (The dk/dv kernel is
// flash_attention_bwd_dkv_small.cu.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dq_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// the head dims the wgmma kernel (flash_attention_bwd_dq.cu) does not take:
// its shared-memory layout and descriptors assume 128-byte swizzled rows
// of 64 elements, and a 16-wide bf16 row is 32 bytes.  The Pallas kernel
// takes any D, and the `tiny` configs train at D = 16.  Same function:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dQ = dS K
// with dS rounded to the input type before its product (the TPU kernel's
// ds.astype(k.dtype)), f32 sums, and dq written in the input type.
//
// What bounds it on an H100: 6 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v, dO and dq, so the bytes bound it up to S of about a
// thousand (causal, the tensor cores' 989 TFLOP/s against 3.35 TB/s); the
// shapes the `tiny` models give it (S <= 128) are a few tens of KB, so
// one launch is launch latency.
//
// Design (the small forward's, simple and correct first):
// - One CTA of 4 warps per (batch * q-head, 64-row q tile); each warp owns
//   16 q rows.  Q and dO stay in registers as the A fragments of m16n8k16,
//   and each thread keeps its two rows' -lse log2 e (-inf past S) and
//   delta (0 past S) for the whole sweep.
// - K and V tiles of 64 rows go through two shared-memory stages filled by
//   cp.async (rows past S zero-filled), rows padded by 8 elements.  GQA:
//   the CTA reads kv head h / (Hq / Hkv).
// - Per tile: S = Q K^T and dP = dO V^T (8 n-tiles of 8 keys each);
//   P = 2^(S scale log2 e - lse log2 e); dS = P (dP - delta) scale, rounded
//   to the input type in registers, is the A fragment of dQ += dS K as it
//   stands (the forward's reuse of P); K's B fragments are two 16-bit
//   shared loads each.
// - Masking, explicit and only where needed: on the causal diagonal tile
//   (key > row) and on the ragged tile (keys past S: zero-filled K rows
//   would give P = exp(-lse) != 0) P is set to 0, never formed from -1e30
//   and an infinite lse.  Causal tiles wholly after the q tile's last row
//   are skipped (the TPU kernel's diag_ok).  Rows past S are not stored.
// - Each dq element is summed by one thread in a fixed order, with no
//   atomics: dq is bit-reproducible run to run.

#include <math.h>

#include "sm80_mma.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows per CTA: 4 warps x 16
constexpr int kBlockN = 64;  // k/v rows per tile (== kBlockM)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

using sm80::kPad;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int hq, int hkv, int s_len,
                           float scale, int causal) {
  constexpr int kLd = D + kPad;  // shared-memory row, in elements
  __shared__ __align__(16) T k_s[kStages][kBlockN * kLd];
  __shared__ __align__(16) T v_s[kStages][kBlockN * kLd];

  const int bh = blockIdx.x;                      // b * hq + h
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int b = bh / hq;
  const int bkv = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = q_tile * kBlockM;
  const int n_tiles_all = (s_len + kBlockN - 1) / kBlockN;
  const int n_tiles = causal ? min(n_tiles_all, q_tile + 1) : n_tiles_all;
  const T* k_head = k + size_t(bkv) * s_len * D;
  const T* v_head = v + size_t(bkv) * s_len * D;

  auto load_tile = [&](int t) {
    sm80::load_tile_pair<D, kBlockN, kThreads>(
        k_s[t % kStages], v_s[t % kStages], k_head, v_head, t * kBlockN,
        s_len);
  };
  load_tile(0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row in the fragment
  const int quad = lane % 4;  // column pair in the fragment
  const int row_base = q0 + warp * 16 + g;
  const int rows[2] = {row_base, row_base + 8};

  // Q and dO as the A fragments of S = Q K^T and dP = dO V^T.
  uint32_t q_frag[D / 16][4], do_frag[D / 16][4];
  sm80::load_a_rows<D>(q_frag, q + size_t(bh) * s_len * D, rows, quad,
                       s_len);
  sm80::load_a_rows<D>(do_frag, dout + size_t(bh) * s_len * D, rows, quad,
                       s_len);
  float neg_lse[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in_seq = rows[i] < s_len;
    const size_t at = size_t(bh) * s_len + rows[i];
    neg_lse[i] = in_seq ? -lse[at] * kLog2e : -INFINITY;
    delta_r[i] = in_seq ? delta[at] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      sm80::cp_async_wait<1>();
    } else {
      sm80::cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_s[t % kStages];
    const T* vs = v_s[t % kStages];

    // S = Q K^T and dP = dO V^T over this tile's 64 keys: register
    // 4 j + 2 i + e holds row rows[i], key t * 64 + 8 j + 2 quad + e.
    float s[kBlockN / 2], dp[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const T* k_row = ks + (8 * j + g) * kLd + 2 * quad;
      const T* v_row = vs + (8 * j + g) * kLd + 2 * quad;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm80::mma16816<T>(s, 4 * j, q_frag[kk],
                          sm80::load_u32(k_row + 16 * kk),
                          sm80::load_u32(k_row + 16 * kk + 8));
        sm80::mma16816<T>(dp, 4 * j, do_frag[kk],
                          sm80::load_u32(v_row + 16 * kk),
                          sm80::load_u32(v_row + 16 * kk + 8));
      }
    }

    // dS = P (dP - delta) scale, in place of S.
    const bool mask = (causal && t == q_tile) || (t + 1) * kBlockN > s_len;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e;
          float p = sm90::ex2(fmaf(s[idx], scale_log2, neg_lse[i]));
          if (mask) {
            const int col = t * kBlockN + 8 * j + 2 * quad + e;
            if (col >= s_len || (causal && col > rows[i])) p = 0.f;
          }
          s[idx] = p * (dp[idx] - delta_r[i]) * scale;
        }

    // dQ += dS K: k16 step kk covers keys 16 kk .. 16 kk + 15 of the tile;
    // n8 tile n covers columns 8 n .. 8 n + 7 of D.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t ds_frag[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ds_frag[r] =
            sm90::pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      const T* k_k = ks + (16 * kk + 2 * quad) * kLd + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* k_col = k_k + 8 * n;
        sm80::mma16816<T>(dq_acc, 4 * n, ds_frag,
                          sm80::pack_u16(k_col, k_col + kLd),
                          sm80::pack_u16(k_col + 8 * kLd, k_col + 9 * kLd));
      }
    }
    // The next iteration's cp.async overwrites this stage.
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= s_len) continue;
    T* dq_row = dq + (size_t(bh) * s_len + rows[i]) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq_row + 8 * n) = sm90::pack2<T>(
          dq_acc[4 * n + 2 * i], dq_acc[4 * n + 2 * i + 1]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int hq, int hkv, int s_len, float scale,
                   int causal, cudaStream_t stream) {
  const dim3 grid(b * hq, (s_len + kBlockM - 1) / kBlockM);
  fa_bwd_dq_small_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), hq, hkv, s_len, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_bwd_dq at head_dim 16 or 32.  q, dout, dq
// [B,Hq,S,D] and k, v [B,Hkv,S,D] contiguous, 16-byte aligned; lse, delta
// [B,Hq,S] f32.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's
// cudaError_t.
extern "C" int skytpu_flash_attention_bwd_dq_small(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int s_len, int head_dim, int dtype, float scale, int causal,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      s_len > 65535 * kBlockM)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 16)
    return int(launch<__nv_bfloat16, 16>(q, k, v, dout, lse, delta, dq, b,
                                         hq, hkv, s_len, scale, causal, st));
  if (dtype == 0 && head_dim == 32)
    return int(launch<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dq, b,
                                         hq, hkv, s_len, scale, causal, st));
  if (dtype == 1 && head_dim == 16)
    return int(launch<__half, 16>(q, k, v, dout, lse, delta, dq, b, hq, hkv,
                                  s_len, scale, causal, st));
  if (dtype == 1 && head_dim == 32)
    return int(launch<__half, 32>(q, k, v, dout, lse, delta, dq, b, hq, hkv,
                                  s_len, scale, causal, st));
  return int(cudaErrorInvalidValue);
}
