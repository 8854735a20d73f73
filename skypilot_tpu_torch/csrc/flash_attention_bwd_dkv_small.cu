// Flash-attention backward, dk/dv kernel, for small head dims (D = 16, 32)
// on Hopper (sm_90a): mma.sync m16n8k16, Q/dO tiles through shared memory
// by cp.async, P^T and dS^T in f32 registers.  (The dq kernel is
// flash_attention_bwd_dq_small.cu.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dkv_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// the head dims the wgmma kernel (flash_attention_bwd_dkv.cu) does not
// take (its layout assumes 128-byte rows; a 16-wide bf16 row is 32 bytes).
// Same function:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dV = P^T dO,   dK = dS^T Q
// with P and dS rounded to the input type before their products (the TPU
// kernel's p.astype(do.dtype), ds.astype(q.dtype)), f32 sums, and dk/dv
// summed over each kv head's group of query heads.
//
// What bounds it on an H100: 8 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v, dO, dk and dv, so the bytes bound it up to S of
// about a thousand (causal); at the `tiny` models' shapes one launch is
// launch latency.
//
// Design (the small forward's, simple and correct first):
// - One CTA of 4 warps per (batch * kv-head, 64-row k tile); each warp
//   owns 16 k rows.  K and V stay in registers as the A fragments of
//   m16n8k16.
// - The CTA loops over the Hq / Hkv query heads of its kv head and over
//   the q tiles (when causal, from the diagonal down), so the GQA sum
//   happens in the f32 accumulators: no atomics, no [B, Hq, S, D]
//   temporary, and dk/dv are bit-reproducible run to run.  Q and dO
//   tiles of 64 rows go through two shared-memory stages filled by
//   cp.async (rows past S zero-filled), rows padded by 8 elements; the
//   tile's lse (times log2 e; +inf past S) and delta (0 past S) are staged
//   beside them by plain loads.
// - Per tile: S^T = K Q^T and dP^T = V dO^T (8 n-tiles of 8 q rows each);
//   P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - delta)
//   scale with lse and delta per column, read from the stage.  Rounded to
//   the input type in registers they are the A fragments of dV += P^T dO
//   and dK += dS^T Q as they stand; dO's and Q's B fragments are two
//   16-bit shared loads each.
// - Masking, explicit and only where needed: on the causal diagonal tile
//   (q < k), the ragged q tile (q rows past S) and the ragged k tile
//   (k rows past S) P^T is set to 0, never formed from -1e30 and an
//   infinite lse.  Causal q tiles wholly before the k tile's first row
//   are skipped (the TPU kernel's diag_ok).  Rows past S are not stored.
// - Heaviest k tiles first: block y is the k tile, and the causal k tile
//   0 has the most q tiles.

#include <math.h>

#include "sm80_mma.cuh"

namespace {

constexpr int kBlockN = 64;  // k rows per CTA: 4 warps x 16
constexpr int kBlockM = 64;  // q rows per tile (== kBlockN)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

using sm80::kPad;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int hq,
                            int hkv, int s_len, float scale, int causal) {
  constexpr int kLd = D + kPad;  // shared-memory row, in elements
  __shared__ __align__(16) T q_s[kStages][kBlockM * kLd];
  __shared__ __align__(16) T do_s[kStages][kBlockM * kLd];
  __shared__ float lse_s[kStages][kBlockM];
  __shared__ float delta_s[kStages][kBlockM];

  const int bkv = blockIdx.x;  // b * hkv + kv head
  const int k_tile = blockIdx.y;
  const int b = bkv / hkv;
  const int group = hq / hkv;
  const int bh0 = b * hq + (bkv - b * hkv) * group;  // the group's first
  const int k0 = k_tile * kBlockN;
  const int q_first = causal ? k_tile : 0;
  const int n_q = (s_len + kBlockM - 1) / kBlockM - q_first;
  const int n_items = group * n_q;  // (query head, q tile) pairs

  auto load_item = [&](int it) {
    const int st = it % kStages;
    const int bh = bh0 + it / n_q;
    const int row0 = (q_first + it % n_q) * kBlockM;
    const size_t head = size_t(bh) * s_len * D;
    sm80::load_tile_pair<D, kBlockM, kThreads>(q_s[st], do_s[st], q + head,
                                               dout + head, row0, s_len);
    // The stage was last read before the previous iteration's closing
    // barrier; the next iteration's barrier publishes these stores.
    if (threadIdx.x < kBlockM) {
      const int row = row0 + threadIdx.x;
      const bool in_seq = row < s_len;
      const size_t at = size_t(bh) * s_len + row;
      lse_s[st][threadIdx.x] = in_seq ? lse[at] * kLog2e : INFINITY;
      delta_s[st][threadIdx.x] = in_seq ? delta[at] : 0.f;
    }
  };
  load_item(0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row in the fragment
  const int quad = lane % 4;  // column pair in the fragment
  const int row_base = k0 + warp * 16 + g;
  const int rows[2] = {row_base, row_base + 8};  // this thread's k rows

  // K and V as the A fragments of S^T = K Q^T and dP^T = V dO^T.
  uint32_t k_frag[D / 16][4], v_frag[D / 16][4];
  sm80::load_a_rows<D>(k_frag, k + size_t(bkv) * s_len * D, rows, quad,
                       s_len);
  sm80::load_a_rows<D>(v_frag, v + size_t(bkv) * s_len * D, rows, quad,
                       s_len);
  const float scale_log2 = scale * kLog2e;
  const bool k_ragged = k0 + kBlockN > s_len;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      load_item(it + 1);
      sm80::cp_async_wait<1>();
    } else {
      sm80::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it % kStages;
    const int q_tile = q_first + it % n_q;
    const T* qs = q_s[st];
    const T* dos = do_s[st];

    // S^T = K Q^T and dP^T = V dO^T over this tile's 64 q rows: register
    // 4 j + 2 i + e holds k row rows[i], q row q_tile * 64 + 8 j + 2 quad
    // + e.
    float s[kBlockM / 2], dp[kBlockM / 2];
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j) {
      const T* q_row = qs + (8 * j + g) * kLd + 2 * quad;
      const T* do_row = dos + (8 * j + g) * kLd + 2 * quad;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm80::mma16816<T>(s, 4 * j, k_frag[kk],
                          sm80::load_u32(q_row + 16 * kk),
                          sm80::load_u32(q_row + 16 * kk + 8));
        sm80::mma16816<T>(dp, 4 * j, v_frag[kk],
                          sm80::load_u32(do_row + 16 * kk),
                          sm80::load_u32(do_row + 16 * kk + 8));
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T.
    const bool mask = (causal && q_tile == k_tile) ||
                      (q_tile + 1) * kBlockM > s_len || k_ragged;
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * quad + e;
        const float lse2 = lse_s[st][c];
        const float delta_c = delta_s[st][c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          float p = sm90::ex2(fmaf(s[idx], scale_log2, -lse2));
          if (mask) {
            const int col = q_tile * kBlockM + c;
            if (col >= s_len || rows[i] >= s_len ||
                (causal && col < rows[i]))
              p = 0.f;
          }
          s[idx] = p;
          dp[idx] = p * (dp[idx] - delta_c) * scale;
        }
      }

    // dV += P^T dO and dK += dS^T Q: k16 step kk covers q rows 16 kk ..
    // 16 kk + 15 of the tile; n8 tile n covers columns 8 n .. 8 n + 7 of D.
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t p_frag[4], ds_frag[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p_frag[r] = sm90::pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        ds_frag[r] =
            sm90::pack2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
      const T* do_k = dos + (16 * kk + 2 * quad) * kLd + g;
      const T* q_k = qs + (16 * kk + 2 * quad) * kLd + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* do_col = do_k + 8 * n;
        const T* q_col = q_k + 8 * n;
        sm80::mma16816<T>(dv_acc, 4 * n, p_frag,
                          sm80::pack_u16(do_col, do_col + kLd),
                          sm80::pack_u16(do_col + 8 * kLd,
                                         do_col + 9 * kLd));
        sm80::mma16816<T>(dk_acc, 4 * n, ds_frag,
                          sm80::pack_u16(q_col, q_col + kLd),
                          sm80::pack_u16(q_col + 8 * kLd, q_col + 9 * kLd));
      }
    }
    // The next iteration's loads overwrite this stage.
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= s_len) continue;
    const size_t at = (size_t(bkv) * s_len + rows[i]) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = sm90::pack2<T>(
          dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) = sm90::pack2<T>(
          dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int hq, int hkv, int s_len,
                   float scale, int causal, cudaStream_t stream) {
  const dim3 grid(b * hkv, (s_len + kBlockN - 1) / kBlockN);
  fa_bwd_dkv_small_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, s_len, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_bwd_dkv at head_dim 16 or 32.  q, dout
// [B,Hq,S,D] and k, v [B,Hkv,S,D] contiguous, 16-byte aligned; lse, delta
// [B,Hq,S] f32; dk, dv [B,Hkv,S,D], summed over each kv head's group of
// query heads.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's
// cudaError_t.
extern "C" int skytpu_flash_attention_bwd_dkv_small(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s_len, int head_dim, int dtype, float scale, int causal,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      s_len > 65535 * kBlockN)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 16)
    return int(launch<__nv_bfloat16, 16>(q, k, v, dout, lse, delta, dk, dv,
                                         b, hq, hkv, s_len, scale, causal,
                                         st));
  if (dtype == 0 && head_dim == 32)
    return int(launch<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dk, dv,
                                         b, hq, hkv, s_len, scale, causal,
                                         st));
  if (dtype == 1 && head_dim == 16)
    return int(launch<__half, 16>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                  hkv, s_len, scale, causal, st));
  if (dtype == 1 && head_dim == 32)
    return int(launch<__half, 32>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                  hkv, s_len, scale, causal, st));
  return int(cudaErrorInvalidValue);
}
