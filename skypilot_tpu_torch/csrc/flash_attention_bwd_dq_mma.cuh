// Flash-attention backward, dq kernel, in mma.sync on Hopper (sm_90a),
// where the wgmma kernels (flash_attention_bwd_dq.cu: bf16/fp16 at D = 64
// and 128; flash_attention_bwd_dq_256.cu at 256) do not reach: bf16/fp16
// at D = 16 and 32 (instantiated in flash_attention_bwd_dq_small.cu) and
// D = 80 and 96 (flash_attention_bwd_dq_wide.cu), and f32 at D = 16, 32, 64 and 128
// (flash_attention_bwd_dq_f32.cu) and 80, 96 and 256
// (flash_attention_bwd_dq_f32_wide.cu).  m16n8k16 products, or m16n8k8
// tf32 ones taken three times for f32 (3xTF32, sm80_mma.cuh), K/V tiles
// through shared memory by cp.async, dS in f32 registers.  (The dk/dv
// kernel of the family is flash_attention_bwd_dkv_mma.cuh.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dq_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// those head dims: the wgmma kernel's shared-memory layout and descriptors
// assume 128-byte swizzled rows of 64 16-bit elements.  The Pallas kernel
// takes any D and the input's dtype.  Same function:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dQ = dS K
// with dS rounded to the input type before its product (the TPU kernel's
// ds.astype(k.dtype); f32 keeps it, split into tf32 hi and lo), f32 sums,
// and dq written in the input type.
// `scale` is the caller's (the real head_dim^-1/2 when the wrapper
// zero-pads a narrower head_dim up to one of these).
//
// What bounds it on an H100: 6 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v, dO and dq, so the bytes bound it up to S of about
// a thousand (causal, the tensor cores' 989 TFLOP/s against 3.35 TB/s) and
// the tensor cores past that; at the `tiny` models' shapes (S <= 128) one
// launch is launch latency.
//
// Design (the family's forward's, simple and correct first):
// - One CTA of 4 warps per (batch * q-head, 64-row q tile); each warp owns
//   16 q rows.  Up to D = 128 (16-bit) Q and dO stay in registers as the
//   A fragments of m16n8k16.  At D = 256 the 16 x 256 f32 dq accumulator
//   is 128 registers a thread, and Q's and dO's fragments (128 more) would
//   spill: both go into shared memory with the first K/V tile, and each
//   k-step's A fragments are read from there.  f32 always takes that
//   route (the tf32 hi and lo parts of Q and dO are 2 D registers).
//   Each thread keeps its two rows' -lse log2 e (-inf past S) and delta
//   (0 past S) for the sweep.
// - K and V tiles of kBlockN rows (64; 32 at D = 256, which keeps S and dP
//   at 16 registers each; in f32 32 from D = 80 and 16 at D = 256, which
//   keeps the stages and Q/dO within 227 KB) go through two shared-memory
//   stages filled by cp.async (rows past S zero-filled), rows padded by 8
//   16-bit or 4 f32 elements (sm80_mma.cuh); dynamic shared memory (52 KB
//   at D = 96, 132 KB at D = 256 in bf16; 30-195 KB in f32).  GQA: the
//   CTA reads kv head h / (Hq / Hkv).
// - Per tile: S = Q K^T and dP = dO V^T (kBlockN / 8 n-tiles of 8 keys,
//   k-steps outer); P = 2^(S scale log2 e - lse log2 e); dS = P (dP -
//   delta) scale, rounded to the input type in registers, is the A
//   fragment of dQ += dS K as it stands (the forward's reuse of P, in the
//   permuted k order for tf32); K's B fragments are two shared loads
//   each.  In f32 each n8 tile of dQ takes a K/V tile's products in a sum
//   of its own, added in f32 (sm80::mma_sum_f32: the tensor core's
//   accumulation rounds toward zero, which over S keys would bias dQ).
// - Masking, explicit and only where needed: on the causal tiles that
//   cross the diagonal (key > row) and on the ragged tile (keys past S:
//   zero-filled K rows would give P = exp(-lse) != 0) P is set to 0, never
//   formed from -1e30 and an infinite lse.  Causal tiles wholly after the
//   q tile's last row are skipped (the TPU kernel's diag_ok).  Rows past S
//   are not stored.
// - Each dq element is summed by one thread in a fixed order, with no
//   atomics: dq is bit-reproducible run to run.

#pragma once

#include <math.h>

#include "sm80_mma.cuh"

namespace flash_mma {

constexpr int kDqBlockM = 64;  // q rows per CTA: 4 warps x 16
constexpr int kDqThreads = 128;
constexpr int kDqStages = 2;

// The dq kernel's tiles at element type T and head dim D.
template <typename T, int D>
struct DqCfg {
  static constexpr bool kF32 = sm80::kIsF32<T>;
  // k/v rows per tile
  static constexpr int kBlockN =
      kF32 ? (D > 128 ? 16 : D > 64 ? 32 : 64) : (D > 128 ? 32 : 64);
  static constexpr bool kQdoInSmem = kF32 || D > 128;
  static constexpr int kLd = D + sm80::kPad<T>;  // shared row, in elements
  static constexpr int kKvTile = kBlockN * kLd;
  static constexpr int kSmemBytes =
      (2 * kDqStages * kKvTile + (kQdoInSmem ? 2 * kDqBlockM * kLd : 0)) *
      int(sizeof(T));
};

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads)
    fa_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dq, int hq, int hkv, int s_len,
                         float scale, int causal) {
  using Cfg = DqCfg<T, D>;
  constexpr int kBlockM = kDqBlockM;
  constexpr int kK = sm80::kStep<T>;  // k per product
  constexpr int kBlockN = Cfg::kBlockN;
  constexpr int kLd = Cfg::kLd;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);       // [stage][kBlockN * kLd]
  T* v_s = k_s + kDqStages * Cfg::kKvTile;   // [stage][kBlockN * kLd]
  T* q_s = v_s + kDqStages * Cfg::kKvTile;   // [kBlockM * kLd] (D = 256)
  T* do_s = q_s + kBlockM * kLd;             // [kBlockM * kLd] (D = 256)

  const int bh = blockIdx.x;                      // b * hq + h
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int b = bh / hq;
  const int bkv = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = q_tile * kBlockM;
  const int n_tiles_all = (s_len + kBlockN - 1) / kBlockN;
  // Causal: the key tiles up to the q tile's last row.
  const int n_tiles =
      causal ? min(n_tiles_all, (q0 + kBlockM + kBlockN - 1) / kBlockN)
             : n_tiles_all;
  const T* q_head = q + size_t(bh) * s_len * D;
  const T* do_head = dout + size_t(bh) * s_len * D;
  const T* k_head = k + size_t(bkv) * s_len * D;
  const T* v_head = v + size_t(bkv) * s_len * D;

  // Q and dO (at D = 256) join the first K/V tile's commit group.
  if constexpr (Cfg::kQdoInSmem) {
    sm80::load_rows<D, kBlockM, kDqThreads>(q_s, q_head, q0, s_len);
    sm80::load_rows<D, kBlockM, kDqThreads>(do_s, do_head, q0, s_len);
  }
  auto load_tile = [&](int t) {
    const int st = t % kDqStages;
    sm80::load_tile_pair<D, kBlockN, kDqThreads>(
        k_s + st * Cfg::kKvTile, v_s + st * Cfg::kKvTile, k_head, v_head,
        t * kBlockN, s_len);
  };
  load_tile(0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row in the fragment
  const int quad = lane % 4;  // column pair in the fragment
  const int row_base = q0 + warp * 16 + g;
  const int rows[2] = {row_base, row_base + 8};

  // Q and dO as the A fragments of S = Q K^T and dP = dO V^T (16-bit up to
  // D = 128; at D = 256 and in f32 they are read from q_s and do_s per
  // k-step).
  constexpr int kFrags = Cfg::kQdoInSmem ? 1 : D / 16;
  uint32_t q_frag[kFrags][4], do_frag[kFrags][4];
  if constexpr (!Cfg::kQdoInSmem) {
    sm80::load_a_rows<D>(q_frag, q_head, rows, quad, s_len);
    sm80::load_a_rows<D>(do_frag, do_head, rows, quad, s_len);
  }
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
    const T* ks = k_s + (t % kDqStages) * Cfg::kKvTile;
    const T* vs = v_s + (t % kDqStages) * Cfg::kKvTile;

    // S = Q K^T and dP = dO V^T over this tile's keys: register
    // 4 j + 2 i + e holds row rows[i], key t * kBlockN + 8 j + 2 quad + e.
    float s[kBlockN / 2], dp[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / kK; ++kk) {
      sm80::FragA<T> a_q, a_do;
      if constexpr (Cfg::kQdoInSmem) {
        sm80::load_a(a_q, q_s, kLd, warp * 16, kk, g, quad);
        sm80::load_a(a_do, do_s, kLd, warp * 16, kk, g, quad);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a_q.r[r] = q_frag[kk][r];
          a_do.r[r] = do_frag[kk][r];
        }
      }
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        sm80::FragB<T> b_k, b_v;
        sm80::load_b_row(b_k, ks + (8 * j + g) * kLd, kk, quad);
        sm80::load_b_row(b_v, vs + (8 * j + g) * kLd, kk, quad);
        sm80::mma(s, 4 * j, a_q, b_k);
        sm80::mma(dp, 4 * j, a_do, b_v);
      }
    }

    // dS = P (dP - delta) scale, in place of S.
    const bool mask = (causal && (t + 1) * kBlockN > q0 + 1) ||
                      (t + 1) * kBlockN > s_len;
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

    // dQ += dS K: k-step kk covers keys kK kk .. kK kk + kK - 1 of the
    // tile; n8 tile n covers columns 8 n .. 8 n + 7 of D.
    if constexpr (Cfg::kF32) {
      sm80::mma_sum_f32<kBlockN / kK>(dq_acc, s, ks, kLd, g, quad);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBlockN / kK; ++kk) {
        sm80::FragA<T> ds_frag;
        sm80::a_from_acc(ds_frag, s, kk);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          sm80::FragB<T> b;
          sm80::load_b_col(b, ks, kLd, kk, 8 * n + g, quad);
          sm80::mma(dq_acc, 4 * n, ds_frag, b);
        }
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
      sm80::store2(dq_row + 8 * n, dq_acc[4 * n + 2 * i],
                   dq_acc[4 * n + 2 * i + 1]);
  }
}

template <typename T, int D>
cudaError_t launch_dq_typed(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int b, int hq,
                            int hkv, int s_len, float scale, int causal,
                            cudaStream_t stream) {
  constexpr int smem = DqCfg<T, D>::kSmemBytes;
  cudaError_t err = sm80::allow_smem(fa_bwd_dq_mma_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + kDqBlockM - 1) / kDqBlockM);
  fa_bwd_dq_mma_kernel<T, D><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), hq, hkv, s_len, scale, causal);
  return cudaGetLastError();
}

// One launch at head dim D; dtype 0 = bf16, 1 = fp16.
template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, int hq, int hkv, int s_len, int dtype,
                      float scale, int causal, cudaStream_t stream) {
  if (dtype == 0)
    return launch_dq_typed<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dq,
                                             b, hq, hkv, s_len, scale,
                                             causal, stream);
  if (dtype == 1)
    return launch_dq_typed<__half, D>(q, k, v, dout, lse, delta, dq, b, hq,
                                      hkv, s_len, scale, causal, stream);
  return cudaErrorInvalidValue;
}

// The C entries' argument check: the grid's y dimension holds the q tiles.
inline bool dq_args_ok(int b, int hq, int hkv, int s_len) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && s_len > 0 &&
         s_len <= 65535 * kDqBlockM;
}

// The f32 dq kernel at head dim 80, 96 or 256 (cudaErrorInvalidValue at
// any other), compiled in flash_attention_bwd_dq_f32_wide.cu.
cudaError_t launch_dq_f32_wide(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int hq,
                               int hkv, int s_len, int head_dim, float scale,
                               int causal, cudaStream_t stream);

}  // namespace flash_mma
