// Flash-attention backward, dk/dv kernel, in mma.sync on Hopper (sm_90a),
// where the wgmma kernels (flash_attention_bwd_dkv.cu: bf16/fp16 at D = 64
// and 128; flash_attention_bwd_dkv_256.cu at 256) do not reach: bf16/fp16
// at D = 16 and 32 (instantiated in flash_attention_bwd_dkv_small.cu) and
// D = 80 and 96 (flash_attention_bwd_dkv_wide.cu), and f32 at D = 16, 32, 64 and 128
// (flash_attention_bwd_dkv_f32.cu) and 80, 96 and 256
// (flash_attention_bwd_dkv_f32_wide.cu).  m16n8k16 products, or m16n8k8
// tf32 ones taken three times for f32 (3xTF32, sm80_mma.cuh), Q/dO tiles
// through shared memory by cp.async, P^T and dS^T in f32 registers.  (The
// dq kernel of the family is flash_attention_bwd_dq_mma.cuh.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dkv_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// those head dims and dtypes (the wgmma kernel's layout assumes 128-byte
// rows of 64 16-bit elements).  Same function:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dV = P^T dO,   dK = dS^T Q
// with P and dS rounded to the input type before their products (the TPU
// kernel's p.astype(do.dtype), ds.astype(q.dtype); f32 keeps them, split
// into tf32 hi and lo), f32 sums, and dk/dv
// summed over each kv head's group of query heads.  `scale` is the
// caller's (the real head_dim^-1/2 when the wrapper zero-pads a narrower
// head_dim up to one of these).
//
// What bounds it on an H100: 8 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v, dO, dk and dv, so the bytes bound it up to S of
// about a thousand (causal) and the tensor cores past that; at the `tiny`
// models' shapes one launch is launch latency.
//
// Design (the family's forward's, simple and correct first):
// - One CTA of 4 warps per (batch * kv-head, 64-row k tile); each warp
//   owns 16 k rows.  At D = 16 and 32 K and V stay in registers as the A
//   fragments of m16n8k16.  From D = 80 up, the two f32 accumulators (dK
//   and dV: D registers a thread), K's and V's fragments (D / 2) and S^T,
//   dP^T (64) leave too little of 255 registers for the rest (208 at
//   D = 96 before any address or temporary), so K and V go into shared
//   memory with the first Q/dO tile and each k-step's A fragments are
//   read from there.  f32 always keeps K and V in shared memory (their
//   tf32 hi and lo parts would be 2 D registers).
// - At D = 256 the two 16 x 256 f32 accumulators alone are 256 registers a
//   thread, more than a thread has.  The kernel is split: the grid's z
//   dimension is 2, the CTAs of z = 0 compute dV = P^T dO only, those of
//   z = 1 dK = dS^T Q only (each one 128-register accumulator; z = 0 skips
//   dO V^T).  Both recompute S^T = K Q^T: 10 D flops per (q, k) pair in
//   place of 8, and Q and dO are read twice.  (The other ways out, 8 warps
//   splitting D or a 32-row K/V tile with two warps per 16 rows, also
//   recompute S^T and add a cross-warp reduction; this one keeps the
//   kernel's code the same at every D.)  The q tiles are 32 rows at
//   D = 256 (S^T and dP^T at 16 registers each).  f32 splits from D = 128
//   (the 3xTF32 operands' hi and lo parts leave too few registers for two
//   16 x 128 accumulators), with q tiles of 32 rows from D = 64 and 16 at
//   D = 256 (so K, V and the two stages fit in 227 KB, and P^T's and
//   dS^T's A fragments of a whole tile fit beside the accumulators).
// - The CTA loops over the Hq / Hkv query heads of its kv head and over
//   the q tiles (when causal, from the diagonal down), so the GQA sum
//   happens in the f32 accumulators: no atomics, no [B, Hq, S, D]
//   temporary, and dk/dv are bit-reproducible run to run.  Q and dO
//   tiles go through two shared-memory stages filled by cp.async (rows
//   past S zero-filled), rows padded by 8 elements (sm80_mma.cuh); the
//   tile's lse (times log2 e; +inf past S) and delta (0 past S) are staged
//   beside them by plain loads.  Dynamic shared memory: 79 KB at D = 96,
//   133 KB at D = 256 (bf16); 31-195 KB in f32.
// - Per tile: S^T = K Q^T and dP^T = V dO^T (kBlockM / 8 n-tiles of 8 q
//   rows each, k-steps outer); P^T = 2^(S^T scale log2 e - lse log2 e)
//   and dS^T = P^T (dP^T - delta) scale with lse and delta per column,
//   read from the stage.  Rounded to the input type in registers they are
//   the A fragments of dV += P^T dO and dK += dS^T Q as they stand (in the
//   permuted k order for tf32); dO's and Q's B fragments are two shared
//   loads each.  In f32 each n8 tile of dV and dK takes a q tile's
//   products in a sum of its own, added in f32 (sm80::mma_sum_f32: the
//   tensor core's accumulation rounds toward zero, which over a GQA
//   group's S query rows would bias dK and dV).
// - Masking, explicit and only where needed: on the causal tiles that
//   cross the diagonal (q < k), the ragged q tile (q rows past S) and the
//   ragged k tile (k rows past S) P^T is set to 0, never formed from -1e30
//   and an infinite lse.  Causal q tiles wholly before the k tile's first
//   row are skipped (the TPU kernel's diag_ok).  Rows past S are not
//   stored.
// - Heaviest k tiles first: block y is the k tile, and the causal k tile
//   0 has the most q tiles.

#pragma once

#include <math.h>

#include "sm80_mma.cuh"

namespace flash_mma {

constexpr int kDkvBlockN = 64;  // k rows per CTA: 4 warps x 16
constexpr int kDkvThreads = 128;
constexpr int kDkvStages = 2;

// The dk/dv kernel's tiles at element type T and head dim D.
template <typename T, int D>
struct DkvCfg {
  static constexpr bool kF32 = sm80::kIsF32<T>;
  static constexpr int kBytes = int(sizeof(T));
  // q rows per tile
  static constexpr int kBlockM =
      kF32 ? (D > 128 ? 16 : D > 32 ? 32 : 64) : (D > 128 ? 32 : 64);
  static constexpr bool kKvInSmem = kF32 || D > 64;
  // dV (z = 0) and dK (z = 1)
  static constexpr bool kSplit = kF32 ? D >= 128 : D > 128;
  static constexpr int kLd = D + sm80::kPad<T>;  // shared row, in elements
  static constexpr int kQTile = kBlockM * kLd;
  static constexpr int kStageBytes = 2 * kQTile * kBytes + 2 * kBlockM * 4;
  static constexpr int kSmemBytes =
      kDkvStages * kStageBytes +
      (kKvInSmem ? 2 * kDkvBlockN * kLd * kBytes : 0);
};

template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads)
    fa_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int hq,
                          int hkv, int s_len, float scale, int causal) {
  using Cfg = DkvCfg<T, D>;
  constexpr int kBlockN = kDkvBlockN;
  constexpr int kBlockM = Cfg::kBlockM;
  constexpr int kK = sm80::kStep<T>;  // k per product
  constexpr int kLd = Cfg::kLd;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);         // [stage][kBlockM * kLd]
  T* do_s = q_s + kDkvStages * Cfg::kQTile;    // [stage][kBlockM * kLd]
  T* k_s = do_s + kDkvStages * Cfg::kQTile;    // [kBlockN * kLd] (D >= 80)
  T* v_s = k_s + kBlockN * kLd;                // [kBlockN * kLd] (D >= 80)
  float* lse_s = reinterpret_cast<float*>(
      smem + 2 * kDkvStages * Cfg::kQTile * Cfg::kBytes +
      (Cfg::kKvInSmem ? 2 * kBlockN * kLd * Cfg::kBytes : 0));
  // lse_s, delta_s: [stage][kBlockM]
  float* delta_s = lse_s + kDkvStages * kBlockM;     // [stage][kBlockM]

  const int bkv = blockIdx.x;  // b * hkv + kv head
  const int k_tile = blockIdx.y;
  // The split kernel's part (D = 256): z = 0 computes dV, z = 1 dK.
  const bool want_dv = !Cfg::kSplit || blockIdx.z == 0;
  const bool want_dk = !Cfg::kSplit || blockIdx.z == 1;
  const int b = bkv / hkv;
  const int group = hq / hkv;
  const int bh0 = b * hq + (bkv - b * hkv) * group;  // the group's first
  const int k0 = k_tile * kBlockN;
  const int q_first = causal ? k0 / kBlockM : 0;
  const int n_q = (s_len + kBlockM - 1) / kBlockM - q_first;
  const int n_items = group * n_q;  // (query head, q tile) pairs
  const T* k_head = k + size_t(bkv) * s_len * D;
  const T* v_head = v + size_t(bkv) * s_len * D;

  // K and V (from D = 80) in one commit group ahead of the first item's.
  if constexpr (Cfg::kKvInSmem)
    sm80::load_tile_pair<D, kBlockN, kDkvThreads>(k_s, v_s, k_head, v_head,
                                                  k0, s_len);
  auto load_item = [&](int it) {
    const int st = it % kDkvStages;
    const int bh = bh0 + it / n_q;
    const int row0 = (q_first + it % n_q) * kBlockM;
    const size_t head = size_t(bh) * s_len * D;
    sm80::load_tile_pair<D, kBlockM, kDkvThreads>(
        q_s + st * Cfg::kQTile, do_s + st * Cfg::kQTile, q + head,
        dout + head, row0, s_len);
    // The stage was last read before the previous iteration's closing
    // barrier; the next iteration's barrier publishes these stores.
    if (threadIdx.x < kBlockM) {
      const int row = row0 + threadIdx.x;
      const bool in_seq = row < s_len;
      const size_t at = size_t(bh) * s_len + row;
      lse_s[st * kBlockM + threadIdx.x] = in_seq ? lse[at] * kLog2e
                                                 : INFINITY;
      delta_s[st * kBlockM + threadIdx.x] = in_seq ? delta[at] : 0.f;
    }
  };
  load_item(0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row in the fragment
  const int quad = lane % 4;  // column pair in the fragment
  const int row_base = k0 + warp * 16 + g;
  const int rows[2] = {row_base, row_base + 8};  // this thread's k rows

  // K and V as the A fragments of S^T = K Q^T and dP^T = V dO^T (16-bit at
  // D = 16 and 32; from D = 80 and in f32 they are read from k_s and v_s
  // per k-step).
  constexpr int kFrags = Cfg::kKvInSmem ? 1 : D / 16;
  uint32_t k_frag[kFrags][4], v_frag[kFrags][4];
  if constexpr (!Cfg::kKvInSmem) {
    sm80::load_a_rows<D>(k_frag, k_head, rows, quad, s_len);
    sm80::load_a_rows<D>(v_frag, v_head, rows, quad, s_len);
  }
  const float scale_log2 = scale * kLog2e;
  const bool k_ragged = k0 + kBlockN > s_len;

  // dV and dK; the split kernel's one accumulator is dV at z = 0 and dK at
  // z = 1.
  float dv_acc[D / 2], dk_acc[Cfg::kSplit ? 1 : D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (Cfg::kSplit ? 1 : D / 2); ++i) dk_acc[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      load_item(it + 1);
      sm80::cp_async_wait<1>();
    } else {
      sm80::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it % kDkvStages;
    const int q_tile = q_first + it % n_q;
    const T* qs = q_s + st * Cfg::kQTile;
    const T* dos = do_s + st * Cfg::kQTile;

    // S^T = K Q^T and dP^T = V dO^T over this tile's q rows: register
    // 4 j + 2 i + e holds k row rows[i], q row q_tile * kBlockM + 8 j +
    // 2 quad + e.
    float s[kBlockM / 2], dp[kBlockM / 2];
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / kK; ++kk) {
      sm80::FragA<T> a_k, a_v;
      if constexpr (Cfg::kKvInSmem) {
        sm80::load_a(a_k, k_s, kLd, warp * 16, kk, g, quad);
        if (want_dk) sm80::load_a(a_v, v_s, kLd, warp * 16, kk, g, quad);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a_k.r[r] = k_frag[kk][r];
          a_v.r[r] = v_frag[kk][r];
        }
      }
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
        sm80::FragB<T> b_q;
        sm80::load_b_row(b_q, qs + (8 * j + g) * kLd, kk, quad);
        sm80::mma(s, 4 * j, a_k, b_q);
        if (want_dk) {
          sm80::FragB<T> b_do;
          sm80::load_b_row(b_do, dos + (8 * j + g) * kLd, kk, quad);
          sm80::mma(dp, 4 * j, a_v, b_do);
        }
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T.
    const bool mask = (causal && q_tile * kBlockM < k0 + kBlockN - 1) ||
                      (q_tile + 1) * kBlockM > s_len || k_ragged;
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * quad + e;
        const float lse2 = lse_s[st * kBlockM + c];
        const float delta_c = delta_s[st * kBlockM + c];
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

    // dV += P^T dO and dK += dS^T Q: k-step kk covers q rows kK kk ..
    // kK kk + kK - 1 of the tile; n8 tile n covers columns 8 n .. 8 n + 7
    // of D.
    if constexpr (Cfg::kF32 && Cfg::kSplit) {
      // The split kernel's one product: P^T dO (z = 0) or dS^T Q (z = 1).
      float a_src[kBlockM / 2];
#pragma unroll
      for (int i = 0; i < kBlockM / 2; ++i) a_src[i] = want_dv ? s[i] : dp[i];
      sm80::mma_sum_f32<kBlockM / kK>(dv_acc, a_src, want_dv ? dos : qs,
                                      kLd, g, quad);
    } else if constexpr (Cfg::kF32) {
      sm80::mma_sum_f32<kBlockM / kK>(dv_acc, s, dos, kLd, g, quad);
      sm80::mma_sum_f32<kBlockM / kK>(dk_acc, dp, qs, kLd, g, quad);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBlockM / kK; ++kk) {
        sm80::FragA<T> p_frag, ds_frag;
        sm80::a_from_acc(p_frag, s, kk);
        sm80::a_from_acc(ds_frag, dp, kk);
        if constexpr (Cfg::kSplit) {
          // One product into the one accumulator: P^T dO or dS^T Q.
          sm80::FragA<T> a;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a.r[r] = want_dv ? p_frag.r[r] : ds_frag.r[r];
          const T* b_tile = want_dv ? dos : qs;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            sm80::FragB<T> b;
            sm80::load_b_col(b, b_tile, kLd, kk, 8 * n + g, quad);
            sm80::mma(dv_acc, 4 * n, a, b);
          }
        } else {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            sm80::FragB<T> b_do, b_q;
            sm80::load_b_col(b_do, dos, kLd, kk, 8 * n + g, quad);
            sm80::load_b_col(b_q, qs, kLd, kk, 8 * n + g, quad);
            sm80::mma(dv_acc, 4 * n, p_frag, b_do);
            sm80::mma(dk_acc, 4 * n, ds_frag, b_q);
          }
        }
      }
    }
    // The next iteration's loads overwrite this stage.
    __syncthreads();
  }

  // The split kernel's accumulator goes to dV (z = 0) or dK (z = 1).
  T* out_a = want_dv ? dv : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= s_len) continue;
    const size_t at = (size_t(bkv) * s_len + rows[i]) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      sm80::store2(out_a + at + 8 * n, dv_acc[4 * n + 2 * i],
                   dv_acc[4 * n + 2 * i + 1]);
      if constexpr (!Cfg::kSplit)
        sm80::store2(dk + at + 8 * n, dk_acc[4 * n + 2 * i],
                     dk_acc[4 * n + 2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv_typed(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int b,
                             int hq, int hkv, int s_len, float scale,
                             int causal, cudaStream_t stream) {
  constexpr int smem = DkvCfg<T, D>::kSmemBytes;
  cudaError_t err = sm80::allow_smem(fa_bwd_dkv_mma_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hkv, (s_len + kDkvBlockN - 1) / kDkvBlockN,
                  DkvCfg<T, D>::kSplit ? 2 : 1);
  fa_bwd_dkv_mma_kernel<T, D><<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, s_len, scale,
      causal);
  return cudaGetLastError();
}

// One launch at head dim D; dtype 0 = bf16, 1 = fp16.
template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int hq, int hkv, int s_len,
                       int dtype, float scale, int causal,
                       cudaStream_t stream) {
  if (dtype == 0)
    return launch_dkv_typed<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dk,
                                              dv, b, hq, hkv, s_len, scale,
                                              causal, stream);
  if (dtype == 1)
    return launch_dkv_typed<__half, D>(q, k, v, dout, lse, delta, dk, dv, b,
                                       hq, hkv, s_len, scale, causal,
                                       stream);
  return cudaErrorInvalidValue;
}

// The C entries' argument check: the grid's y dimension holds the k tiles.
inline bool dkv_args_ok(int b, int hq, int hkv, int s_len) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && s_len > 0 &&
         s_len <= 65535 * kDkvBlockN;
}

// The f32 dk/dv kernel at head dim 80, 96 or 256 (cudaErrorInvalidValue at
// any other), compiled in flash_attention_bwd_dkv_f32_wide.cu.
cudaError_t launch_dkv_f32_wide(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int b,
                                int hq, int hkv, int s_len, int head_dim,
                                float scale, int causal, cudaStream_t stream);

}  // namespace flash_mma
