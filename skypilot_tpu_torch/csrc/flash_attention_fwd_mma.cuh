// Flash-attention forward in mma.sync on Hopper (sm_90a), at the head dims
// the wgmma kernel (flash_attention_fwd.cu, D = 64 and 128) does not take:
// D = 16 and 32 (instantiated in flash_attention_fwd_small.cu) and D = 80,
// 96 and 256 (flash_attention_fwd_wide.cu).  m16n8k16 products, K/V tiles
// through shared memory by cp.async, the online softmax in f32 registers.
//
// Replaces the Pallas TPU kernel `_fa_kernel`, driven by
// `flash_attention_fwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// those head dims: the wgmma kernel's shared-memory layout and descriptors
// assume 128-byte swizzled rows of 64 elements, and a 16-, 32-, 80-, 96- or
// 256-wide bf16 row is 32, 64, 160, 192 or 512 bytes.  The Pallas kernel
// takes any D; the `tiny` configs have D = 16, Phi-2's widths D = 80,
// Phi-3-mini's 96 and Gemma's 256.  Same function: softmax(Q K^T * scale) V,
// causal or not, GQA, -1e30 masking, causal tiles above the diagonal
// skipped, rows whose denominator is 0 emitting 0 and lse +inf, the row
// logsumexp in natural log units when lse is not null.  `scale` is the
// caller's (the wrapper passes the real head_dim^-1/2 when it zero-pads a
// narrower head_dim up to one of these).
//
// What bounds it on an H100: 4 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v and out, S / 4 flops a byte when causal, so the bytes
// bound it up to S of about 1200 (989 TFLOP/s against 3.35 TB/s) and the
// tensor cores past that; at the `tiny` models' shapes (S <= 128) one
// launch is launch latency.
//
// Design (simple, correct first):
// - One CTA of 4 warps per (batch * q-head, 64-row q tile); each warp owns
//   16 q rows.  Up to D = 128 Q stays in registers as the A fragments of
//   m16n8k16 (D/16 k-steps, read once from global memory).  At D = 256
//   the 16 x 256 f32 output accumulator alone is 128 registers a thread,
//   so Q's fragments (64 more) would spill: Q goes into shared memory with
//   the first K/V tile and each k-step's A fragment is read from there.
// - K and V tiles of kBlockN rows (64; 32 at D = 256, which keeps the S
//   tile at 16 registers and the two stages at 66 KB) go through two
//   shared-memory stages filled by cp.async (16 bytes a thread and copy;
//   rows past S zero-filled), so tile t + 1 loads while tile t computes.
//   Rows are padded by 8 elements (sm80_mma.cuh), which makes both the K
//   fragment reads (one 32-bit word per row) and the V column reads
//   conflict-free.  The stages (and Q) are dynamic shared memory: 52 KB at
//   D = 96, 99 KB at D = 256, past the 48 KB a launch gets unasked.
// - S = Q K^T by m16n8k16, kBlockN / 8 n-tiles of 8 keys, k-steps outer so
//   each A fragment is formed once; the online softmax on the accumulator
//   as the wgmma kernel's softmax_tile (2^x with log2 e folded into the
//   scale, the row max over the 4 lanes of a quad by two xor-shuffles,
//   the row sum reduced once at the end).
// - P is rounded to the input type in registers (the TPU kernel's
//   p.astype(v.dtype)) and is the A fragment of O += P V as it stands
//   (the accumulator layout of two n8 tiles is the A layout of one k16
//   step); V's B fragments are two 16-bit shared loads each.
// - Causal: tiles wholly above the diagonal are skipped; only the tiles
//   that cross it and the ragged tile past S are masked element by
//   element.
// The mma.sync, cp.async and fragment helpers, shared with the backward
// kernels of the same family (flash_attention_bwd_{dq,dkv}_mma.cuh), are
// in sm80_mma.cuh.

#pragma once

#include <math.h>

#include "sm80_mma.cuh"

namespace flash_mma {

constexpr int kFwdBlockM = 64;  // q rows per CTA: 4 warps x 16
constexpr int kFwdThreads = 128;
constexpr int kFwdStages = 2;

// The forward's tiles at head dim D.
template <int D>
struct FwdCfg {
  static constexpr int kBlockN = D > 128 ? 32 : 64;  // kv rows per tile
  static constexpr bool kQInSmem = D > 128;
  static constexpr int kLd = D + sm80::kPad;  // shared row, in elements
  static constexpr int kKvTile = kBlockN * kLd;
  static constexpr int kSmemBytes =
      (2 * kFwdStages * kKvTile + (kQInSmem ? kFwdBlockM * kLd : 0)) * 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
    fa_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int hq, int hkv, int s_len,
                      float scale_log2, int causal) {
  using Cfg = FwdCfg<D>;
  constexpr int kBlockM = kFwdBlockM;
  constexpr int kBlockN = Cfg::kBlockN;
  constexpr int kLd = Cfg::kLd;
  constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);           // [stage][kBlockN * kLd]
  T* v_s = k_s + kFwdStages * Cfg::kKvTile;      // [stage][kBlockN * kLd]
  T* q_s = v_s + kFwdStages * Cfg::kKvTile;      // [kBlockM * kLd] (D = 256)

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
  const T* k_head = k + size_t(bkv) * s_len * D;
  const T* v_head = v + size_t(bkv) * s_len * D;

  // Q (at D = 256) joins the first K/V tile's commit group.
  if constexpr (Cfg::kQInSmem)
    sm80::load_rows<D, kBlockM, kFwdThreads>(q_s, q_head, q0, s_len);
  auto load_tile = [&](int t) {
    const int st = t % kFwdStages;
    sm80::load_tile_pair<D, kBlockN, kFwdThreads>(
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

  // Q as the A fragments of the D / 16 k-steps of S = Q K^T (up to
  // D = 128; at D = 256 they are read from q_s per k-step).
  uint32_t q_frag[Cfg::kQInSmem ? 1 : D / 16][4];
  if constexpr (!Cfg::kQInSmem)
    sm80::load_a_rows<D>(q_frag, q_head, rows, quad, s_len);

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      sm80::cp_async_wait<1>();
    } else {
      sm80::cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_s + (t % kFwdStages) * Cfg::kKvTile;
    const T* vs = v_s + (t % kFwdStages) * Cfg::kKvTile;

    // S = Q K^T over this tile's keys: register 4 j + 2 i + e holds row
    // rows[i], key t * kBlockN + 8 j + 2 quad + e.
    float s[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Cfg::kQInSmem) {
        sm80::load_a_smem(a, q_s, kLd, warp * 16, kk, g, quad);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = q_frag[kk][r];
      }
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const T* k_row = ks + (8 * j + g) * kLd + 16 * kk + 2 * quad;
        sm80::mma16816<T>(s, 4 * j, a, sm80::load_u32(k_row),
                          sm80::load_u32(k_row + 8));
      }
    }

    // Online softmax (the wgmma kernel's softmax_tile on kBlockN keys).
    const bool mask = (causal && (t + 1) * kBlockN > q0 + 1) ||
                      (t + 1) * kBlockN > s_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          if (mask) {
            const int col = t * kBlockN + 8 * j + 2 * quad + e;
            if (col >= s_len || (causal && col > rows[i])) x = kNegInf;
          }
          mx[i] = fmaxf(mx[i], x);
        }
    float neg_m[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      corr[i] = sm90::ex2(m[i] - m_new);
      m[i] = m_new;
      neg_m[i] = -m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = sm90::ex2(fmaf(x, scale_log2, neg_m[i]));
          l[i] += x;
        }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o_acc[4 * n + 2 * i] *= corr[i];
        o_acc[4 * n + 2 * i + 1] *= corr[i];
      }

    // O += P V: k16 step kk covers keys 16 kk .. 16 kk + 15 of the tile;
    // n8 tile n covers columns 8 n .. 8 n + 7 of D.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t p_frag[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p_frag[r] =
            sm90::pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      const T* v_k = vs + (16 * kk + 2 * quad) * kLd + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* v_col = v_k + 8 * n;
        sm80::mma16816<T>(o_acc, 4 * n, p_frag,
                          sm80::pack_u16(v_col, v_col + kLd),
                          sm80::pack_u16(v_col + 8 * kLd, v_col + 9 * kLd));
      }
    }
    // The next iteration's cp.async overwrites this stage.
    __syncthreads();
  }

  // Epilogue: out = acc / l (0 where l == 0), lse = m + log l.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= s_len) continue;
    T* o_row = o + (size_t(bh) * s_len + rows[i]) * D + 2 * quad;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o_row + 8 * n) = sm90::pack2<T>(
          o_acc[4 * n + 2 * i] * inv[i], o_acc[4 * n + 2 * i + 1] * inv[i]);
    if (lse != nullptr && quad == 0)
      lse[size_t(bh) * s_len + rows[i]] =
          l[i] == 0.f ? INFINITY : (m[i] + log2f(l[i])) * kLn2;
  }
}

template <typename T, int D>
cudaError_t launch_fwd_typed(const void* q, const void* k, const void* v,
                             void* o, void* lse, int b, int hq, int hkv,
                             int s_len, float scale, int causal,
                             cudaStream_t stream) {
  constexpr int smem = FwdCfg<D>::kSmemBytes;
  cudaError_t err = sm80::allow_smem(fa_fwd_mma_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + kFwdBlockM - 1) / kFwdBlockM);
  fa_fwd_mma_kernel<T, D><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, s_len, scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

// One launch at head dim D; dtype 0 = bf16, 1 = fp16.
template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int b, int hq, int hkv, int s_len,
                       int dtype, float scale, int causal,
                       cudaStream_t stream) {
  if (dtype == 0)
    return launch_fwd_typed<__nv_bfloat16, D>(q, k, v, o, lse, b, hq, hkv,
                                              s_len, scale, causal, stream);
  if (dtype == 1)
    return launch_fwd_typed<__half, D>(q, k, v, o, lse, b, hq, hkv, s_len,
                                       scale, causal, stream);
  return cudaErrorInvalidValue;
}

// The C entries' argument check: the grid's y dimension holds the q tiles.
inline bool fwd_args_ok(int b, int hq, int hkv, int s_len) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && s_len > 0 &&
         s_len <= 65535 * kFwdBlockM;
}

}  // namespace flash_mma
