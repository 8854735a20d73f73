// Flash-attention forward in mma.sync on Hopper (sm_90a), where the wgmma
// kernels (flash_attention_fwd.cu: bf16/fp16 at D = 64 and 128;
// flash_attention_fwd_256.cu: at D = 256) do not reach: bf16/fp16 at D =
// 16 and 32 (instantiated in flash_attention_fwd_small.cu) and at D = 80
// and 96 (flash_attention_fwd_wide.cu), and f32 at D = 16, 32, 64 and 128
// (flash_attention_fwd_f32.cu) and 80, 96 and 256
// (flash_attention_fwd_f32_wide.cu).  m16n8k16 products (bf16/fp16) or
// m16n8k8 tf32 products taken three times (3xTF32, f32 class: see
// sm80_mma.cuh), K/V tiles through shared memory by cp.async, the online
// softmax in f32 registers.
//
// Replaces the Pallas TPU kernel `_fa_kernel`, driven by
// `flash_attention_fwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// those head dims: the wgmma kernel's shared-memory layout and descriptors
// assume 128-byte swizzled rows of 64 elements, and a 16-, 32-, 80- or
// 96-wide bf16 row is 32, 64, 160 or 192 bytes, and wgmma takes tf32 only
// with both operands K-major (P V would need V transposed in shared
// memory).  The Pallas kernel takes any D and the input's dtype (bf16,
// fp16 or f32: out in q's dtype, P cast to v's); the `tiny` configs have
// D = 16, Phi-2's widths D = 80, Phi-3-mini's 96 and Gemma's 256 (here in
// f32 only).  Same
// function: softmax(Q K^T * scale) V, causal or not, GQA, -1e30 masking,
// causal tiles above the diagonal skipped, rows whose denominator is 0
// emitting 0 and lse +inf, the row logsumexp in natural log units when
// lse is not null.  `scale` is the
// caller's (the wrapper passes the real head_dim^-1/2 when it zero-pads a
// narrower head_dim up to one of these).
//
// What bounds it on an H100: 4 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v and out, S / 4 flops a byte when causal, so the bytes
// bound it up to S of about 1200 (989 TFLOP/s against 3.35 TB/s) and the
// tensor cores past that; at the `tiny` models' shapes (S <= 128) one
// launch is launch latency.  In f32 the rows are 4 D bytes and the peak
// is TF32's 495 TFLOP/s, with three products where the bound counts one.
//
// Design (simple, correct first):
// - One CTA of 4 warps per (batch * q-head, 64-row q tile); each warp owns
//   16 q rows.  In 16 bits Q stays in registers as the A fragments of
//   m16n8k16 (D/16 k-steps, read once from global memory).  In f32 Q goes
//   into shared memory with the first K/V tile and each k-step's A
//   fragment is read from there: Q's tf32 hi and lo parts are D
//   registers, split from shared memory per k-step instead (at D = 256
//   the 16 x 256 f32 output accumulator alone is 128 registers a thread).
// - K and V tiles of kBlockN rows (64; in f32 32 from D = 80 and 16 at
//   D = 256, stages of 20-68 KB) go through two
//   shared-memory stages filled by cp.async (16 bytes a thread and copy;
//   rows past S zero-filled), so tile t + 1 loads while tile t computes.
//   Rows are padded by 8 16-bit elements or 4 f32 ones (sm80_mma.cuh),
//   which makes both the K fragment reads (one 32-bit word per row) and
//   the V column reads conflict-free.  The stages (and Q) are dynamic
//   shared memory: 52 KB at D = 96 (bf16); 25-130 KB in f32; past the
//   48 KB a launch gets unasked.
// - S = Q K^T by mma.sync, kBlockN / 8 n-tiles of 8 keys, k-steps outer so
//   each A fragment is formed once; the online softmax on the accumulator
//   as the wgmma kernel's softmax_tile (2^x with log2 e folded into the
//   scale, the row max over the 4 lanes of a quad by two xor-shuffles,
//   the row sum reduced once at the end).
// - P is rounded to the input type in registers (the TPU kernel's
//   p.astype(v.dtype); in f32, split into tf32 hi and lo) and is the A
//   fragment of O += P V as it stands (16-bit: the accumulator layout of
//   two n8 tiles is the A layout of one k16 step; tf32: one n8 tile in a
//   permuted k order, matched by the rows V's B fragment reads); V's B
//   fragments are two 16-bit shared loads each, or two f32 ones.  In f32
//   each n8 tile of O takes a K/V tile's products in a sum of its own,
//   added in f32 (sm80::mma_sum_f32: the tensor core's accumulation
//   rounds toward zero, which over S keys would bias O).
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

// The forward's tiles at element type T and head dim D.
template <typename T, int D>
struct FwdCfg {
  static constexpr bool kF32 = sm80::kIsF32<T>;
  // kv rows per tile
  static constexpr int kBlockN =
      kF32 ? (D > 128 ? 16 : D > 64 ? 32 : 64) : 64;
  static constexpr bool kQInSmem = kF32;
  static constexpr int kLd = D + sm80::kPad<T>;  // shared row, in elements
  static constexpr int kKvTile = kBlockN * kLd;
  static constexpr int kSmemBytes =
      (2 * kFwdStages * kKvTile + (kQInSmem ? kFwdBlockM * kLd : 0)) *
      int(sizeof(T));
};

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
    fa_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int hq, int hkv, int s_len,
                      float scale_log2, int causal) {
  using Cfg = FwdCfg<T, D>;
  constexpr int kBlockM = kFwdBlockM;
  constexpr int kK = sm80::kStep<T>;  // k per product
  constexpr int kBlockN = Cfg::kBlockN;
  constexpr int kLd = Cfg::kLd;
  constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);           // [stage][kBlockN * kLd]
  T* v_s = k_s + kFwdStages * Cfg::kKvTile;      // [stage][kBlockN * kLd]
  T* q_s = v_s + kFwdStages * Cfg::kKvTile;      // [kBlockM * kLd] (f32)

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

  // Q (f32) joins the first K/V tile's commit group.
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

  // Q as the A fragments of the D / 16 k-steps of S = Q K^T (16-bit; in
  // f32 they are read from q_s per k-step).
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
    for (int kk = 0; kk < D / kK; ++kk) {
      sm80::FragA<T> a;
      if constexpr (Cfg::kQInSmem) {
        sm80::load_a(a, q_s, kLd, warp * 16, kk, g, quad);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) a.r[r] = q_frag[kk][r];
      }
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        sm80::FragB<T> b;
        sm80::load_b_row(b, ks + (8 * j + g) * kLd, kk, quad);
        sm80::mma(s, 4 * j, a, b);
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

    // O += P V: k-step kk covers keys kK kk .. kK kk + kK - 1 of the
    // tile; n8 tile n covers columns 8 n .. 8 n + 7 of D.
    if constexpr (Cfg::kF32) {
      sm80::mma_sum_f32<kBlockN / kK>(o_acc, s, vs, kLd, g, quad);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBlockN / kK; ++kk) {
        sm80::FragA<T> p_frag;
        sm80::a_from_acc(p_frag, s, kk);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          sm80::FragB<T> b;
          sm80::load_b_col(b, vs, kLd, kk, 8 * n + g, quad);
          sm80::mma(o_acc, 4 * n, p_frag, b);
        }
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
      sm80::store2(o_row + 8 * n, o_acc[4 * n + 2 * i] * inv[i],
                   o_acc[4 * n + 2 * i + 1] * inv[i]);
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
  constexpr int smem = FwdCfg<T, D>::kSmemBytes;
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

// The f32 forward at head dim 80, 96 or 256 (cudaErrorInvalidValue at any
// other), compiled in flash_attention_fwd_f32_wide.cu so that nvcc builds
// it beside flash_attention_fwd_f32.cu.
cudaError_t launch_fwd_f32_wide(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int hq, int hkv,
                                int s_len, int head_dim, float scale,
                                int causal, cudaStream_t stream);

}  // namespace flash_mma
