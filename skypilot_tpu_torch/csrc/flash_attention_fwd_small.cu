// Flash-attention forward for small head dims (D = 16, 32) on Hopper
// (sm_90a): mma.sync m16n8k16, K/V tiles through shared memory by
// cp.async, the online softmax in f32 registers.
//
// Replaces the Pallas TPU kernel `_fa_kernel`, driven by
// `flash_attention_fwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// the head dims the wgmma kernel (flash_attention_fwd.cu) does not take:
// its shared-memory layout and descriptors assume 128-byte swizzled rows
// of 64 elements, and a 16-wide bf16 row is 32 bytes.  The Pallas kernel
// takes any D, and the `tiny` configs (Llama and encoder) have D = 16.
// Same function: softmax(Q K^T * D^-1/2) V, causal or not, GQA, -1e30
// masking, causal tiles above the diagonal skipped, rows whose
// denominator is 0 emitting 0 and lse +inf, the row logsumexp in natural
// log units when lse is not null.
//
// What bounds it on an H100: 4 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v and out, so at D <= 32 the bytes bound it up to S of
// a few thousand (q, k, v read once, out written once at 3.35 TB/s); the
// shapes the `tiny` models give it (S <= 128) are a few KB, so one launch
// is launch latency.
//
// Design (simple, correct first):
// - One CTA of 4 warps per (batch * q-head, 64-row q tile); each warp owns
//   16 q rows.  Q stays in registers as the A fragments of m16n8k16 (D/16
//   k-steps, read once from global memory).
// - K and V tiles of 64 rows go through two shared-memory stages filled
//   by cp.async (16 bytes a thread and copy; rows past S zero-filled), so
//   tile t + 1 loads while tile t computes.  Rows are padded by 8
//   elements (48 or 80 bytes), which makes both the K fragment reads (one
//   32-bit word per row) and the V column reads conflict-free.
// - S = Q K^T by m16n8k16, 8 n-tiles of 8 keys; the online softmax on the
//   accumulator as the wgmma kernel's softmax_tile (2^x with log2 e folded
//   into the scale, the row max over the 4 lanes of a quad by two
//   xor-shuffles, the row sum reduced once at the end).
// - P is rounded to the input type in registers (the TPU kernel's
//   p.astype(v.dtype)) and is the A fragment of O += P V as it stands
//   (the accumulator layout of two n8 tiles is the A layout of one k16
//   step); V's B fragments are two 16-bit shared loads each.
// - Causal: tiles above the diagonal are skipped; only the diagonal and
//   the ragged tile past S are masked element by element.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows per CTA: 4 warps x 16
constexpr int kBlockN = 64;  // kv rows per tile (== kBlockM)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kPad = 8;  // elements of padding per shared-memory row
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 copies nothing and zero-fills the 16 bytes.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b: one m16n8k16 product, f32 accumulators d[off .. off + 3].
template <typename T, int N>
__device__ __forceinline__ void mma16816(float (&d)[N], int off,
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (sm90::kIsBf16<T>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[off]), "+f"(d[off + 1]), "+f"(d[off + 2]), "+f"(d[off + 3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[off]), "+f"(d[off + 1]), "+f"(d[off + 2]), "+f"(d[off + 3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t load_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit values from two rows of one column, low half first.
__device__ __forceinline__ uint32_t pack_u16(const void* lo, const void* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int hq, int hkv, int s_len,
                        float scale_log2, int causal) {
  constexpr int kLd = D + kPad;     // shared-memory row, in elements
  constexpr int kChunks = D / 8;    // 16-byte chunks per row
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
    const int st = t % kStages;
    for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
      const int row = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int key = t * kBlockN + row;
      const bool valid = key < s_len;
      const size_t off = size_t(valid ? key : 0) * D + col;
      cp_async16(&k_s[st][row * kLd + col], k_head + off, valid);
      cp_async16(&v_s[st][row * kLd + col], v_head + off, valid);
    }
    cp_async_commit();
  };
  load_tile(0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row in the fragment
  const int quad = lane % 4;  // column pair in the fragment
  const int row_base = q0 + warp * 16 + g;
  const int rows[2] = {row_base, row_base + 8};

  // Q as the A fragments of the D / 16 k-steps of S = Q K^T.
  uint32_t q_frag[D / 16][4];
  {
    const T* q_head = q + size_t(bh) * s_len * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rows[r % 2];
        const int col = kk * 16 + 2 * quad + 8 * (r / 2);
        q_frag[kk][r] =
            row < s_len ? load_u32(q_head + size_t(row) * D + col) : 0u;
      }
  }

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_s[t % kStages];
    const T* vs = v_s[t % kStages];

    // S = Q K^T over this tile's 64 keys: register 4 j + 2 i + e holds
    // row rows[i], key t * 64 + 8 j + 2 quad + e.
    float s[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const T* k_row = ks + (8 * j + g) * kLd + 2 * quad;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma16816<T>(s, 4 * j, q_frag[kk], load_u32(k_row + 16 * kk),
                    load_u32(k_row + 16 * kk + 8));
    }

    // Online softmax (the wgmma kernel's softmax_tile on 64 keys).
    const bool mask =
        (causal && t == n_tiles - 1) || (t + 1) * kBlockN > s_len;
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
        mma16816<T>(o_acc, 4 * n, p_frag, pack_u16(v_col, v_col + kLd),
                    pack_u16(v_col + 8 * kLd, v_col + 9 * kLd));
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int hq, int hkv, int s_len, float scale,
                   int causal, cudaStream_t stream) {
  const dim3 grid(b * hq, (s_len + kBlockM - 1) / kBlockM);
  fa_fwd_small_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, s_len, scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_fwd at head_dim 16 or 32.  q [B,Hq,S,D], k/v
// [B,Hkv,S,D], o [B,Hq,S,D] contiguous, 16-byte aligned; lse [B,Hq,S] f32
// or null.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_fwd_small(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int hq, int hkv, int s_len, int head_dim, int dtype, float scale,
    int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      s_len > 65535 * kBlockM)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 16)
    return int(launch<__nv_bfloat16, 16>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         scale, causal, st));
  if (dtype == 0 && head_dim == 32)
    return int(launch<__nv_bfloat16, 32>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         scale, causal, st));
  if (dtype == 1 && head_dim == 16)
    return int(launch<__half, 16>(q, k, v, o, lse, b, hq, hkv, s_len, scale,
                                  causal, st));
  if (dtype == 1 && head_dim == 32)
    return int(launch<__half, 32>(q, k, v, o, lse, b, hq, hkv, s_len, scale,
                                  causal, st));
  return int(cudaErrorInvalidValue);
}
