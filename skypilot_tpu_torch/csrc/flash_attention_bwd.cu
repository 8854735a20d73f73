// Flash-attention backward for Hopper (sm_90a), CUDA C++ with WMMA: the dq
// kernel.  (The dk/dv kernel is flash_attention_bwd_dkv.cu.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dq_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py.  It
// recomputes the softmax tile from the forward's saved row logsumexp, so
// nothing O(S^2) reaches device memory:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dQ = dS K
// with dS rounded to the input type before its product, as the TPU kernel
// does (ds.astype(k.dtype)), and f32 sums.
//
// What bounds it on an H100: at training shapes (S = 2k-4k, head_dim
// 64/128) each (q, k) pair costs 6*D flops against O(S*D) bytes, so the
// tensor cores (989 TFLOP/s bf16) bound it; the bytes are ~5x below.
// This first version is not near that bound: WMMA (mma.sync class)
// instead of wgmma, synchronous tile loads without double buffering, f32
// score tiles round-tripped through shared memory (the WMMA accumulator
// layout is opaque, so per-row lse/delta and the causal mask are applied
// there), 4 warps and ~120 KB of shared memory per block.
//
// Design, translated from the TPU blocking rather than copied: one block
// per (batch*q-head, 64-row q tile); each warp owns 16 q rows.  The TPU's
// sequential k grid axis becomes a loop over 64-row K/V tiles that stops
// at the diagonal when causal.  Nothing is rescaled across the loop, so
// the f32 dQ accumulator stays in WMMA accumulator fragments (registers)
// for the whole sweep and is written once.  Key columns on the ragged
// last tile (S = 32 or 96) are zero-filled, contribute exactly 0
// (k_pos >= S gives P = 0), and rows past S are not stored.  Shared
// memory at D = 128: four 16-bit [64, D] tiles (70 KB), two f32 [64, 64]
// tiles (34 KB), two 16-bit [64, 64] tiles (18 KB): ~121 KB of dynamic
// shared memory, opted in with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 64;   // rows of every q and k tile (diagonal tile of
                            // q tile t is k tile t)
constexpr int kWarps = 4;   // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

// Shared-memory layout.  Row pitches are padded
// (fewer bank conflicts) and keep every WMMA pointer 32-byte aligned.
template <int D>
struct Smem {
  static constexpr int kLd = D + 8;        // 16-bit [64, D] tiles
  static constexpr int kLdS = kTile + 4;   // f32 [64, 64] tiles
  static constexpr int kLdP = kTile + 8;   // 16-bit [64, 64] tiles
  static constexpr int kLdAcc = D + 4;     // f32 accumulator staging
  static constexpr size_t kTileBytes = size_t(kTile) * kLd * 2;
  static constexpr size_t t0_off = 0;
  static constexpr size_t t1_off = t0_off + kTileBytes;
  static constexpr size_t t2_off = t1_off + kTileBytes;
  static constexpr size_t t3_off = t2_off + kTileBytes;
  static constexpr size_t s_off = t3_off + kTileBytes;
  static constexpr size_t dp_off = s_off + size_t(kTile) * kLdS * 4;
  static constexpr size_t p_off = dp_off + size_t(kTile) * kLdS * 4;
  static constexpr size_t ds_off = p_off + size_t(kTile) * kLdP * 2;
  static constexpr size_t lse_off = ds_off + size_t(kTile) * kLdP * 2;
  static constexpr size_t delta_off = lse_off + size_t(kTile) * 4;
  static constexpr size_t bytes = delta_off + size_t(kTile) * 4;
  static_assert(t1_off % 32 == 0 && s_off % 32 == 0 && dp_off % 32 == 0 &&
                    p_off % 32 == 0 && ds_off % 32 == 0,
                "WMMA tiles must start 32-byte aligned");
  // The accumulators are staged over the two f32 score tiles at the end.
  static_assert(size_t(kTile) * kLdAcc * 4 <= p_off - s_off,
                "accumulator staging must fit the score tiles");
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float(float x) {
  return __float2half(x);
}

// Copies rows [row0, row0 + kTile) of a row-major [s_len, D] matrix into a
// shared tile of pitch Smem<D>::kLd, 16 bytes per thread per step; rows
// past s_len are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int s_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s_len)
      val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::kLd + c) = val;
  }
}

// lse and delta of q rows [q0, q0 + kTile); rows past s_len get lse = +inf
// and delta = 0, so their P and dS are exactly 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int q0, int s_len) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in_seq = q0 + i < s_len;
    lse_s[i] = in_seq ? lse[q0 + i] : INFINITY;
    delta_s[i] = in_seq ? delta[q0 + i] : 0.f;
  }
}

// The warp's 16 rows x 64 columns of A B^T and C E^T (f32), A and C rows
// row_w.. of their tiles, B and E read col-major (i.e. transposed) from
// their [64, D] tiles; stored row-major to x_s and y_s.
template <typename T, int D>
__device__ __forceinline__ void two_products_nt(const T* a_s, const T* b_s,
                                                const T* c_s, const T* e_s,
                                                float* x_s, float* y_s,
                                                int row_w) {
  using L = Smem<D>;
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> x, y;
    wmma::fill_fragment(x, 0.f);
    wmma::fill_fragment(y, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a_s + row_w * L::kLd + kk * 16, L::kLd);
      wmma::load_matrix_sync(bf, b_s + n * 16 * L::kLd + kk * 16, L::kLd);
      wmma::mma_sync(x, af, bf, x);
      wmma::load_matrix_sync(af, c_s + row_w * L::kLd + kk * 16, L::kLd);
      wmma::load_matrix_sync(bf, e_s + n * 16 * L::kLd + kk * 16, L::kLd);
      wmma::mma_sync(y, af, bf, y);
    }
    wmma::store_matrix_sync(x_s + row_w * L::kLdS + n * 16, x, L::kLdS,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(y_s + row_w * L::kLdS + n * 16, y, L::kLdS,
                            wmma::mem_row_major);
  }
}

// acc[dn] += A[row_w rows, 0:64] * B[0:64, dn*16 : dn*16+16], A a 16-bit
// [64, 64] tile of pitch kLdP, B a [64, D] tile of pitch kLd.
template <typename T, int D>
__device__ __forceinline__ void accumulate_nn(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    const T* a_s, const T* b_s, int row_w) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
    wmma::load_matrix_sync(af, a_s + row_w * L::kLdP + kk * 16, L::kLdP);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b_s + kk * 16 * L::kLd + dn * 16, L::kLd);
      wmma::mma_sync(acc[dn], af, bf, acc[dn]);
    }
  }
}

// Writes the warp's 16 accumulator rows (rows row0 + row_w.. of a [s_len,
// D] output), staged through shared memory; rows past s_len are skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* stage, T* __restrict__ out, int row0, int s_len, int row_w,
    int lane) {
  using L = Smem<D>;
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn)
    wmma::store_matrix_sync(stage + row_w * L::kLdAcc + dn * 16, acc[dn],
                            L::kLdAcc, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int pos = row0 + row_w + r;
    if (pos >= s_len) break;
    for (int c = lane; c < D; c += 32)
      out[size_t(pos) * D + c] =
          from_float<T>(stage[(row_w + r) * L::kLdAcc + c]);
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int hq, int hkv, int s_len, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::t0_off);
  T* do_s = reinterpret_cast<T*>(smem + L::t1_off);
  T* k_s = reinterpret_cast<T*>(smem + L::t2_off);
  T* v_s = reinterpret_cast<T*>(smem + L::t3_off);
  float* s_s = reinterpret_cast<float*>(smem + L::s_off);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp_off);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int bh = blockIdx.x;  // b * hq + h
  const int q_tile = blockIdx.y;
  const int b = bh / hq;
  const int h_kv = (bh - b * hq) / (hq / hkv);
  const int q0 = q_tile * kTile;
  const size_t kv_base = (size_t(b) * hkv + h_kv) * s_len * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_w = warp * 16;

  load_tile<T, D>(q_s, q + size_t(bh) * s_len * D, q0, s_len);
  load_tile<T, D>(do_s, dout + size_t(bh) * s_len * D, q0, s_len);
  load_rows(lse_s, delta_s, lse + size_t(bh) * s_len,
            delta + size_t(bh) * s_len, q0, s_len);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) wmma::fill_fragment(acc[dn], 0.f);

  const int n_tiles_all = (s_len + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_tiles_all, q_tile + 1) : n_tiles_all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(k_s, k + kv_base, k0, s_len);
    load_tile<T, D>(v_s, v + kv_base, k0, s_len);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 q rows.
    two_products_nt<T, D>(q_s, k_s, do_s, v_s, s_s, dp_s, row_w);
    __syncwarp();

    // dS = P (dP - delta) scale, rounded to T; lane owns 2 columns.
    for (int r = 0; r < 16; ++r) {
      const int row = row_w + r;
      const int q_pos = q0 + row;
      const float lse_r = lse_s[row];
      const float delta_r = delta_s[row];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int k_pos = k0 + c;
        float x = s_s[row * L::kLdS + c] * scale;
        if (causal && q_pos < k_pos) x = kNegInf;
        const float p = k_pos < s_len ? expf(x - lse_r) : 0.f;
        ds_s[row * L::kLdP + c] =
            from_float<T>(p * (dp_s[row * L::kLdS + c] - delta_r) * scale);
      }
    }
    __syncwarp();

    // dQ += dS K.
    accumulate_nn<T, D>(acc, ds_s, k_s, row_w);
  }
  __syncthreads();  // the staging area overlaps other warps' score rows
  store_rows<T, D>(acc, s_s, dq + size_t(bh) * s_len * D, q0, s_len, row_w,
                   lane);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int b, hq, hkv, s_len;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.hq, (a.s_len + kTile - 1) / kTile);
  fa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.hq, a.hkv, a.s_len, a.scale, a.causal);
  return cudaGetLastError();
}

int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.b <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0 || a.s_len <= 0)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 128)
    return int(launch_dq<__nv_bfloat16, 128>(a));
  if (dtype == 0 && head_dim == 64)
    return int(launch_dq<__nv_bfloat16, 64>(a));
  if (dtype == 1 && head_dim == 128) return int(launch_dq<__half, 128>(a));
  if (dtype == 1 && head_dim == 64) return int(launch_dq<__half, 64>(a));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, dout [B,Hq,S,D] and k, v
// [B,Hkv,S,D] contiguous, 16-byte aligned; lse, delta [B,Hq,S] f32;
// dq [B,Hq,S,D].  dtype: 0 = bf16, 1 = fp16.  Returns the launch's
// cudaError_t.
extern "C" int skytpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int s_len, int head_dim, int dtype, float scale, int causal,
    void* stream) {
  const Args a{q,   k,   v,     dout,  lse,   delta, dq,
               b,   hq,  hkv,   s_len, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, dtype);
}
