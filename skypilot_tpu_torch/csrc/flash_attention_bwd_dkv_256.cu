// Flash-attention backward, dk/dv kernel at head_dim 256, for Hopper
// (sm_90a): wgmma, a TMA ring of Q/dO stages, two consumer warpgroups (one
// computes S^T and dV, the other dP^T and dK), and a grid split over the
// query work when the kv tiles alone do not fill the card.  (The
// dq kernel of this width is flash_attention_bwd_dq_256.cu; the dk/dv
// kernel at 64 and 128 is flash_attention_bwd_dkv.cu.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dkv_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// head_dim 256 in bf16 and fp16: Gemma's attention width, and the
// zero-padded head_dims 160 and 200 (the wrapper pads them to 256).  It
// recomputes the softmax tile from the forward's saved row logsumexp, so
// nothing O(S^2) reaches device memory:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dV = P^T dO,   dK = dS^T Q
// with P and dS rounded to the input type before their products, as the
// TPU kernel does (p.astype(do.dtype), ds.astype(q.dtype)), P still in f32
// when dS is formed, f32 sums, and dk/dv summed over each kv head's group
// of query heads.  `scale` is the caller's.
//
// What bounds it on an H100: 8 D flops per (q, k) pair (four products)
// against O(S D) bytes, so the tensor cores at training shapes (989
// TFLOP/s bf16: 0.556 ms at Gemma-7B's B=2, Hq=Hkv=16, S=4096 causal) and
// the bytes at the serving bucket's.
//
// Design:
// - Registers decide the layout.  A wgmma warpgroup owns 64 rows, and dK
//   and dV of 64 k rows x 256 in f32 are 256 registers a thread: more than
//   one warpgroup holds.  So a CTA takes one 64-row k tile and two
//   consumer warpgroups (240 registers each after setmaxnreg) beside a
//   producer warpgroup (24): consumer 0 owns dV, consumer 1 dK (128
//   registers each; with the score tile and its fragments about 180).
// - Each q tile's S^T = K Q^T and dP^T = V dO^T (64 k x 64 q, K = 256)
//   are computed once, each by the consumer whose gradient needs it:
//   consumer 0 computes S^T, forms P^T = 2^(S^T scale log2 e - lse log2 e)
//   (masked) in f32, packs it and runs dV += P^T dO; consumer 1 computes
//   dP^T, forms dS^T = P^T (dP^T - delta) scale and runs dK += dS^T Q
//   (m64n256k16, P^T and dS^T as the register A operand, dO and Q as the
//   MN-major B operand with the transpose flag).  The one hand-over is
//   P^T in f32, from consumer 0 to 1 through shared memory (16 KB, one
//   float2 per thread and register pair in the accumulator's own thread
//   order, so the other warpgroup's thread of the same index reads
//   exactly its fragment).  That is the 8 D flops a pair that the bound
//   counts (the mma.sync kernel this replaces split dV and dK over the
//   grid and recomputed S^T in each half: 10 D).  An earlier layout gave
//   each consumer half of D's columns of both dK and dV, which needs
//   both P^T and dS^T in both and so a second hand-over (dS^T back):
//   more shared-memory traffic and a barrier more a tile; it measured
//   slower on an H100.
// - K and V stay resident (64 KB); Q, dO, lse and delta tiles of 64 q
//   rows stream through two stages (64 KB each) filled by the producer
//   warp: TMA for Q and dO, its lanes for lse (times log2 e; +inf past S)
//   and delta (0 past S).  With the hand-over buffer: 210 KB of dynamic
//   shared memory, one CTA per SM.
// - Overlap: each consumer issues its gradient product and, behind it,
//   the next tile's score product, and waits for both; while consumer 0
//   forms the next P^T, consumer 1's products run, and while consumer 1
//   forms dS^T, consumer 0's do.
// - The CTA loops over the (query head, q tile) pairs of its kv head's
//   group (when causal, the q tiles from the diagonal down), so the GQA
//   sum happens in the f32 accumulators.  With split = 1 (the grid's
//   B * Hkv * S / 64 CTAs fill the card and no causal k tile is far
//   heavier than its share) the CTA writes dk and dv.  Under MQA that
//   grid is short (32 CTAs at Gemma-2B's serving bucket for 132 SMs) and
//   the causal k tile 0 holds Hq / Hkv times S / 64 steps; there the host
//   (`plan_dkv_256_split` in ops/cuda/flash_attention.py) picks split > 1:
//   CTA (kv tile, c) takes the c-th of `split` contiguous, near-equal
//   ranges of the tile's (head, q tile) list and writes f32 partial dK and
//   dV ([split, 2, B * Hkv, S, D]); a second kernel sums the partials in
//   the order c = 0, 1, ... and casts them.  No atomics anywhere: dk and
//   dv are bit-reproducible run to run, split or not.
// - Masking only on tiles that need it: the causal diagonal (q < k gives
//   P = 0, as the TPU kernel's -1e30) and k rows past S (P = 0); q rows
//   past S get lse = +inf, so P = 0 and dS = 0.  Causal q tiles wholly
//   before the k tile are skipped.
// - Heaviest k tiles first: block y is the k tile (the causal k tile 0
//   has the most q tiles), and the split's ranges of a tile are
//   neighbours in block x.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kD = 256;
constexpr int kBlockK = 64;    // k rows per CTA
constexpr int kBlockQ = 64;    // q rows per stage
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kPairThreads = 256;  // the two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxSplit = 64;
// Named barriers between the consumers: P^T is in shared memory (consumer
// 0 arrives, 1 waits), and consumer 1 has taken it (1 arrives, 0 waits
// before it writes the next).
constexpr int kBarP = 1;
constexpr int kBarFree = 2;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  static constexpr int kTileBytes = 64 * kD * 2;  // K, V, a Q or a dO tile
  static constexpr int k_off = 0;
  static constexpr int v_off = kTileBytes;
  __host__ __device__ static constexpr int q_off(int s) {
    return 2 * kTileBytes + s * 2 * kTileBytes;
  }
  __host__ __device__ static constexpr int do_off(int s) {
    return q_off(s) + kTileBytes;
  }
  // P^T in f32: [16 register pairs][128 threads] float2.
  static constexpr int p_off = 2 * kTileBytes + kStages * 2 * kTileBytes;
  static constexpr int rows_off = p_off + (kBlockQ / 2) * 128 * 4;
  __host__ __device__ static constexpr int lse_off(int s) {
    return rows_off + s * 2 * kBlockQ * 4;
  }
  __host__ __device__ static constexpr int delta_off(int s) {
    return lse_off(s) + kBlockQ * 4;
  }
  static constexpr int bar_off = rows_off + kStages * 2 * kBlockQ * 4;
  // kv_full, full[kStages], empty[kStages]
  static constexpr int bytes =
      bar_off + (1 + 2 * kStages) * 8 + sm90::kSmemAlign;
  static_assert(kTileBytes % 1024 == 0, "tiles must keep 1024-byte "
                                        "alignment");
  static_assert(bytes <= 232448, "more than a CTA's shared memory");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkv_256_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ partial, int hq, int hkv,
                          int s_len, float scale, int causal, int split) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int chunk = blockIdx.x % split;
  const int bkv = blockIdx.x / split;  // b * hkv + h_kv
  const int k_tile = blockIdx.y;
  const int b = bkv / hkv;
  const int h_kv = bkv - b * hkv;
  const int group = hq / hkv;
  const int k0 = k_tile * kBlockK;
  const int n_q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  const int first_q_tile = causal ? k0 / kBlockQ : 0;
  const int per_head = n_q_tiles - first_q_tile;
  // This CTA's range [it_lo, it_hi) of the tile's (head, q tile) list.
  const long long n_all = (long long)group * per_head;
  const int it_lo = int(n_all * chunk / split);
  const int n_iters = int(n_all * (chunk + 1) / split) - it_lo;
  auto q_row0 = [&](int it) {
    const int g = it / per_head;
    return (first_q_tile + it - g * per_head) * kBlockQ;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer warp's lanes
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ----- producer: warp 0 keeps the ring full.
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kTileBytes);
        sm90::tma_load_tile<T, kD>(k_s, &k_map, kv_full, kBlockK, k0, bkv);
        sm90::tma_load_tile<T, kD>(v_s, &v_map, kv_full, kBlockK, k0, bkv);
      }
      for (int n = 0; n < n_iters; ++n) {
        const int it = it_lo + n;
        const int q0 = q_row0(it);
        const int bh = b * hq + h_kv * group + it / per_head;
        const int s = n % kStages;
        sm90::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        float* lse_s = reinterpret_cast<float*>(smem + L::lse_off(s));
        float* delta_s = reinterpret_cast<float*>(smem + L::delta_off(s));
        for (int r = lane; r < kBlockQ; r += 32) {
          const int pos = q0 + r;
          const bool in_seq = pos < s_len;
          const size_t at = size_t(bh) * s_len + pos;
          lse_s[r] = in_seq ? lse[at] * kLog2e : INFINITY;
          delta_s[r] = in_seq ? delta[at] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kTileBytes);
          sm90::tma_load_tile<T, kD>(reinterpret_cast<T*>(smem + L::q_off(s)),
                                     &q_map, &full[s], kBlockQ, q0, bh);
          sm90::tma_load_tile<T, kD>(
              reinterpret_cast<T*>(smem + L::do_off(s)), &do_map, &full[s],
              kBlockQ, q0, bh);
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ----- consumers: the tile's 64 k rows; consumer 0 owns dV, 1 dK.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    // The two k rows (i = 0, 1) this thread holds in every accumulator.
    const int row_base = k0 + warp * 16 + lane / 4;
    const int rows[2] = {row_base, row_base + 8};
    const float scale_log2 = scale * kLog2e;
    float2* p_x = reinterpret_cast<float2*>(smem + L::p_off);
    // Consumer 0: S^T = K Q^T, then dV += P^T dO.  Consumer 1: dP^T =
    // V dO^T, then dK += dS^T Q.  (In a stage, Q is at 0 and dO at
    // kTileBytes.)
    const T* score_a = cw == 0 ? k_s : v_s;
    const int score_b_off = cw == 0 ? 0 : L::kTileBytes;
    const int grad_b_off = cw == 0 ? L::kTileBytes : 0;

    float grad_acc[kD / 2];  // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) grad_acc[i] = 0.f;
    float acc[kBlockQ / 2];  // S^T or dP^T of the current q tile
    uint32_t frag[kBlockQ / 16][4];  // P^T or dS^T in 16 bits

    // A tile of the stage (descriptors formed where they are used,
    // sm90::opaque).
    auto stage_tile = [&](int n, int off) {
      return sm90::opaque(
          reinterpret_cast<const T*>(smem + L::q_off(n % kStages) + off));
    };
    // S^T = K Q_n^T or dP^T = V dO_n^T: 64 k rows x 64 q, K = 256.
    auto issue_score = [&](int n) {
      const T* a_tile = sm90::opaque(score_a);
      const T* b_tile = stage_tile(n, score_b_off);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        sm90::wgmma_ss<T, kBlockQ, 0>(
            acc, sm90::desc_kmajor(a_tile, kBlockK, 0, k),
            sm90::desc_kmajor(b_tile, kBlockQ, 0, k), k > 0);
      sm90::wgmma_commit();
    };
    // dV += P^T dO_n or dK += dS^T Q_n: m64n256k16, the register A operand.
    auto issue_grad = [&](int n) {
      const T* b_tile = stage_tile(n, grad_b_off);
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk)
        sm90::wgmma_rs<T, kD, 1>(grad_acc, frag[kk],
                                 sm90::desc_mnmajor(b_tile, kBlockQ, kk),
                                 true);
      sm90::wgmma_commit();
    };

    sm90::mbar_wait(kv_full, 0);
    if (n_iters > 0) {
      sm90::mbar_wait(&full[0], 0);
      sm90::wgmma_fence();
      issue_score(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    // Register pair (kk, r) of the fragments is accumulator entries
    // 8 kk + 2 r and + 1: row i = r % 2, q columns 16 kk + 8 (r / 2) +
    // 2 quad and + 1.
    for (int n = 0; n < n_iters; ++n) {
      const int q0 = q_row0(it_lo + n);
      const int s = n % kStages;
      if (cw == 0) {
        // P^T, once consumer 1 has taken the previous tile's: handed over
        // in f32 and packed.  (Not kept in acc: with acc redefined in
        // place ptxas serialized the wgmma products, C7515.)
        if (n > 0) sm90::named_barrier_sync(kBarFree, kPairThreads);
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::lse_off(s));
        const bool mask =
            (causal && q0 < k0 + kBlockK) || k0 + kBlockK > s_len;
#pragma unroll
        for (int kk = 0; kk < kBlockQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int idx = 8 * kk + 2 * r;
            const int i = r % 2;
            const int col = 16 * kk + 8 * (r / 2) + 2 * quad;
            const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
            float p0 = sm90::ex2(fmaf(acc[idx], scale_log2, -lse2.x));
            float p1 = sm90::ex2(fmaf(acc[idx + 1], scale_log2, -lse2.y));
            if (mask) {
              if ((causal && q0 + col < rows[i]) || rows[i] >= s_len)
                p0 = 0.f;
              if ((causal && q0 + col + 1 < rows[i]) || rows[i] >= s_len)
                p1 = 0.f;
            }
            p_x[(idx / 2) * 128 + tid] = make_float2(p0, p1);
            frag[kk][r] = sm90::pack2<T>(p0, p1);
          }
        sm90::named_barrier_arrive(kBarP, kPairThreads);
      } else {
        // dS^T = P^T (dP^T - delta) scale, packed; the buffer is then free
        // for the next tile's P^T.
        const float* delta_s =
            reinterpret_cast<const float*>(smem + L::delta_off(s));
        sm90::named_barrier_sync(kBarP, kPairThreads);
#pragma unroll
        for (int kk = 0; kk < kBlockQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int idx = 8 * kk + 2 * r;
            const int col = 16 * kk + 8 * (r / 2) + 2 * quad;
            const float2 delta2 =
                *reinterpret_cast<const float2*>(delta_s + col);
            const float2 p = p_x[(idx / 2) * 128 + tid];
            frag[kk][r] = sm90::pack2<T>(
                p.x * (acc[idx] - delta2.x) * scale,
                p.y * (acc[idx + 1] - delta2.y) * scale);
          }
        if (n + 1 < n_iters)
          sm90::named_barrier_arrive(kBarFree, kPairThreads);
      }

      // This tile's gradient product, then the next tile's score product.
      sm90::wgmma_fence();
      issue_grad(n);
      if (n + 1 < n_iters) {
        sm90::mbar_wait(&full[(n + 1) % kStages], ((n + 1) / kStages) & 1);
        issue_score(n + 1);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(grad_acc);
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // Epilogue: the k rows inside S, straight from the accumulator; in T
    // to dv (consumer 0) or dk (1), or in f32 to this range's partial
    // ([split, 2, ...]: dk at 0, dv at 1).
    const size_t n_elems = size_t(gridDim.x / split) * s_len * kD;
    T* out = cw == 0 ? dv : dk;
    float* part =
        split == 1 ? nullptr
                   : partial + (size_t(chunk) * 2 + (cw == 0)) * n_elems;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= s_len) continue;
      const size_t at = (size_t(bkv) * s_len + rows[i]) * kD + 2 * quad;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int e = 4 * j + 2 * i;
        if (split == 1)
          *reinterpret_cast<uint32_t*>(out + at + 8 * j) =
              sm90::pack2<T>(grad_acc[e], grad_acc[e + 1]);
        else
          *reinterpret_cast<float2*>(part + at + 8 * j) =
              make_float2(grad_acc[e], grad_acc[e + 1]);
      }
    }
  }
}

// dk (blockIdx.y = 0) or dv (1) = the sum of the `split` f32 partials, in
// the order c = 0, 1, ..., cast to T; four elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    fa_bwd_dkv_256_reduce(const float* __restrict__ partial,
                          T* __restrict__ dk, T* __restrict__ dv,
                          size_t n_elems, int split) {
  const size_t at =
      (size_t(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (at >= n_elems) return;
  const float* src = partial + blockIdx.y * n_elems + at;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int c = 1; c < split; ++c) {
    const float4 x =
        *reinterpret_cast<const float4*>(src + size_t(c) * 2 * n_elems);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  T* out = (blockIdx.y == 0 ? dk : dv) + at;
  *reinterpret_cast<uint2*>(out) =
      make_uint2(sm90::pack2<T>(sum.x, sum.y), sm90::pack2<T>(sum.z, sum.w));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, void* partial, int b, int hq, int hkv,
                   int s_len, int dtype, float scale, int causal, int split,
                   cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err =
      sm90::make_tile_map(&q_map, q, dtype, b * hq, s_len, kD, kBlockQ);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&do_map, dout, dtype, b * hq, s_len, kD,
                              kBlockQ);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&k_map, k, dtype, b * hkv, s_len, kD, kBlockK);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&v_map, v, dtype, b * hkv, s_len, kD, kBlockK);
  if (err != cudaSuccess) return err;
  const int smem = sm90::launch_smem_bytes(Smem::bytes);
  err = cudaFuncSetAttribute(fa_bwd_dkv_256_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hkv * split, (s_len + kBlockK - 1) / kBlockK);
  fa_bwd_dkv_256_kernel<T><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(partial), hq, hkv, s_len,
      scale, causal, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const size_t n_elems = size_t(b) * hkv * s_len * kD;
  const dim3 reduce_grid(unsigned((n_elems / 4 + 255) / 256), 2);
  fa_bwd_dkv_256_reduce<T><<<reduce_grid, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(dk),
      static_cast<T*>(dv), n_elems, split);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): the contract of
// skytpu_flash_attention_bwd_dkv at head_dim 256, then the split.  q, dout
// [B,Hq,S,D] and k, v [B,Hkv,S,D] contiguous, 16-byte aligned; lse, delta
// [B,Hq,S] f32; dk, dv [B,Hkv,S,D], summed over each kv head's group of
// query heads.  dtype: 0 = bf16, 1 = fp16.  split (1 to 64): the number of
// ranges each kv tile's query work is cut into; above 1, `partial` is an
// f32 workspace of split x 2 x B x Hkv x S x D elements (16-byte aligned;
// null at 1).  Returns the first launch error (cudaError_t).
extern "C" int skytpu_flash_attention_bwd_dkv_256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s_len, int head_dim, int dtype, float scale, int causal,
    void* partial, int split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      head_dim != kD || split < 1 || split > kMaxSplit ||
      (split > 1 && partial == nullptr) ||
      (long long)b * hkv * split > 0x7fffffffLL ||
      (s_len + kBlockK - 1) / kBlockK > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                     partial, b, hq, hkv, s_len, dtype,
                                     scale, causal, split, st));
  if (dtype == 1)
    return int(launch<__half>(q, k, v, dout, lse, delta, dk, dv, partial, b,
                              hq, hkv, s_len, dtype, scale, causal, split,
                              st));
  return int(cudaErrorInvalidValue);
}
