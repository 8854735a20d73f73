// Flash-attention backward, dk/dv kernel, for Hopper (sm_90a): wgmma, a
// TMA ring of Q/dO stages, P^T and dS^T in registers.
//
// Replaces the Pallas TPU kernel `_fa_bwd_dkv_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py.  It
// recomputes the softmax tile from the forward's saved row logsumexp, so
// nothing O(S^2) reaches device memory:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dV = P^T dO,   dK = dS^T Q
// with P and dS rounded to the input type before their products, as the
// TPU kernel does (p.astype(do.dtype), ds.astype(q.dtype)), and f32 sums.
//
// What bounds it on an H100: each (q, k) pair costs 8 D flops (four
// products) against O(S D) bytes, so at training shapes the tensor cores
// do (989 TFLOP/s bf16: 0.556 ms for bench-1b's B=4, Hq=16, Hkv=8,
// S=4096, D=128 causal).
//
// Design:
// - One CTA per (batch * kv-head, 128-row k tile) and three warpgroups:
//   warpgroup 0 produces (its first warp loads, the rest idle, all with
//   few registers after setmaxnreg), warpgroups 1 and 2 consume 64 k rows
//   each.  K and V stay resident in shared memory; Q, dO, lse and delta
//   tiles of 64 q rows stream through a ring of kStages stages, over the
//   G query heads of the group and, when causal, over the q tiles from
//   the diagonal down.  The GQA sum therefore happens in the f32
//   accumulators: no atomics, no [B, Hq, S, D] temporary, and dk/dv are
//   bit-reproducible run to run.
// - TMA brings Q and dO (128-byte swizzle, rows past S as zeros); the
//   producer warp's lanes copy lse (times log2 e; +inf past S) and delta
//   (0 past S) into the stage and arrive on its full barrier with the
//   TMA's transaction bytes.  At D = 128: K and V 64 KB, two stages of
//   32.5 KB: ~130 KB of dynamic shared memory.
// - S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16, all operands
//   K-major as TMA lays them down.  P^T = 2^(S^T scale log2 e - lse log2 e)
//   and dS^T = P^T (dP^T - delta) scale are formed in the accumulator
//   registers (lse and delta read per column from the stage) and packed
//   to 16-bit pairs column pair by column pair, which bounds the peak to
//   the 128 registers of dK and dV plus the two 32-register score tiles.
// - dV += P^T dO and dK += dS^T Q (m64nDk16) take the packed P^T and dS^T
//   as the register A operand (the accumulator fragment of S^T is the A
//   fragment, see sm90_common.cuh); dO and Q are the shared-memory B
//   operand, MN-major, with the transpose flag.
// - Masking only on tiles that need it: the causal diagonal (q < k gives
//   P = 0, as the TPU kernel's -1e30), k rows past S (P = 0); q rows past
//   S get lse = +inf, so P = 0 and dS = 0.
// - Heaviest k tiles first: block y is the k tile, and the causal k tile
//   0 has the most q tiles.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBlockK = 128;  // k rows per CTA: 2 consumer warpgroups x 64
constexpr int kBlockQ = 64;   // q rows per stage
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kKBytes = kBlockK * D * 2;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = kKBytes;
  __host__ __device__ static constexpr int q_off(int s) {
    return 2 * kKBytes + s * 2 * kQBytes;
  }
  __host__ __device__ static constexpr int do_off(int s) {
    return q_off(s) + kQBytes;
  }
  static constexpr int rows_off = 2 * kKBytes + kStages * 2 * kQBytes;
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
  static_assert(kKBytes % 1024 == 0 && kQBytes % 1024 == 0,
                "tiles must keep 1024-byte alignment");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int hq, int hkv, int s_len,
                      float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bkv = blockIdx.x;  // b * hkv + h_kv
  const int k_tile = blockIdx.y;
  const int b = bkv / hkv;
  const int h_kv = bkv - b * hkv;
  const int group = hq / hkv;
  const int k0 = k_tile * kBlockK;
  const int n_q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  const int first_q_tile = causal ? k0 / kBlockQ : 0;
  const int per_head = n_q_tiles - first_q_tile;
  const int n_iters = group * per_head;

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
        sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kKBytes);
        sm90::tma_load_tile<T, D>(k_s, &k_map, kv_full, kBlockK, k0, bkv);
        sm90::tma_load_tile<T, D>(v_s, &v_map, kv_full, kBlockK, k0, bkv);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int g = it / per_head;
        const int q0 = (first_q_tile + it - g * per_head) * kBlockQ;
        const int bh = b * hq + h_kv * group + g;
        const int s = it % kStages;
        const int round = it / kStages;
        sm90::mbar_wait(&empty[s], (round & 1) ^ 1);
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
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kQBytes);
          sm90::tma_load_tile<T, D>(reinterpret_cast<T*>(smem + L::q_off(s)),
                                    &q_map, &full[s], kBlockQ, q0, bh);
          sm90::tma_load_tile<T, D>(
              reinterpret_cast<T*>(smem + L::do_off(s)), &do_map, &full[s],
              kBlockQ, q0, bh);
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ----- consumers: 64 k rows per warpgroup.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    // The two k rows (i = 0, 1) this thread holds in every accumulator.
    const int row_base = k0 + cw * 64 + warp * 16 + lane / 4;
    const int rows[2] = {row_base, row_base + 8};
    const float scale_log2 = scale * kLog2e;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }

    sm90::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int g = it / per_head;
      const int q0 = (first_q_tile + it - g * per_head) * kBlockQ;
      const int s = it % kStages;
      const int round = it / kStages;
      const T* q_s = reinterpret_cast<const T*>(smem + L::q_off(s));
      const T* do_s = reinterpret_cast<const T*>(smem + L::do_off(s));
      const float* lse_s = reinterpret_cast<const float*>(smem + L::lse_off(s));
      const float* delta_s =
          reinterpret_cast<const float*>(smem + L::delta_off(s));

      // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 k rows x 64 q.
      float st[kBlockQ / 2], dpt[kBlockQ / 2];
      sm90::mbar_wait(&full[s], round & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss<T, kBlockQ, 0>(
            st, sm90::desc_kmajor(k_s, kBlockK, cw * 64, k),
            sm90::desc_kmajor(q_s, kBlockQ, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss<T, kBlockQ, 0>(
            dpt, sm90::desc_kmajor(v_s, kBlockK, cw * 64, k),
            sm90::desc_kmajor(do_s, kBlockQ, 0, k), k > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // P^T and dS^T in registers, packed to 16-bit A fragments.
      const bool mask =
          (causal && q0 < k0 + kBlockK) || k0 + kBlockK > s_len;
      uint32_t p_frag[kBlockQ / 16][4], ds_frag[kBlockQ / 16][4];
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 delta2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            float pv =
                sm90::ex2(fmaf(st[idx], scale_log2, -(e ? lse2.y : lse2.x)));
            if (mask && ((causal && q0 + col + e < rows[i]) ||
                         rows[i] >= s_len))
              pv = 0.f;
            p[e] = pv;
            ds[e] = pv * (dpt[idx] - (e ? delta2.y : delta2.x)) * scale;
          }
          p_frag[j / 2][2 * (j % 2) + i] = sm90::pack2<T>(p[0], p[1]);
          ds_frag[j / 2][2 * (j % 2) + i] = sm90::pack2<T>(ds[0], ds[1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q.
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk)
        sm90::wgmma_rs<T, D, 1>(dv_acc, p_frag[kk],
                                sm90::desc_mnmajor(do_s, kBlockQ, kk), true);
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk)
        sm90::wgmma_rs<T, D, 1>(dk_acc, ds_frag[kk],
                                sm90::desc_mnmajor(q_s, kBlockQ, kk), true);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk_acc);
      sm90::fence_regs(dv_acc);
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    // Epilogue: the k rows inside S, straight from the accumulators.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= s_len) continue;
      const size_t at = (size_t(bkv) * s_len + rows[i]) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
            sm90::pack2<T>(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
            sm90::pack2<T>(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int hq, int hkv, int s_len,
                   int dtype, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err =
      sm90::make_tile_map(&q_map, q, dtype, b * hq, s_len, D, kBlockQ);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&do_map, dout, dtype, b * hq, s_len, D,
                              kBlockQ);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&k_map, k, dtype, b * hkv, s_len, D, kBlockK);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&v_map, v, dtype, b * hkv, s_len, D, kBlockK);
  if (err != cudaSuccess) return err;
  const int smem = sm90::launch_smem_bytes(Smem<D>::bytes);
  err = cudaFuncSetAttribute(fa_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hkv, (s_len + kBlockK - 1) / kBlockK);
  fa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), hq, hkv, s_len, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, dout [B,Hq,S,D] and k, v
// [B,Hkv,S,D] contiguous, 16-byte aligned; lse, delta [B,Hq,S] f32;
// dk, dv [B,Hkv,S,D], summed over each kv head's group of query heads.
// dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s_len, int head_dim, int dtype, float scale, int causal,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 128)
    return int(launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv,
                                          b, hq, hkv, s_len, dtype, scale,
                                          causal, st));
  if (dtype == 0 && head_dim == 64)
    return int(launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv,
                                         b, hq, hkv, s_len, dtype, scale,
                                         causal, st));
  if (dtype == 1 && head_dim == 128)
    return int(launch<__half, 128>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                   hkv, s_len, dtype, scale, causal, st));
  if (dtype == 1 && head_dim == 64)
    return int(launch<__half, 64>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                  hkv, s_len, dtype, scale, causal, st));
  return int(cudaErrorInvalidValue);
}
