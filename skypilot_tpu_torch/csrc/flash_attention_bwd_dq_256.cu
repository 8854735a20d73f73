// Flash-attention backward, dq kernel at head_dim 256, for Hopper (sm_90a):
// wgmma, a TMA ring of 32-row K/V stages, dS in registers.  (The dk/dv
// kernel of this width is flash_attention_bwd_dkv_256.cu; the dq kernel at
// 64 and 128 is flash_attention_bwd_dq.cu, whose design this one resizes.)
//
// Replaces the Pallas TPU kernel `_fa_bwd_dq_kernel`, driven by
// `flash_attention_bwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// head_dim 256 in bf16 and fp16: Gemma's attention width, and the
// zero-padded head_dims 160 and 200 (the wrapper pads them to 256).  It
// recomputes the softmax tile from the forward's saved row logsumexp, so
// nothing O(S^2) reaches device memory:
//   P  = exp(mask(Q K^T * scale) - lse)       (-1e30 mask; lse = +inf -> 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale             (delta = rowsum(dO * O), f32,
//                                              computed outside the kernel)
//   dQ = dS K
// with dS rounded to the input type before its product, as the TPU kernel
// does (ds.astype(k.dtype)), f32 sums, and dq written in the input type.
// `scale` is the caller's (the real head_dim^-1/2 on the padded route).
//
// What bounds it on an H100: 6 D flops per (q, k) pair against O(S D)
// bytes, so the tensor cores at training shapes (989 TFLOP/s bf16: 0.417
// ms at Gemma-7B's B=2, Hq=16, S=4096 causal) and the bytes at the serving
// bucket's (8 x 256).
//
// Design: the wgmma dq kernel's, resized for 256 columns.
// - One CTA per (batch * q-head, 128-row q tile) and three warpgroups:
//   warpgroup 0 produces (one thread issues every TMA load; 24 registers
//   after setmaxnreg), warpgroups 1 and 2 consume 64 q rows each (240
//   registers: dQ alone is 128).  Blocks are numbered so that the
//   heaviest causal q tiles (the last) start first.  B * Hq * S / 128 CTAs: 1024 at Gemma-7B's training shape, 512
//   at Gemma-2B's, 128 at Gemma-2B's serving bucket.
// - Q and dO of the 128 rows stay resident in shared memory: 128 KB.  At
//   D = 256 a 64-row K/V stage would be 64 KB, so the ring holds 32-row
//   stages (16 KB of K and 16 KB of V) and three of them fit: 224 KB of
//   dynamic shared memory.  (64 q rows a CTA with 64-row stages would
//   also fit, but would stream every K/V tile for half as many q rows:
//   twice the L2 traffic per flop.)  GQA: the K/V tensor maps run over
//   [B * Hkv, S, D] and the CTA reads kv head h / (Hq / Hkv).
// - S = Q K^T and dP = dO V^T by wgmma m64n32k16 (16 k-steps each), all
//   operands K-major as TMA lays them down.  P = 2^(S scale log2 e - lse
//   log2 e) and dS = P (dP - delta) scale are formed in the accumulator
//   registers (lse and delta of the thread's two q rows held for the
//   whole sweep) and packed to 16-bit pairs, the register A fragment of
//   dQ += dS K: m64n256k16 into the f32 dQ accumulator (128 registers a
//   thread), K as the shared-memory B operand, MN-major, with the
//   transpose flag.  Registers: dQ 128, S and dP 16 each, the dS
//   fragments 8.
// - Overlap as in the D = 128 kernel: tile t's S and dP and tile t-1's
//   dQ product are issued together and dS of tile t is formed under the
//   dQ product.  The two warpgroups issue as they go: the D = 128
//   kernel's ping-pong (named barriers handing the turn to issue back and
//   forth) measured slower at D = 256 on an H100.
// - Masking only where needed: the causal diagonal tiles (k > q gives
//   P = 0, as the TPU kernel's -1e30) and the ragged last tile (key
//   columns past S are zero-filled by TMA, which would give P = exp(-lse)
//   != 0, so they are set to P = 0).  A tile wholly above a warpgroup's
//   diagonal is not computed; the warpgroup still waits for the stage and
//   releases it, so the ring stays in step.
// - Epilogue: dq straight from the accumulators, rows past S skipped.
//   Each dq element is summed by one thread in a fixed order, with no
//   atomics: dq is bit-reproducible run to run.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kD = 256;
constexpr int kBlockM = 128;   // q rows per CTA: 2 consumer warpgroups x 64
constexpr int kBlockN = 32;    // k/v rows per stage
constexpr int kStages = 3;
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  static constexpr int kQBytes = kBlockM * kD * 2;
  static constexpr int kKVBytes = kBlockN * kD * 2;
  static constexpr int q_off = 0;
  static constexpr int do_off = kQBytes;
  __host__ __device__ static constexpr int k_off(int s) {
    return 2 * kQBytes + s * 2 * kKVBytes;
  }
  __host__ __device__ static constexpr int v_off(int s) {
    return k_off(s) + kKVBytes;
  }
  static constexpr int bar_off = 2 * kQBytes + kStages * 2 * kKVBytes;
  // q_full, full[kStages], empty[kStages]
  static constexpr int bytes =
      bar_off + (1 + 2 * kStages) * 8 + sm90::kSmemAlign;
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "tiles must keep 1024-byte alignment");
  static_assert(bytes <= 232448, "more than a CTA's shared memory");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq_256_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int hq, int hkv, int s_len, float scale,
                         int causal) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  T* do_s = reinterpret_cast<T*>(smem + L::do_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;                      // b * hq + h
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int b = bh / hq;
  const int bkv = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = q_tile * kBlockM;
  const int n_tiles_all = (s_len + kBlockN - 1) / kBlockN;
  const int n_tiles =
      causal ? min(n_tiles_all, (q0 + kBlockM) / kBlockN) : n_tiles_all;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ----- producer: one thread loads Q and dO, then keeps the ring full.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
      sm90::tma_load_tile<T, kD>(q_s, &q_map, q_full, kBlockM, q0, bh);
      sm90::tma_load_tile<T, kD>(do_s, &do_map, q_full, kBlockM, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        sm90::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKVBytes);
        sm90::tma_load_tile<T, kD>(reinterpret_cast<T*>(smem + L::k_off(s)),
                                   &k_map, &full[s], kBlockN, t * kBlockN,
                                   bkv);
        sm90::tma_load_tile<T, kD>(reinterpret_cast<T*>(smem + L::v_off(s)),
                                   &v_map, &full[s], kBlockN, t * kBlockN,
                                   bkv);
      }
    }
  } else {
    // ----- consumers: 64 q rows per warpgroup.
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int wg_row0 = q0 + cw * 64;
    // The two q rows (i = 0, 1) this thread holds in every accumulator,
    // and their -lse log2 e and delta, fixed over the whole sweep.
    const int row_base = wg_row0 + warp * 16 + lane / 4;
    const int rows[2] = {row_base, row_base + 8};
    float neg_lse[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in_seq = rows[i] < s_len;
      const size_t at = size_t(bh) * s_len + rows[i];
      neg_lse[i] = in_seq ? -lse[at] * kLog2e : -INFINITY;
      delta_r[i] = in_seq ? delta[at] : 0.f;
    }
    const float scale_log2 = scale * kLog2e;
    // Tiles this warpgroup computes: when causal, those that start at or
    // before its last row.
    const int n_mine =
        causal ? min(n_tiles, (wg_row0 + 64 + kBlockN - 1) / kBlockN)
               : n_tiles;

    float dq_acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dq_acc[i] = 0.f;
    float s_acc[kBlockN / 2], dp_acc[kBlockN / 2];
    uint32_t ds_frag[kBlockN / 16][4];

    auto k_tile = [&](int t) {
      return reinterpret_cast<const T*>(smem + L::k_off(t % kStages));
    };
    auto v_tile = [&](int t) {
      return reinterpret_cast<const T*>(smem + L::v_off(t % kStages));
    };
    auto parity = [](int t) { return uint32_t(t / kStages) & 1; };
    // S = Q K_t^T and dP = dO V_t^T: the warpgroup's 64 q rows x kBlockN
    // (Q's and dO's descriptors formed here, sm90::opaque).
    auto issue_sdp = [&](int t) {
      const T* q_t = sm90::opaque(q_s);
      const T* do_t = sm90::opaque(do_s);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        sm90::wgmma_ss<T, kBlockN, 0>(
            s_acc, sm90::desc_kmajor(q_t, kBlockM, cw * 64, k),
            sm90::desc_kmajor(k_tile(t), kBlockN, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        sm90::wgmma_ss<T, kBlockN, 0>(
            dp_acc, sm90::desc_kmajor(do_t, kBlockM, cw * 64, k),
            sm90::desc_kmajor(v_tile(t), kBlockN, 0, k), k > 0);
      sm90::wgmma_commit();
    };
    // dQ += dS K_t: m64n256k16, every column of dQ in one product.
    auto issue_dq = [&](int t) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        sm90::wgmma_rs<T, kD, 1>(dq_acc, ds_frag[kk],
                                 sm90::desc_mnmajor(k_tile(t), kBlockN, kk),
                                 true);
      sm90::wgmma_commit();
    };
    // dS of tile t in f32, in place of S (the dS fragments of tile t - 1
    // may still be read by its dQ product).
    auto form_ds = [&](int t) {
      const int k0 = t * kBlockN;
      const bool mask =
          (causal && k0 + kBlockN - 1 > wg_row0) || k0 + kBlockN > s_len;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            float p = sm90::ex2(fmaf(s_acc[idx], scale_log2, neg_lse[i]));
            if (mask) {
              const int col = k0 + 8 * j + 2 * quad + e;
              if (col >= s_len || (causal && col > rows[i])) p = 0.f;
            }
            s_acc[idx] = p * (dp_acc[idx] - delta_r[i]) * scale;
          }
    };
    // dS rounded to T, as the register A fragments of the k16 slices.
    auto pack_ds = [&] {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds_frag[kk][r] = sm90::pack2<T>(s_acc[8 * kk + 2 * r],
                                          s_acc[8 * kk + 2 * r + 1]);
    };

    // Tile 0: S and dP only.
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&full[0], 0);
    sm90::wgmma_fence();
    issue_sdp(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s_acc);
    sm90::fence_regs(dp_acc);
    form_ds(0);
    pack_ds();

    // Tile t: S_t, dP_t and dQ += dS_{t-1} K_{t-1} in flight together; dS_t
    // is formed under the dQ product.
    for (int t = 1; t < n_mine; ++t) {
      sm90::mbar_wait(&full[t % kStages], parity(t));
      sm90::wgmma_fence();
      issue_sdp(t);
      issue_dq(t - 1);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s_acc);
      sm90::fence_regs(dp_acc);
      form_ds(t);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq_acc);
      if (lane == 0) sm90::mbar_arrive(&empty[(t - 1) % kStages]);
      pack_ds();
    }

    // The last tile's dQ product.
    sm90::wgmma_fence();
    issue_dq(n_mine - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq_acc);
    if (lane == 0) sm90::mbar_arrive(&empty[(n_mine - 1) % kStages]);
    // Tiles wholly above this warpgroup's diagonal: waited for and
    // released, so the producer's ring stays in step.
    for (int t = n_mine; t < n_tiles; ++t) {
      sm90::mbar_wait(&full[t % kStages], parity(t));
      if (lane == 0) sm90::mbar_arrive(&empty[t % kStages]);
    }

    // Epilogue: the q rows inside S, straight from the accumulators.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= s_len) continue;
      T* dq_row = dq + (size_t(bh) * s_len + rows[i]) * kD + 2 * quad;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dq_row + 8 * j) = sm90::pack2<T>(
            dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int hq, int hkv, int s_len, int dtype,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err =
      sm90::make_tile_map(&q_map, q, dtype, b * hq, s_len, kD, kBlockM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&do_map, dout, dtype, b * hq, s_len, kD,
                              kBlockM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&k_map, k, dtype, b * hkv, s_len, kD, kBlockN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&v_map, v, dtype, b * hkv, s_len, kD, kBlockN);
  if (err != cudaSuccess) return err;
  const int smem = sm90::launch_smem_bytes(Smem::bytes);
  err = cudaFuncSetAttribute(fa_bwd_dq_256_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + kBlockM - 1) / kBlockM);
  fa_bwd_dq_256_kernel<T><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), hq, hkv, s_len,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_bwd_dq at head_dim 256.  q, dout, dq [B,Hq,S,D]
// and k, v [B,Hkv,S,D] contiguous, 16-byte aligned; lse, delta [B,Hq,S]
// f32.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_bwd_dq_256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int s_len, int head_dim, int dtype, float scale, int causal,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      head_dim != kD || (s_len + kBlockM - 1) / kBlockM > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b, hq,
                                     hkv, s_len, dtype, scale, causal, st));
  if (dtype == 1)
    return int(launch<__half>(q, k, v, dout, lse, delta, dq, b, hq, hkv,
                              s_len, dtype, scale, causal, st));
  return int(cudaErrorInvalidValue);
}
