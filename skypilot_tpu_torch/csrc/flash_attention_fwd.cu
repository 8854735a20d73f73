// Flash-attention forward for Hopper (sm_90a): wgmma, a TMA ring of K/V
// stages, the online softmax in registers.
//
// Replaces the Pallas TPU kernel `_fa_kernel`, driven by
// `flash_attention_fwd` in skypilot_tpu/ops/pallas/flash_attention.py:
// blocked online-softmax attention softmax(Q K^T * D^-1/2) V, causal or
// not, with the causal tiles above the diagonal skipped, all-masked rows
// emitting 0, and (optionally) the row logsumexp (+inf for all-masked
// rows).
//
// What bounds it on an H100: each (q, k) pair costs 4 D flops (Q K^T and
// P V) against O(S D) bytes, so past S ~ 1k the tensor cores bound it
// (989 TFLOP/s bf16: 0.278 ms for bench-1b's B=4, Hq=16, S=4096, D=128
// causal); at the serving prefill shapes (S <= 512) the bytes do (q, k, v
// read once, out written once at 3.35 TB/s).
//
// Design:
// - One CTA per (batch * q-head, 128-row q tile) and three warpgroups.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//   one thread issues every TMA load.  Warpgroups 1 and 2 are consumers
//   of 64 q rows each and take the registers.
// - Q is loaded once; K and V tiles of 128 rows go through a ring of
//   kStages stages with full and empty barriers of their own, so Q K^T
//   starts before V lands and K is released as soon as S is done.  At
//   D = 128 that is 32 KB of Q and 2 x 64 KB of K/V: 160 KB of dynamic
//   shared memory, one CTA per SM.  128-row K/V tiles halve the barrier
//   round trips of 64-row ones and still keep the S accumulator at 64
//   registers a thread.
// - S = Q K^T by wgmma m64n128k16 with Q and K both K-major in shared
//   memory (as TMA lays rows down), so nothing is transposed.
// - The softmax stays in registers: each row's 32 values per thread,
//   then two xor-shuffles over the 4 lanes that share the row; the f32 O
//   accumulator is rescaled in registers.  2^x on the SFU with log2(e)
//   folded into the scale (one FFMA per element); lse is written back in
//   natural-log units (the dq and dk/dv kernels scale it by log2 e once
//   and rebuild P as 2^(x scale log2 e - lse log2 e)).  The row sum is
//   reduced across lanes once, at the end.
// - P is rounded to the input type in registers (as the TPU kernel's
//   p.astype(v.dtype)) and is the register A operand of O += P V
//   (m64nDk16); V is the shared-memory B operand, MN-major, with the
//   transpose flag.
// - The tensor cores are kept busy two ways.  Inside a warpgroup, tile
//   t's S = Q K_t^T and tile t-1's O += P V_{t-1} are issued together and
//   the softmax of S_t runs while P V is in flight (S, O and P: 160 f32
//   registers a thread).  Between the two warpgroups, named barriers hand
//   the turn to issue products back and forth (ping-pong), so one
//   warpgroup's softmax overlaps the other's products.
// - Causal: tiles above the diagonal are skipped, and only the last tile
//   a CTA visits (the diagonal, or the ragged edge past S) is masked
//   element by element, with the TPU kernel's -1e30.  Key columns past S
//   are zero-filled by TMA and masked, so they contribute exactly 0.
//   Blocks are numbered so that the heaviest q tiles start first.
// - Epilogue: out = acc / l (0 where l = 0), lse = m + log l (+inf where
//   l = 0), rows past S not stored, and no lse write when lse is null
//   (serving).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBlockM = 128;  // q rows per CTA: 2 consumer warpgroups x 64
constexpr int kBlockN = 128;  // kv rows per tile (== kBlockM: the diagonal
                              // tile of q tile t is kv tile t)
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int q_off = 0;
  __host__ __device__ static constexpr int k_off(int s) {
    return kQBytes + s * 2 * kKVBytes;
  }
  __host__ __device__ static constexpr int v_off(int s) {
    return k_off(s) + kKVBytes;
  }
  static constexpr int bar_off = kQBytes + kStages * 2 * kKVBytes;
  // q_full, then k_full, v_full, k_empty, v_empty [kStages] each
  static constexpr int bytes =
      bar_off + (1 + 4 * kStages) * 8 + sm90::kSmemAlign;
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0,
                "tiles must keep 1024-byte alignment");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  T* __restrict__ o, float* __restrict__ lse, int hq,
                  int hkv, int s_len, float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int bh = blockIdx.x;                        // b * hq + h
  const int q_tile = gridDim.y - 1 - blockIdx.y;    // heaviest first
  const int b = bh / hq;
  const int bkv = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = q_tile * kBlockM;
  const int n_tiles_all = (s_len + kBlockN - 1) / kBlockN;
  const int n_tiles = causal ? min(n_tiles_all, q_tile + 1) : n_tiles_all;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);  // lane 0 of each consumer warp
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ----- producer: one thread keeps both rings full.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, L::kQBytes);
      sm90::tma_load_tile<T, D>(q_s, &q_map, q_full, kBlockM, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t free_parity = ((t / kStages) & 1) ^ 1;
        sm90::mbar_wait(&k_empty[s], free_parity);
        sm90::mbar_arrive_expect_tx(&k_full[s], L::kKVBytes);
        sm90::tma_load_tile<T, D>(reinterpret_cast<T*>(smem + L::k_off(s)),
                                  &k_map, &k_full[s], kBlockN, t * kBlockN,
                                  bkv);
        sm90::mbar_wait(&v_empty[s], free_parity);
        sm90::mbar_arrive_expect_tx(&v_full[s], L::kKVBytes);
        sm90::tma_load_tile<T, D>(reinterpret_cast<T*>(smem + L::v_off(s)),
                                  &v_map, &v_full[s], kBlockN, t * kBlockN,
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
    // The two rows (i = 0, 1) this thread holds in every accumulator.
    const int row_base = q0 + cw * 64 + warp * 16 + lane / 4;
    const int rows[2] = {row_base, row_base + 8};
    // Ping-pong: a warpgroup issues its products only on its turn (named
    // barrier 1 + cw), then hands the turn over, so one warpgroup's
    // softmax runs under the other's products.  Warpgroup 0 starts.
    const int my_turn = 1 + cw;
    const int other_turn = 2 - cw;
    if (cw == 0) sm90::named_barrier_arrive(my_turn, kConsumerThreads);

    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    // The running max (log2 units) and this thread's share of the row sum.
    float m[2] = {sm90::kMaskValue, sm90::kMaskValue};
    float l[2] = {0.f, 0.f};
    float corr[2];
    float s_acc[kBlockN / 2];
    uint32_t p_frag[kBlockN / 16][4];

    auto issue_s = [&](const T* k_s) {
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss<T, kBlockN, 0>(
            s_acc, sm90::desc_kmajor(q_s, kBlockM, cw * 64, k),
            sm90::desc_kmajor(k_s, kBlockN, 0, k), k > 0);
      sm90::wgmma_commit();
    };
    auto issue_pv = [&](const T* v_s) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        sm90::wgmma_rs<T, D, 1>(o_acc, p_frag[kk],
                                sm90::desc_mnmajor(v_s, kBlockN, kk), true);
      sm90::wgmma_commit();
    };
    auto k_tile = [&](int t) {
      return reinterpret_cast<const T*>(smem + L::k_off(t % kStages));
    };
    auto v_tile = [&](int t) {
      return reinterpret_cast<const T*>(smem + L::v_off(t % kStages));
    };
    auto parity = [](int t) { return uint32_t(t / kStages) & 1; };

    // Tile 0: S only (O is still 0).
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    sm90::named_barrier_sync(my_turn, kConsumerThreads);
    sm90::wgmma_fence();
    issue_s(k_tile(0));
    sm90::named_barrier_arrive(other_turn, kConsumerThreads);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s_acc);
    if (lane == 0) sm90::mbar_arrive(&k_empty[0]);
    sm90::softmax_tile<kBlockN>(s_acc, m, l, corr, n_tiles == 1, 0, rows,
                                s_len, causal, scale_log2, quad);
    sm90::to_a_frags<T, kBlockN>(s_acc, p_frag);

    // Tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} in flight together;
    // the softmax of S_t runs under P V.
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int sp = (t - 1) % kStages;
      sm90::mbar_wait(&k_full[s], parity(t));
      sm90::mbar_wait(&v_full[sp], parity(t - 1));
      sm90::named_barrier_sync(my_turn, kConsumerThreads);
      sm90::wgmma_fence();
      issue_s(k_tile(t));
      issue_pv(v_tile(t - 1));
      sm90::named_barrier_arrive(other_turn, kConsumerThreads);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s_acc);
      if (lane == 0) sm90::mbar_arrive(&k_empty[s]);
      sm90::softmax_tile<kBlockN>(s_acc, m, l, corr, t == n_tiles - 1,
                                  t * kBlockN, rows, s_len, causal,
                                  scale_log2, quad);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o_acc);
      if (lane == 0) sm90::mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o_acc[4 * j + 2 * i] *= corr[i];
          o_acc[4 * j + 2 * i + 1] *= corr[i];
        }
      sm90::to_a_frags<T, kBlockN>(s_acc, p_frag);
    }

    // The last tile's P V.
    sm90::mbar_wait(&v_full[(n_tiles - 1) % kStages], parity(n_tiles - 1));
    sm90::named_barrier_sync(my_turn, kConsumerThreads);
    sm90::wgmma_fence();
    issue_pv(v_tile(n_tiles - 1));
    sm90::named_barrier_arrive(other_turn, kConsumerThreads);
    // Warpgroup 0 takes the last hand-over, so both barriers end even.
    if (cw == 0) sm90::named_barrier_sync(my_turn, kConsumerThreads);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o_acc);

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
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(o_row + 8 * j) =
            sm90::pack2<T>(o_acc[4 * j + 2 * i] * inv[i],
                           o_acc[4 * j + 2 * i + 1] * inv[i]);
      if (lse != nullptr && quad == 0)
        lse[size_t(bh) * s_len + rows[i]] =
            l[i] == 0.f ? INFINITY : (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int hq, int hkv, int s_len, int dtype,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err =
      sm90::make_tile_map(&q_map, q, dtype, b * hq, s_len, D, kBlockM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&k_map, k, dtype, b * hkv, s_len, D, kBlockN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&v_map, v, dtype, b * hkv, s_len, D, kBlockN);
  if (err != cudaSuccess) return err;
  const int smem = sm90::launch_smem_bytes(Smem<D>::bytes);
  err = cudaFuncSetAttribute(fa_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + kBlockM - 1) / kBlockM);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), static_cast<float*>(lse), hq,
      hkv, s_len, scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B,Hq,S,D], k/v [B,Hkv,S,D],
// o [B,Hq,S,D] contiguous, 16-byte aligned; lse [B,Hq,S] f32 or null.
// dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int b, int hq, int hkv, int s_len,
                                          int head_dim, int dtype, float scale,
                                          int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 128)
    return int(launch<__nv_bfloat16, 128>(q, k, v, o, lse, b, hq, hkv, s_len,
                                          dtype, scale, causal, st));
  if (dtype == 0 && head_dim == 64)
    return int(launch<__nv_bfloat16, 64>(q, k, v, o, lse, b, hq, hkv, s_len,
                                         dtype, scale, causal, st));
  if (dtype == 1 && head_dim == 128)
    return int(launch<__half, 128>(q, k, v, o, lse, b, hq, hkv, s_len, dtype,
                                   scale, causal, st));
  if (dtype == 1 && head_dim == 64)
    return int(launch<__half, 64>(q, k, v, o, lse, b, hq, hkv, s_len, dtype,
                                  scale, causal, st));
  return int(cudaErrorInvalidValue);
}
