// Flash-attention forward at head_dim 256 for Hopper (sm_90a): wgmma, a TMA
// ring of 64-row K/V stages, 64-row q slabs a consumer warpgroup.  (The
// forward at 64 and 128 is flash_attention_fwd.cu, whose design this one
// resizes; dq and dk/dv at 256 are flash_attention_bwd_{dq,dkv}_256.cu.)
//
// Replaces the Pallas TPU kernel `_fa_kernel`, driven by
// `flash_attention_fwd` in skypilot_tpu/ops/pallas/flash_attention.py, at
// head_dim 256 in bf16 and fp16: Gemma's attention width, and the
// zero-padded head_dims 160 and 200 (the wrapper pads them to 256).
// O = softmax(mask(Q K^T * scale)) V by online softmax, causal or not, GQA
// (q head h reads kv head h / (Hq / Hkv)), the TPU kernel's -1e30 mask,
// rows whose denominator is 0 emitting 0 and lse +inf, P rounded to the
// input type before P V (the TPU kernel's p.astype(v.dtype)), f32 sums,
// and the row logsumexp in natural-log units only when lse is not null.
// `scale` is the caller's (the real head_dim^-1/2 on the padded route).
//
// What bounds it on an H100: 4 D flops per (q, k) pair against 2 D bytes
// per row of q, k, v and out, so the tensor cores at the training shapes
// (989 TFLOP/s bf16: 0.278 ms at Gemma-7B's B=2, Hq=16, S=4096 causal)
// and the bytes at the serving bucket's (8 x 256: q, k, v read once and
// out written once at 3.35 TB/s).
//
// Design: the wgmma forward of D = 128, resized for 256 columns.
// - One CTA per (batch * q-head, 128-row q tile) and three warpgroups:
//   warpgroup 0 produces (it gives up its registers by setmaxnreg while
//   one of its threads issues every TMA load), warpgroups 1 and 2 consume
//   64 q rows each.  Blocks are numbered so that the heaviest causal q
//   tiles (the last) start first.  1024 CTAs at Gemma-7B's training
//   shape, 512 at Gemma-2B's, 256 at Gemma-7B's serving bucket, 128 at
//   Gemma-2B's.  A CTA of 128 q rows serves each K/V tile it streams from
//   L2 to twice the rows a 64-row one does: one consumer a CTA (twice the
//   CTAs) measured slower on an H100 at all four shapes, Gemma-2B's
//   serving bucket, a grid under one wave, included.  So did numbering
//   the q tiles fastest, so that a wave holds fewer heads' K/V: the
//   heaviest tiles of the last heads then start last.
// - Registers.  O of 64 rows x 256 in f32 is 128 registers a consumer
//   thread.  With 64-row K/V tiles S is 32 more and P's packed fragments
//   16: 176 before the softmax state and addresses, under the 240 that
//   setmaxnreg gives a consumer (24 left to the producer).  128-row
//   tiles (the D = 128 kernel's) would need 64 + 32 and leave no room
//   for the overlap below.
// - Shared memory: Q's 128 rows resident (64 KB) and two K + V stages of
//   64 rows (64 KB each): 192 KB of dynamic shared memory, one CTA per
//   SM.  K and V of a stage have full and empty barriers of their own, so
//   S = Q K^T starts before V lands and K is released as soon as S is
//   done.  GQA: the K/V tensor maps run over [B * Hkv, S, D].
// - Products.  S = Q K^T by wgmma m64n64k16 (16 k-steps), Q and K both
//   K-major as TMA lays rows down.  O += P V by m64n256k16 (4 k-steps):
//   P, packed from the S accumulator, is the register A operand, V the
//   shared-memory B operand, MN-major, with the transpose flag.  The
//   descriptors of the resident Q are formed where each product is issued
//   (sm90::opaque), or ptxas hoists sixteen 64-bit descriptors out of the
//   loop and spills.
// - Overlap inside a warpgroup, as at D = 128: tile t's S = Q K_t^T and
//   tile t-1's O += P V_{t-1} are issued together and the softmax of S_t
//   (sm90::softmax_tile: 2^x on the SFU with log2 e folded into the
//   scale; the row sum reduced across lanes once, at the end) runs while
//   P V is in flight.  Between the two warpgroups the turn to issue
//   products is handed back and forth (ping-pong, named barriers), as in
//   the D = 128 kernel, so one warpgroup's softmax overlaps the other's
//   products: on an H100 a little faster than issuing as they go at
//   three of Gemma's four shapes, a little slower at Gemma-7B's serving
//   bucket (PERF.md, the forward at 256).
// - Masking only where needed: each consumer's causal diagonal tile (its
//   64 rows against the 64 keys of the same positions) and the ragged
//   last tile (key columns past S arrive as TMA zeros and are masked, so
//   they give P = 0).  A tile wholly above a consumer's diagonal (the
//   CTA's last, for the first consumer) is not computed; the consumer
//   still waits for its stage and releases it, so the ring stays in step.
// - Epilogue: out = acc / l (0 where l = 0) rounded to the input type into
//   the warpgroup's own 64-row slab of Q's shared memory (free once its
//   last S is done), swizzled as TMA lays tiles down, then stored by TMA:
//   four 64 x 64 boxes a warpgroup, rows past S not written.  Written
//   from the registers instead, each warp store covers 8 rows of 16
//   bytes, which measured slower on an H100 at all four Gemma shapes,
//   most at the serving buckets.  lse = m + log l (+inf where l = 0)
//   from the registers, not written when the pointer is null
//   (serving).

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kD = 256;
constexpr int kBlockN = 64;  // kv rows per stage (== a consumer's q rows:
                             // a consumer's diagonal is one kv tile)
constexpr int kStages = 2;
constexpr int kBlockM = 128;  // q rows per CTA: 2 consumer warpgroups x 64
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  static constexpr int kQBytes = kBlockM * kD * 2;
  static constexpr int kKVBytes = kBlockN * kD * 2;
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
  static_assert(bytes <= 232448, "more than a CTA's shared memory");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fa_fwd_256_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map,
                      float* __restrict__ lse, int hq, int hkv, int s_len,
                      float scale_log2, int causal) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_smem(smem_raw);
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

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
    // ----- producer: one thread loads Q, then keeps both rings full.
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, L::kQBytes);
      sm90::tma_load_tile<T, kD>(q_s, &q_map, q_full, kBlockM, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t free_parity = ((t / kStages) & 1) ^ 1;
        sm90::mbar_wait(&k_empty[s], free_parity);
        sm90::mbar_arrive_expect_tx(&k_full[s], L::kKVBytes);
        sm90::tma_load_tile<T, kD>(reinterpret_cast<T*>(smem + L::k_off(s)),
                                   &k_map, &k_full[s], kBlockN, t * kBlockN,
                                   bkv);
        sm90::mbar_wait(&v_empty[s], free_parity);
        sm90::mbar_arrive_expect_tx(&v_full[s], L::kKVBytes);
        sm90::tma_load_tile<T, kD>(reinterpret_cast<T*>(smem + L::v_off(s)),
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
    const int wg_row0 = q0 + cw * 64;
    // The two rows (i = 0, 1) this thread holds in every accumulator.
    const int row_base = wg_row0 + warp * 16 + lane / 4;
    const int rows[2] = {row_base, row_base + 8};
    // Tiles this warpgroup computes: when causal, those that start at or
    // before its last row (its diagonal is tile wg_row0 / kBlockN).
    const int n_mine =
        causal ? min(n_tiles, (wg_row0 + 64) / kBlockN) : n_tiles;
    // Ping-pong: a warpgroup issues its products only on its turn (named
    // barrier 1 + cw), then hands the turn over; warpgroup 0 starts.
    const int my_turn = 1 + cw;
    const int other_turn = 2 - cw;
    auto take_turn = [&] {
      sm90::named_barrier_sync(my_turn, kConsumerThreads);
    };
    auto hand_over = [&] {
      sm90::named_barrier_arrive(other_turn, kConsumerThreads);
    };
    if (cw == 0) sm90::named_barrier_arrive(my_turn, kConsumerThreads);

    float o_acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o_acc[i] = 0.f;
    // The running max (log2 units) and this thread's share of the row sum.
    float m[2] = {sm90::kMaskValue, sm90::kMaskValue};
    float l[2] = {0.f, 0.f};
    float corr[2];
    float s_acc[kBlockN / 2];
    uint32_t p_frag[kBlockN / 16][4];

    auto k_tile = [&](int t) {
      return reinterpret_cast<const T*>(smem + L::k_off(t % kStages));
    };
    auto v_tile = [&](int t) {
      return reinterpret_cast<const T*>(smem + L::v_off(t % kStages));
    };
    auto parity = [](int t) { return uint32_t(t / kStages) & 1; };
    // S = Q K_t^T: the warpgroup's 64 q rows x 64 keys.
    auto issue_s = [&](int t) {
      const T* q_t = sm90::opaque(q_s);
      const T* k_s = sm90::opaque(k_tile(t));
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        sm90::wgmma_ss<T, kBlockN, 0>(
            s_acc, sm90::desc_kmajor(q_t, kBlockM, cw * 64, k),
            sm90::desc_kmajor(k_s, kBlockN, 0, k), k > 0);
      sm90::wgmma_commit();
    };
    // O += P V_t: m64n256k16, every column of O in one product.
    auto issue_pv = [&](int t) {
      const T* v_s = sm90::opaque(v_tile(t));
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        sm90::wgmma_rs<T, kD, 1>(o_acc, p_frag[kk],
                                 sm90::desc_mnmajor(v_s, kBlockN, kk), true);
      sm90::wgmma_commit();
    };
    auto softmax = [&](int t) {
      const int k0 = t * kBlockN;
      const bool mask =
          (causal && k0 + kBlockN - 1 > wg_row0) || k0 + kBlockN > s_len;
      sm90::softmax_tile<kBlockN>(s_acc, m, l, corr, mask, k0, rows, s_len,
                                  causal, scale_log2, quad);
    };

    // Tile 0: S only (O is still 0).
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(&k_full[0], 0);
    take_turn();
    sm90::wgmma_fence();
    issue_s(0);
    hand_over();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s_acc);
    if (lane == 0) sm90::mbar_arrive(&k_empty[0]);
    softmax(0);
    sm90::to_a_frags<T, kBlockN>(s_acc, p_frag);

    // Tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} in flight together;
    // the softmax of S_t runs under P V.
    for (int t = 1; t < n_mine; ++t) {
      const int s = t % kStages;
      const int sp = (t - 1) % kStages;
      sm90::mbar_wait(&k_full[s], parity(t));
      sm90::mbar_wait(&v_full[sp], parity(t - 1));
      take_turn();
      sm90::wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      hand_over();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s_acc);
      if (lane == 0) sm90::mbar_arrive(&k_empty[s]);
      softmax(t);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o_acc);
      if (lane == 0) sm90::mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o_acc[4 * j + 2 * i] *= corr[i];
          o_acc[4 * j + 2 * i + 1] *= corr[i];
        }
      sm90::to_a_frags<T, kBlockN>(s_acc, p_frag);
    }

    // The last computed tile's P V.
    sm90::mbar_wait(&v_full[(n_mine - 1) % kStages], parity(n_mine - 1));
    take_turn();
    sm90::wgmma_fence();
    issue_pv(n_mine - 1);
    hand_over();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o_acc);
    if (lane == 0) sm90::mbar_arrive(&v_empty[(n_mine - 1) % kStages]);
    // Tiles wholly above this warpgroup's diagonal: waited for and
    // released, so the producer's ring stays in step; each still takes
    // and hands over its turn, so the two warpgroups pass the turn as
    // often.
    for (int t = n_mine; t < n_tiles; ++t) {
      sm90::mbar_wait(&k_full[t % kStages], parity(t));
      if (lane == 0) sm90::mbar_arrive(&k_empty[t % kStages]);
      sm90::mbar_wait(&v_full[t % kStages], parity(t));
      if (lane == 0) sm90::mbar_arrive(&v_empty[t % kStages]);
      take_turn();
      hand_over();
    }
    // Warpgroup 0 takes the last hand-over, so both barriers end even.
    if (cw == 0) take_turn();

    // Epilogue: out = acc / l (0 where l == 0), rounded to T, into this
    // warpgroup's 64-row slab of Q (free since its last S), swizzled as
    // TMA lays tiles down; lse = m + log l (+inf where l == 0) straight
    // from the registers.  Then one thread stores the slab's four column
    // chunks by TMA (rows past S are not written) and waits until TMA
    // has read them, before the CTA's shared memory goes.
    T* slab = q_s + cw * 64 * 64;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
      const int r = rows[i] - wg_row0;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(
            slab + (j / 8) * kBlockM * 64 + r * 64 +
            (((j % 8) ^ (r % 8)) * 8) + 2 * quad) =
            sm90::pack2<T>(o_acc[4 * j + 2 * i] * inv,
                           o_acc[4 * j + 2 * i + 1] * inv);
      if (lse != nullptr && quad == 0 && rows[i] < s_len)
        lse[size_t(bh) * s_len + rows[i]] =
            l[i] == 0.f ? INFINITY : (m[i] + log2f(l[i])) * kLn2;
    }
    sm90::fence_async();
    sm90::named_barrier_sync(3 + cw, 128);
    if (tid == 0 && wg_row0 < s_len) {
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
        sm90::tma_store_3d(&o_map, slab + c * kBlockM * 64, c * 64, wg_row0,
                           bh);
      sm90::bulk_commit();
      sm90::bulk_wait_read();
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int hq, int hkv, int s_len, int dtype,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, o_map;
  cudaError_t err =
      sm90::make_tile_map(&q_map, q, dtype, b * hq, s_len, kD, kBlockM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&o_map, o, dtype, b * hq, s_len, kD, 64);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&k_map, k, dtype, b * hkv, s_len, kD, kBlockN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&v_map, v, dtype, b * hkv, s_len, kD, kBlockN);
  if (err != cudaSuccess) return err;
  const int smem = sm90::launch_smem_bytes(Smem::bytes);
  err = cudaFuncSetAttribute(fa_fwd_256_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (s_len + kBlockM - 1) / kBlockM);
  fa_fwd_256_kernel<T><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, o_map, static_cast<float*>(lse), hq, hkv, s_len,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); the contract of
// skytpu_flash_attention_fwd at head_dim 256.  q [B,Hq,S,D], k/v
// [B,Hkv,S,D], o [B,Hq,S,D] contiguous, 16-byte aligned; lse [B,Hq,S] f32
// or null.  dtype: 0 = bf16, 1 = fp16.  Returns the launch's cudaError_t.
extern "C" int skytpu_flash_attention_fwd_256(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* lse, int b, int hq,
                                              int hkv, int s_len,
                                              int head_dim, int dtype,
                                              float scale, int causal,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      head_dim != kD || (s_len + kBlockM - 1) / kBlockM > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(launch<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, s_len,
                                     dtype, scale, causal, st));
  if (dtype == 1)
    return int(launch<__half>(q, k, v, o, lse, b, hq, hkv, s_len, dtype,
                              scale, causal, st));
  return int(cudaErrorInvalidValue);
}
