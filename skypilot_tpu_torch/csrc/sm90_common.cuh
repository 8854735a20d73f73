// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA tile loads into 128-byte-swizzled shared memory and
// stores out of it, the wgmma shared-memory descriptor and the m64nNk16
// bf16/fp16 -> f32 products (A from shared memory or from registers),
// warpgroup register reallocation, the forwards' online-softmax step, and
// the host-side tensor maps.
//
// Layout convention.  Every 16-bit tile of R rows by D columns (D = 64,
// 128 or 256) lies in shared memory as D / 64 column chunks of R rows x 128
// bytes, each chunk 1024-byte aligned and swizzled as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it (16-byte unit u of row r lands at
// u ^ (r % 8)).  That is the canonical 128-byte-swizzle layout of wgmma
// for both operand majors:
// - K-major (the reduction runs along the row: Q and K in Q K^T):
//   8-row groups 1024 bytes apart (SBO), one k16 step is +32 bytes
//   inside a chunk, the next chunk is the next 64 k.
// - MN-major (the reduction runs down the rows: V in P V, with the
//   transpose flag): 8-row k groups 1024 bytes apart (SBO), one k16 step
//   is +2048 bytes, and the next 64 columns of N are the next chunk
//   (LBO = R x 128 bytes).
//
// Accumulator fragment of an m64nN f32 product, per thread of the
// warpgroup (warp w, lane l): rows 16 w + l / 4 (i = 0) and + 8 (i = 1);
// register 4 j + 2 i + e holds column 8 j + 2 (l % 4) + e.  Packing the
// registers 8 kk + 2 q and 8 kk + 2 q + 1 into one 16-bit pair for q = 0..3
// gives exactly the register A fragment of the k16 slice kk of the next
// product (the reuse FlashAttention-3 relies on).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

// ----- shared memory and mbarriers -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.  Callers derive
// the parity from their own iteration count (round r of a ring waits on
// r & 1), so no phase bit is carried between iterations.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barriers 1..15 over `threads` threads (a multiple of 32); id 0 is
// __syncthreads'.  An arrive counts without waiting.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ----- TMA -------------------------------------------------------------------

// One box of a 3-D tensor map ([B * H, S, D], innermost first in the
// coordinates: column c0, row c1, head c2) into shared memory; completion
// is reported to `bar` as transaction bytes.  Rows past S arrive as
// zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One box of shared memory (laid out as tma_load_3d lays it down) into a
// 3-D tensor map at (column c0, row c1, head c2), as a bulk async-group of
// the issuing thread; rows past the map's S are not written.  The writes
// to `src` must be made visible to the async proxy first (fence_async).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA) reads of it.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every committed bulk group of this thread has read its
// shared-memory source (so the source may be freed or rewritten).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// All D / 64 column chunks of `rows` rows starting at row `row0` of head
// `head`, into a tile laid out as the file's header says.
template <typename T, int D>
__device__ __forceinline__ void tma_load_tile(T* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int row0, int head) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(dst + c * rows * 64, map, bar, c * 64, row0, head);
}

// ----- warpgroup registers and wgmma ----------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// Offsets in bytes; the start address is 16-byte aligned and the tile's
// chunk 1024-byte aligned, so the base offset field stays 0.
__device__ __forceinline__ uint64_t make_desc(const void* smem,
                                              uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t desc = (smem_u32(smem) & 0x3FFFF) >> 4;
  desc |= uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16;
  desc |= uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32;
  desc |= uint64_t(1) << 62;
  return desc;
}

// Descriptor of the k16 step `k` of a K-major tile (rows x D, 16-bit):
// chunk k / 4, +32 bytes per step inside it; `row0` selects the first of
// the product's rows (a multiple of 8).
template <typename T>
__device__ __forceinline__ uint64_t desc_kmajor(const T* tile, int rows,
                                                int row0, int k) {
  return make_desc(tile + (k / 4) * rows * 64 + row0 * 64 + (k % 4) * 16,
                   16, 1024);
}

// Descriptor of the k16 step `k` of an MN-major tile (rows along the
// reduction, rows x D): +16 rows per step, chunks `rows` x 128 bytes
// apart along N.
template <typename T>
__device__ __forceinline__ uint64_t desc_mnmajor(const T* tile, int rows,
                                                 int k) {
  return make_desc(tile + k * 16 * 64, uint32_t(rows) * 128, 1024);
}

// The pointer, hidden from the optimizer at this point: wgmma descriptors
// of a tile that stays resident over a loop, derived from it inside the
// loop, are then formed where each product is issued instead of being
// hoisted out of the loop and held (at D = 256 sixteen 64-bit descriptors
// per product, more registers than a consumer can spare).
template <typename P>
__device__ __forceinline__ P* opaque(P* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait (the asm that wrote them completes asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SKYTPU_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SKYTPU_ACC32(i) \
  SKYTPU_ACC8(i), SKYTPU_ACC8(i + 8), SKYTPU_ACC8(i + 16), SKYTPU_ACC8(i + 24)
#define SKYTPU_D16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SKYTPU_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SKYTPU_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SKYTPU_D128                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                               \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                      \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                      \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                      \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                      \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                      \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "                      \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                      \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "                      \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "                      \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "            \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "            \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define SKYTPU_PRED(n) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n ", 0;\n"

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) B (16 x N, shared;
// K-major, or MN-major with kTransB = 1); N = 32, 64 or 128.
template <typename T, int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, bool accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "N is 32, 64 or 128");
  if constexpr (N == 32 && kIsBf16<T>) {
    asm volatile(SKYTPU_PRED(18)
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 SKYTPU_D16 ", %16, %17, p, 1, 1, 0, %19;\n}\n"
                 : SKYTPU_ACC8(0), SKYTPU_ACC8(8)
                 : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)),
                   "n"(kTransB));
  } else if constexpr (N == 32) {
    asm volatile(SKYTPU_PRED(18)
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
                 SKYTPU_D16 ", %16, %17, p, 1, 1, 0, %19;\n}\n"
                 : SKYTPU_ACC8(0), SKYTPU_ACC8(8)
                 : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)),
                   "n"(kTransB));
  } else if constexpr (N == 64 && kIsBf16<T>) {
    asm volatile(SKYTPU_PRED(34)
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 SKYTPU_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
                 : SKYTPU_ACC32(0)
                 : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)),
                   "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(SKYTPU_PRED(34)
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
                 SKYTPU_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
                 : SKYTPU_ACC32(0)
                 : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)),
                   "n"(kTransB));
  } else if constexpr (kIsBf16<T>) {
    asm volatile(SKYTPU_PRED(66)
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 SKYTPU_D64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
                 : SKYTPU_ACC32(0), SKYTPU_ACC32(32)
                 : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)),
                   "n"(kTransB));
  } else {
    asm volatile(SKYTPU_PRED(66)
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
                 SKYTPU_D64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
                 : SKYTPU_ACC32(0), SKYTPU_ACC32(32)
                 : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)),
                   "n"(kTransB));
  }
}

// d (64 x N, f32) (+)= A (64 x 16, four 16-bit pairs per thread in the
// register fragment above) B (16 x N, shared; kTransB as wgmma_ss); N = 64,
// 128 or 256.
template <typename T, int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, bool accumulate) {
  static_assert(N == 64 || N == 128 || N == 256, "N is 64, 128 or 256");
  if constexpr (N == 256) {
    // One m64n256k16 (dq at D = 256: every column of dQ in one product).
    if constexpr (kIsBf16<T>) {
      asm volatile(SKYTPU_PRED(133)
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                   SKYTPU_D128 ", {%128, %129, %130, %131}, %132, p, 1, 1, "
                   "%134;\n}\n"
                   : SKYTPU_ACC32(0), SKYTPU_ACC32(32), SKYTPU_ACC32(64),
                     SKYTPU_ACC32(96)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                     "r"(int(accumulate)), "n"(kTransB));
    } else {
      asm volatile(SKYTPU_PRED(133)
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
                   SKYTPU_D128 ", {%128, %129, %130, %131}, %132, p, 1, 1, "
                   "%134;\n}\n"
                   : SKYTPU_ACC32(0), SKYTPU_ACC32(32), SKYTPU_ACC32(64),
                     SKYTPU_ACC32(96)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                     "r"(int(accumulate)), "n"(kTransB));
    }
    return;
  }
  if constexpr (N == 64 && kIsBf16<T>) {
    asm volatile(SKYTPU_PRED(37)
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 SKYTPU_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                 : SKYTPU_ACC32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"(int(accumulate)), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(SKYTPU_PRED(37)
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
                 SKYTPU_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                 : SKYTPU_ACC32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"(int(accumulate)), "n"(kTransB));
  } else if constexpr (kIsBf16<T>) {
    asm volatile(SKYTPU_PRED(69)
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 SKYTPU_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                 : SKYTPU_ACC32(0), SKYTPU_ACC32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"(int(accumulate)), "n"(kTransB));
  } else {
    asm volatile(SKYTPU_PRED(69)
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
                 SKYTPU_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                 : SKYTPU_ACC32(0), SKYTPU_ACC32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"(int(accumulate)), "n"(kTransB));
  }
}

#undef SKYTPU_ACC8
#undef SKYTPU_ACC32
#undef SKYTPU_D16
#undef SKYTPU_D32
#undef SKYTPU_D64
#undef SKYTPU_D128
#undef SKYTPU_PRED

// 2^x by the SFU (ex2.approx, subnormal results flushed to 0): what the
// softmax needs, without exp2f's subnormal fix-up instructions.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ----- 16-bit conversions ---------------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ----- the forward's online softmax ------------------------------------------

constexpr float kMaskValue = -1e30f;  // the TPU kernel's mask value

// One kv tile's online-softmax step on this thread's share of an m64nN S
// accumulator (rows rows[0], rows[1]; columns k0 + 8 j + 2 quad + e):
// masks the raw scores (where `mask`: keys past s_len, and above the
// diagonal when causal), updates the running max m (log2 units: max times
// scale log2 e) and the thread's share of the row sum l, leaves P =
// 2^(s scale log2 e - m) in s (one FFMA and one SFU op an element), and
// returns in corr the factor the O accumulator must take.
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&s)[N / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool mask, int k0, const int (&rows)[2], int s_len, int causal,
    float scale_log2, int quad) {
  float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        if (mask) {
          const int col = k0 + 8 * j + 2 * quad + e;
          if (col >= s_len || (causal && col > rows[i])) x = kMaskValue;
        }
        mx[i] = fmaxf(mx[i], x);
      }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = ex2(fmaf(x, scale_log2, neg_m[i]));
        l[i] += x;
      }
}

// P rounded to T, as the register A fragments of the k16 slices of P V.
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N / 2],
                                           uint32_t (&frag)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      frag[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// ----- host: tensor maps ----------------------------------------------------

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links nothing beyond the CUDA runtime.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a contiguous [heads, s_len, D] 16-bit tensor, boxes of
// `rows` rows x 64 columns (128 bytes, the swizzle's span), 128-byte
// swizzle, rows past s_len filled with zeros.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base,
                                 int dtype, int heads, int s_len, int d,
                                 int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(s_len),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2,
                                 cuuint64_t(s_len) * d * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Rounds a dynamic shared-memory base up to 1024 bytes (the swizzle
// atom); launches ask for kSmemAlign bytes more than their layout.
constexpr int kSmemAlign = 1024;

// Dynamic shared memory a warp-specialised launch asks for at least: more
// than half an SM's 228 KB, so one CTA runs per SM and the consumers'
// setmaxnreg.inc always finds the registers the producer gave up.
constexpr int kOneCtaPerSmBytes = 120 * 1024;

constexpr int launch_smem_bytes(int layout_bytes) {
  return layout_bytes > kOneCtaPerSmBytes ? layout_bytes : kOneCtaPerSmBytes;
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kSmemAlign - (a % kSmemAlign)) % kSmemAlign);
}

}  // namespace sm90
