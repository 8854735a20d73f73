// The mma.sync building blocks of the flash-attention kernels that are
// not wgmma (forward, dq, dk/dv at D = 16, 32, 80, 96 and 256; the
// kernel templates are in flash_attention_{fwd,bwd_dq,bwd_dkv}_mma.cuh):
// cp.async copies of 16 bytes into shared memory, the m16n8k16 bf16/fp16
// -> f32 product, and 32-bit fragment loads from shared rows.  The wgmma
// layout of sm90_common.cuh assumes 64-element rows of 128 bytes (D = 64
// and 128), which a 16-, 32-, 80-, 96- or 256-wide row is not, so these
// kernels use the warp-level product and plain padded rows (no swizzle).
//
// m16n8k16 fragments, per lane l of the warp (g = l / 4, c = l % 4):
// - A (16 x 16, row-major): register r holds row g + 8 (r % 2), columns
//   2 c + 8 (r / 2) and the next one (low half first).
// - B (16 x 8, column-major): b0 holds rows 2 c, 2 c + 1 of column g, b1
//   rows 2 c + 8, 2 c + 9.
// - C/D (16 x 8, f32): register 2 i + e holds row g + 8 i, column 2 c + e.
// So the accumulators of two n8 tiles, rounded to 16-bit pairs, are the A
// fragment of one k16 step of the next product (P in P V, dS in dS K).

#pragma once

#include "sm90_common.cuh"

namespace sm80 {

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

// Shared-memory rows are padded by kPad elements: for every D that is a
// multiple of 16, a row of D + 8 elements is 4 words past a multiple of 8,
// which makes both the row-wise 32-bit fragment reads (one word per row,
// the 8 rows of a fragment on 8 distinct groups of 4 banks) and the
// column-wise 16-bit reads of pack_u16 conflict-free.
constexpr int kPad = 8;

// Rows row0 .. row0 + kRows - 1 of a [s_len, D] head `a` into the padded
// shared tile `a_s` (row stride D + kPad) by cp.async, 16 bytes a thread
// and copy, rows past S zero-filled; joins the open commit group.
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_rows(T* a_s, const T* a, int row0,
                                          int s_len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + row < s_len;
    const size_t off = size_t(valid ? row0 + row : 0) * D + col;
    cp_async16(&a_s[row * (D + kPad) + col], a + off, valid);
  }
}

// The same rows of two heads `a` and `b` into `a_s` and `b_s`; closes one
// commit group.
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_tile_pair(T* a_s, T* b_s, const T* a,
                                               const T* b, int row0,
                                               int s_len) {
  load_rows<D, kRows, kThreads>(a_s, a, row0, s_len);
  load_rows<D, kRows, kThreads>(b_s, b, row0, s_len);
  cp_async_commit();
}

// The A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of the 16
// rows row0 .. row0 + 15 of a padded shared tile (row stride ld).
template <typename T>
__device__ __forceinline__ void load_a_smem(uint32_t (&frag)[4], const T* tile,
                                            int ld, int row0, int kk, int g,
                                            int quad) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    frag[r] = load_u32(tile + (row0 + g + 8 * (r % 2)) * ld + 16 * kk +
                       2 * quad + 8 * (r / 2));
}

// Opts `kernel` in to `bytes` of dynamic shared memory where that is past
// the 48 KB every launch may take.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The A fragments of rows `rows` (this lane's two) of a [s_len, D] head
// for the D / 16 k-steps of a product over D; rows past S are zeros.
template <int D, typename T>
__device__ __forceinline__ void load_a_rows(uint32_t (&frag)[D / 16][4],
                                            const T* head, const int (&rows)[2],
                                            int quad, int s_len) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r % 2];
      const int col = kk * 16 + 2 * quad + 8 * (r / 2);
      frag[kk][r] = row < s_len ? load_u32(head + size_t(row) * D + col) : 0u;
    }
}

}  // namespace sm80
