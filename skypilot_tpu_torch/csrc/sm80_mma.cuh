// The mma.sync building blocks of the flash-attention kernels that are
// not wgmma (forward, dq, dk/dv at D = 16, 32, 80, 96 and 256 in bf16 and
// fp16, and at every kernel width in f32; the kernel templates are in
// flash_attention_{fwd,bwd_dq,bwd_dkv}_mma.cuh): cp.async copies of 16
// bytes into shared memory, the m16n8k16 bf16/fp16 -> f32 product, the
// m16n8k8 tf32 -> f32 product taken three times for f32 inputs (3xTF32),
// and the fragment loads of both from shared rows.  The wgmma layout of
// sm90_common.cuh assumes 64-element rows of 128 bytes (D = 64 and 128 in
// 16-bit types), which a 16-, 32-, 80-, 96- or 256-wide 16-bit row, or any
// f32 row, is not, so these kernels use the warp-level product and plain
// padded rows (no swizzle).
//
// m16n8k16 fragments, per lane l of the warp (g = l / 4, c = l % 4):
// - A (16 x 16, row-major): register r holds row g + 8 (r % 2), columns
//   2 c + 8 (r / 2) and the next one (low half first).
// - B (16 x 8, column-major): b0 holds rows 2 c, 2 c + 1 of column g, b1
//   rows 2 c + 8, 2 c + 9.
// - C/D (16 x 8, f32): register 2 i + e holds row g + 8 i, column 2 c + e.
// So the accumulators of two n8 tiles, rounded to 16-bit pairs, are the A
// fragment of one k16 step of the next product (P in P V, dS in dS K).
//
// m16n8k8 tf32 fragments (f32 inputs), per lane (g, c):
// - A (16 x 8): register r holds row g + 8 (r % 2), column c + 4 (r / 2).
// - B (8 x 8): b0 holds row c of column g, b1 row c + 4.
// - C/D as m16n8k16's.
// The accumulator of one n8 tile gives lane (g, c) columns 2 c and 2 c + 1,
// where A wants columns c and c + 4.  The sum over k does not care which
// k slot holds which key, so the kernels contract in a permuted order:
// A's slot c holds the accumulator's column 2 c and slot c + 4 column
// 2 c + 1 (a_from_acc), and the B fragment of that product reads rows
// 2 c and 2 c + 1 of the k-major tile (load_b_col).  No shuffle and no
// trip through shared memory.
//
// 3xTF32: each f32 operand x is split into hi = x rounded to tf32 (10
// mantissa bits, cvt.rna) and lo = (x - hi) rounded to tf32; a b is taken
// as lo_a hi_b + hi_a lo_b + hi_a hi_b in f32, the small terms first.
// The dropped lo_a lo_b and the rounding of lo keep a product's error
// near 2^-21 of |a b|, f32 class (one tf32 product alone is near 2^-11).
// The long sums (over S keys or query rows) add each tile's products to
// their accumulator in f32 (mma_sum_f32), not through the tensor core's
// accumulation, which rounds toward zero.

#pragma once

#include "sm90_common.cuh"

namespace sm80 {

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// Elements of k per product: m16n8k16 for 16-bit inputs, m16n8k8 (tf32)
// for f32.
template <typename T>
constexpr int kStep = kIsF32<T> ? 8 : 16;

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

// d += a b: one m16n8k8 tf32 product, f32 accumulators d[off .. off + 3].
template <int N>
__device__ __forceinline__ void mma1688(float (&d)[N], int off, uint32_t a0,
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[off]), "+f"(d[off + 1]), "+f"(d[off + 2]), "+f"(d[off + 3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + lo to f32 precision: hi is x rounded to tf32, lo the rest
// rounded to tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(lo)
      : "f"(x - __uint_as_float(hi)));
}

// One k-step's A (16 x kStep) and B (kStep x 8) operands: 16-bit pairs as
// the m16n8k16 fragments hold them, or for f32 the tf32 hi parts (A:
// r[0..3], B: r[0..1]) and lo parts (A: r[4..7], B: r[2..3]).
template <typename T>
struct FragA {
  uint32_t r[kIsF32<T> ? 8 : 4];
};
template <typename T>
struct FragB {
  uint32_t r[kIsF32<T> ? 4 : 2];
};

__device__ __forceinline__ uint32_t load_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit values from two rows of one column, low half first.
__device__ __forceinline__ uint32_t pack_u16(const void* lo, const void* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// Shared-memory rows are padded by kPad<T> elements.  16-bit: for every D
// that is a multiple of 16, a row of D + 8 elements is 4 words past a
// multiple of 8, which makes both the row-wise 32-bit fragment reads (one
// word per row, the 8 rows of a fragment on 8 distinct groups of 4 banks)
// and the column-wise 16-bit reads of pack_u16 conflict-free.  f32: a row
// of D + 4 words (D a multiple of 8) is 4 words past a multiple of 8, so
// the 8 rows g of a row-wise read (word c of each, c < 4) start on 8
// distinct multiples of 4 banks, and the 4 row pairs 2 c, 2 c + 1 of a
// column-wise read (8 adjacent columns g) on 4 distinct multiples of 8:
// both conflict-free.
template <typename T>
constexpr int kPad = kIsF32<T> ? 4 : 8;

// Rows row0 .. row0 + kRows - 1 of a [s_len, D] head `a` into the padded
// shared tile `a_s` (row stride D + kPad<T>) by cp.async, 16 bytes a
// thread and copy, rows past S zero-filled; joins the open commit group.
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_rows(T* a_s, const T* a, int row0,
                                          int s_len) {
  constexpr int kPer = 16 / int(sizeof(T));  // elements per 16 bytes
  constexpr int kChunks = D / kPer;          // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * kPer;
    const bool valid = row0 + row < s_len;
    const size_t off = size_t(valid ? row0 + row : 0) * D + col;
    cp_async16(&a_s[row * (D + kPad<T>) + col], a + off, valid);
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

// The A operand of k-step kk (columns kStep kk ..) of the 16 rows row0 ..
// row0 + 15 of a padded shared tile (row stride ld).
template <typename T>
__device__ __forceinline__ void load_a(FragA<T>& a, const T* tile, int ld,
                                       int row0, int kk, int g, int quad) {
  if constexpr (kIsF32<T>) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(tile[(row0 + g + 8 * (r % 2)) * ld + 8 * kk + quad +
                      4 * (r / 2)],
                 a.r[r], a.r[4 + r]);
  } else {
    load_a_smem(a.r, tile, ld, row0, kk, g, quad);
  }
}

// The B operand of k-step kk where the tile's rows are the product's n
// (K in Q K^T): `row` is the lane's row (n = g) of the tile.
template <typename T>
__device__ __forceinline__ void load_b_row(FragB<T>& b, const T* row, int kk,
                                           int quad) {
  if constexpr (kIsF32<T>) {
    split_tf32(row[8 * kk + quad], b.r[0], b.r[2]);
    split_tf32(row[8 * kk + quad + 4], b.r[1], b.r[3]);
  } else {
    const T* p = row + 16 * kk + 2 * quad;
    b.r[0] = load_u32(p);
    b.r[1] = load_u32(p + 8);
  }
}

// The B operand of k-step kk where the tile's rows are the product's k
// (V in P V), at column `col` (8 n + g): for f32 rows 2 quad and
// 2 quad + 1 of the step, the k order a_from_acc gives A.
template <typename T>
__device__ __forceinline__ void load_b_col(FragB<T>& b, const T* tile, int ld,
                                           int kk, int col, int quad) {
  if constexpr (kIsF32<T>) {
    const T* p = tile + (8 * kk + 2 * quad) * ld + col;
    split_tf32(p[0], b.r[0], b.r[2]);
    split_tf32(p[ld], b.r[1], b.r[3]);
  } else {
    const T* p = tile + (16 * kk + 2 * quad) * ld + col;
    b.r[0] = pack_u16(p, p + ld);
    b.r[1] = pack_u16(p + 8 * ld, p + 9 * ld);
  }
}

// The A operand of k-step kk of the next product from the f32
// accumulators `acc` of this one (register 4 j + 2 i + e: n8 tile j, row
// g + 8 i, column 2 quad + e), rounded to T (the TPU kernels'
// p.astype(v.dtype), ds.astype(k.dtype)): 16-bit, two n8 tiles as they
// stand; f32, one n8 tile in the permuted k order.
template <typename T, int N>
__device__ __forceinline__ void a_from_acc(FragA<T>& a, const float (&acc)[N],
                                           int kk) {
  if constexpr (kIsF32<T>) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(acc[4 * kk + 2 * (r % 2) + r / 2], a.r[r], a.r[4 + r]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a.r[r] = sm90::pack2<T>(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
  }
}

// d += a b over one k-step, f32 accumulators d[off .. off + 3].
template <typename T, int N>
__device__ __forceinline__ void mma(float (&d)[N], int off,
                                    const FragA<T>& a, const FragB<T>& b) {
  if constexpr (kIsF32<T>) {
    // 3xTF32, the small products first.
    mma1688(d, off, a.r[4], a.r[5], a.r[6], a.r[7], b.r[0], b.r[1]);
    mma1688(d, off, a.r[0], a.r[1], a.r[2], a.r[3], b.r[2], b.r[3]);
    mma1688(d, off, a.r[0], a.r[1], a.r[2], a.r[3], b.r[0], b.r[1]);
  } else {
    mma16816<T>(d, off, a.r, b.r[0], b.r[1]);
  }
}

// acc += A B over one tile of a long f32 sum (O += P V and dQ += dS K
// over the keys, dV += P^T dO and dK += dS^T Q over the query rows): A
// (16 x 8 kSteps) from the f32 accumulators `src` of the tile's previous
// product (a_from_acc), B from the k-major shared tile `tile` (row stride
// ld) at columns 8 n + g.  Each n8 tile of acc takes the tile's 3xTF32
// products in a sum of its own, then adds it to acc in f32 (round to
// nearest).  The tensor core's accumulation rounds toward zero, up to an
// ulp of its accumulator per product and all of one sign, so with acc as
// the accumulator the error grew with the sum's length: 7.2e-5
// norm-relative against the plain f32 version on a 4096-token training
// step's attention backward on an H100, 3.6e-6 with this per-tile sum.
// n outer and the tile's A fragments held (kSteps x 8 registers) keep
// one 4-register sum live at a time (a sum per k-step, kept live across
// the unrolled n tiles, spilled at D = 256).
template <int kSteps, int N, int M>
__device__ __forceinline__ void mma_sum_f32(float (&acc)[N],
                                            const float (&src)[M],
                                            const float* tile, int ld,
                                            int g, int quad) {
  FragA<float> a[kSteps];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) a_from_acc(a[kk], src, kk);
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      FragB<float> b;
      load_b_col(b, tile, ld, kk, 8 * n + g, quad);
      mma(t, 0, a[kk], b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * n + i] += t[i];
  }
}

// Two adjacent outputs (columns 2 quad, 2 quad + 1) in T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (kIsF32<T>)
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  else
    *reinterpret_cast<uint32_t*>(p) = sm90::pack2<T>(lo, hi);
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
