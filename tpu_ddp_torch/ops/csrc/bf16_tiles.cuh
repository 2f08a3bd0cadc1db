// The bfloat16 building blocks of K4-K6's bfloat16 instantiations
// (flash_forward.cu, flash_attention.cu): shared tiles of bf16 rows, their
// mma.sync.m16n8k16 fragments, and the product itself.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for the
// lane (g, t) = (lane / 4, lane % 4), two bf16 values a 32-bit register, the
// lower column (or k) in the low half:
//   A (16 x 16, row-major): a0 = row g, columns 2t, 2t + 1; a1 = row g + 8,
//     the same columns; a2, a3 = the same rows, columns 2t + 8, 2t + 9.
//   B (16 x 8, k x n): b0 = k = 2t, 2t + 1 at n = g; b1 = k = 2t + 8, 2t + 9.
//   C, D (16 x 8, float32): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row
//     g + 8, the same columns.
// So the accumulators of two neighbouring 8-column tiles of a score matrix
// (S, or dS) are, rounded and packed in pairs, the A fragment of a product
// over those 16 columns: P and dS never leave registers.
//
// A tile is kRows rows of kD + 8 bf16 (a 16-byte pad), so the eight 16-byte
// rows an ldmatrix reads, and the 32-bit fragment loads of a warp, fall in
// distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf16_tiles {

using Bf16 = __nv_bfloat16;

struct View {  // element strides of B, T and H; D has stride 1
  long long sb, st, sh;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// Rows [t0, t0 + kRows) of the (b, h) slice of x into a (kRows, kD + 8)
// shared tile; rows past T and columns past D are zero. vec: 16-byte copies
// by cp.async (D, the strides and the pointer a multiple of 8 elements; a
// source address outside the slice is replaced by its base, read 0 bytes);
// otherwise element by element, stored at once (the caller's barrier makes
// them visible, as cp.async's wait does).
template <int kD, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(Bf16* dst, const Bf16* __restrict__ x, View v,
                                          int b, int h, int t0, int T, int D, bool vec) {
  constexpr int kLd = kD + 8;
  const Bf16* base = x + b * v.sb + h * v.sh;
  if (vec) {
    constexpr int kChunks = kD / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, d = 8 * (i % kChunks), t = t0 + r;
      const bool live = t < T && d < D;
      cp_async16(dst + r * kLd + d, live ? base + static_cast<long long>(t) * v.st + d : base,
                 live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
      const int r = i / kD, d = i % kD, t = t0 + r;
      dst[r * kLd + d] = t < T && d < D ? base[static_cast<long long>(t) * v.st + d]
                                        : __float2bfloat16_rn(0.0f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const Bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of a 16 x 16 block of a row-major tile; p points at the
// block's row g, column 2t.
template <int kLd>
__device__ __forceinline__ void frag_a(const Bf16* p, uint32_t (&a)[4]) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * kLd);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * kLd + 8);
}

// The B fragments of X itself (k the tile's rows, n its columns) for two
// neighbouring 8-column tiles, by one ldmatrix.x4.trans: rows k0..k0 + 15,
// columns n0..n0 + 15; x0 points at row k0, column n0. b[0], b[1] are the
// fragment of columns n0..n0 + 7, b[2], b[3] that of n0 + 8..n0 + 15.
template <int kLd>
__device__ __forceinline__ void frag_b_trans2(const Bf16* x0, int lane, uint32_t (&b)[4]) {
  const Bf16* p = x0 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s)
               : "memory");
}

// d += a.b, one m16n8k16 bf16 product with float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators of 8-column tiles c0 (columns 0-7) and c1 (8-15) as the
// A fragment of a product over those 16 columns, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rows row_lo and row_lo + 8 (those below T) of a warp's (16, kD) float32
// accumulator, rounded to bf16, into the (b, h) slice of y, columns below D;
// each value scaled by inv_lo or inv_hi (its row's).
template <int kDT>
__device__ __forceinline__ void store_rows(Bf16* y, View v, int b, int h, int row_lo, int T,
                                           int D, int t, const float (&acc)[kDT][4],
                                           float inv_lo = 1.0f, float inv_hi = 1.0f) {
  Bf16* base = y + b * v.sb + h * v.sh;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (col >= D) break;
    const bool pair = col + 1 < D;
    if (row_lo < T) {
      Bf16* o = base + static_cast<long long>(row_lo) * v.st + col;
      o[0] = __float2bfloat16_rn(acc[dn][0] * inv_lo);
      if (pair) o[1] = __float2bfloat16_rn(acc[dn][1] * inv_lo);
    }
    if (row_hi < T) {
      Bf16* o = base + static_cast<long long>(row_hi) * v.st + col;
      o[0] = __float2bfloat16_rn(acc[dn][2] * inv_hi);
      if (pair) o[1] = __float2bfloat16_rn(acc[dn][3] * inv_hi);
    }
  }
}

// vec of load_tile: every pointer 16-byte aligned, every stride a multiple
// of 8 elements, D a multiple of 8
inline bool vec_ok(int D, const void* const* ptrs, const View* views, int n) {
  if (D % 8 != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    if (views[i].sb % 8 || views[i].st % 8 || views[i].sh % 8) return false;
  }
  return true;
}

}  // namespace bf16_tiles
