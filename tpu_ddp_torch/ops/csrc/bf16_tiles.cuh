// The bfloat16 helpers that K4-K6's bfloat16 kernels share (flash_forward.cu,
// flash_attention.cu): the A fragment of a product formed from float32
// accumulators, and the rounded store of an output accumulator.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, which
// wgmma's A from registers takes warp by warp (hopper.cuh), for the lane
// (g, t) = (lane / 4, lane % 4), two bf16 values a 32-bit register, the
// lower column (or k) in the low half:
//   A (16 x 16, row-major): a0 = row g, columns 2t, 2t + 1; a1 = row g + 8,
//     the same columns; a2, a3 = the same rows, columns 2t + 8, 2t + 9.
//   C, D (16 x 8, float32): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row
//     g + 8, the same columns.
// So the accumulators of two neighbouring 8-column tiles of a score matrix
// (S, or dS) are, rounded and packed in pairs, the A fragment of a product
// over those 16 columns: P and dS never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf16_tiles {

using Bf16 = __nv_bfloat16;

struct View {  // element strides of B, T and H; D has stride 1
  long long sb, st, sh;
};

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

}  // namespace bf16_tiles
