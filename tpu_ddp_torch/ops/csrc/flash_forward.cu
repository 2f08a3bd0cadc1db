// K4: the flash-attention forward for Hopper, on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel tpu_ddp/ops/flash_attention.py::_kernel
// (launched by _flash_forward). The plain PyTorch version is forward_plain
// in tpu_ddp_torch/ops/flash_attention.py; the backward kernels K5 and K6
// (csrc/flash_attention.cu) read the row log-sum-exp written here.
//
// What it computes, for q, k, v of shape (B, T, H, D), float32, scale
// 1/sqrt(D), a key visible to a query when it exists (col < T), is not
// masked (kv_mask[b, col] > 0) and, under causal, col <= row:
// s = scale * q.k (invisible: NEG); an online softmax over the key tiles
// with the running max m, sum l and accumulator o; out = o / l and
// lse = m + log l, or out = 0 and lse = NEG for a row that sees no key.
//
// What bounds it on this card: the two products, 4*T^2*D operations per
// (b, h). On the CUDA cores float32 runs at 67 TFLOP/s at most; the tensor
// cores take TF32 (a 10-bit mantissa) at 495 TFLOP/s. 3xTF32 keeps float32
// accuracy on them: each operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), and a product is lo.hi + hi.lo + hi.hi with float32
// accumulators (the lo.lo term, ~2^-22 relative, is dropped), three
// mma.sync.m16n8k8 TF32 products for each float32 one: 165 TFLOP/s at most.
// At short T (the ViT's 64 tokens) the bytes of q, k, v and the latency of
// one tile instead.
//
// The design (the FlashAttention-2 layout):
// - A block owns one (b*h, 64-row query tile); each of its four warps owns
//   16 query rows. 32-row tiles, which would give the ViT's (32, 64, 3, 64)
//   192 blocks for the 132 SMs instead of 96, measured slower there and at
//   every other shape tried (PERF.md): a block's latency, not the SMs left
//   idle, sets the time of a short grid.
// - A warp's 16 x kBN score tile lives in mma accumulator registers. Row
//   max and row sum are shuffles within the quad that holds a row. P stays
//   in registers for P.V: the accumulator holds row r's keys 2t and 2t+1 in
//   lane (r, t), which is the A operand's layout once the key order inside
//   each 8-key slice is permuted (key 2t as k = t, key 2t + 1 as k = t + 4);
//   V's B operand is read in that same order. So no shuffle, no score tile
//   in shared memory, and no barrier between S and P.V.
// - The three products of a 3xTF32 step go to several independent
//   accumulators in turn (the key or output n-tiles, and for S at D = 128
//   a second set for the small terms), so no mma waits on the one before.
// - K and V tiles stream through a two-stage ring in shared memory, filled
//   by cp.async: tile j + 1 loads while tile j is computed, one barrier a
//   tile. Rows past T and columns past D arrive as zeros (cp.async's
//   src-size), so any T >= 1 and D <= 128 work, the products run over all
//   kD columns with no bound checks; the key mask rides in the same ring.
// - Tiles are rows of kD + 4 floats: the A, B and permuted-B fragment reads
//   of a warp fall in 32 distinct banks.
// - The softmax runs in base 2 (ex2.approx); a tile the warp sees whole
//   skips the visibility tests, and the accumulator's rescale is skipped
//   when no row max of the warp moved.
// - At D = 64 the S loop is unrolled twice, not fully: in the ViT step K4
//   runs between other kernels, and less code starts faster from a cold
//   instruction cache.
// - Resources: __launch_bounds__ caps a thread at 128 registers (at D = 128
//   the output accumulator alone takes 64, and ptxas spills ~80 bytes);
//   shared memory is the Q tile and the ring: 68 KB at D = 128 (16-key
//   tiles: three blocks an SM) and 88 KB at D = 64 (64-key tiles: two).
// Causal skips the tiles past the query tile's last row, and a warp skips
// the tiles past its own rows. q, k and v are read through their (B, T, H)
// strides, so the views of the ViT's qkv split need no copy; 16-byte copies
// where D, the strides and the pointers allow, 4-byte ones otherwise.
//
// Plain C interface, loaded with ctypes (tpu_ddp_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bf16_tiles.cuh"
#include "flash_wg.cuh"

namespace {

using bf16_tiles::Bf16;
using bf16_tiles::View;

constexpr float kNeg = -1e30f;  // finite stand-in for -inf (the JAX NEG)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename E>  // the element type of q, k, v and out
struct ArgsT {
  const E *q, *k, *v;
  const float* mask;
  E* out;
  float* lse;
  View vq, vk, vv, vout;
  int B, T, H, D;
  bool causal, vec;  // vec: 16-byte copies of q, k, v rows
  float scale;
};
using Args = ArgsT<float>;

constexpr int kBM = 64;        // query rows of a block
constexpr int kThreads = 128;  // four warps of 16 query rows

template <int kD, int kBN>
struct Cfg {
  static constexpr int kLd = kD + 4;           // row stride of a tile
  static constexpr int kQFloats = kBM * kLd;
  static constexpr int kKVFloats = kBN * kLd;  // one K or V tile
  // Q, then K[2], V[2], mask[2]
  static constexpr size_t kSmem =
      sizeof(float) * (kQFloats + 4 * kKVFloats + 2 * kBN);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [t0, t0 + kRows) of the (b, h) slice of x into a (kRows, kD + 4)
// shared tile; rows past T and columns past D are zero. A source address
// that would lie outside the slice is replaced by its base (nothing is read
// from it: src-size 0).
template <int kD, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x,
                                          View v, int b, int h, int t0, int T, int D,
                                          bool vec) {
  constexpr int kLd = kD + 4;
  const float* base = x + b * v.sb + h * v.sh;
  if (vec) {
    constexpr int kChunks = kD / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, d = 4 * (i % kChunks), t = t0 + r;
      const bool live = t < T && d < D;
      cp_async16(dst + r * kLd + d, live ? base + static_cast<long long>(t) * v.st + d : base,
                 live ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
      const int r = i / kD, d = i % kD, t = t0 + r;
      const bool live = t < T && d < D;
      cp_async4(dst + r * kLd + d, live ? base + static_cast<long long>(t) * v.st + d : base,
                live ? 4 : 0);
    }
  }
}

// hi = tf32(x), lo = tf32(x - hi), as the mma's 32-bit operands. Both round
// to nearest with ties away from zero, the rounding of cvt.rna.tf32.f32,
// written as an add of half a TF32 unit to the bit pattern and a mask of the
// 13 bits below it (a carry rounds up into the exponent). sm_90 has no
// single instruction for that cvt: ptxas expands it into a compare-and-
// select sequence, and K4 built with it takes 1.27x as long at (4, 2048,
// 8, 128) (tpu_ddp_torch/tools/k4_variants.py; PERF.md).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

// d += a.b, one m16n8k8 TF32 product with float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a.b[i] in 3xTF32 for kN tiles: the small terms first, then
// hi.hi, each round over all kN accumulators
template <int kN>
__device__ __forceinline__ void mma3(float (&d)[kN][4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[kN][2],
                                     const uint32_t (&blo)[kN][2]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) mma(d[i], alo, bhi[i]);
#pragma unroll
  for (int i = 0; i < kN; ++i) mma(d[i], ahi, blo[i]);
#pragma unroll
  for (int i = 0; i < kN; ++i) mma(d[i], ahi, bhi[i]);
}

// 2^x (ex2.approx: 2 ulp; an argument of -inf or below -126 gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One key tile of the online softmax, in base 2, for a warp's 16 rows (the
// lane's rows row_lo = g and row_hi = g + 8): s (the tile's raw scores, in
// mma accumulator layout: s[n][e] is row g for e < 2, g + 8 else, key
// 8n + 2t + (e & 1)) becomes p = 2^(s * scale * log2(e) - m), invisible
// entries exactly 0; the running max m and sum l move, and o is rescaled
// when a max moved. Unless the tile is seen whole, a key is visible when it
// exists (col < T, or its mask Mt > 0 when Mt is given) and, under causal,
// col <= row; bit 4n + e of vis says so, and an invisible score is NEG.
template <int kNT, int kDT>
__device__ __forceinline__ void online_softmax(float (&s)[kNT][4], float (&o)[kDT][4],
                                               float& m_lo, float& m_hi, float& l_lo,
                                               float& l_hi, bool whole, const float* Mt,
                                               int k0, int T, bool causal, int row_lo,
                                               int row_hi, int t, float scale2) {
  unsigned vis = ~0u;
  float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (whole) {
        s[n][e] *= scale2;
      } else {
        const int c = 8 * n + 2 * t + (e & 1), col = k0 + c;
        const int row = e < 2 ? row_lo : row_hi;
        const bool live = (Mt != nullptr ? Mt[c] > 0.0f : col < T) &&
                          (!causal || col <= row);
        vis &= live ? ~0u : ~(1u << (4 * n + e));
        s[n][e] = live ? s[n][e] * scale2 : kNeg;
      }
    }
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  float rs_lo = 0.0f, rs_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the multiplicative mask: a row that has seen no key yet has
      // m == NEG, and its invisible entries must still give 0
      const float p = ex2(s[n][e] - (e < 2 ? mn_lo : mn_hi));
      s[n][e] = (vis >> (4 * n + e)) & 1u ? p : 0.0f;
    }
    rs_lo += s[n][0] + s[n][1];
    rs_hi += s[n][2] + s[n][3];
  }
  const float al_lo = ex2(m_lo - mn_lo), al_hi = ex2(m_hi - mn_hi);
  l_lo = l_lo * al_lo + quad_sum(rs_lo);
  l_hi = l_hi * al_hi + quad_sum(rs_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  if (__any_sync(0xffffffffu, al_lo != 1.0f || al_hi != 1.0f)) {  // a max moved
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      o[n][0] *= al_lo;
      o[n][1] *= al_lo;
      o[n][2] *= al_hi;
      o[n][3] *= al_hi;
    }
  }
}

// K4 (replaces _kernel). 1-D grid of B*H*ceil(T/kBM) blocks, the query
// tiles of one (b, h) adjacent so that they share K/V tiles in L2; at most
// 128 registers a thread, so that four blocks' worth fit an SM's file.
template <int kD, int kBN>
__global__ void __launch_bounds__(kThreads, 4) flash_fwd_kernel(Args a) {
  using C = Cfg<kD, kBN>;
  constexpr int kLd = C::kLd, kNT = kBN / 8, kDT = kD / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + C::kQFloats;
  float* Vs = Ks + 2 * C::kKVFloats;
  float* Ms = Vs + 2 * C::kKVFloats;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row and column
  const int tiles = (a.T + kBM - 1) / kBM;
  const int bh = blockIdx.x / tiles, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x % tiles * kBM;
  const int row_lo = q0 + 16 * warp + g, row_hi = row_lo + 8;
  const int warp_last = q0 + 16 * warp + 15;
  const float scale2 = a.scale * kLog2e;
  constexpr int kG = 4;  // output n-tiles a round of P.V
  const float* mask_b = a.mask ? a.mask + static_cast<long long>(b) * a.T : nullptr;

  auto load_kv = [&](int j, int stage) {
    const int k0 = j * kBN;
    load_tile<kD, kBN, kThreads>(Ks + stage * C::kKVFloats, a.k, a.vk, b, h, k0, a.T,
                                    a.D, a.vec);
    load_tile<kD, kBN, kThreads>(Vs + stage * C::kKVFloats, a.v, a.vv, b, h, k0, a.T,
                                    a.D, a.vec);
    if (mask_b != nullptr && threadIdx.x < kBN) {
      const int col = k0 + threadIdx.x;
      const bool live = col < a.T;
      cp_async4(Ms + stage * kBN + threadIdx.x, live ? mask_b + col : mask_b, live ? 4 : 0);
    }
  };

  const int kv_end = a.causal ? min(a.T, q0 + kBM) : a.T;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  load_tile<kD, kBM, kThreads>(Qs, a.q, a.vq, b, h, q0, a.T, a.D, a.vec);
  load_kv(0, 0);
  cp_async_commit();

  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
  const float* Qw = Qs + (16 * warp + g) * kLd + t;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    const int k0 = j * kBN;
    if (a.causal && k0 > warp_last) continue;  // no key of this tile is visible
    const float* Kt = Ks + (j & 1) * C::kKVFloats;
    const float* Vt = Vs + (j & 1) * C::kKVFloats;
    const float* Mt = Ms + (j & 1) * kBN;

    // S = Q K^T for the warp's 16 rows and the tile's kBN keys, over all
    // kD columns (those past D are zeros). The three products of each
    // 3xTF32 step go to independent accumulators in turn, so no product
    // waits on the one before it; with few key n-tiles the small terms get
    // accumulators of their own for the same reason.
    constexpr bool kSmallAcc = kNT < 4;
    float s[kNT][4], sm[kSmallAcc ? kNT : 1][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < (kSmallAcc ? kNT : 1); ++n)
      sm[n][0] = sm[n][1] = sm[n][2] = sm[n][3] = 0.0f;
    // unrolled twice at D = 64 (header), fully at D = 128
#pragma unroll(kD == 64 ? 2 : kD / 8)
    for (int kk = 0; kk < kD; kk += 8) {
      uint32_t ahi[4], alo[4], bhi[kNT][2], blo[kNT][2];
      split(Qw[kk], ahi[0], alo[0]);
      split(Qw[kk + 8 * kLd], ahi[1], alo[1]);
      split(Qw[kk + 4], ahi[2], alo[2]);
      split(Qw[kk + 8 * kLd + 4], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float* Kr = Kt + (8 * n + g) * kLd + kk + t;
        split(Kr[0], bhi[n][0], blo[n][0]);
        split(Kr[4], bhi[n][1], blo[n][1]);
      }
      if constexpr (kSmallAcc) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma(sm[n], alo, bhi[n]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma(s[n], ahi, bhi[n]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma(sm[n], ahi, blo[n]);
      } else {
        mma3(s, ahi, alo, bhi, blo);
      }
    }
    if constexpr (kSmallAcc) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += sm[n][e];
    }

    // A tile the warp sees whole (no key mask, no key past T, under causal
    // no key past its first row) needs no visibility tests.
    const bool whole = mask_b == nullptr && k0 + kBN <= a.T &&
                       (!a.causal || k0 + kBN - 1 <= q0 + 16 * warp);
    online_softmax(s, o, m_lo, m_hi, l_lo, l_hi, whole, mask_b != nullptr ? Mt : nullptr,
                   k0, a.T, a.causal, row_lo, row_hi, t, scale2);

    // O += P V: P's accumulator layout is its A operand under the key
    // permutation (header), so V rows are read as keys 2t and 2t + 1; the
    // output columns go kG n-tiles at a time through the products in turn
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      uint32_t ahi[4], alo[4];
      split(s[n][0], ahi[0], alo[0]);
      split(s[n][2], ahi[1], alo[1]);
      split(s[n][1], ahi[2], alo[2]);
      split(s[n][3], ahi[3], alo[3]);
      const float* Vr = Vt + (8 * n + 2 * t) * kLd + g;
#pragma unroll
      for (int d0 = 0; d0 < kDT; d0 += kG) {
        uint32_t bhi[kG][2], blo[kG][2];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          split(Vr[8 * (d0 + i)], bhi[i][0], blo[i][0]);
          split(Vr[8 * (d0 + i) + kLd], bhi[i][1], blo[i][1]);
        }
#pragma unroll
        for (int i = 0; i < kG; ++i) mma(o[d0 + i], alo, bhi[i]);
#pragma unroll
        for (int i = 0; i < kG; ++i) mma(o[d0 + i], ahi, blo[i]);
#pragma unroll
        for (int i = 0; i < kG; ++i) mma(o[d0 + i], ahi, bhi[i]);
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group

  const bool live_lo = l_lo > 0.0f, live_hi = l_hi > 0.0f;
  const float inv_lo = live_lo ? 1.0f / l_lo : 0.0f;  // a dead row's o is 0
  const float inv_hi = live_hi ? 1.0f / l_hi : 0.0f;
  if (t == 0) {
    float* lse = a.lse + static_cast<long long>(bh) * a.T;
    if (row_lo < a.T) lse[row_lo] = live_lo ? m_lo * kLn2 + logf(l_lo) : kNeg;
    if (row_hi < a.T) lse[row_hi] = live_hi ? m_hi * kLn2 + logf(l_hi) : kNeg;
  }
  float* base = a.out + b * a.vout.sb + h * a.vout.sh;
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (col >= a.D) break;
    const bool pair = col + 1 < a.D;
    if (row_lo < a.T) {
      float* y = base + static_cast<long long>(row_lo) * a.vout.st + col;
      y[0] = o[dn][0] * inv_lo;
      if (pair) y[1] = o[dn][1] * inv_lo;
    }
    if (row_hi < a.T) {
      float* y = base + static_cast<long long>(row_hi) * a.vout.st + col;
      y[0] = o[dn][2] * inv_hi;
      if (pair) y[1] = o[dn][3] * inv_hi;
    }
  }
}

// K4 for bfloat16 inputs (replaces _kernel on bf16 q, k, v), on Hopper's
// tensor-core path: TMA, an mbarrier ring and wgmma, in the skeleton it
// shares with K5's (flash_wg.cuh).
//
// What bounds it: the two products, 4 T^2 D bf16 operations a (b, h)
// (under causal over the T(T + 1)/2 visible pairs), at 989 TFLOP/s on the
// tensor cores; at the ViT's 64 tokens one tile's latency. The mma.sync
// design before it (one warp's 16 rows, fragments reloaded from shared
// memory every key tile, copies and products in the same warps, two
// 4-warp blocks an SM) reached 10.5% of that bound at the LM's shape. Here:
// - a block owns 128 query rows of one (b, h), 64 to each warpgroup; Q is
//   loaded once and K and V tiles of 64 keys stream through the ring, so
//   the copies run beside the products (128-key tiles measured slower at
//   the LM's shape: pick_bf16);
// - S = Q K^T is wgmma with both operands in shared memory (K is K-major
//   as it lies); the online softmax runs on S's accumulator registers in
//   base 2, without branches over the scores (row max and sum are shuffles
//   within the quad that holds a row; a tile the warp sees whole skips the
//   visibility tests, and the rescale of O is skipped when no row max of
//   the warp moved); p is rounded to bf16 and its accumulator pairs are
//   P V's A operand in registers, with V read transposed (MN-major) from
//   the ring: P never goes through shared memory;
// - S of tile j and P V of tile j - 1 are issued together, so tile j's
//   softmax runs while P V does, and O is rescaled once P V has landed;
// - the row sum l takes the unrounded p, out = O / l is rounded to bf16
//   (nearest even) and lse = m ln 2 + log l stays float32 (the dtype flow
//   of ops/flash_attention.py's design (a)); a row that sees no key gives
//   out 0 and lse NEG.
// 256 threads; at D = 64, 127 registers a thread and 81 KB of shared
// memory, so two blocks an SM.

// One key tile of the online softmax for a warp's 16 rows (row_lo = its row
// g, row_hi = g + 8): s (raw scores in accumulator layout, key
// 8n + 2t + (e & 1)) becomes p = 2^(s * scale * log2(e) - m), invisible
// entries exactly 0; m and l move as in online_softmax, and al_lo, al_hi
// are the factors by which the caller rescales O (once the product that
// accumulates into it has landed). A tile seen whole (kWhole) has no
// invisible score; otherwise one (its key not in `keys`, or under causal
// past the row) is set to NEG, the mark that zeroes its p. Both forms are
// branch-free over the scores.
template <bool kWhole, int kNT>
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4], float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi, float& al_lo,
                                             float& al_hi, uint32_t keys, int k0, bool causal,
                                             int row_lo, int row_hi, int t, float scale2) {
  float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kWhole)
        s[n][e] *= scale2;
      else
        s[n][e] = flash_wg::visible(keys, n, e, k0, t, causal, row_lo, row_hi)
                      ? s[n][e] * scale2
                      : kNeg;
    }
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  float rs_lo = 0.0f, rs_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a row that has seen no key yet has m == NEG: its invisible
      // entries must still give 0
      const float p = ex2(s[n][e] - (e < 2 ? mn_lo : mn_hi));
      s[n][e] = kWhole || s[n][e] != kNeg ? p : 0.0f;
    }
    rs_lo += s[n][0] + s[n][1];
    rs_hi += s[n][2] + s[n][3];
  }
  al_lo = ex2(m_lo - mn_lo);
  al_hi = ex2(m_hi - mn_hi);
  l_lo = l_lo * al_lo + quad_sum(rs_lo);
  l_hi = l_hi * al_hi + quad_sum(rs_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
}

template <int kD, int kStages>
__global__ void __launch_bounds__(flash_wg::kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, flash_wg::Args a) {
  namespace fw = flash_wg;
  using L = fw::Smem<kD, 1, kStages>;
  constexpr int kBN = fw::kBN, kNT = fw::kNT, kDT = kD / 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ fw::Sync<kStages> sy;
  uint8_t* smem = fw::align1024(smem_raw);
  const fw::Work w = fw::block_work(a);
  const fw::Ring<kD, 1, kStages> ring{sy, smem, &tk, &tv, w};
  fw::init_barriers(sy);
  if (threadIdx.x == 0) {
    const CUtensorMap* res[1] = {&tq};
    ring.start(res);
  }
  const int wg = threadIdx.x / fw::kWG;
  const int tid = threadIdx.x % fw::kWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = w.q0 + 64 * wg;  // the warpgroup's first row
  const int row_lo = r0 + 16 * warp + g, row_hi = row_lo + 8;
  const float scale2 = a.scale * kLog2e;
  const float* mask_b = a.mask ? a.mask + static_cast<long long>(w.b) * a.T : nullptr;
  const uint64_t qd = hopper::desc_sw128(smem + wg * 64 * 128);
  const int n_act = fw::active_tiles(w, a, r0);
  const float* Mt = nullptr;  // the key-mask tile of the last tile taken

  // tile j's stage in, and its key mask in the warpgroup's buffer
  auto acquire = [&](int j) {
    if (mask_b != nullptr)
      Mt = fw::mask_tile(sy.mask[wg], mask_b, j * kBN, a.T, j, wg, tid);
    ring.wait(j);
  };
  auto stage = [&](int j) { return ring.stage(j); };

  float o[kDT][4], sc[kNT][4];
  uint32_t pa[kNT / 2][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
  hopper::mbar_wait(&sy.res, 0);
  // Step j issues S of tile j and O += P V of tile j - 1 together; tile j's
  // softmax then runs while P V does, and O is rescaled once P V has
  // landed. Every warpgroup takes n_tiles + 1 steps; a tile none of its
  // rows sees is only taken and released.
  for (int j = 0; j <= w.n_tiles; ++j) {
    if (j < w.n_tiles) acquire(j);
    const bool s_go = j < n_act, pv_go = j >= 1 && j - 1 < n_act;
    hopper::wgmma_fence();
    if (s_go) {
      fw::issue_abt<kD>(&sc[0][0], qd, hopper::desc_sw128(stage(j)));
      hopper::wgmma_commit();
    }
    if (pv_go) {
      fw::issue_px<kD>(&o[0][0], pa, hopper::desc_sw128(stage(j - 1) + L::kTileBytes));
      hopper::wgmma_commit();
    }
    float al_lo = 1.0f, al_hi = 1.0f;
    if (s_go) {
      if (pv_go)
        hopper::wgmma_wait<1>();
      else
        hopper::wgmma_wait<0>();
      hopper::fence_regs<4 * kNT>(&sc[0][0]);
      // a tile the warp sees whole (no key mask, no key past T, under
      // causal no key past its first row) skips the visibility tests
      const int k0 = j * kBN;
      if (mask_b == nullptr && k0 + kBN <= a.T && (!a.causal || k0 + kBN - 1 <= r0 + 16 * warp))
        softmax_tile<true>(sc, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi, 0u, k0, a.causal, row_lo,
                           row_hi, t, scale2);
      else
        softmax_tile<false>(sc, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi,
                            fw::key_bits(Mt, k0, a.T, t), k0, a.causal, row_lo, row_hi, t,
                            scale2);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<4 * kDT>(&o[0][0]);
    if (j >= 1) ring.release(j - 1, lane);
    if (s_go) {
      if (__any_sync(0xffffffffu, al_lo != 1.0f || al_hi != 1.0f)) {  // a max moved
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          o[n][0] *= al_lo;
          o[n][1] *= al_lo;
          o[n][2] *= al_hi;
          o[n][3] *= al_hi;
        }
      }
      fw::to_a(sc, pa);
    }
  }

  const bool live_lo = l_lo > 0.0f, live_hi = l_hi > 0.0f;
  const float inv_lo = live_lo ? 1.0f / l_lo : 0.0f;  // a dead row's o is 0
  const float inv_hi = live_hi ? 1.0f / l_hi : 0.0f;
  if (t == 0) {
    float* lse = a.lse + static_cast<long long>(w.bh) * a.T;
    if (row_lo < a.T) lse[row_lo] = live_lo ? m_lo * kLn2 + logf(l_lo) : kNeg;
    if (row_hi < a.T) lse[row_hi] = live_hi ? m_hi * kLn2 + logf(l_hi) : kNeg;
  }
  bf16_tiles::store_rows(a.out, a.vout, w.b, w.h, row_lo, a.T, a.D, t, o, inv_lo, inv_hi);
}

// A kernel and its launch: dynamic shared memory a block and rows of its
// key tiles
template <typename A>
struct Launch {
  void (*kernel)(A);
  size_t smem;
  int key_rows;
};

// The kernel for head dim D: float32, the 64-wide tiles with 64-key tiles,
// or the 128-wide ones with 16-key tiles (the ring and the registers at
// D = 128).
Launch<Args> pick(const Args& a) {
  return a.D <= 64 ? Launch<Args>{flash_fwd_kernel<64, 64>, Cfg<64, 64>::kSmem, 64}
                   : Launch<Args>{flash_fwd_kernel<128, 16>, Cfg<128, 16>::kSmem, 16};
}

// above 48 KB, dynamic shared memory needs the kernel's opt-in; the
// carveout asks for the SM's largest shared-memory split, so the blocks fit
template <typename A>
cudaError_t prepare(const Launch<A>& l) {
  const cudaError_t err = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// query rows, key rows and threads of a block, registers a thread, local
// (spilled) bytes a thread, dynamic shared memory a block, blocks an SM
template <typename A>
cudaError_t info(const Launch<A>& l, int* out) {
  cudaError_t err = prepare(l);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, l.kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, kThreads, l.smem);
  const int vals[] = {kBM, l.key_rows, kThreads, attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), static_cast<int>(l.smem),
                      per_sm};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool strides4(const View& v) { return v.sb % 4 == 0 && v.st % 4 == 0 && v.sh % 4 == 0; }

// 16-byte copies of q, k and v rows: 4 floats, or 8 bf16, at a time
bool vec_copies(const Args& a) {
  return a.D % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         strides4(a.vq) && strides4(a.vk) && strides4(a.vv);
}

template <typename E>
int run(const E* q, const E* k, const E* v, const float* mask, E* out, float* lse,
        const long long* strides, int B, int T, int H, int D, int causal, void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T < 1) return 0;
  ArgsT<E> a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.out = out;
  a.lse = lse;
  View* views[] = {&a.vq, &a.vk, &a.vv, &a.vout};
  for (int i = 0; i < 4; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B;
  a.T = T;
  a.H = H;
  a.D = D;
  a.causal = causal != 0;
  a.vec = vec_copies(a);
  // as PyTorch rounds the Python float 1/sqrt(D) for a float32 product
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const Launch<ArgsT<E>> l = pick(a);
  const cudaError_t err = prepare(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = B * H * ((T + kBM - 1) / kBM);
  l.kernel<<<blocks, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_info(int D, int* out) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  ArgsT<E> a{};
  a.D = D;
  return static_cast<int>(info(pick(a), out));
}

// ---- K4 bfloat16: the host side of a TMA launch ----

// K/V stages of the ring: a warpgroup holds two (P V of tile j - 1, S of
// tile j), and the loads of the next two run meanwhile
constexpr int kFwdStages = 4;

// a wgmma kernel and its dynamic shared memory a block
struct LaunchW {
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, flash_wg::Args);
  int smem;
};

// 64-key tiles at either width: at the LM's (4, 4096, 8, 64) 128-key tiles
// (S in 64 accumulator registers a thread) took 0.294 ms against 0.245 on
// an H100 (PERF.md)
LaunchW pick_bf16(int D) {
  using flash_wg::Smem;
  return D <= 64 ? LaunchW{flash_fwd_bf16_kernel<64, kFwdStages>, Smem<64, 1, kFwdStages>::kDynamic}
                 : LaunchW{flash_fwd_bf16_kernel<128, kFwdStages>,
                           Smem<128, 1, kFwdStages>::kDynamic};
}

cudaError_t prepare_bf16(const LaunchW& l) {
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
}

// One tensor map a call for each of q, k and v (ops/flash_attention.py
// hands over operands TMA takes as they lie, or aligned copies); the scale
// is 1/sqrt(D) of the true D.
int run_bf16(const Bf16* q, const Bf16* k, const Bf16* v, const float* mask, Bf16* out,
             float* lse, const long long* strides, int B, int T, int H, int D, int causal,
             void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T < 1) return 0;
  const LaunchW l = pick_bf16(D);
  const long long* s = strides;  // (B, T, H) strides of q, k, v and out
  CUtensorMap tq, tk, tv;
  if (!hopper_host::encode_bf16(&tq, q, s[0], s[1], s[2], B, T, H, D, flash_wg::kBM) ||
      !hopper_host::encode_bf16(&tk, k, s[3], s[4], s[5], B, T, H, D, flash_wg::kBN) ||
      !hopper_host::encode_bf16(&tv, v, s[6], s[7], s[8], B, T, H, D, flash_wg::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_wg::Args a{};
  a.mask = mask;
  a.out = out;
  a.lse = lse;
  a.vout = View{s[9], s[10], s[11]};
  a.B = B;
  a.T = T;
  a.H = H;
  a.D = D;
  a.causal = causal != 0;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const cudaError_t err = prepare_bf16(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = B * H * ((T + flash_wg::kBM - 1) / flash_wg::kBM);
  l.kernel<<<blocks, flash_wg::kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(tq, tk,
                                                                                     tv, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_info_bf16(int D, int* out) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  const LaunchW l = pick_bf16(D);
  cudaError_t err = prepare_bf16(l);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, l.kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, flash_wg::kThreads,
                                                        l.smem);
  const int vals[] = {flash_wg::kBM, flash_wg::kBN, flash_wg::kThreads, attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), l.smem, per_sm};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each launch returns cudaGetLastError() after the launch (0 on success), or
// the error of setting the kernel's attributes. strides holds the (B, T, H)
// element strides of q, k, v and out; lse is contiguous (B, H, T) float32;
// mask is contiguous (B, T) float32, or null.
int tpu_ddp_flash_fwd(const float* q, const float* k, const float* v,
                      const float* mask, float* out, float* lse,
                      const long long* strides, int B, int T, int H, int D,
                      int causal, void* stream) {
  return run(q, k, v, mask, out, lse, strides, B, T, H, D, causal, stream);
}

// The same for bfloat16 q, k, v and out.
int tpu_ddp_flash_fwd_bf16(const Bf16* q, const Bf16* k, const Bf16* v,
                           const float* mask, Bf16* out, float* lse,
                           const long long* strides, int B, int T, int H, int D,
                           int causal, void* stream) {
  return run_bf16(q, k, v, mask, out, lse, strides, B, T, H, D, causal, stream);
}

// The launch configuration tpu_ddp_flash_fwd (or _bf16) takes for head dim
// D, into out[7]: query rows, key rows and threads of a block, registers and
// local (spilled) bytes a thread, dynamic shared memory a block, and blocks
// an SM by the runtime's occupancy calculator. Returns a CUDA error code.
int tpu_ddp_flash_fwd_info(int D, int* out) { return launch_info<float>(D, out); }

int tpu_ddp_flash_fwd_info_bf16(int D, int* out) { return launch_info_bf16(D, out); }

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
