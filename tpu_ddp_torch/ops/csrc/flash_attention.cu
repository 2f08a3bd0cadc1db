// K5-K6: the two flash-attention backward kernels for Hopper, on the tensor
// cores in 3xTF32.
//
// Replace the Pallas kernels of tpu_ddp/ops/flash_attention.py:
//   K5 flash_dq_kernel   <- _dq_kernel   (launched by _flash_backward)
//   K6 flash_dkv_kernel  <- _dkv_kernel  (launched by _flash_backward)
// The plain PyTorch versions are dq_plain and dkv_plain in
// tpu_ddp_torch/ops/flash_attention.py. The forward, K4, is
// csrc/flash_forward.cu; its row log-sum-exp lse is read here.
//
// What they compute, for q, k, v of shape (B, T, H, D), float32, scale
// 1/sqrt(D), a key visible to a query when it exists (col < T), is not
// masked (kv_mask[b, col] > 0) and, under causal, col <= row:
//   K5  p = exp(scale * q.k - lse) (invisible: 0); ds = p * (dO.v - di) *
//       scale; dq = sum over keys of ds * k.
//   K6  dv = sum over queries of p * dO; dk = sum over queries of ds * q.
// di = rowsum(dO * O) comes from the caller, as in the JAX package. Each
// output row is written once, by the block that owns it, with no atomics,
// so the result does not change from run to run.
//
// What bounds them on this card: their products, 6*T^2*D operations per
// (b, h) for dq (S = Q K^T, dP = dO V^T, dQ = dS K) and 8*T^2*D for dk/dv
// (S^T, dP^T, dV = P^T dO, dK = dS^T Q). They run on the tensor cores in
// 3xTF32, as K4's do: each operand x splits into hi = tf32(x) and
// lo = x - hi (which the tensor core reads truncated to TF32), and a
// product is lo.hi + hi.lo + hi.hi with float32 accumulators (lo.lo,
// ~2^-22 relative, dropped), three mma.sync.m16n8k8 TF32 products for each
// float32 one (165 TFLOP/s at most, against 67 for float32 on the CUDA
// cores, by the H100 SXM data sheet's 495 TF32 and 67 float32 TFLOP/s). At short
// T (the ViT's 64 tokens) the bytes of q, k, v, dO and one tile's latency
// bound them instead.
//
// The design (K4's FlashAttention-2 layout, twice):
// - K5: a block owns one (b*h, 64-row query tile), each of its four warps
//   16 query rows. The Q and dO tiles stay in shared memory; each thread
//   keeps lse * log2(e) and di of its two rows (g, g + 8) in registers. K,
//   V and the key mask stream through the ring. Per key tile, S and dP are
//   mma accumulators; p = 2^(s * scale * log2(e) - lse * log2(e)) and
//   ds = p * (dp - di) * scale replace them in place; then dQ += dS K.
// - K6: a block owns one (b*h, 64-row key tile), each warp 16 key rows. K,
//   V and the rows' key-mask bits stay; Q, dO and the query tile's lse and
//   di stream through the ring. Per query tile, S^T = K Q^T and
//   dP^T = V dO^T (K4's S with the roles swapped, the per-column lse and
//   di from the ring), then dV += P^T dO and dK += dS^T Q.
// - A score accumulator holds row r's columns 2t and 2t + 1 in lane (r, t),
//   which is the A operand's layout once the column order inside each
//   8-wide slice is permuted (column 2t as k = t, 2t + 1 as k = t + 4); the
//   B operand (K for dQ, dO and Q for dV and dK) is read in that same order.
//   So P and dS never leave registers: no shuffle, no score tile in shared
//   memory, no barrier between the scores and the products.
// - The three products of a 3xTF32 step go to independent accumulators in
//   turn (S's and dP's n-tiles together; the output n-tiles, four at a
//   time, of dQ, or of dV and dK together), so no mma waits on the one
//   before it.
// - The streamed tiles go through a two-stage ring in shared memory, filled
//   by cp.async: tile j + 1 loads while tile j is computed, one barrier a
//   tile. Rows past T and columns past D arrive as zeros (cp.async's
//   src-size), so any T >= 1 and D <= 128 work and the products run over
//   all kD columns with no bound checks. Tiles are rows of kD + 4 floats:
//   every fragment read of a warp falls in 32 distinct banks.
// - An entry that is not visible is set to 0 by selection, so rows with no
//   visible key give dq = 0 and masked keys dk = dv = 0, exactly; a tile
//   the warp sees whole skips the visibility tests.
// - Resources: 128 threads, __launch_bounds__(128, 2), so a thread may take
//   up to 255 registers (K6's dk and dv accumulators alone are 128 at
//   D = 128) and two blocks fit an SM's register file. Shared memory a
//   block: the two resident (64, kD + 4) tiles and the ring, ~100 KB at
//   D = 128 with 16-row streamed tiles, so two blocks fit an SM's 227 KB;
//   at D = 64, 32-row streamed tiles, ~70 KB (64-key tiles for K5 measured
//   slower at the ViT's shape: tools/k56_variants.py, PERF.md).
// Causal: K5 stops at its query tile's last row, and a warp skips the key
// tiles past its own last row; K6 starts at the query tile holding its
// first key, and a warp skips the query tiles that end before its first
// key. q, k, v and dO are read through their (B, T, H) strides, so the
// views of the ViT's qkv split need no copy; 16-byte copies where D, the
// strides and the pointers allow, 4-byte ones otherwise.
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

constexpr float kLog2e = 1.4426950408889634f;

template <typename E>  // the element type of q, k, v, dO, dq, dk and dv
struct ArgsT {
  const E *q, *k, *v, *dout;
  const float *lse_in, *di, *mask;
  E *dq, *dk, *dv;
  View vq, vk, vv, vdo, vout, vdk, vdv;  // vout: the strides of dq
  int B, T, H, D;
  bool causal, vec;  // vec: 16-byte copies of q, k, v and dO rows
  float scale;
};
using Args = ArgsT<float>;

constexpr int kBM = 64;        // rows a block owns: queries (K5), keys (K6)
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kMinBlocks = 2;  // blocks an SM: up to 255 registers a thread

// Shared memory of a block: two resident (kBM, kD + 4) tiles, two streamed
// (kBN, kD + 4) tiles in two stages, and kVecs per-row vectors of the
// streamed tile in two stages (K5: the key mask; K6: lse and di).
template <int kD, int kBN, int kVecs>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBM * (kD + 4) + 4 * kBN * (kD + 4) + 2 * kVecs * kBN);
}

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
template <int kD, int kRows>
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

// Elements [t0, t0 + n) of row src into dst, zero past T (n <= kThreads).
__device__ __forceinline__ void load_vec(float* dst, const float* src, int t0, int n, int T) {
  if (threadIdx.x < n) {
    const int t = t0 + threadIdx.x;
    const bool live = t < T;
    cp_async4(dst + threadIdx.x, live ? src + t : src, live ? 4 : 0);
  }
}

// hi = tf32(x) and lo = x - hi, as the mma's 32-bit operands. hi rounds to
// nearest, ties away from zero (cvt.rna.tf32.f32's rounding), written as
// in K4 (flash_forward.cu: the instruction costs more on sm_90): an add of
// half a TF32 unit to the bit pattern and a mask of the 13 bits below it.
// lo (exact: |lo| <= 2^-11 |x|) goes to the tensor core as it is, which
// reads a TF32 operand's top 19 bits and so truncates it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  lo = __float_as_uint(rest);
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

// One round of d[d0 + i] += a.b[i] in 3xTF32 over kN accumulators: round 0
// the lo.hi terms, 1 the hi.lo terms, 2 the hi.hi terms (the small terms
// first)
template <int kRound, int kN, int kM>
__device__ __forceinline__ void mma_round(float (&d)[kM][4], int d0, const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[kN][2],
                                          const uint32_t (&blo)[kN][2]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    mma(d[d0 + i], kRound == 0 ? alo : ahi, kRound == 1 ? blo[i] : bhi[i]);
}

// The A operand (16 x 8: rows g, g + 8; columns t, t + 4) of a row-major
// tile, split; p points at row g, column t.
template <int kLd>
__device__ __forceinline__ void frag_a(const float* p, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * kLd], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * kLd + 4], hi[3], lo[3]);
}

// The B operand (8 x 8: k = t, t + 4; n = g) of X^T, X a row-major tile
// whose row is n, split; p points at row g, column t.
__device__ __forceinline__ void frag_b(const float* p, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// The B operand of X itself under the permutation: k = t is row 2t, k = t + 4
// row 2t + 1, n = g the column; p points at row 2t, column g.
template <int kLd>
__device__ __forceinline__ void frag_b_perm(const float* p, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  split(p[0], hi[0], lo[0]);
  split(p[kLd], hi[1], lo[1]);
}

// An accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A operand under
// the permutation, split.
__device__ __forceinline__ void frag_acc(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// 2^x (ex2.approx: 2 ulp; an argument of -inf or below -126 gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = A X^T and U = C Y^T for a warp's 16 rows of the resident tiles (A, C
// at the lane's row g, column t) and the kBN rows of the streamed ones, over
// all kD columns: the three products of each 3xTF32 step go round the 2 kN
// independent accumulators (K4's own accumulators for the small terms, at
// few n-tiles, measured no faster here: PERF.md).
template <int kD, int kBN>
__device__ __forceinline__ void two_products(const float* A, const float* X, const float* C,
                                             const float* Y, int g, int t,
                                             float (&s)[kBN / 8][4], float (&u)[kBN / 8][4]) {
  constexpr int kLd = kD + 4, kNT = kBN / 8;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = u[n][e] = 0.0f;
#pragma unroll(kD == 64 ? 2 : kD / 8)
  for (int kk = 0; kk < kD; kk += 8) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    uint32_t xh[kNT][2], xl[kNT][2], yh[kNT][2], yl[kNT][2];
    frag_a<kLd>(A + kk, ah, al);
    frag_a<kLd>(C + kk, ch, cl);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      frag_b(X + (8 * n + g) * kLd + kk + t, xh[n], xl[n]);
      frag_b(Y + (8 * n + g) * kLd + kk + t, yh[n], yl[n]);
    }
    mma_round<0>(s, 0, ah, al, xh, xl);
    mma_round<0>(u, 0, ch, cl, yh, yl);
    mma_round<1>(s, 0, ah, al, xh, xl);
    mma_round<1>(u, 0, ch, cl, yh, yl);
    mma_round<2>(s, 0, ah, al, xh, xl);
    mma_round<2>(u, 0, ch, cl, yh, yl);
  }
}

// Rows row_lo and row_lo + 8 (those below T) of a warp's (16, kD)
// accumulator into the (b, h) slice of y, columns below D.
template <int kDT>
__device__ __forceinline__ void store_rows(float* y, View v, int b, int h, int row_lo,
                                           int T, int D, int t, const float (&acc)[kDT][4]) {
  float* base = y + b * v.sb + h * v.sh;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (col >= D) break;
    const bool pair = col + 1 < D;
    if (row_lo < T) {
      float* o = base + static_cast<long long>(row_lo) * v.st + col;
      o[0] = acc[dn][0];
      if (pair) o[1] = acc[dn][1];
    }
    if (row_hi < T) {
      float* o = base + static_cast<long long>(row_hi) * v.st + col;
      o[0] = acc[dn][2];
      if (pair) o[1] = acc[dn][3];
    }
  }
}

constexpr int kG = 4;  // output n-tiles a round of dQ, dV and dK

// K5 (replaces _dq_kernel). 1-D grid of B*H*ceil(T/kBM) blocks, the query
// tiles of one (b, h) adjacent so that they share K/V tiles in L2.
template <int kD, int kBN>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_dq_kernel(Args a) {
  constexpr int kLd = kD + 4, kNT = kBN / 8, kDT = kD / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBM * kLd;
  float* Ks = dOs + kBM * kLd;  // [2][kBN][kLd]
  float* Vs = Ks + 2 * kBN * kLd;
  float* Ms = Vs + 2 * kBN * kLd;  // [2][kBN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row and column
  const int tiles = (a.T + kBM - 1) / kBM;
  const int bh = blockIdx.x / tiles, b = bh / a.H, h = bh % a.H;
  // under causal the last query tiles have the most keys: start them first
  const int tile = a.causal ? tiles - 1 - blockIdx.x % tiles : blockIdx.x % tiles;
  const int q0 = tile * kBM;
  const int warp_first = q0 + 16 * warp, warp_last = warp_first + 15;
  const int row_lo = warp_first + g, row_hi = row_lo + 8;
  const float scale2 = a.scale * kLog2e;
  const float* mask_b = a.mask ? a.mask + static_cast<long long>(b) * a.T : nullptr;

  auto load_kv = [&](int j, int stage) {
    const int k0 = j * kBN;
    load_tile<kD, kBN>(Ks + stage * kBN * kLd, a.k, a.vk, b, h, k0, a.T, a.D, a.vec);
    load_tile<kD, kBN>(Vs + stage * kBN * kLd, a.v, a.vv, b, h, k0, a.T, a.D, a.vec);
    if (mask_b != nullptr) load_vec(Ms + stage * kBN, mask_b, k0, kBN, a.T);
  };

  const int kv_end = a.causal ? min(a.T, q0 + kBM) : a.T;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  load_tile<kD, kBM>(Qs, a.q, a.vq, b, h, q0, a.T, a.D, a.vec);
  load_tile<kD, kBM>(dOs, a.dout, a.vdo, b, h, q0, a.T, a.D, a.vec);
  load_kv(0, 0);
  cp_async_commit();

  // the two rows' lse in base 2 and di; a row past T takes 0 (not stored)
  const float* lse_bh = a.lse_in + static_cast<long long>(bh) * a.T;
  const float* di_bh = a.di + static_cast<long long>(bh) * a.T;
  const float l2_lo = row_lo < a.T ? lse_bh[row_lo] * kLog2e : 0.0f;
  const float l2_hi = row_hi < a.T ? lse_bh[row_hi] * kLog2e : 0.0f;
  const float di_lo = row_lo < a.T ? di_bh[row_lo] : 0.0f;
  const float di_hi = row_hi < a.T ? di_bh[row_hi] : 0.0f;

  float dq[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  const float* Qw = Qs + (16 * warp + g) * kLd + t;
  const float* dOw = dOs + (16 * warp + g) * kLd + t;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    const int k0 = j * kBN;
    if (a.causal && k0 > warp_last) continue;  // no key of this tile is visible
    const float* Kt = Ks + (j & 1) * kBN * kLd;
    const float* Vt = Vs + (j & 1) * kBN * kLd;
    const float* Mt = Ms + (j & 1) * kBN;

    float s[kNT][4], ds[kNT][4];  // S, then dP, then dS in place
    two_products<kD, kBN>(Qw, Kt, dOw, Vt, g, t, s, ds);

    // p and ds. A tile the warp sees whole (no key mask, no key past T,
    // under causal no key past its first row) needs no visibility; else an
    // entry (row g or g + 8, key 8n + 2t + (e & 1)) that is not visible
    // gets p = 0 by selection.
    const bool whole = mask_b == nullptr && k0 + kBN <= a.T &&
                       (!a.causal || k0 + kBN - 1 <= warp_first);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[n][e], scale2, -(e < 2 ? l2_lo : l2_hi)));
        if (!whole) {
          const int c = 8 * n + 2 * t + (e & 1), col = k0 + c;
          const bool live = (mask_b != nullptr ? Mt[c] > 0.0f : col < a.T) &&
                            (!a.causal || col <= (e < 2 ? row_lo : row_hi));
          p = live ? p : 0.0f;
        }
        ds[n][e] = p * (ds[n][e] - (e < 2 ? di_lo : di_hi)) * a.scale;
      }
    }

    // dQ += dS K: dS's accumulator layout is its A operand under the key
    // permutation, so K rows are read as keys 2t and 2t + 1
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      uint32_t ah[4], al[4];
      frag_acc(ds[n], ah, al);
      const float* Kr = Kt + (8 * n + 2 * t) * kLd + g;
#pragma unroll
      for (int d0 = 0; d0 < kDT; d0 += kG) {
        uint32_t bh_[kG][2], bl[kG][2];
#pragma unroll
        for (int i = 0; i < kG; ++i) frag_b_perm<kLd>(Kr + 8 * (d0 + i), bh_[i], bl[i]);
        mma_round<0>(dq, d0, ah, al, bh_, bl);
        mma_round<1>(dq, d0, ah, al, bh_, bl);
        mma_round<2>(dq, d0, ah, al, bh_, bl);
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group
  store_rows(a.dq, a.vout, b, h, row_lo, a.T, a.D, t, dq);
}

// K6 (replaces _dkv_kernel). 1-D grid of B*H*ceil(T/kBM) blocks, the key
// tiles of one (b, h) adjacent so that they share Q/dO tiles in L2.
template <int kD, int kBN>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_dkv_kernel(Args a) {
  constexpr int kLd = kD + 4, kNT = kBN / 8, kDT = kD / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBM * kLd;
  float* Qs = Vs + kBM * kLd;  // [2][kBN][kLd]
  float* dOs = Qs + 2 * kBN * kLd;
  float* Ls = dOs + 2 * kBN * kLd;  // [2][kBN]: the query tile's lse
  float* Ds = Ls + 2 * kBN;         // [2][kBN]: its di

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (a.T + kBM - 1) / kBM;
  const int bh = blockIdx.x / tiles, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x % tiles * kBM;
  const int warp_first = k0 + 16 * warp;
  const int key_lo = warp_first + g, key_hi = key_lo + 8;
  const float scale2 = a.scale * kLog2e;
  const float* mask_b = a.mask ? a.mask + static_cast<long long>(b) * a.T : nullptr;
  const bool live_lo = key_lo < a.T && (mask_b == nullptr || mask_b[key_lo] > 0.0f);
  const bool live_hi = key_hi < a.T && (mask_b == nullptr || mask_b[key_hi] > 0.0f);
  const float* lse_bh = a.lse_in + static_cast<long long>(bh) * a.T;
  const float* di_bh = a.di + static_cast<long long>(bh) * a.T;

  // causal: queries before k0 see none of this tile's keys
  const int q_begin = a.causal ? k0 : 0;
  auto load_q = [&](int j, int stage) {
    const int q0 = q_begin + j * kBN;
    load_tile<kD, kBN>(Qs + stage * kBN * kLd, a.q, a.vq, b, h, q0, a.T, a.D, a.vec);
    load_tile<kD, kBN>(dOs + stage * kBN * kLd, a.dout, a.vdo, b, h, q0, a.T, a.D, a.vec);
    load_vec(Ls + stage * kBN, lse_bh, q0, kBN, a.T);
    load_vec(Ds + stage * kBN, di_bh, q0, kBN, a.T);
  };

  const int n_tiles = (a.T - q_begin + kBN - 1) / kBN;
  load_tile<kD, kBM>(Ks, a.k, a.vk, b, h, k0, a.T, a.D, a.vec);
  load_tile<kD, kBM>(Vs, a.v, a.vv, b, h, k0, a.T, a.D, a.vec);
  load_q(0, 0);
  cp_async_commit();

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const float* Kw = Ks + (16 * warp + g) * kLd + t;
  const float* Vw = Vs + (16 * warp + g) * kLd + t;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + 1 < n_tiles) load_q(j + 1, (j + 1) & 1);
    cp_async_commit();
    const int q0 = q_begin + j * kBN;
    // causal: every query of this tile comes before the warp's first key
    if (a.causal && q0 + kBN - 1 < warp_first) continue;
    const float* Qt = Qs + (j & 1) * kBN * kLd;
    const float* dOt = dOs + (j & 1) * kBN * kLd;
    const float* Lt = Ls + (j & 1) * kBN;
    const float* Dt = Ds + (j & 1) * kBN;

    float p[kNT][4], ds[kNT][4];  // S^T, then P^T; dP^T, then dS^T
    two_products<kD, kBN>(Kw, Qt, Vw, dOt, g, t, p, ds);

    // P^T and dS^T: entry (key row g or g + 8, query 8n + 2t + (e & 1)),
    // with that query's lse and di. A tile the warp sees whole (no key
    // mask, no key or query past T, under causal no key past the tile's
    // first query) needs no visibility.
    const bool whole = mask_b == nullptr && q0 + kBN <= a.T && warp_first + 16 <= a.T &&
                       (!a.causal || warp_first + 15 <= q0);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        float pe = ex2(fmaf(p[n][e], scale2, -(Lt[c] * kLog2e)));
        if (!whole) {
          const int row = q0 + c;
          const bool live = (e < 2 ? live_lo : live_hi) && row < a.T &&
                            (!a.causal || (e < 2 ? key_lo : key_hi) <= row);
          pe = live ? pe : 0.0f;
        }
        p[n][e] = pe;
        ds[n][e] = pe * (ds[n][e] - Dt[c]) * a.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: both accumulator layouts are A
    // operands under the query permutation, so dO and Q rows are read as
    // queries 2t and 2t + 1
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      frag_acc(p[n], ph, pl);
      frag_acc(ds[n], sh, sl);
      const float* dOr = dOt + (8 * n + 2 * t) * kLd + g;
      const float* Qr = Qt + (8 * n + 2 * t) * kLd + g;
#pragma unroll
      for (int d0 = 0; d0 < kDT; d0 += kG) {
        uint32_t oh[kG][2], ol[kG][2], qh[kG][2], ql[kG][2];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          frag_b_perm<kLd>(dOr + 8 * (d0 + i), oh[i], ol[i]);
          frag_b_perm<kLd>(Qr + 8 * (d0 + i), qh[i], ql[i]);
        }
        mma_round<0>(dv, d0, ph, pl, oh, ol);
        mma_round<0>(dk, d0, sh, sl, qh, ql);
        mma_round<1>(dv, d0, ph, pl, oh, ol);
        mma_round<1>(dk, d0, sh, sl, qh, ql);
        mma_round<2>(dv, d0, ph, pl, oh, ol);
        mma_round<2>(dk, d0, sh, sl, qh, ql);
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group
  store_rows(a.dk, a.vdk, b, h, key_lo, a.T, a.D, t, dk);
  store_rows(a.dv, a.vdv, b, h, key_lo, a.T, a.D, t, dv);
}

// K5 for bfloat16 inputs (replaces _dq_kernel on bf16 q, k, v and dO), on
// Hopper's tensor-core path: TMA, an mbarrier ring and wgmma, in the
// skeleton it shares with K4's (flash_wg.cuh).
//
// What bounds it: its three products, 6 T^2 D bf16 operations a (b, h)
// (under causal over the T(T + 1)/2 visible pairs), at 989 TFLOP/s; at the
// ViT's 64 tokens one tile's latency. The mma.sync design before it (one
// warp's 16 rows, Q's, dO's and K's fragments reloaded from shared memory
// every key tile, two 4-warp blocks an SM) reached 14.5% of that bound at
// the LM's shape. Here:
// - a block owns 128 query rows of one (b, h), 64 to each warpgroup; Q and
//   dO are loaded once, and each thread keeps lse * log2(e) and di of its
//   two rows in registers; K and V tiles of 64 keys stream through the ring;
// - S = Q K^T and dP = dO V^T are wgmma with both operands in shared
//   memory, issued together; p = 2^(s * scale * log2(e) - lse * log2(e))
//   (invisible entries 0 by selection, without branches) and
//   ds = p (dp - di) scale are formed in their accumulator registers,
//   rounded to bf16 (design (a)) and handed as A fragments to dQ += dS K,
//   with K read transposed (MN-major) from the same ring stage;
// - tile j's ds is formed while the tensor cores run tile j + 1's S and dP,
//   issued before it into a second pair of accumulators: S, dP, the next
//   tile's S and dP, dQ and dS's fragments take 32 + 32 + 64 + kD / 2 + 16
//   registers a thread, 225 in all at D = 64, which two warpgroups allow;
// - dq is written once, rounded to bf16 (nearest even), by the warpgroup
//   that owns its rows: no atomics, so a call's bits do not change from run
//   to run.
// 256 threads, one block an SM; measured alternatives (dQ of tile j - 1 also
// under tile j's ds, 3 or 6 stages): tools/k56_variants.py, PERF.md.

// K5's scores of one key tile for a warp's 16 rows (row_lo = its row g,
// row_hi = g + 8), in accumulator layout (key 8n + 2t + (e & 1)):
// p = 2^(s * scale * log2(e) - lse * log2(e)) and ds = p (dp - di) scale
// replace dp. A tile seen whole (kWhole) has no invisible score; otherwise
// one (its key not in `keys`, or under causal past the row) gets p = 0 by
// selection. Both forms are branch-free over the scores.
template <bool kWhole, int kNT>
__device__ __forceinline__ void ds_tile(const float (&s)[kNT][4], float (&dp)[kNT][4],
                                        uint32_t keys, int k0, bool causal, int row_lo,
                                        int row_hi, int t, float scale2, float scale, float l2_lo,
                                        float l2_hi, float di_lo, float di_hi) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[n][e], scale2, -(e < 2 ? l2_lo : l2_hi)));
      if (!kWhole)
        p = flash_wg::visible(keys, n, e, k0, t, causal, row_lo, row_hi) ? p : 0.0f;
      dp[n][e] = p * (dp[n][e] - (e < 2 ? di_lo : di_hi)) * scale;
    }
  }
}

template <int kD, int kStages>
__global__ void __launch_bounds__(flash_wg::kThreads, 1)
    flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, flash_wg::Args a) {
  namespace fw = flash_wg;
  using L = fw::Smem<kD, 2, kStages>;
  constexpr int kBN = fw::kBN, kNT = fw::kNT, kDT = kD / 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ fw::Sync<kStages> sy;
  uint8_t* smem = fw::align1024(smem_raw);
  const fw::Work w = fw::block_work(a);
  const fw::Ring<kD, 2, kStages> ring{sy, smem, &tk, &tv, w};
  fw::init_barriers(sy);
  if (threadIdx.x == 0) {
    const CUtensorMap* res[2] = {&tq, &tdo};
    ring.start(res);
  }
  const int wg = threadIdx.x / fw::kWG;
  const int tid = threadIdx.x % fw::kWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = w.row0 + 64 * wg;  // the warpgroup's first row
  const int row_lo = r0 + 16 * warp + g, row_hi = row_lo + 8;
  const float scale2 = a.scale * kLog2e;
  const float* mask_b = a.mask ? a.mask + static_cast<long long>(w.b) * a.T : nullptr;
  const uint64_t qd = hopper::desc_sw128(smem + wg * 64 * 128);
  const uint64_t dod = hopper::desc_sw128(smem + L::kResBytes + wg * 64 * 128);
  const int n_act = fw::active_tiles(w, a, r0);
  const float* Mt = nullptr;  // the key-mask tile of the last tile taken

  // the two rows' lse in base 2 and di; a row past T takes 0 (not stored)
  const float* lse_bh = a.lse_in + static_cast<long long>(w.bh) * a.T;
  const float* di_bh = a.di + static_cast<long long>(w.bh) * a.T;
  const float l2_lo = row_lo < a.T ? lse_bh[row_lo] * kLog2e : 0.0f;
  const float l2_hi = row_hi < a.T ? lse_bh[row_hi] * kLog2e : 0.0f;
  const float di_lo = row_lo < a.T ? di_bh[row_lo] : 0.0f;
  const float di_hi = row_hi < a.T ? di_bh[row_hi] : 0.0f;

  // tile j's stage in, and its key mask in the warpgroup's buffer
  auto acquire = [&](int j) {
    if (mask_b != nullptr)
      Mt = fw::mask_tile(sy.mask[wg], mask_b, j * kBN, a.T, j, wg, tid);
    ring.wait(j);
  };
  auto stage = [&](int j) { return ring.stage(j); };

  // S and dP of tile j + 1 into sn and dn, issued as one group
  auto issue_sdp = [&](float* s_acc, float* p_acc, int j) {
    fw::issue_abt<kD>(s_acc, qd, hopper::desc_sw128(stage(j)));
    fw::issue_abt<kD>(p_acc, dod, hopper::desc_sw128(stage(j) + L::kTileBytes));
    hopper::wgmma_commit();
  };

  // sc, dp: tile j's S and dP (dp then dS); sn, dn: tile j + 1's
  float dq[kDT][4], sc[kNT][4], dp[kNT][4], sn[kNT][4], dn[kNT][4];
  uint32_t da[kNT / 2][4];  // dS's A fragments, rounded to bf16
#pragma unroll
  for (int n = 0; n < kDT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  hopper::mbar_wait(&sy.res, 0);
  if (n_act > 0) {
    acquire(0);
    hopper::wgmma_fence();
    issue_sdp(&sc[0][0], &dp[0][0], 0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<4 * kNT>(&sc[0][0]);
    hopper::fence_regs<4 * kNT>(&dp[0][0]);
  }
  // Tile j's ds is formed while S and dP of tile j + 1 run on the tensor
  // cores; then dQ += dS K.
  for (int j = 0; j < n_act; ++j) {
    const bool more = j + 1 < n_act;
    const int k0 = j * kBN;
    const float* Mj = Mt;  // tile j's key mask (taking tile j + 1 moves Mt)
    if (more) {
      acquire(j + 1);
      hopper::wgmma_fence();
      issue_sdp(&sn[0][0], &dn[0][0], j + 1);
    }
    // a tile the warp sees whole (no key mask, no key past T, under causal
    // no key past its first row) needs no visibility
    if (mask_b == nullptr && k0 + kBN <= a.T && (!a.causal || k0 + kBN - 1 <= r0 + 16 * warp))
      ds_tile<true>(sc, dp, 0u, k0, a.causal, row_lo, row_hi, t, scale2, a.scale, l2_lo,
                    l2_hi, di_lo, di_hi);
    else
      ds_tile<false>(sc, dp, fw::key_bits(Mj, k0, a.T, t), k0, a.causal, row_lo, row_hi,
                     t, scale2, a.scale, l2_lo, l2_hi, di_lo, di_hi);
    fw::to_a(dp, da);
    hopper::wgmma_fence();
    fw::issue_px<kD>(&dq[0][0], da, hopper::desc_sw128(stage(j)));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<4 * kDT>(&dq[0][0]);
    ring.release(j, lane);
    if (more) {
      hopper::fence_regs<4 * kNT>(&sn[0][0]);
      hopper::fence_regs<4 * kNT>(&dn[0][0]);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = sn[n][e];
          dp[n][e] = dn[n][e];
        }
    }
  }
  // the tiles none of the warpgroup's rows sees: taken and given back
  for (int j = n_act; j < w.n_tiles; ++j) {
    acquire(j);
    ring.release(j, lane);
  }
  bf16_tiles::store_rows(a.out, a.vout, w.b, w.h, row_lo, a.T, a.D, t, dq);
}

// K6 for bfloat16 inputs (replaces _dkv_kernel on bf16 q, k, v and dO), on
// Hopper's tensor-core path: TMA, an mbarrier ring and wgmma, in the
// skeleton K4's and K5's share (flash_wg.cuh) with the roles of the resident
// and streamed tiles swapped.
//
// What bounds it: its four products, 8 T^2 D bf16 operations a (b, h)
// (under causal over the T(T + 1)/2 visible pairs), at 989 TFLOP/s; at the
// ViT's 64 tokens one tile's latency. The mma.sync design before it (128
// threads, each warp's 16 keys, K's and V's fragments reloaded from shared
// memory for every query tile, cp.async tiles) reached 18.3% of that bound
// at the LM's shape. Here:
// - a block owns 128 keys of one (b, h), 64 to each warpgroup; K and V are
//   loaded once, and Q and dO tiles of 64 queries stream through the ring
//   with those queries' lse and di (TMA loads of the (B H, T) float32 rows
//   into the same stage); under causal the query tiles start at the block's
//   first key, and the grid starts the first key tiles, which the most
//   queries see;
// - S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in shared
//   memory, issued together (the warpgroup's 64 keys are the M rows);
//   p^T = 2^(s^T scale log2(e) - lse log2(e)) is formed in S^T's
//   accumulator registers, a column's lse read from the stage (invisible
//   entries 0 by selection, without branches: two live-key flags a thread,
//   a query test a column), and ds^T = p^T (dp^T - di) scale in dP^T's;
//   both are rounded to bf16 (design (a)) and handed as A fragments to
//   dV += P^T dO and dK += dS^T Q, issued together, with dO and Q read
//   transposed (MN-major) from the same stage;
// - the tensor cores overlap one warpgroup's products with the other's
//   p^T and ds^T; a thread holds S^T, dP^T, dK, dV and the A fragments,
//   32 + 32 + 32 + 32 + 32 registers at D = 64 (176 in all, no spill);
// - dk and dv are written once, rounded to bf16 (nearest even), by the
//   warpgroup that owns their keys: no atomics, so a call's bits do not
//   change from run to run.
// 256 threads, one block an SM. Measured no faster at the LM's shape
// (PERF.md): tile j + 1's S^T and dP^T issued before tile j's p^T into a
// second pair of accumulators, as K5 does; dV, dK of tile j issued back to
// back with S^T, dP^T of tile j + 1 (ptxas serializes the wgmma); lse and
// di copied by each warpgroup instead of riding in the stage. dV issued
// before ds^T is formed, S^T waited for alone (p^T formed while dP^T
// runs), 3 or 6 stages: tools/k56_variants.py.

// K6's p^T of one query tile for a warp's 16 keys (key_lo = its row g,
// key_hi = g + 8), in accumulator layout (query q0 + 8n + 2t + (e & 1)):
// s = S^T becomes p^T = 2^(s scale log2(e) - lse log2(e)) with the tile's
// kBN values of lse, rounded to bf16 into the A fragments pa. A tile seen
// whole (kWhole) has no invisible score; otherwise one (flash_wg::visible_kv)
// gets p = 0 by selection. Both forms are branch-free over the scores.
template <bool kWhole, int kNT>
__device__ __forceinline__ void p_tile(float (&s)[kNT][4], uint32_t (&pa)[kNT / 2][4],
                                       const float* lse, bool live_lo, bool live_hi, int q0,
                                       int T, bool causal, int key_lo, int key_hi, int t,
                                       float scale2) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[n][e], scale2, -((e & 1 ? l.y : l.x) * kLog2e)));
      s[n][e] = kWhole || flash_wg::visible_kv(live_lo, live_hi, n, e, q0, t, T, causal,
                                               key_lo, key_hi)
                    ? p
                    : 0.0f;
    }
  }
  flash_wg::to_a(s, pa);
}

// ds^T = p^T (dp - di) scale from p = P^T and dp = dP^T with the tile's kBN
// values of di, rounded to bf16 into the A fragments sa (an invisible entry's
// p is 0, so its ds is too)
template <int kNT>
__device__ __forceinline__ void ds_tile_kv(const float (&p)[kNT][4], float (&dp)[kNT][4],
                                           uint32_t (&sa)[kNT / 2][4], const float* di, int t,
                                           float scale) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 d = *reinterpret_cast<const float2*>(di + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - (e & 1 ? d.y : d.x)) * scale;
  }
  flash_wg::to_a(dp, sa);
}

template <int kD, int kStages>
__global__ void __launch_bounds__(flash_wg::kThreads, 1)
    flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdi, flash_wg::Args a) {
  namespace fw = flash_wg;
  using L = fw::Smem<kD, 2, kStages, 2>;
  constexpr int kBN = fw::kBN, kNT = fw::kNT, kDT = kD / 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ fw::Sync<kStages> sy;
  uint8_t* smem = fw::align1024(smem_raw);
  const fw::Work w = fw::block_work_kv(a);
  const fw::Ring<kD, 2, kStages, 2> ring{sy, smem, &tq, &tdo, w, {&tlse, &tdi}};
  fw::init_barriers(sy);
  if (threadIdx.x == 0) {
    const CUtensorMap* res[2] = {&tk, &tv};
    ring.start(res);
  }
  const int wg = threadIdx.x / fw::kWG;
  const int tid = threadIdx.x % fw::kWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = w.row0 + 64 * wg;  // the warpgroup's first key
  const int rw = r0 + 16 * warp;    // the warp's
  const int key_lo = rw + g, key_hi = key_lo + 8;
  const float scale2 = a.scale * kLog2e;
  const float* mask_b = a.mask ? a.mask + static_cast<long long>(w.b) * a.T : nullptr;
  const bool live_lo = key_lo < a.T && (mask_b == nullptr || mask_b[key_lo] > 0.0f);
  const bool live_hi = key_hi < a.T && (mask_b == nullptr || mask_b[key_hi] > 0.0f);
  const uint64_t kd = hopper::desc_sw128(smem + wg * 64 * 128);
  const uint64_t vd = hopper::desc_sw128(smem + L::kResBytes + wg * 64 * 128);
  const int n_tiles = w.n_tiles, j0 = fw::first_tile_kv(w, a, r0);

  // sc, dp: a tile's S^T and dP^T (p^T, ds^T in place)
  float dk[kDT][4], dv[kDT][4], sc[kNT][4], dp[kNT][4];
  uint32_t pa[kNT / 2][4], sa[kNT / 2][4];  // P^T's and dS^T's A fragments, bf16
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  hopper::mbar_wait(&sy.res, 0);
  // the tiles none of the warpgroup's keys is seen by: taken and given back
  for (int j = 0; j < j0; ++j) {
    ring.wait(j);
    ring.release(j, lane);
  }
  for (int j = j0; j < n_tiles; ++j) {
    const uint64_t qdesc = hopper::desc_sw128(ring.stage(j));
    const uint64_t dodesc = hopper::desc_sw128(ring.stage(j) + L::kTileBytes);
    ring.wait(j);
    hopper::wgmma_fence();
    fw::issue_abt<kD>(&sc[0][0], kd, qdesc);   // S^T = K Q^T
    fw::issue_abt<kD>(&dp[0][0], vd, dodesc);  // dP^T = V dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<4 * kNT>(&sc[0][0]);
    hopper::fence_regs<4 * kNT>(&dp[0][0]);
    // a tile the warp sees whole (no key mask, no key or query past T, under
    // causal no key of the warp after the tile's first query) needs no
    // visibility
    const int q0 = w.s0 + j * kBN;
    const float* vt = ring.vec(j);  // lse, then di
    if (mask_b == nullptr && rw + 16 <= a.T && q0 + kBN <= a.T && (!a.causal || rw + 15 <= q0))
      p_tile<true>(sc, pa, vt, live_lo, live_hi, q0, a.T, a.causal, key_lo, key_hi, t, scale2);
    else
      p_tile<false>(sc, pa, vt, live_lo, live_hi, q0, a.T, a.causal, key_lo, key_hi, t, scale2);
    ds_tile_kv(sc, dp, sa, vt + kBN, t, a.scale);
    hopper::wgmma_fence();
    fw::issue_px<kD>(&dv[0][0], pa, dodesc);  // dV += P^T dO
    fw::issue_px<kD>(&dk[0][0], sa, qdesc);   // dK += dS^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<4 * kDT>(&dk[0][0]);
    hopper::fence_regs<4 * kDT>(&dv[0][0]);
    ring.release(j, lane);
  }
  bf16_tiles::store_rows(a.out, a.vout, w.b, w.h, key_lo, a.T, a.D, t, dk);
  bf16_tiles::store_rows(a.out2, a.vout2, w.b, w.h, key_lo, a.T, a.D, t, dv);
}

enum Which { kDq = 0, kDkv = 1 };

template <typename A>
struct Launch {
  void (*kernel)(A);
  size_t smem;
  int query_rows, key_rows;  // rows of a block's query and key tiles
};

// The kernel for head dim D: the 64-wide tiles with 32-row streamed tiles,
// or the 128-wide ones with 16-row streamed tiles (the ring and the
// registers at D = 128, two blocks an SM).
Launch<Args> pick(Which w, const Args& a) {
  if (w == kDq)
    return a.D <= 64
               ? Launch<Args>{flash_dq_kernel<64, 32>, smem_bytes<64, 32, 1>(), kBM, 32}
               : Launch<Args>{flash_dq_kernel<128, 16>, smem_bytes<128, 16, 1>(), kBM, 16};
  return a.D <= 64
             ? Launch<Args>{flash_dkv_kernel<64, 32>, smem_bytes<64, 32, 2>(), 32, kBM}
             : Launch<Args>{flash_dkv_kernel<128, 16>, smem_bytes<128, 16, 2>(), 16, kBM};
}

// above 48 KB, dynamic shared memory needs the kernel's opt-in; the carveout
// asks for the SM's largest shared-memory split, so two blocks fit
template <typename A>
cudaError_t prepare(const Launch<A>& l) {
  const cudaError_t err = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool strides4(const View& v) { return v.sb % 4 == 0 && v.st % 4 == 0 && v.sh % 4 == 0; }

// 16-byte copies of q, k, v and dO rows: 4 floats at a time
bool vec_copies(const Args& a) {
  return a.D % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout) && strides4(a.vq) && strides4(a.vk) && strides4(a.vv) &&
         strides4(a.vdo);
}

template <typename A>
int run(Which w, A& a, const long long* strides, int n_views, View* const* views,
        int B, int T, int H, int D, int causal, void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T < 1) return 0;
  for (int i = 0; i < n_views; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B;
  a.T = T;
  a.H = H;
  a.D = D;
  a.causal = causal != 0;
  a.vec = vec_copies(a);
  // as PyTorch rounds the Python float 1/sqrt(D) for a float32 product
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const Launch<A> l = pick(w, a);
  const cudaError_t err = prepare(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = B * H * ((T + kBM - 1) / kBM);
  l.kernel<<<blocks, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dq(const E* q, const E* k, const E* v, const E* dout, const float* lse,
       const float* di, const float* mask, E* dq_out, const long long* strides, int B,
       int T, int H, int D, int causal, void* stream) {
  ArgsT<E> a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.mask = mask;
  a.dq = dq_out;
  View* views[] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vout};
  return run(kDq, a, strides, 5, views, B, T, H, D, causal, stream);
}

template <typename E>
int dkv(const E* q, const E* k, const E* v, const E* dout, const float* lse,
        const float* di, const float* mask, E* dk, E* dv, const long long* strides, int B,
        int T, int H, int D, int causal, void* stream) {
  ArgsT<E> a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.mask = mask;
  a.dk = dk;
  a.dv = dv;
  View* views[] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vdk, &a.vdv};
  return run(kDkv, a, strides, 6, views, B, T, H, D, causal, stream);
}

// rows of a block's query and key tiles, threads a block, registers and
// local (spilled) bytes a thread, dynamic shared memory a block, and blocks
// an SM by the runtime's occupancy calculator
template <typename E>
int launch_info(int which, int D, int* out) {
  if (D < 1 || D > 128 || (which != kDq && which != kDkv))
    return static_cast<int>(cudaErrorInvalidValue);
  ArgsT<E> a{};
  a.D = D;
  const Launch<ArgsT<E>> l = pick(static_cast<Which>(which), a);
  cudaError_t err = prepare(l);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, l.kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, kThreads, l.smem);
  const int vals[] = {l.query_rows, l.key_rows, kThreads, attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), static_cast<int>(l.smem),
                      per_sm};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}

// ---- K5's and K6's bfloat16 kernels: the host side of a TMA launch ----

// K/V stages of K5's ring: a warpgroup holds two (dS K of tile j, S and dP
// of tile j + 1), and the loads of the next ones run meanwhile
constexpr int kDqStages = 4;
// Q/dO stages of K6's ring, likewise
constexpr int kDkvStages = 4;

// a wgmma kernel and its dynamic shared memory a block
struct LaunchW {
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, flash_wg::Args);
  int smem;
};

struct LaunchKv {
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                 flash_wg::Args);
  int smem;
};

LaunchW pick_dq_bf16(int D) {
  using flash_wg::Smem;
  return D <= 64 ? LaunchW{flash_dq_bf16_kernel<64, kDqStages>, Smem<64, 2, kDqStages>::kDynamic}
                 : LaunchW{flash_dq_bf16_kernel<128, kDqStages>,
                           Smem<128, 2, kDqStages>::kDynamic};
}

LaunchKv pick_dkv_bf16(int D) {
  using flash_wg::Smem;
  return D <= 64 ? LaunchKv{flash_dkv_bf16_kernel<64, kDkvStages>,
                            Smem<64, 2, kDkvStages, 2>::kDynamic}
                 : LaunchKv{flash_dkv_bf16_kernel<128, kDkvStages>,
                            Smem<128, 2, kDkvStages, 2>::kDynamic};
}

template <typename L>
cudaError_t prepare_bf16(const L& l) {
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
}

// The fields both kernels' Args share; the scale is 1/sqrt(D) of the true D.
flash_wg::Args args_bf16(const float* lse, const float* di, const float* mask, int B, int T,
                         int H, int D, int causal) {
  flash_wg::Args a{};
  a.mask = mask;
  a.lse_in = lse;
  a.di = di;
  a.B = B;
  a.T = T;
  a.H = H;
  a.D = D;
  a.causal = causal != 0;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  return a;
}

// One tensor map a call for each of q, dO, k and v (ops/flash_attention.py
// hands over operands TMA takes as they lie, or aligned copies).
int dq_bf16(const Bf16* q, const Bf16* k, const Bf16* v, const Bf16* dout, const float* lse,
            const float* di, const float* mask, Bf16* dq_out, const long long* strides, int B,
            int T, int H, int D, int causal, void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T < 1) return 0;
  const LaunchW l = pick_dq_bf16(D);
  const long long* s = strides;  // (B, T, H) strides of q, k, v, dO and dq
  CUtensorMap tq, tdo, tk, tv;
  if (!hopper_host::encode_bf16(&tq, q, s[0], s[1], s[2], B, T, H, D, flash_wg::kBM) ||
      !hopper_host::encode_bf16(&tk, k, s[3], s[4], s[5], B, T, H, D, flash_wg::kBN) ||
      !hopper_host::encode_bf16(&tv, v, s[6], s[7], s[8], B, T, H, D, flash_wg::kBN) ||
      !hopper_host::encode_bf16(&tdo, dout, s[9], s[10], s[11], B, T, H, D, flash_wg::kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_wg::Args a = args_bf16(lse, di, mask, B, T, H, D, causal);
  a.out = dq_out;
  a.vout = View{s[12], s[13], s[14]};
  const cudaError_t err = prepare_bf16(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = B * H * ((T + flash_wg::kBM - 1) / flash_wg::kBM);
  l.kernel<<<blocks, flash_wg::kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// One tensor map a call for each of k, v, q and dO, and for lse and di,
// whose rows lie at a stride of T rounded up to 4 (TMA's 16 bytes; the
// wrapper pads them where T is not a multiple of 4).
int dkv_bf16(const Bf16* q, const Bf16* k, const Bf16* v, const Bf16* dout, const float* lse,
             const float* di, const float* mask, Bf16* dk, Bf16* dv, const long long* strides,
             int B, int T, int H, int D, int causal, void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (T < 1) return 0;
  const LaunchKv l = pick_dkv_bf16(D);
  const long long* s = strides;  // (B, T, H) strides of q, k, v, dO, dk and dv
  const long long ld = (T + 3) / 4 * 4;
  CUtensorMap tk, tv, tq, tdo, tlse, tdi;
  if (!hopper_host::encode_bf16(&tk, k, s[3], s[4], s[5], B, T, H, D, flash_wg::kBM) ||
      !hopper_host::encode_bf16(&tv, v, s[6], s[7], s[8], B, T, H, D, flash_wg::kBM) ||
      !hopper_host::encode_bf16(&tq, q, s[0], s[1], s[2], B, T, H, D, flash_wg::kBN) ||
      !hopper_host::encode_bf16(&tdo, dout, s[9], s[10], s[11], B, T, H, D, flash_wg::kBN) ||
      !hopper_host::encode_f32_rows(&tlse, lse, B * H, T, ld, flash_wg::kBN) ||
      !hopper_host::encode_f32_rows(&tdi, di, B * H, T, ld, flash_wg::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_wg::Args a = args_bf16(lse, di, mask, B, T, H, D, causal);
  a.out = dk;
  a.vout = View{s[12], s[13], s[14]};
  a.out2 = dv;
  a.vout2 = View{s[15], s[16], s[17]};
  const cudaError_t err = prepare_bf16(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = B * H * ((T + flash_wg::kBM - 1) / flash_wg::kBM);
  l.kernel<<<blocks, flash_wg::kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      tk, tv, tq, tdo, tlse, tdi, a);
  return static_cast<int>(cudaGetLastError());
}

// launch_info's values for a wgmma kernel with query_rows and key_rows a block
template <typename L>
int info_bf16(const L& l, int query_rows, int key_rows, int* out) {
  cudaError_t err = prepare_bf16(l);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, l.kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, flash_wg::kThreads,
                                                        l.smem);
  const int vals[] = {query_rows, key_rows, flash_wg::kThreads, attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), l.smem, per_sm};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}

int launch_info_bf16(int which, int D, int* out) {
  if (D < 1 || D > 128 || (which != kDq && which != kDkv))
    return static_cast<int>(cudaErrorInvalidValue);
  return which == kDq ? info_bf16(pick_dq_bf16(D), flash_wg::kBM, flash_wg::kBN, out)
                      : info_bf16(pick_dkv_bf16(D), flash_wg::kBN, flash_wg::kBM, out);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 on
// success), or the error of setting the kernel's attributes. strides holds
// the (B, T, H) element strides of each (B, T, H, D) tensor argument, in
// argument order; lse and di are contiguous (B, H, T) float32 (for
// tpu_ddp_flash_dkv_bf16 rows at a stride of T rounded up to 4, the same
// where T is a multiple of 4); mask is contiguous (B, T) float32, or null.
// The _bf16 entry points take bfloat16 (B, T, H, D) tensors.

int tpu_ddp_flash_dq(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* di,
                     const float* mask, float* dq_out, const long long* strides,
                     int B, int T, int H, int D, int causal, void* stream) {
  return dq(q, k, v, dout, lse, di, mask, dq_out, strides, B, T, H, D, causal, stream);
}

int tpu_ddp_flash_dkv(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* di,
                      const float* mask, float* dk, float* dv,
                      const long long* strides, int B, int T, int H, int D,
                      int causal, void* stream) {
  return dkv(q, k, v, dout, lse, di, mask, dk, dv, strides, B, T, H, D, causal, stream);
}

int tpu_ddp_flash_dq_bf16(const Bf16* q, const Bf16* k, const Bf16* v,
                          const Bf16* dout, const float* lse, const float* di,
                          const float* mask, Bf16* dq_out, const long long* strides,
                          int B, int T, int H, int D, int causal, void* stream) {
  return dq_bf16(q, k, v, dout, lse, di, mask, dq_out, strides, B, T, H, D, causal, stream);
}

int tpu_ddp_flash_dkv_bf16(const Bf16* q, const Bf16* k, const Bf16* v,
                           const Bf16* dout, const float* lse, const float* di,
                           const float* mask, Bf16* dk, Bf16* dv,
                           const long long* strides, int B, int T, int H, int D,
                           int causal, void* stream) {
  return dkv_bf16(q, k, v, dout, lse, di, mask, dk, dv, strides, B, T, H, D, causal, stream);
}

// The launch configuration of K5 (which = 0) or K6 (which = 1) for head dim
// D, into out[7] (launch_info). Returns a CUDA error code.
int tpu_ddp_flash_bwd_info(int which, int D, int* out) {
  return launch_info<float>(which, D, out);
}

int tpu_ddp_flash_bwd_info_bf16(int which, int D, int* out) {
  return launch_info_bf16(which, D, out);
}

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
