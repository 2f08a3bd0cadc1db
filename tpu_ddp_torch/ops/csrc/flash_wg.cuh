// The skeleton that K4's and K5's bfloat16 kernels share (flash_forward.cu,
// flash_attention.cu): a block of two warpgroups over one (b, h) and a
// 128-row query tile, 64 rows each.
//
// - The block's resident tiles (K4: Q; K5: Q and dO) are loaded once by
//   TMA; the key tiles (K and V, kBN = 64 rows each) stream through a ring of
//   kStages stages. Each stage has a "full" mbarrier, which its TMA loads
//   complete, and a count of the warps done with it: the last of the eight
//   to finish a tile issues the loads of the tile kStages on into the same
//   stage, from its own lane 0. Thread 0 issues the first kStages.
// - No warp is given to the loads alone: two warpgroups (256 threads) and
//   one block an SM let ptxas give each thread up to 255 registers, where a
//   third, producer warpgroup caps every thread at 168 (and so does a lone
//   producer warp: 288 threads were given 168 too). setmaxnreg, which
//   hands a producer warpgroup's registers to the consumers at run time,
//   does not lift that cap: ptxas allocates every path within the launch
//   bound's budget (on an H100 build the consumers' code used at most 166
//   registers and spilled the same bytes whether setmaxnreg raised them to
//   232 or to 240; PERF.md).
// - Each warpgroup's products are wgmma with float32 accumulators in
//   registers (hopper.cuh). Every warpgroup waits on every stage and
//   releases it, also a stage none of its rows sees (causal, or rows past
//   T), so the ring's phases stay in step.
// - Tiles lie in shared memory as TMA writes them with the 128-byte swizzle:
//   64-column boxes, each on a 1024-byte boundary. A tile reaching past T or
//   D arrives zero-filled, so the products need no bound checks; the row
//   and key tests are the warpgroups' own (T = 1 to any T, D <= 128).
// - The key mask's floats do not ride in the ring: a warpgroup copies its
//   tile's kBN floats (zero past T) into a buffer of its own, one of three,
//   behind one named barrier of its warpgroup.
// - Under causal the grid starts the heaviest query tiles (the last of each
//   head) first, all heads' together; otherwise a head's tiles are adjacent,
//   so that they share K and V in L2.

#pragma once

#include <cstdint>

#include "bf16_tiles.cuh"
#include "hopper.cuh"

namespace flash_wg {

using bf16_tiles::Bf16;
using bf16_tiles::View;

constexpr int kBM = 128;              // query rows a block
constexpr int kWG = 128;              // threads a warpgroup
constexpr int kThreads = 2 * kWG;     // warpgroups 0 and 1, 64 query rows each
constexpr int kWarps = kThreads / 32;  // the warps that release a stage
constexpr int kBN = 64;               // keys a streamed tile
constexpr int kNT = kBN / 8;          // its 8-key n-tiles in a score accumulator

struct Args {
  const float* mask;    // (B, T), or null
  const float* lse_in;  // K5: the forward's (B, H, T) row log-sum-exp
  const float* di;      // K5: (B, H, T) rowsum(dO * O)
  Bf16* out;            // K4's out, K5's dq: (B, T, H, D) through vout
  float* lse;           // K4: (B, H, T)
  View vout;
  int B, T, H, D;
  bool causal;
  float scale;
};

// Shared memory: kRes resident (kBM, kD) tiles, then kStages stages of a K
// and a V (kBN, kD) tile; each tile is kD / 64 boxes of 64 columns.
template <int kD, int kRes, int kStages>
struct Smem {
  static constexpr int kBoxes = kD / 64;
  static constexpr int kResBytes = kBM * kD * 2;
  static constexpr int kTileBytes = kBN * kD * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  // dynamic shared memory a block: the tiles and the slack that rounds the
  // base up to 1024 bytes
  static constexpr int kDynamic = kRes * kResBytes + kStages * kStageBytes + 1024;
};

// the barriers, the ring's counts, and each warpgroup's key-mask tiles
template <int kStages>
struct Sync {
  uint64_t res;              // the resident tiles are in
  uint64_t full[kStages];    // stage s holds its K and V tiles
  unsigned freed[kStages];   // warps done with stage s, over all its tiles
  float mask[2][3][kBN];
};

struct Work {
  int b, h, bh, q0, n_tiles;  // the block's head, first query row, key tiles
};

__device__ __forceinline__ Work block_work(const Args& a) {
  const int tiles = (a.T + kBM - 1) / kBM, heads = a.B * a.H;
  Work w;
  if (a.causal) {  // the last query tiles see the most keys: start them first
    w.bh = blockIdx.x % heads;
    w.q0 = (tiles - 1 - static_cast<int>(blockIdx.x) / heads) * kBM;
  } else {
    w.bh = blockIdx.x / tiles;
    w.q0 = blockIdx.x % tiles * kBM;
  }
  w.b = w.bh / a.H;
  w.h = w.bh % a.H;
  const int kv_end = a.causal ? min(a.T, w.q0 + kBM) : a.T;
  w.n_tiles = (kv_end + kBN - 1) / kBN;
  return w;
}

// Key tiles 0 .. n - 1 that some row of the warpgroup from row r0 on sees:
// none past T; under causal, none past its last row (the skipped tiles are
// the last ones).
__device__ __forceinline__ int active_tiles(const Work& w, const Args& a, int r0) {
  if (r0 >= a.T) return 0;
  return a.causal ? min(w.n_tiles, (r0 + 63) / kBN + 1) : w.n_tiles;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

template <int kStages>
__device__ __forceinline__ void init_barriers(Sync<kStages>& sy) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sy.res, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sy.full[s], 1);
      sy.freed[s] = 0;
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// The block's loads: the resident tiles (kRes tensor maps, rows q0 of the
// block) and key tiles 0 .. n_tiles - 1 of maps tk and tv through the ring.
template <int kD, int kRes, int kStages>
struct Ring {
  using L = Smem<kD, kRes, kStages>;
  Sync<kStages>& sy;
  uint8_t* smem;  // the resident tiles, then the stages
  const CUtensorMap *tk, *tv;
  Work w;

  __device__ __forceinline__ uint8_t* stage(int j) const {
    return smem + kRes * L::kResBytes + (j % kStages) * L::kStageBytes;
  }

  // key tile j (K, then V) into its stage, completing its full barrier
  __device__ __forceinline__ void load(int j) const {
    uint64_t* full = &sy.full[j % kStages];
    uint8_t* kt = stage(j);
    hopper::mbar_expect_tx(full, L::kStageBytes);
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x) {
      hopper::tma_load_4d(kt + x * kBN * 128, tk, full, 64 * x, w.h, j * kBN, w.b);
      hopper::tma_load_4d(kt + L::kTileBytes + x * kBN * 128, tv, full, 64 * x, w.h, j * kBN,
                          w.b);
    }
  }

  // thread 0, once the barriers are set: the resident tiles and the first
  // kStages key tiles
  __device__ __forceinline__ void start(const CUtensorMap* const (&res)[kRes]) const {
    hopper::mbar_expect_tx(&sy.res, kRes * L::kResBytes);
#pragma unroll
    for (int r = 0; r < kRes; ++r)
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
        hopper::tma_load_4d(smem + r * L::kResBytes + x * kBM * 128, res[r], &sy.res, 64 * x,
                            w.h, w.q0, w.b);
    for (int j = 0; j < kStages && j < w.n_tiles; ++j) load(j);
  }

  // tile j's stage in (every thread of the warpgroup waits)
  __device__ __forceinline__ void wait(int j) const {
    hopper::mbar_wait(&sy.full[j % kStages], (j / kStages) & 1);
  }

  // A warp is done with tile j's stage (its reads of it complete: the
  // wgmma that read it waited for); the last of the kWarps refills it.
  __device__ __forceinline__ void release(int j, int lane) const {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&sy.freed[j % kStages], 1u) % kWarps == kWarps - 1 &&
          j + kStages < w.n_tiles)
        load(j + kStages);
    }
  }
};

// Warpgroup c's key-mask tile j (keys k0 .. k0 + kBN - 1, zero past T) in
// its buffer, visible to the warpgroup: one named barrier (1 + c) a tile.
// Three buffers: a warpgroup takes tile j + 1's mask before it is done with tile
// j's, and a thread still reading tile j - 1's has passed tile j's barrier
// but not tile j + 1's.
__device__ __forceinline__ const float* mask_tile(float (&buf)[3][kBN], const float* mask_b,
                                                  int k0, int T, int j, int c, int tid) {
  float* m = buf[j % 3];
  for (int i = tid; i < kBN; i += kWG) m[i] = k0 + i < T ? mask_b[k0 + i] : 0.0f;
  hopper::named_sync(1 + c, kWG);
  return m;
}

// The keys of a tile not seen whole that a thread's 2 kNT columns hold
// (bit 2n + b: column 8n + 2t + b): those that exist (col < T) or, with a
// key mask, are not masked (Mt, zero past T). One test a column, outside
// the per-score loops, so that they run without branches.
__device__ __forceinline__ uint32_t key_bits(const float* Mt, int k0, int T, int t) {
  uint32_t bits = 0;
  if (Mt != nullptr) {
#pragma unroll
    for (int i = 0; i < 2 * kNT; ++i)
      bits |= (Mt[8 * (i / 2) + 2 * t + (i & 1)] > 0.0f ? 1u : 0u) << i;
  } else {
#pragma unroll
    for (int i = 0; i < 2 * kNT; ++i)
      bits |= (k0 + 8 * (i / 2) + 2 * t + (i & 1) < T ? 1u : 0u) << i;
  }
  return bits;
}

// Whether score e of n-tile n is visible: its key is in `keys` and, under
// causal, not past the row (row_lo for e < 2, row_hi else)
__device__ __forceinline__ bool visible(uint32_t keys, int n, int e, int k0, int t,
                                        bool causal, int row_lo, int row_hi) {
  const int col = k0 + 8 * n + 2 * t + (e & 1);
  const bool key = (keys >> (2 * n + (e & 1))) & 1u;
  return key & (!causal | (col <= (e < 2 ? row_lo : row_hi)));
}

// acc (the warpgroup's 64 rows by kBN keys, float32) = A B^T over kD
// columns, issued and not waited for: a the descriptor of a resident tile's
// box 0 at the warpgroup's rows, b that of a streamed tile.
template <int kD>
__device__ __forceinline__ void issue_abt(float* acc, uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t step = 32 * (kk % 4), box = kk / 4;
    const uint64_t da = hopper::desc_add(a, box * kBM * 128 + step);
    const uint64_t db = hopper::desc_add(b, box * kBN * 128 + step);
    hopper::wgmma_ss_n64(acc, da, db, kk > 0);
  }
}

// acc (64 rows by kD, float32) += P X, issued and not waited for: P the
// kBN / 16 A fragments in registers, X a streamed tile read MN-major (its
// rows are the product's k), one n64 product a box.
template <int kD>
__device__ __forceinline__ void issue_px(float* acc, const uint32_t (&p)[kBN / 16][4],
                                         uint64_t x) {
#pragma unroll
  for (int m = 0; m < kBN / 16; ++m)
#pragma unroll
    for (int box = 0; box < kD / 64; ++box)
      hopper::wgmma_rs_n64_tb(acc + 32 * box, p[m],
                              hopper::desc_add(x, box * kBN * 128 + m * 2048), 1);
}

// The score accumulators of 16-key slices as A fragments, rounded to bf16
__device__ __forceinline__ void to_a(const float (&s)[kNT][4], uint32_t (&a)[kNT / 2][4]) {
#pragma unroll
  for (int m = 0; m < kNT / 2; ++m) bf16_tiles::acc_to_a(s[2 * m], s[2 * m + 1], a[m]);
}

}  // namespace flash_wg
