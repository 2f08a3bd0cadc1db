// K2 and K3: block-scaled int8 quantize and dequantize(-accumulate) of the
// compressed gradient ring, for Hopper, over a table of segments: one launch
// serves every leaf of a ring hop.
//
// K2 (tpu_ddp_quant_kernel) replaces the Pallas kernel
// tpu_ddp/ops/fused_quant.py::_quant_kernel (launched by fused_quant). Per
// scale block of `block` consecutive elements of a leaf's chunk:
//   scale = max|x| / 127          (a max that keeps NaN, IEEE division)
//   safe  = scale > 0 ? scale : 1
//   q     = clamp(rint(x / safe), -127, 127)   (round half to even)
// and, when asked, the error the wire adds: err = x - (float)q * scale.
// Positions at or past the chunk's length read 0, so each chunk's tail block
// is zero-padded.
//
// K3 (tpu_ddp_dequant_kernel) replaces the Pallas kernel
// tpu_ddp/ops/fused_quant.py::_make_dequant_kernel (launched by
// fused_dequant): out = (float)q * scale, plus add_to when given. It
// multiplies by the RAW scale, so a block whose scale is not finite
// dequantizes non-finite.
//
// The segment table. The ring keeps all leaves in one float32 buffer,
// leaf-major: leaf i at p_i, its chunk c at p_i + c * s_i (s_i = its padded
// length / n ranks). A hop's wire message holds every leaf's chunk c: first
// all scales (one float a scale block, in leaf order), then all q (block
// bytes a scale block). Row i of the int64 table (kCols columns) holds p_i,
// s_i, b_i (the leaf's first scale block in the message) and r_i (its offset
// in one rank's row of the shard layout, ChunkMajor). Scale blocks restart at
// every leaf's chunk and never straddle two leaves: that keeps the bits those
// of quantize_chunk run leaf by leaf. A thread group finds its leaf by a
// binary search over b_i, so the table has no length cap. A null table is
// the one-segment case: one leaf of `size` elements at offset 0 (the
// single-chunk fused_quant / fused_dequant).
//
// The arithmetic follows quantize_chunk and dequantize_chunk
// (tpu_ddp_torch/parallel/compression.py, the plain versions) operation for
// operation. Build with -fmad=false: the plain version rounds q * scale and
// then the sum with add_to (or the difference from x); an FMA would round
// once.
//
// What bounds them: device-memory bandwidth at large chunks (K2 reads 4
// bytes an element and writes 1, plus 4 with the error; K3 reads 1, plus 4
// with add_to, and writes 4), the launch at the ring's chunk sizes. What the
// design does about the launch: one K2 and one K3 a hop for all leaves, the
// hop's chunk a scalar argument, the table uploaded once; K2 writes the wire
// message and the error in the same pass, and K3 reads the received message
// in place, one row or all n ranks' rows (a 2-D grid) at once. About the
// bytes: each scale block is one warp (K2: one 256-thread block when the
// scale block is longer than 1,024 elements); neighbouring lanes read
// neighbouring elements; K2 reduces the max with shuffles and, up to 1,024
// elements, keeps the block in registers for the second pass (its loads all
// in flight at once; larger blocks are read again from the cache).
//
// Plain C interface, loaded with ctypes (tpu_ddp_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int64_t kWarpMaxBlock = 1024;   // longest scale block one warp takes
constexpr int kCols = 4;                  // table columns: p, s, b, r

struct Segment {
  int64_t p, s, b, r;
};

// max that keeps NaN (as torch.amax and jnp.max; fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The leaf of scale block g: the last table row whose first block is <= g
// (empty leaves share their first block with the next leaf, so the last
// such row is the one that holds g).
__device__ __forceinline__ Segment find_segment(const int64_t* __restrict__ table,
                                                int nseg, int64_t size, int64_t g) {
  if (table == nullptr) return {0, size, 0, 0};
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * kCols + 2] <= g) lo = mid; else hi = mid - 1;
  }
  const int64_t* row = table + lo * kCols;
  return {row[0], row[1], row[2], row[3]};
}

// G threads per scale block: 32 (one warp) or kThreads (the whole block).
// Reads chunk `chunk` of every segment of x; writes the scales, q and (E:
// err is not null) the error at the same chunk of err. K > 0 (one warp):
// each lane holds its K elements of the scale block (block <= 32 * K) in
// registers from the max to the quantize pass, so its K loads are in flight
// at once and the block is read once. K = 0: each pass loops over the
// block, the second reading it again from the cache.
template <int G, int K, bool E>
__global__ void tpu_ddp_quant_kernel(const float* __restrict__ x,
                                     const int64_t* __restrict__ table, int nseg,
                                     int64_t size, int64_t nb, int64_t block,
                                     int64_t chunk, float* __restrict__ scale,
                                     int8_t* __restrict__ q, float* __restrict__ err) {
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / G;
  int64_t start = 0;  // the scale block's first element in x
  int64_t end = 0;    // its elements inside the chunk (the tail block is short)
  float v[K > 0 ? K : 1];
  float amax = 0.0f;
  if (g < nb) {
    const Segment seg = find_segment(table, nseg, size, g);
    const int64_t base = (g - seg.b) * block;
    start = seg.p + chunk * seg.s + base;
    end = seg.s - base < block ? seg.s - base : block;
    if constexpr (K > 0) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int j = lane + u * G;
        v[u] = j < end ? x[start + j] : 0.0f;
        amax = nan_max(amax, fabsf(v[u]));
      }
    } else {
      for (int64_t j = lane; j < end; j += G) amax = nan_max(amax, fabsf(x[start + j]));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (G > kWarp) {
    __shared__ float warp_max[kThreads / kWarp];
    if (threadIdx.x % kWarp == 0) warp_max[threadIdx.x / kWarp] = amax;
    __syncthreads();
    amax = warp_max[0];
    for (int w = 1; w < kThreads / kWarp; ++w) amax = nan_max(amax, warp_max[w]);
  }
  if (g >= nb) return;
  const float s = amax / 127.0f;
  const float safe = s > 0.0f ? s : 1.0f;
  if (lane == 0) scale[g] = s;
  int8_t* qb = q + g * block;
  float* e = E ? err + start : nullptr;
  const bool with_err = E;
  if constexpr (K > 0) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int j = lane + u * G;
      if (j < block) {
        const int8_t qv =
            static_cast<int8_t>(fminf(fmaxf(rintf(v[u] / safe), -127.0f), 127.0f));
        qb[j] = qv;
        if (with_err && j < end) e[j] = v[u] - static_cast<float>(qv) * s;
      }
    }
  } else {
    for (int64_t j = lane; j < block; j += G) {
      const float val = j < end ? x[start + j] : 0.0f;
      const int8_t qv =
          static_cast<int8_t>(fminf(fmaxf(rintf(val / safe), -127.0f), 127.0f));
      qb[j] = qv;
      if (with_err && j < end) e[j] = val - static_cast<float>(qv) * s;
    }
  }
}

template <int G, int K>
void launch_quant(int64_t grid, cudaStream_t stream, const float* x,
                  const int64_t* table, int nseg, int64_t size, int64_t nb,
                  int64_t block, int64_t chunk, float* scale, int8_t* q, float* err) {
  const unsigned blocks = static_cast<unsigned>(grid);
  if (err != nullptr) {
    tpu_ddp_quant_kernel<G, K, true><<<blocks, kThreads, 0, stream>>>(
        x, table, nseg, size, nb, block, chunk, scale, q, err);
  } else {
    tpu_ddp_quant_kernel<G, K, false><<<blocks, kThreads, 0, stream>>>(
        x, table, nseg, size, nb, block, chunk, scale, q, err);
  }
}

// One warp per scale block of row blockIdx.y of the message (rows lie
// row_bytes apart: the all-gather's n rows). Writes each segment's
// dequantized chunk to dst: at r_i (to_rows: one rank's shard row) or at
// chunk dst_chunk + row of the leaf-major dst; adds chunk add_chunk of the
// leaf-major add first when add is not null. add and dst may be the same
// buffer (each element is read and written by one thread), so they are not
// __restrict__: each lane loads kUnroll elements before it stores any, or
// every load would wait for the store before it.
constexpr int kUnroll = 8;

__global__ void tpu_ddp_dequant_kernel(const float* __restrict__ scale,
                                       const int8_t* __restrict__ q,
                                       int64_t row_bytes,
                                       const int64_t* __restrict__ table, int nseg,
                                       int64_t size, int64_t nb, int64_t block,
                                       const float* add, int64_t add_chunk,
                                       float* dst, int64_t dst_chunk, int to_rows) {
  constexpr int kGroups = kThreads / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / kWarp;
  if (g >= nb) return;
  const int64_t row = blockIdx.y;
  const Segment seg = find_segment(table, nseg, size, g);
  const int64_t base = (g - seg.b) * block;
  // a row starts 4-byte aligned only when row_bytes is a multiple of 4
  const char* scales = reinterpret_cast<const char*>(scale) + row * row_bytes;
  float sc;
  if ((row_bytes & 3) == 0) {
    sc = reinterpret_cast<const float*>(scales)[g];
  } else {
    memcpy(&sc, scales + 4 * g, sizeof(float));
  }
  const int8_t* qb = q + row * row_bytes + g * block;
  const float* a = add != nullptr ? add + seg.p + add_chunk * seg.s : nullptr;
  float* d = dst + (to_rows ? seg.r : seg.p + (dst_chunk + row) * seg.s);
  // the block's elements that lie inside the chunk (the tail block is short)
  const int64_t end = seg.s - base < block ? seg.s - base : block;
  for (int64_t j0 = lane; j0 < end; j0 += kWarp * kUnroll) {
    float v[kUnroll], av[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * kWarp;
      if (j < end) {
        v[u] = static_cast<float>(qb[j]) * sc;
        av[u] = a != nullptr ? a[base + j] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * kWarp;
      if (j < end) d[base + j] = a != nullptr ? av[u] + v[u] : v[u];
    }
  }
}

}  // namespace

extern "C" {

// K2 over nseg segments of `table` (or one of `size` elements when table is
// null), nb scale blocks in all, chunk `chunk` of each. Returns
// cudaGetLastError() after the launch (0 on success).
int tpu_ddp_fused_quant(const float* x, const int64_t* table, int nseg,
                        long long size, long long nb, long long block,
                        long long chunk, float* scale, int8_t* q, float* err,
                        void* stream) {
  if (nb <= 0 || block <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t warps = (nb + kThreads / kWarp - 1) / (kThreads / kWarp);
#define TPU_DDP_QUANT_ARGS s, x, table, nseg, size, nb, block, chunk, scale, q, err
  if (block > kWarpMaxBlock) launch_quant<kThreads, 0>(nb, TPU_DDP_QUANT_ARGS);
  else if (block > 16 * kWarp) launch_quant<kWarp, 32>(warps, TPU_DDP_QUANT_ARGS);
  else if (block > 8 * kWarp) launch_quant<kWarp, 16>(warps, TPU_DDP_QUANT_ARGS);
  else if (block > 4 * kWarp) launch_quant<kWarp, 8>(warps, TPU_DDP_QUANT_ARGS);
  else if (block > 2 * kWarp) launch_quant<kWarp, 4>(warps, TPU_DDP_QUANT_ARGS);
  else if (block > kWarp) launch_quant<kWarp, 2>(warps, TPU_DDP_QUANT_ARGS);
  else launch_quant<kWarp, 1>(warps, TPU_DDP_QUANT_ARGS);
#undef TPU_DDP_QUANT_ARGS
  return static_cast<int>(cudaGetLastError());
}

// K3 over `rows` message rows row_bytes apart (scale and q point into row
// 0), the segments as for K2.
int tpu_ddp_fused_dequant(const float* scale, const int8_t* q, long long row_bytes,
                          int rows, const int64_t* table, int nseg, long long size,
                          long long nb, long long block, const float* add,
                          long long add_chunk, float* dst, long long dst_chunk,
                          int to_rows, void* stream) {
  if (nb <= 0 || block <= 0 || rows <= 0) return 0;
  constexpr int kGroups = kThreads / kWarp;
  const dim3 grid(static_cast<unsigned>((nb + kGroups - 1) / kGroups),
                  static_cast<unsigned>(rows));
  tpu_ddp_dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scale, q, row_bytes, table, nseg, size, nb, block, add, add_chunk, dst,
      dst_chunk, to_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
