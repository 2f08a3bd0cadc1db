// K2 and K3: block-scaled int8 quantize and dequantize(-accumulate) of the
// compressed gradient ring, for Hopper.
//
// K2 (tpu_ddp_quant_kernel) replaces the Pallas kernel
// tpu_ddp/ops/fused_quant.py::_quant_kernel (launched by fused_quant). Per
// scale block of `block` consecutive elements of a 1-D float32 chunk:
//   scale = max|x| / 127          (a max that keeps NaN, IEEE division)
//   safe  = scale > 0 ? scale : 1
//   q     = clamp(rint(x / safe), -127, 127)   (round half to even)
// Positions at or past `size` read 0, so the tail block is zero-padded; q
// has nb * block entries and scale nb.
//
// K3 (tpu_ddp_dequant_kernel) replaces the Pallas kernel
// tpu_ddp/ops/fused_quant.py::_make_dequant_kernel (launched by
// fused_dequant): out[i] = (float)q[i] * scale[i / block], plus add_to[i]
// when given, for i < size. It multiplies by the RAW scale, so a block whose
// scale is not finite dequantizes non-finite.
//
// The arithmetic follows quantize_chunk and dequantize_chunk
// (tpu_ddp_torch/parallel/compression.py, the plain versions) operation for
// operation. Build with -fmad=false: the plain version rounds q * scale and
// then the sum with add_to; an FMA would round once.
//
// What bounds them: device-memory bandwidth. K2 reads 4 bytes an element and
// writes 1, plus 4 bytes a block; K3 reads 1 byte an element (5 with
// add_to) plus 4 bytes a block, and writes 4. What this simple design does
// about that: K2 gives each scale block one warp (one 256-thread block when
// the scale block is longer than 1,024 elements); neighbouring lanes read
// neighbouring elements, the warp reduces the max with shuffles, and the
// second pass over the block reads it again from the cache. K3 is one
// grid-stride elementwise pass. Both use 1-D grids, so there is no 65,535
// limit. At the ring's chunk sizes (5 to 32,768 elements for NetResDeep)
// both are bound by the launch, not by the bytes.
//
// Plain C interface, loaded with ctypes (tpu_ddp_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kWarpMaxBlock = 1024;   // longest scale block one warp takes
constexpr int64_t kMaxGrid = 4096;        // K3's grid-stride cap

// max that keeps NaN (as torch.amax and jnp.max; fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// G threads per scale block: 32 (one warp) or kThreads (the whole block).
template <int G>
__global__ void tpu_ddp_quant_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale, int64_t size,
                                     int64_t block, int64_t nb) {
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / G;
  const int64_t base = b * block;
  float amax = 0.0f;
  if (b < nb) {
    for (int64_t j = lane; j < block; j += G) {
      const int64_t i = base + j;
      amax = nan_max(amax, i < size ? fabsf(x[i]) : 0.0f);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (G > 32) {
    __shared__ float warp_max[kThreads / 32];
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
    amax = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) amax = nan_max(amax, warp_max[w]);
  }
  if (b >= nb) return;
  const float s = amax / 127.0f;
  const float safe = s > 0.0f ? s : 1.0f;
  if (lane == 0) scale[b] = s;
  for (int64_t j = lane; j < block; j += G) {
    const int64_t i = base + j;
    const float r = rintf((i < size ? x[i] : 0.0f) / safe);
    q[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
}

template <bool kAdd>
__global__ void tpu_ddp_dequant_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ add_to,
                                       float* __restrict__ out, int64_t size,
                                       int64_t block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    const float d = static_cast<float>(q[i]) * scale[i / block];
    out[i] = kAdd ? add_to[i] + d : d;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int tpu_ddp_fused_quant(const float* x, int8_t* q, float* scale,
                        long long size, long long block, void* stream) {
  if (size <= 0 || block <= 0) return 0;
  const int64_t nb = (size + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block <= kWarpMaxBlock) {
    constexpr int kGroups = kThreads / 32;
    const int64_t grid = (nb + kGroups - 1) / kGroups;
    tpu_ddp_quant_kernel<32><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        x, q, scale, size, block, nb);
  } else {
    tpu_ddp_quant_kernel<kThreads><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        x, q, scale, size, block, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

int tpu_ddp_fused_dequant(const int8_t* q, const float* scale,
                          const float* add_to, float* out, long long size,
                          long long block, void* stream) {
  if (size <= 0 || block <= 0) return 0;
  int64_t grid = (size + kThreads - 1) / kThreads;
  if (grid > kMaxGrid) grid = kMaxGrid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (add_to != nullptr) {
    tpu_ddp_dequant_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        q, scale, add_to, out, size, block);
  } else {
    tpu_ddp_dequant_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        q, scale, add_to, out, size, block);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
