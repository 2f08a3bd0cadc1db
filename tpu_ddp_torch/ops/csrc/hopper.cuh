// Hopper (sm_90a) building blocks of K4's, K5's and K6's bfloat16 kernels
// (flash_forward.cu, flash_attention.cu), in inline PTX: the mbarrier, TMA
// tensor loads, named barriers, the wgmma shared-memory descriptor and
// wgmma itself; on the host, the encoding of a TMA tensor map.
//
// The layout every operand tile takes in shared memory is the one a TMA load
// with the 128-byte swizzle writes: a box of R rows of 64 bf16 (128 bytes),
// row r at 128 r, its eight 16-byte chunks permuted by chunk ^ (r % 8). A
// tile wider than 64 columns is several such boxes one after another. Each
// box starts on a 1024-byte boundary (the swizzle's period of 8 rows), so
// the wgmma descriptors below carry no base offset:
// - K-major (A, or a B whose rows are N): rows at 128 bytes, 8-row groups at
//   SBO = 1024; the k-th 16-column step of a box starts 32 k bytes in.
// - MN-major (a B whose rows are K, N contiguous: V in P V, K in dS K): the
//   same box read with the transpose bit; 8-row groups of K at SBO = 1024,
//   the next 16 rows of K 2048 bytes on; N = 64, one 128-byte chunk column.
//
// Accumulators of wgmma.m64nNk16 with float32 results: warp w of the
// warpgroup holds rows 16 w .. 16 w + 15; lane (g, t) = (lane / 4, lane % 4)
// holds, for each 8-column tile n, d[4n] = (row g, column 8n + 2t),
// d[4n + 1] = (g, 8n + 2t + 1), d[4n + 2] = (g + 8, 8n + 2t),
// d[4n + 3] = (g + 8, 8n + 2t + 1): mma.sync's C fragment, n-tile by n-tile.
// A from registers takes a warp's 16 rows as mma.sync.m16n8k16's A fragment
// (bf16_tiles.cuh), so two neighbouring accumulator n-tiles, rounded and
// packed (bf16_tiles::acc_to_a), are the A operand of the next product.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing is linked
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any thread (or the TMA unit) uses the barriers;
// a __syncthreads follows
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of transactions (the TMA loads that
// complete on this barrier)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that never ends is a fault of the pipeline's bookkeeping: after 10
// seconds the kernel traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(a, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// ---- TMA ------------------------------------------------------------------------

// The box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into shared
// memory at dst; completes `bar`'s transactions with the box's bytes (a box
// reaching past the tensor arrives zero-filled, and counts whole).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box at coordinates (c0, c1) of a 2-D tensor map into shared memory
// at dst, as tma_load_4d
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- named barriers -----------------------------------------------------------

// bar.sync on barrier `id` (1-15; 0 is __syncthreads) for `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -------------------------------------------------------------------------

// The descriptor of a 128-byte-swizzled operand tile at p (a box, or a
// 16-column step into one: p 1024-byte aligned plus 32 k bytes): start
// address >> 4 in bits 0-13, the leading byte offset >> 4 in 16-29 (unused
// by the K-major and one-column MN-major reads here), the stride byte
// offset 1024 >> 4 in 32-45, layout 1 (128-byte swizzle) in 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// a descriptor moved `bytes` on (a multiple of 16) in shared memory
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// before a wgmma reads registers (accumulators, or A) that other
// instructions wrote. Its shared-memory operands come from TMA, the same
// async proxy, so no proxy fence is needed before it reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of n registers across
// this point: a wgmma's results are there only after its wait, though the
// asm that issued it names them as outputs.
template <int kN>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64n64 float32) = a.b (+ d when accumulate): A and B from shared memory,
// both K-major, through their descriptors
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64 float32) += a.b: A from registers (four per thread, the mma.sync
// m16n8k16 A fragment of the warp's 16 rows), B from shared memory through its
// descriptor, MN-major (transposed: N contiguous)
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}


}  // namespace hopper

// ---- host ----------------------------------------------------------------------------

namespace hopper_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library links nothing but the runtime; null if the driver
// has none. Looked up once.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : static_cast<EncodeTiled>(nullptr);
  }();
  return fn;
}

// The tensor map of a bf16 (B, T, H, D) tensor at ptr with element strides
// sb, st, sh (D's is 1) as the 4-D tensor (D, H, T, B), boxes of 64 columns
// by `rows` tokens of one (b, h), 128-byte swizzled; reads past D or T are
// zero-filled. TMA needs ptr 16-byte aligned and sb, st, sh multiples of 8
// elements (the wrapper's operand plan, ops/flash_attention.py). Returns
// false if the encode fails.
inline bool encode_bf16(CUtensorMap* map, const void* ptr, long long sb, long long st,
                        long long sh, int B, int T, int H, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of `rows` float32 rows of n values at ptr, row r at
// ptr + r * stride (stride a multiple of 4 elements: TMA's 16 bytes), as
// boxes of `cols` values of one row, not swizzled; reads past n are
// zero-filled. Returns false if the encode fails.
inline bool encode_f32_rows(CUtensorMap* map, const float* ptr, int rows, int n,
                            long long stride, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), 1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper_host
