// K5-K6: the two flash-attention backward kernels for Hopper.
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
// di = rowsum(dO * O) comes from the caller, as in the JAX package.
//
// Design. The TPU kernels walk a sequential grid and carry the dq, dk, dv
// sums in VMEM scratch from one grid step to the next. Here the sequential
// grid dimension is a loop inside one thread block: a block owns one (b*h,
// 64-row tile) -- of queries for K5, of keys for K6 -- keeps its running
// sums in registers, and streams the other side's 64-row tiles through
// shared memory. 256 threads as 16 x 16: thread (ty, tx) computes rows
// 4ty..4ty+3 and columns tx, tx+16, tx+32, tx+48 of each 64 x 64 score tile
// (float4 reads from rows padded to D+4 floats, so the 16 column rows a
// half-warp reads fall in distinct banks), and the same four rows of the
// output accumulator, columns 4tx..4tx+3 (+64). Tiles are padded with zeros
// past T and D, so any T >= 1 and any D <= 128 work; D <= 64 takes the
// 64-wide instantiation. Causal skips the tiles above the diagonal. q, k, v
// and dO are read through their (B, T, H) strides, so the views of the
// ViT's qkv split need no copy; outputs are contiguous.
//
// What bounds them on this card: float32 arithmetic on the CUDA cores:
// 6*T^2*D operations per (b, h) for dq and 8*T^2*D for dk/dv, against 67
// TFLOP/s; at short T (the ViT's 64 tokens) the bytes of q, k, v, dO and
// the launch instead. The design keeps every score tile out of device
// memory (it lives in registers and shared-memory tiles) and reads each
// input tile once per block, with eight loads in flight per thread. Built
// with -maxrregcount=255 (tpu_ddp_torch/ops/_build.py). The tensor cores
// (as K4 uses them), wgmma, TMA and bf16 are later work.
//
// Plain C interface, loaded with ctypes (tpu_ddp_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdP = kTile + 4;  // row stride of a 64 x 64 score tile

struct View {  // element strides of B, T and H; D has stride 1
  long long sb, st, sh;
};

struct Args {
  const float *q, *k, *v, *dout, *lse_in, *di, *mask;
  float *dq, *dk, *dv;
  View vq, vk, vv, vdo, vout, vdk, vdv;  // vout: the strides of dq
  int B, T, H, D;
  bool causal;
  float scale;
};

template <int kD>
struct Tile {
  static constexpr int kLd = kD + 4;          // row stride of a (64, kD) tile
  static constexpr int kFloats = kTile * kLd;
  static constexpr int kCols = kD / 16;       // accumulator columns a thread owns
};

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows [t0, t0 + 64) of the (b, h) slice of x into a (64, kD) shared tile;
// rows past T and columns past D are zero.
template <int kD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x,
                                          View v, int b, int h, int t0, int T, int D) {
  const float* base = x + b * v.sb + h * v.sh;
#pragma unroll 8  // eight loads in flight per thread, not one
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, t = t0 + r;
    dst[r * Tile<kD>::kLd + d] =
        (t < T && d < D) ? base[static_cast<long long>(t) * v.st + d] : 0.0f;
  }
}

// Per-row statistic (lse or di) of rows [t0, t0 + 64) of the (B, H, T) array.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int bh, int t0, int T) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    dst[threadIdx.x] = t < T ? src[static_cast<long long>(bh) * T + t] : 0.0f;
  }
}

// 1 where key row t0 + r exists and is not masked.
__device__ __forceinline__ void load_key_visibility(float* dst, const float* mask,
                                                    int b, int t0, int T) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    const bool live = t < T && (mask == nullptr ||
                                mask[static_cast<long long>(b) * T + t] > 0.0f);
    dst[threadIdx.x] = live ? 1.0f : 0.0f;
  }
}

// s[i][j] = A[4ty + i] . B[tx + 16j] over the first d_end columns.
template <int kD>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ty,
                                         int tx, int d_end, float (&s)[4][4]) {
  constexpr int kLd = Tile<kD>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < d_end; d += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][4g + e] += sum_r P[4ty + i][r] * V[r][4tx + 64g + e]: a 64 x 64
// score tile in shared memory times a (64, kD) tile.
template <int kD>
__device__ __forceinline__ void pv_tile(const float* P, const float* V, int ty,
                                        int tx, float (&acc)[4][Tile<kD>::kCols]) {
  constexpr int kLd = Tile<kD>::kLd;
  constexpr int kGroups = kD / 64;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kLdP + r);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(V + (r + e) * kLd + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = lane(p[i], e);
          acc[i][4 * g + 0] = fmaf(pe, vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pe, vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pe, vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pe, vv.w, acc[i][4 * g + 3]);
        }
      }
  }
}

// Rows 4ty + i (< T) of acc, divided by div[i], into the (b, h) slice of y.
template <int kD>
__device__ __forceinline__ void store_rows(float* y, View v, int b, int h, int t0,
                                           int T, int D, int ty, int tx,
                                           const float (&acc)[4][Tile<kD>::kCols],
                                           const float (&div)[4]) {
  float* base = y + b * v.sb + h * v.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < Tile<kD>::kCols; ++c) {
      const int d = 4 * tx + 64 * (c / 4) + c % 4;
      if (d < D) base[static_cast<long long>(t) * v.st + d] = acc[i][c] / div[i];
    }
  }
}

// K5 (replaces _dq_kernel). Grid (query tiles, B*H).
template <int kD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  using L = Tile<kD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + L::kFloats;
  float* Ks = dOs + L::kFloats;
  float* Vs = Ks + L::kFloats;
  float* DSs = Vs + L::kFloats;
  float* kvis = DSs + kTile * kLdP;
  float* lse_s = kvis + kTile;
  float* di_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tiles = (a.T + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x % tiles * kTile;
  const int d_end = (a.D + 3) & ~3;

  load_tile<kD>(Qs, a.q, a.vq, b, h, q0, a.T, a.D);
  load_tile<kD>(dOs, a.dout, a.vdo, b, h, q0, a.T, a.D);
  load_rows(lse_s, a.lse_in, bh, q0, a.T);
  load_rows(di_s, a.di, bh, q0, a.T);
  float acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.0f;
  const int kv_end = a.causal ? min(a.T, q0 + kTile) : a.T;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<kD>(Ks, a.k, a.vk, b, h, k0, a.T, a.D);
    load_tile<kD>(Vs, a.v, a.vv, b, h, k0, a.T, a.D);
    load_key_visibility(kvis, a.mask, b, k0, a.T);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<kD>(Qs, Ks, ty, tx, d_end, s);
    dot_tile<kD>(dOs, Vs, ty, tx, d_end, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      const float lse = lse_s[4 * ty + i], di = di_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool vis = kvis[tx + 16 * j] != 0.0f && (!a.causal || col <= row);
        const float p = vis ? expf(s[i][j] * a.scale - lse) : 0.0f;
        DSs[(4 * ty + i) * kLdP + tx + 16 * j] = p * (dp[i][j] - di) * a.scale;
      }
    }
    __syncthreads();
    pv_tile<kD>(DSs, Ks, ty, tx, acc);
  }
  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<kD>(a.dq, a.vout, b, h, q0, a.T, a.D, ty, tx, acc, one);
}

// K6 (replaces _dkv_kernel). Grid (key tiles, B*H).
template <int kD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  using L = Tile<kD>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + L::kFloats;
  float* Qs = Vs + L::kFloats;
  float* dOs = Qs + L::kFloats;
  float* Ps = dOs + L::kFloats;
  float* DSs = Ps + kTile * kLdP;
  float* kvis = DSs + kTile * kLdP;
  float* lse_s = kvis + kTile;
  float* di_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tiles = (a.T + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x % tiles * kTile;
  const int d_end = (a.D + 3) & ~3;

  load_tile<kD>(Ks, a.k, a.vk, b, h, k0, a.T, a.D);
  load_tile<kD>(Vs, a.v, a.vv, b, h, k0, a.T, a.D);
  load_key_visibility(kvis, a.mask, b, k0, a.T);
  float dk[4][L::kCols], dv[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) dk[i][c] = dv[i][c] = 0.0f;
  // causal: query rows before k0 see none of this tile's keys
  for (int q0 = a.causal ? k0 : 0; q0 < a.T; q0 += kTile) {
    __syncthreads();
    load_tile<kD>(Qs, a.q, a.vq, b, h, q0, a.T, a.D);
    load_tile<kD>(dOs, a.dout, a.vdo, b, h, q0, a.T, a.D);
    load_rows(lse_s, a.lse_in, bh, q0, a.T);
    load_rows(di_s, a.di, bh, q0, a.T);
    __syncthreads();
    // transposed tiles: key rows 4ty + i, query columns tx + 16j
    float s[4][4], dp[4][4];
    dot_tile<kD>(Ks, Qs, ty, tx, d_end, s);
    dot_tile<kD>(Vs, dOs, ty, tx, d_end, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + 4 * ty + i;
      const bool key_live = kvis[4 * ty + i] != 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        const bool vis = key_live && row < a.T && (!a.causal || col <= row);
        const float p = vis ? expf(s[i][j] * a.scale - lse_s[tx + 16 * j]) : 0.0f;
        Ps[(4 * ty + i) * kLdP + tx + 16 * j] = p;
        DSs[(4 * ty + i) * kLdP + tx + 16 * j] =
            p * (dp[i][j] - di_s[tx + 16 * j]) * a.scale;
      }
    }
    __syncthreads();
    pv_tile<kD>(Ps, dOs, ty, tx, dv);
    pv_tile<kD>(DSs, Qs, ty, tx, dk);
  }
  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<kD>(a.dk, a.vdk, b, h, k0, a.T, a.D, ty, tx, dk, one);
  store_rows<kD>(a.dv, a.vdv, b, h, k0, a.T, a.D, ty, tx, dv, one);
}

template <int kD>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * Tile<kD>::kFloats + kTile * kLdP + 3 * kTile);
}
template <int kD>
constexpr size_t smem_dkv() {
  return sizeof(float) * (4 * Tile<kD>::kFloats + 2 * kTile * kLdP + 3 * kTile);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Args& a, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory needs the kernel's opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one block per (b*h, tile), tiles of one (b, h) adjacent, so blocks that
  // read the same K/V (or Q/dO) tiles run together and share them in L2
  const unsigned blocks = a.B * a.H * ((a.T + kTile - 1) / kTile);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

enum Which { kDq, kDkv };

template <int kD>
cudaError_t dispatch_width(Which w, const Args& a, cudaStream_t stream) {
  return w == kDq ? launch(flash_dq_kernel<kD>, smem_dq<kD>(), a, stream)
                  : launch(flash_dkv_kernel<kD>, smem_dkv<kD>(), a, stream);
}

int run(Which w, Args& a, const long long* strides, int n_views, View* const* views,
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
  // as PyTorch rounds the Python float 1/sqrt(D) for a float32 product
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 64 ? dispatch_width<64>(w, a, s) : dispatch_width<128>(w, a, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 on
// success). strides holds the (B, T, H) element strides of each (B, T, H, D)
// tensor argument, in argument order; lse and di are contiguous (B, H, T);
// mask is contiguous (B, T) float32, or null.

int tpu_ddp_flash_dq(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* di,
                     const float* mask, float* dq, const long long* strides,
                     int B, int T, int H, int D, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.di = di;
  a.mask = mask;
  a.dq = dq;
  View* views[] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vout};
  return run(kDq, a, strides, 5, views, B, T, H, D, causal, stream);
}

int tpu_ddp_flash_dkv(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* di,
                      const float* mask, float* dk, float* dv,
                      const long long* strides, int B, int T, int H, int D,
                      int causal, void* stream) {
  Args a{};
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

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
