// K1: the fused optimizer update for Hopper, all of a step's parameter
// leaves in one launch.
//
// Replaces the Pallas kernel tpu_ddp/ops/fused_update.py::_build_kernel
// (launched by _fused_leaf, one pallas_call per leaf). It computes,
// elementwise over each float32 leaf, what the optax chain does as separate
// passes: the global-norm clip, SGD (coupled decay, momentum trace) or AdamW
// (mu/nu, bias correction, decoupled decay), the -lr or schedule scale, and
// the EMA of the new params. The arithmetic follows _update_math
// (fused_update.py:116-151) operation for operation, and
// tpu_ddp_torch/ops/fused_update.py::update_math is its plain PyTorch
// version.
//
// What bounds it: device-memory bandwidth. Per element it moves 16 bytes for
// the reference recipe (read g, p; write u, p), 24 with momentum, 32 for
// AdamW, and 8 more with the EMA (16-40 bytes), against a handful of float
// operations. At the main paths' sizes (76,074 and 2,693,194 elements) those
// bytes take well under 30 us, so what a step waits for is the launch: on
// the TPU XLA fuses the per-leaf calls into one program, under eager PyTorch
// each one was a host round trip and a tiny grid.
//
// What the design does about that: one launch updates every leaf of the step
// (up to kMaxLeaves; a larger tree takes ceil(leaves / kMaxLeaves)). The
// leaves' operands travel in one kernel parameter, a table of kMaxLeaves
// entries (pointers g, p, m, v, e, u, the element count, the leaf's first
// block and its vec and wd_apply flags; about 8 KB, within Hopper's 32,764
// bytes of kernel parameters), so nothing is copied to the device for it and
// nothing waits on the host. The grid is one wave of blocks over all leaves:
// each block owns one kChunk-element chunk of one leaf (a binary search of
// the leaves' first blocks), and strides over it in 16-byte vector loads and
// stores where all six of the leaf's pointers are 16-byte aligned (a scalar
// loop covers the tail and unaligned leaves). Every operand is read once and
// written once; p, m, v and e are updated in place, u goes to its own
// buffer. The flags common to the step (AdamW, momentum, clip, EMA, constant
// step) are template parameters; weight decay is per leaf, so each block
// picks one of two instantiations of the same chunk loop.
//
// Exactness: build with -fmad=false. PyTorch's plain version rounds after
// every operation; letting nvcc contract a multiply and an add into one FMA
// would round once where the plain version rounds twice. Division and
// sqrtf keep nvcc's IEEE defaults (-prec-div=true, -prec-sqrt=true), so the
// kernel is bitwise equal to the plain version on the card for the same
// inputs and the same scalar tensor.
//
// Plain C interface, loaded with ctypes (tpu_ddp_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

struct Consts {
  float momentum, wd, max_norm, step_const;
  float one_minus_b1, b1, one_minus_b2, b2, eps;
  float ema_decay, one_minus_ema;
};

// Static flags of one update configuration, packed into the template mask.
// kDecay is chosen per leaf inside the kernel; the others are the step's.
enum : int {
  kAdamW = 1,
  kMomentum = 2,
  kDecay = 4,
  kClip = 8,
  kEma = 16,
  kStepConst = 32,
  kNumVariants = 64,
};

// Per-leaf flags of a table entry (the Python plan's VEC and WD_APPLY).
enum : int { kLeafVec = 1, kLeafWdApply = 2 };

constexpr int kThreads = 256;
// Elements one block covers; a multiple of 4, so every chunk of an aligned
// leaf starts on a 16-byte boundary (tpu_ddp_torch/ops/fused_update.py CHUNK).
constexpr long long kChunk = 16384;
// Leaves one launch takes (tpu_ddp_torch/ops/fused_update.py MAX_LEAVES).
constexpr int kMaxLeaves = 128;
// Columns of a table row as the Python plan writes it.
constexpr int kCols = 9;

template <int F>
__device__ __forceinline__ void update_one(float g, float& p, float& m,
                                           float& v, float& e, float& u,
                                           const Consts& c, float g_norm,
                                           float step, float bc1, float bc2) {
  if (F & kClip) {
    g = (g_norm < c.max_norm) ? g : (g / g_norm) * c.max_norm;
  }
  float uu;
  if (F & kAdamW) {
    const float mu = c.one_minus_b1 * g + c.b1 * m;
    const float nu = c.one_minus_b2 * (g * g) + c.b2 * v;
    m = mu;
    v = nu;
    const float mu_hat = mu / bc1;
    const float nu_hat = nu / bc2;
    uu = mu_hat / (sqrtf(nu_hat + 0.0f) + c.eps);
    if (F & kDecay) uu = uu + c.wd * p;          // decoupled decay
  } else {
    if (F & kDecay) g = g + c.wd * p;            // coupled decay
    if (F & kMomentum) {
      uu = g + c.momentum * m;                   // optax trace
      m = uu;
    } else {
      uu = g;
    }
  }
  uu = (F & kStepConst) ? c.step_const * uu : step * uu;
  if (F & kEma) e = c.ema_decay * e + c.one_minus_ema * (p + uu);
  u = uu;
  p = p + uu;
}

struct Leaf {
  const float* g;
  float *p, *m, *v, *e, *u;
  long long n;
  int first_block;  // the leaf's first block in the launch's grid
  int flags;        // kLeafVec | kLeafWdApply
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
};

// Elements [begin, end) of one leaf; begin is a multiple of 4.
template <int F>
__device__ __forceinline__ void update_chunk(const Leaf& L, long long begin,
                                             long long end, bool vec,
                                             const Consts& c, float g_norm,
                                             float step, float bc1, float bc2) {
  constexpr bool kHasM = (F & (kAdamW | kMomentum)) != 0;
  constexpr bool kHasV = (F & kAdamW) != 0;
  constexpr bool kHasE = (F & kEma) != 0;
  const float* __restrict__ g = L.g;
  float* __restrict__ p = L.p;
  float* __restrict__ m = L.m;
  float* __restrict__ v = L.v;
  float* __restrict__ e = L.e;
  float* __restrict__ u = L.u;
  const long long vec_end = vec ? begin + (end - begin) / 4 * 4 : begin;
  float dummy = 0.0f;

  for (long long i4 = begin / 4 + threadIdx.x; i4 < vec_end / 4; i4 += kThreads) {
    const float4 gv = reinterpret_cast<const float4*>(g)[i4];
    float4 pv = reinterpret_cast<float4*>(p)[i4];
    float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), vv = mv, ev = mv, uv;
    if (kHasM) mv = reinterpret_cast<float4*>(m)[i4];
    if (kHasV) vv = reinterpret_cast<float4*>(v)[i4];
    if (kHasE) ev = reinterpret_cast<float4*>(e)[i4];
    update_one<F>(gv.x, pv.x, mv.x, vv.x, ev.x, uv.x, c, g_norm, step, bc1, bc2);
    update_one<F>(gv.y, pv.y, mv.y, vv.y, ev.y, uv.y, c, g_norm, step, bc1, bc2);
    update_one<F>(gv.z, pv.z, mv.z, vv.z, ev.z, uv.z, c, g_norm, step, bc1, bc2);
    update_one<F>(gv.w, pv.w, mv.w, vv.w, ev.w, uv.w, c, g_norm, step, bc1, bc2);
    reinterpret_cast<float4*>(u)[i4] = uv;
    reinterpret_cast<float4*>(p)[i4] = pv;
    if (kHasM) reinterpret_cast<float4*>(m)[i4] = mv;
    if (kHasV) reinterpret_cast<float4*>(v)[i4] = vv;
    if (kHasE) reinterpret_cast<float4*>(e)[i4] = ev;
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += kThreads) {
    float pi = p[i];
    float mi = kHasM ? m[i] : dummy;
    float vi = kHasV ? v[i] : dummy;
    float ei = kHasE ? e[i] : dummy;
    float ui;
    update_one<F>(g[i], pi, mi, vi, ei, ui, c, g_norm, step, bc1, bc2);
    u[i] = ui;
    p[i] = pi;
    if (kHasM) m[i] = mi;
    if (kHasV) v[i] = vi;
    if (kHasE) e[i] = ei;
  }
}

// One block per (leaf, chunk); F holds the step's flags (never kDecay).
template <int F>
__global__ void __launch_bounds__(kThreads)
    fused_update_kernel(const __grid_constant__ Table t,
                        const float* __restrict__ scalars, Consts c) {
  // the leaf that owns this block: the last whose first block is <= it
  int lo = 0, hi = t.count - 1;
  const int b = static_cast<int>(blockIdx.x);
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long begin = static_cast<long long>(b - L.first_block) * kChunk;
  const long long end = begin + kChunk < L.n ? begin + kChunk : L.n;
  const bool vec = (L.flags & kLeafVec) != 0;
  const float g_norm = scalars[0];
  const float step = scalars[1];
  const float bc1 = scalars[2];
  const float bc2 = scalars[3];
  if (L.flags & kLeafWdApply)
    update_chunk<F | kDecay>(L, begin, end, vec, c, g_norm, step, bc1, bc2);
  else
    update_chunk<F>(L, begin, end, vec, c, g_norm, step, bc1, bc2);
}

template <int F>
cudaError_t launch(const Table& t, int blocks, const float* scalars,
                   const Consts& c, cudaStream_t stream) {
  fused_update_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      t, scalars, c);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Table&, int, const float*, const Consts&,
                                 cudaStream_t);

// The 32 step variants: every flag combination without kDecay.
template <int... Is>
constexpr std::array<LaunchFn, sizeof...(Is)> make_table(
    std::integer_sequence<int, Is...>) {
  return {&launch<(Is & 3) | ((Is & ~3) << 1)>...};
}

constexpr auto kLaunch = make_table(std::make_integer_sequence<int, kNumVariants / 2>{});

}  // namespace

extern "C" {

// One launch over `leaves` table rows (at most kMaxLeaves) and `blocks`
// blocks. A row is kCols int64: g, p, m, v, e, u (addresses; 0 where the
// recipe has no such slot), n, first block, flags. Returns
// cudaGetLastError() after the launch (0 on success).
int tpu_ddp_fused_update(const long long* rows, int leaves, int blocks,
                         const float* scalars, int adamw, int momentum_on,
                         int has_clip, int has_ema, int step_is_const,
                         float momentum, float wd, float max_norm,
                         float step_const, float one_minus_b1, float b1,
                         float one_minus_b2, float b2, float eps,
                         float ema_decay, float one_minus_ema, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  // ~8 KB, kept off the caller's stack; the launch copies it, and ctypes
  // drops the GIL around this call, so each thread has its own
  static thread_local Table t;
  t.count = leaves;
  for (int i = 0; i < leaves; ++i) {
    const long long* r = rows + static_cast<long long>(i) * kCols;
    Leaf& L = t.leaf[i];
    L.g = reinterpret_cast<const float*>(static_cast<uintptr_t>(r[0]));
    L.p = reinterpret_cast<float*>(static_cast<uintptr_t>(r[1]));
    L.m = reinterpret_cast<float*>(static_cast<uintptr_t>(r[2]));
    L.v = reinterpret_cast<float*>(static_cast<uintptr_t>(r[3]));
    L.e = reinterpret_cast<float*>(static_cast<uintptr_t>(r[4]));
    L.u = reinterpret_cast<float*>(static_cast<uintptr_t>(r[5]));
    L.n = r[6];
    L.first_block = static_cast<int>(r[7]);
    L.flags = static_cast<int>(r[8]);
  }
  // the variant index: kAdamW and kMomentum in bits 0-1, then kClip, kEma
  // and kStepConst shifted down past the per-leaf kDecay bit
  const int index = (adamw ? kAdamW : 0) | (momentum_on ? kMomentum : 0) |
                    (has_clip ? kClip >> 1 : 0) | (has_ema ? kEma >> 1 : 0) |
                    (step_is_const ? kStepConst >> 1 : 0);
  const Consts c{momentum, wd, max_norm, step_const, one_minus_b1, b1,
                 one_minus_b2, b2, eps, ema_decay, one_minus_ema};
  return static_cast<int>(
      kLaunch[index](t, blocks, scalars, c, static_cast<cudaStream_t>(stream)));
}

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
