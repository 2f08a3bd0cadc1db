// K1: the fused optimizer update for Hopper, all of a step's parameter
// leaves in one launch.
//
// Replaces the Pallas kernel tpu_ddp/ops/fused_update.py::_build_kernel
// (launched by _fused_leaf, one pallas_call per leaf). It computes,
// elementwise over each float32 leaf, what the optax chain does as separate
// passes: the global-norm clip, SGD (coupled decay, momentum trace) or AdamW
// (mu/nu, bias correction, decoupled decay), the -lr or schedule scale, and
// the EMA of the new params, and under ZeRO-1 the pad mask
// (_build_kernel :205-210): a shard's elements past its leaf's real size
// get u = +0.0 and p + 0.0, while m, v and the EMA still see the unmasked
// u. A frozen leaf (the labeler's "frozen" partition, optax set_to_zero;
// the JAX fused path's :453-461) gets u = +0.0, p = p + 0.0 and, with the
// EMA, e = d * e + (1 - d) * (p + 0.0); its g, m and v are not read. The
// arithmetic follows _update_math (fused_update.py:116-151) operation for
// operation, and tpu_ddp_torch/ops/fused_update.py's update_math (with the
// mask update_math_masked, frozen update_math_frozen) is its plain PyTorch
// version.
//
// What bounds it: device-memory bandwidth. Per element it moves 16 bytes for
// the reference recipe (read g, p; write u, p), 24 with momentum, 32 for
// AdamW, and 8 more with the EMA (16-40 bytes), against a handful of float
// operations; a frozen leaf 12 (read p; write p, u), 20 with the EMA. At the main paths' sizes (76,074 and 2,693,194 elements) those
// bytes take well under 30 us, so what a step waits for is the launch: on
// the TPU XLA fuses the per-leaf calls into one program, under eager PyTorch
// each one was a host round trip and a tiny grid.
//
// What the design does about that: one launch updates every leaf of the step
// (up to kMaxLeaves; a larger tree takes ceil(leaves / kMaxLeaves)). The
// leaves' operands travel in one kernel parameter, a table of kMaxLeaves
// entries (pointers g, p, m, v, e, u, the element count, the leaf's first
// block, its vec, wd_apply and mask flags and its count of live elements;
// 72 bytes an entry, about 9.2 KB, within Hopper's 32,764 bytes of kernel
// parameters), so nothing is copied to the device for it and nothing waits
// on the host. The grid is one wave of blocks over all leaves:
// each block owns one kChunk-element chunk of one leaf (a binary search of
// the leaves' first blocks), and strides over it in 16-byte vector loads and
// stores where all six of the leaf's pointers are 16-byte aligned (a scalar
// loop covers the tail and unaligned leaves). Every operand is read once and
// written once; p, m, v and e are updated in place, u goes to its own
// buffer. The flags common to the step (AdamW, momentum, clip, EMA, constant
// step) are template parameters; weight decay and the mask are per leaf, so
// each block picks one of four instantiations of the same chunk loop, or the
// frozen loop, which moves only p, u and e: a fine-tune that trains the head
// alone pays 12 of the 24 bytes an element of SGD with momentum, in the
// same launches as the trainable leaves. The
// mask's ZeRO-1 form: a shard of a padded leaf holds `valid` live elements
// (its leaf's real size less the shard's start, clamped to [0, n]), then
// pad. Only a block whose chunk reaches past `valid` runs the masked loop,
// which zeroes u element by element (the boundary may fall inside a
// float4); every other block, and every leaf without a pad, runs the loop
// without the select.
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

// Per-leaf flags of a table entry (the Python plan's VEC, WD_APPLY, MASK and
// FROZEN).
enum : int { kLeafVec = 1, kLeafWdApply = 2, kLeafMask = 4, kLeafFrozen = 8 };

constexpr int kThreads = 256;
// Elements one block covers; a multiple of 4, so every chunk of an aligned
// leaf starts on a 16-byte boundary (tpu_ddp_torch/ops/fused_update.py CHUNK).
constexpr long long kChunk = 16384;
// Leaves one launch takes (tpu_ddp_torch/ops/fused_update.py MAX_LEAVES).
constexpr int kMaxLeaves = 128;
// Columns of a table row as the Python plan writes it.
constexpr int kCols = 10;

// One element's update; m, v and e in place. Returns u before the pad mask
// (the EMA has already seen it); the caller writes u and p + u.
template <int F>
__device__ __forceinline__ float update_one(float g, float p, float& m,
                                            float& v, float& e,
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
  return uu;
}

struct Leaf {
  const float* g;
  float *p, *m, *v, *e, *u;
  long long n;
  int first_block;  // the leaf's first block in the launch's grid
  int flags;        // kLeafVec | kLeafWdApply | kLeafMask | kLeafFrozen
  long long valid;  // elements [0, valid) are live, the rest pad (n: no pad)
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
};

// Elements [begin, end) of one leaf; begin is a multiple of 4. kMask: u is
// zeroed at every element i >= L.valid.
template <int F, bool kMask>
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
  const long long valid = L.valid;
  float dummy = 0.0f;

  for (long long i4 = begin / 4 + threadIdx.x; i4 < vec_end / 4; i4 += kThreads) {
    const float4 gv = reinterpret_cast<const float4*>(g)[i4];
    float4 pv = reinterpret_cast<float4*>(p)[i4];
    float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), vv = mv, ev = mv, uv;
    if (kHasM) mv = reinterpret_cast<float4*>(m)[i4];
    if (kHasV) vv = reinterpret_cast<float4*>(v)[i4];
    if (kHasE) ev = reinterpret_cast<float4*>(e)[i4];
    uv.x = update_one<F>(gv.x, pv.x, mv.x, vv.x, ev.x, c, g_norm, step, bc1, bc2);
    uv.y = update_one<F>(gv.y, pv.y, mv.y, vv.y, ev.y, c, g_norm, step, bc1, bc2);
    uv.z = update_one<F>(gv.z, pv.z, mv.z, vv.z, ev.z, c, g_norm, step, bc1, bc2);
    uv.w = update_one<F>(gv.w, pv.w, mv.w, vv.w, ev.w, c, g_norm, step, bc1, bc2);
    if (kMask) {
      const long long i = 4 * i4;
      if (i >= valid) uv.x = 0.0f;
      if (i + 1 >= valid) uv.y = 0.0f;
      if (i + 2 >= valid) uv.z = 0.0f;
      if (i + 3 >= valid) uv.w = 0.0f;
    }
    pv.x = pv.x + uv.x;
    pv.y = pv.y + uv.y;
    pv.z = pv.z + uv.z;
    pv.w = pv.w + uv.w;
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
    float ui = update_one<F>(g[i], pi, mi, vi, ei, c, g_norm, step, bc1, bc2);
    if (kMask && i >= valid) ui = 0.0f;
    u[i] = ui;
    p[i] = pi + ui;
    if (kHasM) m[i] = mi;
    if (kHasV) v[i] = vi;
    if (kHasE) e[i] = ei;
  }
}

// Elements [begin, end) of a frozen leaf: u = +0.0, p = p + 0.0 (a -0.0
// becomes +0.0, as p + zeros does) and, under kEma, the EMA of p + 0.0. g, m
// and v are not read; the pad mask changes nothing here (u is zero).
template <int F>
__device__ __forceinline__ void frozen_chunk(const Leaf& L, long long begin,
                                             long long end, bool vec,
                                             const Consts& c) {
  constexpr bool kHasE = (F & kEma) != 0;
  float* __restrict__ p = L.p;
  float* __restrict__ e = L.e;
  float* __restrict__ u = L.u;
  const long long vec_end = vec ? begin + (end - begin) / 4 * 4 : begin;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (long long i4 = begin / 4 + threadIdx.x; i4 < vec_end / 4; i4 += kThreads) {
    float4 pv = reinterpret_cast<float4*>(p)[i4];
    pv.x = pv.x + 0.0f;
    pv.y = pv.y + 0.0f;
    pv.z = pv.z + 0.0f;
    pv.w = pv.w + 0.0f;
    reinterpret_cast<float4*>(u)[i4] = zero;
    reinterpret_cast<float4*>(p)[i4] = pv;
    if (kHasE) {
      float4 ev = reinterpret_cast<float4*>(e)[i4];
      ev.x = c.ema_decay * ev.x + c.one_minus_ema * pv.x;
      ev.y = c.ema_decay * ev.y + c.one_minus_ema * pv.y;
      ev.z = c.ema_decay * ev.z + c.one_minus_ema * pv.z;
      ev.w = c.ema_decay * ev.w + c.one_minus_ema * pv.w;
      reinterpret_cast<float4*>(e)[i4] = ev;
    }
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += kThreads) {
    const float pi = p[i] + 0.0f;
    u[i] = 0.0f;
    p[i] = pi;
    if (kHasE) e[i] = c.ema_decay * e[i] + c.one_minus_ema * pi;
  }
}

// One block per (leaf, chunk); F holds the step's flags (never kDecay).
// A block runs the masked loop only if its leaf has a pad and its chunk
// reaches past the leaf's live elements.
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
  if (L.flags & kLeafFrozen) {
    frozen_chunk<F>(L, begin, end, vec, c);
    return;
  }
  const bool mask = (L.flags & kLeafMask) != 0 && end > L.valid;
  const float g_norm = scalars[0];
  const float step = scalars[1];
  const float bc1 = scalars[2];
  const float bc2 = scalars[3];
  if (L.flags & kLeafWdApply) {
    if (mask)
      update_chunk<F | kDecay, true>(L, begin, end, vec, c, g_norm, step, bc1, bc2);
    else
      update_chunk<F | kDecay, false>(L, begin, end, vec, c, g_norm, step, bc1, bc2);
  } else if (mask) {
    update_chunk<F, true>(L, begin, end, vec, c, g_norm, step, bc1, bc2);
  } else {
    update_chunk<F, false>(L, begin, end, vec, c, g_norm, step, bc1, bc2);
  }
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
// recipe has no such slot, and g, m, v of a frozen row), n, first block,
// flags, live elements. Returns
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
  // ~9.2 KB, kept off the caller's stack; the launch copies it, and ctypes
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
    L.valid = r[9];
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
