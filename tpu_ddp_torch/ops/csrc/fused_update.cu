// K1: the fused optimizer update, one pass per parameter leaf, for Hopper.
//
// Replaces the Pallas kernel tpu_ddp/ops/fused_update.py::_build_kernel
// (launched by _fused_leaf). It computes, elementwise over one float32 leaf,
// what the optax chain does as separate passes: the global-norm clip, SGD
// (coupled decay, momentum trace) or AdamW (mu/nu, bias correction,
// decoupled decay), the -lr or schedule scale, and the EMA of the new
// params. The arithmetic follows _update_math (fused_update.py:116-151)
// operation for operation, and tpu_ddp_torch/ops/fused_update.py::update_math
// is its plain PyTorch version.
//
// What bounds it: device-memory bandwidth. Per element it moves 16 bytes
// for the reference recipe (read g, p; write u, p), 24 with momentum, 32 for
// AdamW, and 8 more with the EMA, against a handful of float operations.
// What this simple design does about that: every operand is read once and
// written once, in 16-byte vector loads and stores where all pointers are
// 16-byte aligned (a scalar loop covers the tail and unaligned leaves), in a
// grid-stride loop. p, m, v and e are updated in place; u goes to its own
// buffer.
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

// Static flags of one leaf configuration, packed into the template mask.
enum : int {
  kAdamW = 1,
  kMomentum = 2,
  kDecay = 4,
  kClip = 8,
  kEma = 16,
  kStepConst = 32,
  kNumVariants = 64,
};

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

template <int F>
__global__ void fused_update_kernel(const float* __restrict__ g,
                                    float* __restrict__ p,
                                    float* __restrict__ m,
                                    float* __restrict__ v,
                                    float* __restrict__ e,
                                    float* __restrict__ u,
                                    const float* __restrict__ scalars,
                                    int64_t n, bool vec, Consts c) {
  constexpr bool kHasM = (F & (kAdamW | kMomentum)) != 0;
  constexpr bool kHasV = (F & kAdamW) != 0;
  constexpr bool kHasE = (F & kEma) != 0;
  const float g_norm = scalars[0];
  const float step = scalars[1];
  const float bc1 = scalars[2];
  const float bc2 = scalars[3];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = vec ? n / 4 : 0;
  float dummy = 0.0f;

  for (int64_t i = tid; i < n_vec; i += stride) {
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    float4 pv = reinterpret_cast<float4*>(p)[i];
    float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), vv = mv, ev = mv, uv;
    if (kHasM) mv = reinterpret_cast<float4*>(m)[i];
    if (kHasV) vv = reinterpret_cast<float4*>(v)[i];
    if (kHasE) ev = reinterpret_cast<float4*>(e)[i];
    update_one<F>(gv.x, pv.x, mv.x, vv.x, ev.x, uv.x, c, g_norm, step, bc1, bc2);
    update_one<F>(gv.y, pv.y, mv.y, vv.y, ev.y, uv.y, c, g_norm, step, bc1, bc2);
    update_one<F>(gv.z, pv.z, mv.z, vv.z, ev.z, uv.z, c, g_norm, step, bc1, bc2);
    update_one<F>(gv.w, pv.w, mv.w, vv.w, ev.w, uv.w, c, g_norm, step, bc1, bc2);
    reinterpret_cast<float4*>(u)[i] = uv;
    reinterpret_cast<float4*>(p)[i] = pv;
    if (kHasM) reinterpret_cast<float4*>(m)[i] = mv;
    if (kHasV) reinterpret_cast<float4*>(v)[i] = vv;
    if (kHasE) reinterpret_cast<float4*>(e)[i] = ev;
  }
  for (int64_t i = n_vec * 4 + tid; i < n; i += stride) {
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

struct Args {
  const float* g;
  float *p, *m, *v, *e, *u;
  const float* scalars;
  int64_t n;
  bool vec;
  Consts c;
  cudaStream_t stream;
};

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1024;

template <int F>
cudaError_t launch(const Args& a) {
  const int64_t work = a.vec ? a.n / 4 + a.n % 4 : a.n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fused_update_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
      a.g, a.p, a.m, a.v, a.e, a.u, a.scalars, a.n, a.vec, a.c);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Args&);

template <int... Fs>
constexpr std::array<LaunchFn, sizeof...(Fs)> make_table(
    std::integer_sequence<int, Fs...>) {
  return {&launch<Fs>...};
}

constexpr auto kLaunch = make_table(std::make_integer_sequence<int, kNumVariants>{});

bool aligned16(const void* ptr) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % 16) == 0;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int tpu_ddp_fused_update(const float* g, float* p, float* m, float* v,
                         float* e, float* u, const float* scalars,
                         long long n, int adamw, int momentum_on,
                         int wd_apply, int has_clip, int has_ema,
                         int step_is_const, float momentum, float wd,
                         float max_norm, float step_const,
                         float one_minus_b1, float b1, float one_minus_b2,
                         float b2, float eps, float ema_decay,
                         float one_minus_ema, void* stream) {
  if (n <= 0) return 0;
  const int flags = (adamw ? kAdamW : 0) | (momentum_on ? kMomentum : 0) |
                    (wd_apply ? kDecay : 0) | (has_clip ? kClip : 0) |
                    (has_ema ? kEma : 0) | (step_is_const ? kStepConst : 0);
  Args a;
  a.g = g;
  a.p = p;
  a.m = m;
  a.v = v;
  a.e = e;
  a.u = u;
  a.scalars = scalars;
  a.n = n;
  a.vec = aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v) &&
          aligned16(e) && aligned16(u);
  a.c = Consts{momentum, wd, max_norm, step_const, one_minus_b1, b1,
               one_minus_b2, b2, eps, ema_decay, one_minus_ema};
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kLaunch[flags](a));
}

const char* tpu_ddp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
