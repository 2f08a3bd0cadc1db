// Native host-side data-path kernels of tpu_ddp_torch: a copy of
// tpu_ddp/native/cifar_codec.cpp, so that both packages decode and gather
// the same bits.
//
// The two host-side hot loops of the CIFAR workload: (1) raw uint8
// planar-RGB batches -> normalized float32 NHWC, run once per dataset
// load, and (2) the per-batch row gather (the DistributedSampler-style
// index select feeding every training step), multithreaded in C++ behind
// a C ABI for ctypes.
//
// Built with prefetcher.cpp into one library by tpu_ddp_torch/native/__init__.py
// (g++ -O3 -shared -fPIC -std=c++17 ... -lpthread) at first use.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "parallel_for.h"

using tpu_ddp_native::parallel_for;

extern "C" {

// src: n records of 3072 bytes, planar RGB (R 1024, G 1024, B 1024),
// row-major 32x32 — the raw CIFAR pickle layout.
// dst: n * 32 * 32 * 3 floats, NHWC, value = (byte/255 - mean[c]) / std[c].
void cifar_decode_normalize(const uint8_t* src, float* dst, int64_t n,
                            const float* mean, const float* stddev) {
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.0f / (255.0f * stddev[c]);
    shift[c] = mean[c] / stddev[c];
  }
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = src + i * 3072;
      float* out = dst + i * 3072;
      for (int64_t px = 0; px < 1024; ++px) {
        float* o = out + px * 3;
        o[0] = static_cast<float>(rec[px]) * scale[0] - shift[0];
        o[1] = static_cast<float>(rec[1024 + px]) * scale[1] - shift[1];
        o[2] = static_cast<float>(rec[2048 + px]) * scale[2] - shift[2];
      }
    }
  });
}

// Row gather: dst[j] = src[idx[j]] for float32 rows of row_elems elements.
void gather_rows_f32(const float* src, const int64_t* idx, float* dst,
                     int64_t n_idx, int64_t row_elems) {
  parallel_for(n_idx, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      std::memcpy(dst + j * row_elems, src + idx[j] * row_elems,
                  sizeof(float) * static_cast<size_t>(row_elems));
    }
  });
}

// Same for int32 rows (labels / multi-hot targets).
void gather_rows_i32(const int32_t* src, const int64_t* idx, int32_t* dst,
                     int64_t n_idx, int64_t row_elems) {
  parallel_for(n_idx, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      std::memcpy(dst + j * row_elems, src + idx[j] * row_elems,
                  sizeof(int32_t) * static_cast<size_t>(row_elems));
    }
  });
}

// v3: the prefetcher's slots are the caller's buffers (bp_create)
// v4: bp_create takes the rows' digest buffers and key
int cifar_codec_abi_version() { return 4; }

}  // extern "C"
