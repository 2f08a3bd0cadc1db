// Shared thread fan-out helper of the native host data-path library
// (a copy of tpu_ddp/native/parallel_for.h).
#pragma once

#include <cstdint>
#include <thread>
#include <vector>

namespace tpu_ddp_native {

// Spread [0, n) across up to hardware_concurrency workers.
template <typename F>
void parallel_for(int64_t n, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? static_cast<int64_t>(hw) : 4;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    workers.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace tpu_ddp_native
