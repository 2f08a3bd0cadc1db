// Native host-side batch prefetcher of tpu_ddp_torch.
//
// The port's copy of tpu_ddp/native/prefetcher.cpp: a background thread
// assembles whole batches (a multithreaded row gather from the in-memory
// dataset) into a ring of slot buffers, so that the gather of batch N+depth
// overlaps the training step of batch N.
//
// Two changes of design for the GPU. The slot buffers belong to the caller.
// bp_create takes n_slots image and label buffers, which the Python side
// allocates as pinned (page-locked) host memory when the run is on the
// card, so the host-to-device copy out of a slot can be asynchronous on a
// copy stream. The ring never allocates, frees or pins them; the caller
// keeps them alive until bp_destroy has returned. A job under 1 MiB is
// gathered by the worker alone, without the per-job thread fan-out (on a
// host with many cores the JAX package's ring starts up to a thread a row).
// And given digest buffers, the gather also writes each row's keyed
// BLAKE2b digest (blake2b.h) of the slot's image and label rows, so that
// the batch digests of the telemetry's data audit are hashed here and not
// on the training thread.
//
// Contract (enforced on the Python side, tpu_ddp_torch/native/prefetch.py):
//   submit(idx) -> blocks for a free slot, enqueues a gather job
//   acquire()   -> blocks for the next filled slot, FIFO with submits
//   release(id) -> slot becomes reusable; callers release only after the
//                  copy out of the slot has finished
//
// Rows are opaque bytes (img/lbl row sizes in bytes), so any dtype works.
//
// Built into one library with cifar_codec.cpp; C ABI for ctypes.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include "blake2b.h"
#include "parallel_for.h"

namespace {

using tpu_ddp_native::parallel_for;
using tpu_ddp_native::row_digest;

// the Python gather_rows' NATIVE_GATHER_MIN_BYTES
constexpr int64_t kFanOutMinBytes = int64_t(1) << 20;

struct Job {
  const uint8_t* img_src;
  const uint8_t* lbl_src;
  std::vector<int64_t> idx;
  int64_t img_row_bytes;
  int64_t lbl_row_bytes;
  int slot;
};

struct Prefetcher {
  int n_slots;
  int64_t img_capacity;  // bytes per slot
  int64_t lbl_capacity;
  int64_t dig_capacity;  // 0: no digests
  uint64_t digest_key;
  std::vector<uint8_t*> img_bufs;  // the caller's slot buffers
  std::vector<uint8_t*> lbl_bufs;
  std::vector<uint8_t*> dig_bufs;  // 8 bytes a row, or none

  std::mutex m;
  std::condition_variable cv_job;   // worker waits for jobs
  std::condition_variable cv_done;  // acquire waits for filled slots
  std::condition_variable cv_free;  // submit waits for free slots
  std::queue<Job> jobs;
  std::queue<int> done;             // filled slots, FIFO with submits
  std::vector<int> free_slots;
  bool stopping = false;
  std::thread worker;

  Prefetcher(int slots, void* const* img_slots, void* const* lbl_slots,
             void* const* dig_slots, int64_t img_cap, int64_t lbl_cap,
             int64_t dig_cap, uint64_t key)
      : n_slots(slots), img_capacity(img_cap), lbl_capacity(lbl_cap),
        dig_capacity(dig_slots ? dig_cap : 0), digest_key(key) {
    for (int s = 0; s < n_slots; ++s) {
      img_bufs.push_back(static_cast<uint8_t*>(img_slots[s]));
      lbl_bufs.push_back(static_cast<uint8_t*>(lbl_slots[s]));
      dig_bufs.push_back(dig_slots ? static_cast<uint8_t*>(dig_slots[s]) : nullptr);
      free_slots.push_back(s);
    }
    worker = std::thread([this] { run(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(m);
      stopping = true;
    }
    cv_job.notify_all();
    cv_done.notify_all();
    cv_free.notify_all();
    worker.join();
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(m);
        cv_job.wait(lk, [&] { return stopping || !jobs.empty(); });
        if (stopping) return;
        job = std::move(jobs.front());
        jobs.pop();
      }
      uint8_t* img_dst = img_bufs[job.slot];
      uint8_t* lbl_dst = lbl_bufs[job.slot];
      uint8_t* dig_dst = dig_bufs[job.slot];
      const int64_t n = static_cast<int64_t>(job.idx.size());
      const int64_t irb = job.img_row_bytes;
      const int64_t lrb = job.lbl_row_bytes;
      const int64_t* idx = job.idx.data();
      auto gather = [&](int64_t lo, int64_t hi) {
        for (int64_t j = lo; j < hi; ++j) {
          std::memcpy(img_dst + j * irb, job.img_src + idx[j] * irb,
                      static_cast<size_t>(irb));
          std::memcpy(lbl_dst + j * lrb, job.lbl_src + idx[j] * lrb,
                      static_cast<size_t>(lrb));
          if (dig_dst) {
            row_digest(digest_key, img_dst + j * irb, static_cast<size_t>(irb),
                       lbl_dst + j * lrb, static_cast<size_t>(lrb), dig_dst + 8 * j);
          }
        }
      };
      // below kFanOutMinBytes the worker copies alone: starting the threads
      // costs more than the copy (a 32-row CIFAR batch is 384 KiB)
      if (n * (irb + lrb) < kFanOutMinBytes) {
        gather(0, n);
      } else {
        parallel_for(n, gather);
      }
      {
        std::lock_guard<std::mutex> lk(m);
        done.push(job.slot);
      }
      cv_done.notify_one();
    }
  }

  int submit(const uint8_t* img_src, const uint8_t* lbl_src,
             const int64_t* idx, int64_t n_idx, int64_t img_row_bytes,
             int64_t lbl_row_bytes) {
    if (n_idx * img_row_bytes > img_capacity ||
        n_idx * lbl_row_bytes > lbl_capacity ||
        (dig_capacity && n_idx * 8 > dig_capacity)) {
      return -2;  // batch larger than the slot buffers
    }
    int slot;
    {
      std::unique_lock<std::mutex> lk(m);
      cv_free.wait(lk, [&] { return stopping || !free_slots.empty(); });
      if (stopping) return -1;
      slot = free_slots.back();
      free_slots.pop_back();
      Job job;
      job.img_src = img_src;
      job.lbl_src = lbl_src;
      job.idx.assign(idx, idx + n_idx);
      job.img_row_bytes = img_row_bytes;
      job.lbl_row_bytes = lbl_row_bytes;
      job.slot = slot;
      jobs.push(std::move(job));
    }
    cv_job.notify_one();
    return slot;
  }

  int acquire() {
    std::unique_lock<std::mutex> lk(m);
    cv_done.wait(lk, [&] { return stopping || !done.empty(); });
    if (done.empty()) return -1;  // stopping with nothing filled
    int slot = done.front();
    done.pop();
    return slot;
  }

  void release(int slot) {
    {
      std::lock_guard<std::mutex> lk(m);
      free_slots.push_back(slot);
    }
    cv_free.notify_one();
  }
};

}  // namespace

extern "C" {

// img_slots / lbl_slots / dig_slots: n_slots buffers of img_capacity_bytes,
// lbl_capacity_bytes and dig_capacity_bytes each, owned by the caller.
// dig_slots may be null (no digests); else each gathered row's 8 digest
// bytes, keyed with digest_key (row_digest), go to its slot's buffer.
void* bp_create(int n_slots, void* const* img_slots, void* const* lbl_slots,
                void* const* dig_slots, int64_t img_capacity_bytes,
                int64_t lbl_capacity_bytes, int64_t dig_capacity_bytes,
                uint64_t digest_key) {
  if (n_slots < 1) return nullptr;
  return new Prefetcher(n_slots, img_slots, lbl_slots, dig_slots, img_capacity_bytes,
                        lbl_capacity_bytes, dig_capacity_bytes, digest_key);
}

int bp_submit(void* h, const void* img_src, const void* lbl_src,
              const int64_t* idx, int64_t n_idx, int64_t img_row_bytes,
              int64_t lbl_row_bytes) {
  return static_cast<Prefetcher*>(h)->submit(
      static_cast<const uint8_t*>(img_src),
      static_cast<const uint8_t*>(lbl_src), idx, n_idx, img_row_bytes,
      lbl_row_bytes);
}

// The slot of the oldest submission once its gather is done (-1 when the
// ring is stopping with nothing filled).
int bp_acquire(void* h) { return static_cast<Prefetcher*>(h)->acquire(); }

void bp_release(void* h, int slot) {
  static_cast<Prefetcher*>(h)->release(slot);
}

void bp_destroy(void* h) { delete static_cast<Prefetcher*>(h); }

}  // extern "C"
