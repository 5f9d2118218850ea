// Launch, barrier and cp.async queue for the CPU stand-in of the CUDA runtime.
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda_pipeline_primitives.h"
#include "cuda_runtime.h"

thread_local emu_dim3 threadIdx, blockIdx, blockDim;
void* emu_dynamic_smem = nullptr;

namespace {
std::mutex mtx;
std::condition_variable cv;
int waiting = 0, generation = 0, nthreads = 0;
}  // namespace

void __syncwarp() {
  std::unique_lock<std::mutex> lk(mtx);
  const int gen = generation;
  if (++waiting == nthreads) {
    waiting = 0;
    ++generation;
    cv.notify_all();
  } else {
    cv.wait(lk, [&] { return gen != generation; });
  }
}

void emu_launch(int grid, int block, int smem, std::function<void()> fn) {
  std::vector<double> dynamic((smem + 7) / 8 + 1);   // 8-byte aligned
  emu_dynamic_smem = dynamic.data();
  for (int b = 0; b < grid; ++b) {
    nthreads = block;
    waiting = 0;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        blockDim.x = block;
        fn();
      });
    for (auto& th : threads) th.join();
  }
}

namespace {
struct AsyncCopy {
  void* dst;
  const void* src;
  size_t n;
};
thread_local std::vector<AsyncCopy> open_group;
thread_local std::deque<std::vector<AsyncCopy>> committed;
}  // namespace

void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t) {
  if ((n != 4 && n != 8 && n != 16) || (uintptr_t)dst % n || (uintptr_t)src % n) {
    fprintf(stderr, "cp.async of %zu bytes from %p to %p: bad size or alignment\n", n, src,
            dst);
    abort();
  }
  open_group.push_back({dst, src, n});
}

void __pipeline_commit() {
  committed.push_back(std::move(open_group));
  open_group.clear();
}

void __pipeline_wait_prior(size_t prior) {
  while (committed.size() > prior) {
    for (const AsyncCopy& c : committed.front()) memcpy(c.dst, c.src, c.n);
    committed.pop_front();
  }
}
