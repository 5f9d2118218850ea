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
// A reusable barrier over `count` threads.
struct Barrier {
  std::mutex mtx;
  std::condition_variable cv;
  int count = 0, waiting = 0, generation = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(mtx);
    const int gen = generation;
    if (++waiting == count) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != generation; });
    }
  }
};
// The block being run: its barrier, and each warp's barrier and exchange slots.
struct Warp {
  Barrier bar;
  float slot[32];
};
Barrier block_bar;
Warp warps[32];   // at most 1024 threads a block

Warp& my_warp() { return warps[threadIdx.x / 32]; }

// Every thread of the warp posts `mine` and reads the slot of lane `src`.
float exchange(float mine, int src) {
  Warp& w = my_warp();
  w.slot[threadIdx.x % 32] = mine;
  w.bar.wait();
  const float got = w.slot[src];
  w.bar.wait();                // nobody overwrites a slot before all have read
  return got;
}

int src_lane(int src, int width) {
  const int lane = threadIdx.x % 32;
  return (lane & ~(width - 1)) + (src & (width - 1));
}
}  // namespace

void __syncwarp(unsigned) { my_warp().bar.wait(); }
void __syncthreads() { block_bar.wait(); }

float __shfl_sync(unsigned, float v, int src, int width) {
  return exchange(v, src_lane(src, width));
}
float __shfl_xor_sync(unsigned, float v, int lane_mask, int width) {
  return exchange(v, src_lane((threadIdx.x % 32) ^ lane_mask, width));
}

int __all_sync(unsigned, int predicate) {
  Warp& w = my_warp();
  const int n = w.bar.count;
  w.slot[threadIdx.x % 32] = predicate != 0 ? 1.f : 0.f;
  w.bar.wait();
  int all = 1;
  for (int i = 0; i < n; ++i) all = all && w.slot[i] != 0.f;
  w.bar.wait();
  return all;
}

unsigned __ballot_sync(unsigned, int predicate) {
  Warp& w = my_warp();
  const int n = w.bar.count;
  w.slot[threadIdx.x % 32] = predicate != 0 ? 1.f : 0.f;
  w.bar.wait();
  unsigned votes = 0;
  for (int i = 0; i < n; ++i) votes |= (w.slot[i] != 0.f ? 1u : 0u) << i;
  w.bar.wait();
  return votes;
}

void emu_launch(int grid, int block, int smem, std::function<void()> fn) {
  if (block < 1 || block > 1024) {
    fprintf(stderr, "launch of %d threads a block\n", block);
    abort();
  }
  struct alignas(16) Word16 {
    unsigned char bytes[16];
  };
  std::vector<Word16> dynamic((smem + 15) / 16 + 1);   // 16-byte aligned
  emu_dynamic_smem = dynamic.data();
  for (int b = 0; b < grid; ++b) {
    block_bar.count = block;
    block_bar.waiting = 0;
    for (int w = 0; w < (block + 31) / 32; ++w) {
      warps[w].bar.count = block - 32 * w < 32 ? block - 32 * w : 32;
      warps[w].bar.waiting = 0;
    }
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
