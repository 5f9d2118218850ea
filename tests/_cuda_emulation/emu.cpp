// Launch and barrier for the CPU stand-in of the CUDA runtime.
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local emu_dim3 threadIdx, blockIdx, blockDim;

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

void emu_launch(int grid, int block, std::function<void()> fn) {
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
