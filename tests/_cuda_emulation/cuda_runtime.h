// Host-compiler stand-in for the CUDA runtime header, so the port's csrc
// kernels compile and run on the CPU (see __init__.py).  A launch runs the
// grid's blocks one after another, each block's threads as std::threads;
// __syncwarp() is a barrier over the block's threads; __shared__ data is a
// function-local static, shared by the threads of the block being run.
#pragma once

#include <math.h>

#include <cmath>
#include <functional>

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local emu_dim3 threadIdx, blockIdx, blockDim;

#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }

void __syncwarp();
void emu_launch(int grid, int block, std::function<void()> fn);
// kernel<<<grid, block, smem, stream>>>(args...) is rewritten to this
#define EMU_LAUNCH(G, T, K, ...) emu_launch(G, T, [&] { K(__VA_ARGS__); })
