// Host-compiler stand-in for the CUDA runtime header, so the port's csrc
// kernels compile and run on the CPU (see __init__.py).  A launch runs the
// grid's blocks one after another, each block's threads as std::threads;
// __syncwarp() is a barrier over the calling thread's warp (its 32-thread
// slice of the block) and __syncthreads() one over the block's threads; the
// warp-wide exchanges (__shfl_sync, __shfl_xor_sync, __all_sync,
// __ballot_sync) are taken by every thread of the warp, whatever the mask;
// __shared__ data is a function-local static, shared by the threads of the
// block being run; `extern __shared__ T name[];` is rewritten to a pointer
// to the launch's dynamic shared memory, allocated anew for each launch and
// 16-byte aligned, as the card's is, so that float4 loads from it are legal.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <cmath>
#include <functional>

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local emu_dim3 threadIdx, blockIdx, blockDim;

#define __device__
#define __host__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

typedef void* cudaStream_t;
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct alignas(16) float4 {
  float x, y, z, w;
};
inline int cudaGetLastError() { return 0; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }   // never contracted
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
inline int cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }

extern void* emu_dynamic_smem;
void __syncwarp(unsigned mask = 0xffffffffu);
void __syncthreads();
float __shfl_sync(unsigned mask, float v, int src_lane, int width = 32);
float __shfl_xor_sync(unsigned mask, float v, int lane_mask, int width = 32);
int __all_sync(unsigned mask, int predicate);
unsigned __ballot_sync(unsigned mask, int predicate);
inline int __popc(unsigned x) { return __builtin_popcount(x); }
void emu_launch(int grid, int block, int smem, std::function<void()> fn);
// kernel<<<grid, block, smem, stream>>>(args...) is rewritten to this
#define EMU_LAUNCH(G, T, S, K, ...) emu_launch(G, T, S, [&] { K(__VA_ARGS__); })
