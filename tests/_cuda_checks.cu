// Test kernels for the device helpers that the port's kernels share
// (quad_periodic_mpc_tpu_torch/csrc): wl::SpdInv<N> with its top level's
// fused and split schedules on the same matrices, div_rn on operand pairs,
// float4 loads from dynamic shared memory filled by 16-byte cp.async (what
// admm.cu's rhs broadcasts take) and __fmul_rn (its uncontracted products).
// Built for the card with nvcc and for the CPU through tests/_cuda_emulation
// (tests/_cuda_checks.py); driven by tests/test_torch_device_helpers.py.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "div_rn.cuh"
#include "warp_linalg.cuh"

// One warp per matrix: out = M^{-1} by SpdInv<N, kFused>.
template <int N, bool kFused>
__global__ void spd_inv_kernel(const float* __restrict__ M, float* __restrict__ out) {
  __shared__ float m[N * N], o[N * N], scr[wl::SpdInv<N, kFused>::kScratch];
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < N * N; e += 32) m[e] = M[N * N * b + e];
  __syncwarp();
  wl::SpdInv<N, kFused>::run(m, N, o, N, scr);
  for (int e = threadIdx.x; e < N * N; e += 32) out[N * N * b + e] = o[e];
}

template <int N>
int spd_inv(const float* M, float* fused, float* split, int B, void* stream) {
  auto kf = spd_inv_kernel<N, true>;
  auto ks = spd_inv_kernel<N, false>;
  kf<<<B, 32, 0, (cudaStream_t)stream>>>(M, fused);
  ks<<<B, 32, 0, (cudaStream_t)stream>>>(M, split);
  return (int)cudaGetLastError();
}

__global__ void div_rn_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) out[i] = div_rn(a[i], b[i]);
}

extern "C" int spd_inv_6(const float* M, float* f, float* s, int B, void* st) {
  return spd_inv<6>(M, f, s, B, st);
}
extern "C" int spd_inv_12(const float* M, float* f, float* s, int B, void* st) {
  return spd_inv<12>(M, f, s, B, st);
}
extern "C" int spd_inv_14(const float* M, float* f, float* s, int B, void* st) {
  return spd_inv<14>(M, f, s, B, st);
}
extern "C" int spd_inv_18(const float* M, float* f, float* s, int B, void* st) {
  return spd_inv<18>(M, f, s, B, st);
}
extern "C" int spd_inv_28(const float* M, float* f, float* s, int B, void* st) {
  return spd_inv<28>(M, f, s, B, st);
}

extern "C" int div_rn_check(const float* a, const float* b, float* out, int n, void* stream) {
  div_rn_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

// n floats (n a multiple of 4) copied into dynamic shared memory by 16-byte
// cp.async and read back as float4: out[0..n) by each thread's own quads,
// out[n..n+4) quad 0 as one broadcast to every lane, out[n + 4] the shared
// base's address modulo 16.
__host__ __device__ inline int quads(int n) { return n / 4; }

__global__ void float4_smem_kernel(const float* __restrict__ in, float* __restrict__ out,
                                   int n) {
  extern __shared__ float s[];
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
    __pipeline_memcpy_async(s + e, in + e, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const float4* s4 = reinterpret_cast<const float4*>(s);
  for (int q = threadIdx.x; q < quads(n); q += blockDim.x) {
    const float4 v = s4[q];
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
  const float4 b = s4[0];
  if (threadIdx.x == blockDim.x - 1) {
    out[n] = b.x;
    out[n + 1] = b.y;
    out[n + 2] = b.z;
    out[n + 3] = b.w;
    out[n + 4] = (float)(reinterpret_cast<uintptr_t>(s) % 16);
  }
}

extern "C" int float4_smem_check(const float* in, float* out, int n, void* stream) {
  if (n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  float4_smem_kernel<<<1, 64, 4 * n, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

__global__ void fmul_rn_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ out, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) out[i] = __fmul_rn(a[i], b[i]);
}

extern "C" int fmul_rn_check(const float* a, const float* b, float* out, int n, void* stream) {
  fmul_rn_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
