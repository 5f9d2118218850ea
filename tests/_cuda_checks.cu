// Test kernels for the device helpers that the port's kernels share
// (quad_periodic_mpc_tpu_torch/csrc): wl::SpdInv<N> with its top level's
// fused and split schedules on the same matrices, and div_rn on operand
// pairs.  Built for the card with nvcc and for the CPU through
// tests/_cuda_emulation (tests/_cuda_checks.py); driven by
// tests/test_torch_device_helpers.py.

#include <cuda_runtime.h>

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
