// Fused ADMM iterations with K^{-1} held on chip, for Hopper (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/admm_kernel.py
// ::fused_admm_iterations (_kernel).  Per instance, `iters` OSQP iterations
// of the condensed MPC QP (n = 3k force variables, m = 5k pyramid rows,
// A = I_k (x) F with the shared 5x3 block F):
//   w   = rho z - y
//   rhs = sigma x - q + A^T w
//   x~  = K^{-1} rhs          (x~_i = sum_j K^{-1}[j][i] rhs_j: K^{-1} is
//                              symmetric, read by columns as the TPU kernel
//                              reads it; f32 accumulation in the order j = 0..)
//   x   = alpha x~ + (1 - alpha) x
//   zr  = alpha A x~ + (1 - alpha) z
//   z+  = clip(zr + y / rho, l, u);  y = y + rho (zr - z+);  z = z+
// The TPU kernel feeds A and A^T to its matrix unit as dense (m, n) matrices;
// here each is the 5x3 block per foot-step.
//
// Decomposition: one thread block per instance (grid = B: no padding).
// K^{-1} is read from device memory once and stays in dynamic shared memory
// across all iterations, beside x, x~, rhs, q (n each) and z, y, w, l, u,
// rho, 1/rho (m each).  Thread i owns row i of the matrix-vector product and
// the elementwise work on its entries; three __syncthreads() per iteration
// (after w, after rhs, after x~).  With kinv_bf16 the matrix is rounded to
// bf16 (nearest even) as it is stored and widened to f32 before each
// multiply: half the shared memory, the same f32 accumulation.
//
// Resident sizes (227 KB of shared memory a block): f32 up to n = 228
// (h = 19; h = 10 takes 64 KB, three blocks an SM; h = 16 takes 156 KB),
// bf16 up to n = 324 (h = 27).  Beyond that K^{-1} is read from device
// memory in every iteration (the same arithmetic; with kinv_bf16 rounded on
// the fly), so that any horizon gives the right answer.
//
// What bounds it on this card: K^{-1} read once is 4 n^2 bytes an instance
// (118 MB at B = 2048, h = 10: ~0.035 ms), the products 2 n^2 flop an
// iteration (~2 Gflop at 30 iterations: ~0.03 ms).  This first version is
// bound by neither: a thread's product is a chain of n dependent FMAs, an
// iteration three barriers, and at most three blocks of 128 threads run on
// an SM.  Splitting each row's sum over several threads is the next step.
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_SMEM 232448

struct AdmmParams {
  int B, n, m, iters, kinv_bf16;
  float sigma, over_relax;
};

// round to nearest even, as a float32 -> bfloat16 conversion does
__device__ __forceinline__ uint16_t to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

__device__ __forceinline__ float from_bf16(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// Bytes of dynamic shared memory: the vectors, then K^{-1} where resident.
static int vector_floats(int n, int m) { return 4 * n + 7 * m + 16; }

template <bool BF16, bool RESIDENT>
__global__ void admm_kernel(const float* __restrict__ Kinv, const float* __restrict__ q_in,
                            const float* __restrict__ l_in, const float* __restrict__ u_in,
                            const float* __restrict__ rho_in, const float* __restrict__ F_in,
                            const float* __restrict__ x0, const float* __restrict__ z0,
                            const float* __restrict__ y0, float* __restrict__ x_out,
                            float* __restrict__ z_out, float* __restrict__ y_out,
                            const AdmmParams p) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* F = smem;                 // 15 (padded to 16)
  float* x = smem + 16;
  float* xt = x + n;
  float* rhs = xt + n;
  float* q = rhs + n;
  float* z = q + n;
  float* y = z + m;
  float* w = y + m;
  float* l = w + m;
  float* u = l + m;
  float* rho = u + m;
  float* rho_inv = rho + m;
  float* Kf = rho_inv + m;                              // resident f32 copy
  uint16_t* Kh = reinterpret_cast<uint16_t*>(Kf);       // resident bf16 copy
  const float* Kg = Kinv + (size_t)b * n * n;
  const float a = p.over_relax, sigma = p.sigma;

  if (tid < 15) F[tid] = F_in[tid];
  for (int i = tid; i < n; i += nt) {
    x[i] = x0[(size_t)b * n + i];
    q[i] = q_in[(size_t)b * n + i];
  }
  for (int r = tid; r < m; r += nt) {
    const size_t g = (size_t)b * m + r;
    z[r] = z0[g];
    y[r] = y0[g];
    l[r] = l_in[g];
    u[r] = u_in[g];
    rho[r] = rho_in[g];
    rho_inv[r] = 1.0f / rho_in[g];
    w[r] = rho_in[g] * z0[g] - y0[g];
  }
  if (RESIDENT) {
    for (int e = tid; e < n * n; e += nt) {
      if (BF16) Kh[e] = to_bf16(Kg[e]);
      else Kf[e] = Kg[e];
    }
  }
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    // rhs = sigma x - q + A^T w
    for (int i = tid; i < n; i += nt) {
      const int k = i / 3, c = i - 3 * k;
      const float* wk = w + 5 * k;
      float atw = F[c] * wk[0];
      for (int r = 1; r < 5; ++r) atw = fmaf(F[3 * r + c], wk[r], atw);
      rhs[i] = (sigma * x[i] - q[i]) + atw;
    }
    __syncthreads();
    // x~ = K^{-1} rhs by columns; x = alpha x~ + (1 - alpha) x
    for (int i = tid; i < n; i += nt) {
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) {
        float kji;
        if (RESIDENT) kji = BF16 ? from_bf16(Kh[j * n + i]) : Kf[j * n + i];
        else kji = BF16 ? from_bf16(to_bf16(Kg[j * n + i])) : Kg[j * n + i];
        acc = fmaf(kji, rhs[j], acc);
      }
      xt[i] = acc;
      x[i] = a * acc + (1.0f - a) * x[i];
    }
    __syncthreads();
    // z~ = A x~, relax, clip, dual update; w for the next iteration
    for (int r = tid; r < m; r += nt) {
      const int k = r / 5, c = r - 5 * k;
      const float* xk = xt + 3 * k;
      float zt = F[3 * c] * xk[0];
      zt = fmaf(F[3 * c + 1], xk[1], zt);
      zt = fmaf(F[3 * c + 2], xk[2], zt);
      const float zr = a * zt + (1.0f - a) * z[r];
      const float zn = fminf(fmaxf(zr + rho_inv[r] * y[r], l[r]), u[r]);
      const float yn = y[r] + rho[r] * (zr - zn);
      z[r] = zn;
      y[r] = yn;
      w[r] = rho[r] * zn - yn;
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) x_out[(size_t)b * n + i] = x[i];
  for (int r = tid; r < m; r += nt) {
    z_out[(size_t)b * m + r] = z[r];
    y_out[(size_t)b * m + r] = y[r];
  }
}

template <bool BF16, bool RESIDENT>
static int launch(const float* Kinv, const float* q, const float* l, const float* u,
                  const float* rho, const float* F, const float* x0, const float* z0,
                  const float* y0, float* x, float* z, float* y, AdmmParams p, int smem,
                  int threads, void* stream) {
  auto kern = admm_kernel<BF16, RESIDENT>;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
  }
  kern<<<p.B, threads, smem, (cudaStream_t)stream>>>(Kinv, q, l, u, rho, F, x0, z0, y0, x,
                                                     z, y, p);
  return (int)cudaGetLastError();
}

// 1 if K^{-1} of an (n, m) problem is held in shared memory, else 0.
extern "C" int admm_resident(int n, int m, int kinv_bf16) {
  const long bytes = 4L * vector_floats(n, m) + (long)n * n * (kinv_bf16 ? 2 : 4);
  return bytes <= MAX_SMEM ? 1 : 0;
}

extern "C" int admm_launch(const float* Kinv, const float* q, const float* l, const float* u,
                           const float* rho, const float* F, const float* x0,
                           const float* z0, const float* y0, float* x, float* z, float* y,
                           AdmmParams p, void* stream) {
  const bool resident = admm_resident(p.n, p.m, p.kinv_bf16) != 0;
  const int smem = 4 * vector_floats(p.n, p.m) +
                   (resident ? p.n * p.n * (p.kinv_bf16 ? 2 : 4) : 0);
  int threads = ((p.n + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (p.kinv_bf16) {
    if (resident)
      return launch<true, true>(Kinv, q, l, u, rho, F, x0, z0, y0, x, z, y, p, smem,
                                threads, stream);
    return launch<true, false>(Kinv, q, l, u, rho, F, x0, z0, y0, x, z, y, p, smem,
                               threads, stream);
  }
  if (resident)
    return launch<false, true>(Kinv, q, l, u, rho, F, x0, z0, y0, x, z, y, p, smem,
                               threads, stream);
  return launch<false, false>(Kinv, q, l, u, rho, F, x0, z0, y0, x, z, y, p, smem, threads,
                              stream);
}
