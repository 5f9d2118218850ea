// Fused 18-state / 28-measurement Kalman predict + innovation for Hopper
// (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/kf_kernel.py
// ::fused_kf_innovate (_kernel).  Per instance, in the TPU kernel's order:
//   1. predict with A = I + dt E (E: p <- v shift): xp = A x + B a and
//      Pm = A P A^T + diag(q) as row / column shifted adds, no product;
//   2. the innovation with the selection-structured C (rows 3i..3i+2:
//      p - p_foot_i; rows 12+3i..: v; rows 24..27: the foot heights), so
//      ey = y - C xp, CP = C Pm and S = C Pm C^T + diag(r) are row / column
//      combinations, no product;
//   3. S^{-1} (28x28) by the recursive Schur inverse split at (n+1)/2 down
//      to the 1/2/3 closed forms (warp_linalg.cuh SpdInv);
//   4. one refinement step on both solves: S_ey = S^{-1} ey corrected by
//      S^{-1} (ey - S S_ey), M1 = S^{-1} CP corrected by S^{-1} (CP - S M1);
//      cond(S) reaches ~5e5 through the start-up transient (P0 = 100 I
//      against r ~ 1e-3) and the raw f32 inverse loses the digits that the
//      correction recovers;
//   5. x' = xp + (CP)^T S_ey, P' = Pm - (CP)^T M1, symmetrised, then the xy
//      blow-up reset (PositionVelocityEstimator.cpp:233-239): where
//      det P'[0:2,0:2] > 1e-6 the xy block is divided by 10 and its cross
//      terms with the other 16 states are zeroed.
//
// Decomposition: one warp per instance (one 32-thread block each, grid = B:
// no padding, nothing to mask).  Pm, CP, S, S^{-1}, M1, the residual and the
// Schur scratch sit in shared memory, about 17.7 KB, so the covariance chain
// never goes to device memory; P is read once from global memory in the
// predict, x' and P' are written once.  The lanes take the entries of every
// combination and product round-robin, with __syncwarp() between dependent
// steps.
//
// What bounds it on this card: 761 floats in and out per instance (3 KB) and
// about 0.2 Mflop, most of it the four 28x28x18 products of the two-step M1
// solve and the Schur recursion.  At B = 2048 both the bytes (6.2 MB) and the
// operations are microseconds on an H100; the time is the latency of the
// dependent chain (about 60 steps, the recursion's small products use few
// lanes) at 2048 warps over 132 SMs, twelve resident per SM by shared memory.
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_linalg.cuh"

#define NX 18
#define NY 28

struct KfParams {
  int B;
  float dt;
};

struct KfSmem {
  float xp[NX], a[3], y[NY], qd[NX], rd[NY];
  float ey[NY], Sey[NY], rv[NY];
  float Pm[NX * NX], Pn[NX * NX];
  float CP[NY * NX], M1[NY * NX], T[NY * NX];
  float S[NY * NY], Si[NY * NY];
  float scr[wl::SpdInv<NY>::kScratch];
};

// Row r of C applied to the first index of M, at second index j, with
// M(k, j) = M[k * rs + j * cs] (k < NX).
__device__ __forceinline__ float c_row(const float* M, int rs, int cs, int r, int j) {
  const float* col = M + j * cs;
  if (r < 12) return col[(r % 3) * rs] - col[(6 + r) * rs];
  if (r < 24) return col[(3 + (r - 12) % 3) * rs];
  return col[(8 + 3 * (r - 24)) * rs];
}

__global__ void __launch_bounds__(32) kf_kernel(
    const float* __restrict__ x_in, const float* __restrict__ P_in,
    const float* __restrict__ a_in, const float* __restrict__ y_in,
    const float* __restrict__ qd_in, const float* __restrict__ rd_in,
    float* __restrict__ x_out, float* __restrict__ P_out, const KfParams p) {
  __shared__ KfSmem s;
  const int b = blockIdx.x;
  const int lane = wl::lane();
  const float dt = p.dt;
  const float* x = x_in + NX * b;
  const float* P = P_in + NX * NX * b;

  // ---- load; predict xp = A x + B a ----
  if (lane < 3) s.a[lane] = a_in[3 * b + lane];
  if (lane < NY) {
    s.y[lane] = y_in[NY * b + lane];
    s.rd[lane] = rd_in[NY * b + lane];
  }
  if (lane < NX) s.qd[lane] = qd_in[NX * b + lane];
  __syncwarp();
  if (lane < NX) {
    float v = x[lane];
    if (lane < 3) v = v + dt * x[lane + 3];
    else if (lane < 6) v = v + dt * s.a[lane - 3];
    s.xp[lane] = v;
  }
  // Pm = (I + dt E) P (I + dt E)^T + diag(q): rows 0..2 gain dt * rows 3..5,
  // then columns 0..2 gain dt * columns 3..5 of the row-updated matrix
  for (int e = lane; e < NX * NX; e += 32) {
    const int i = e / NX, j = e - (e / NX) * NX;
    float v = P[e];
    if (i < 3) v = v + dt * P[e + 3 * NX];
    if (j < 3) {
      float w = P[e + 3];
      if (i < 3) w = w + dt * P[e + 3 * NX + 3];
      v = v + dt * w;
    }
    if (i == j) v = v + s.qd[i];
    s.Pm[e] = v;
  }
  __syncwarp();

  // ---- innovation: ey = y - C xp, CP = C Pm, S = C (CP)^T + diag(r) ----
  if (lane < NY) s.ey[lane] = s.y[lane] - c_row(s.xp, 1, 0, lane, 0);
  for (int e = lane; e < NY * NX; e += 32) {
    const int r = e / NX, j = e - (e / NX) * NX;
    s.CP[e] = c_row(s.Pm, NX, 1, r, j);
  }
  __syncwarp();
  for (int e = lane; e < NY * NY; e += 32) {
    const int r = e / NY, c = e - (e / NY) * NY;
    float v = c_row(s.CP + c * NX, 1, 0, r, 0);   // over k: (CP)^T(k, c) = CP[c][k]
    if (r == c) v = v + s.rd[r];
    s.S[e] = v;
  }
  __syncwarp();

  wl::SpdInv<NY>::run(s.S, NY, s.Si, NY, s.scr);

  // ---- S_ey = S^{-1} ey, one refinement step; x' = xp + (CP)^T S_ey ----
  wl::gemv(s.Sey, nullptr, 1.f, s.Si, NY, 1, s.ey, 1, NY, NY);
  __syncwarp();
  wl::gemv(s.rv, s.ey, -1.f, s.S, NY, 1, s.Sey, 1, NY, NY);
  __syncwarp();
  wl::gemv(s.Sey, s.Sey, 1.f, s.Si, NY, 1, s.rv, 1, NY, NY);
  __syncwarp();
  wl::gemv(x_out + NX * b, s.xp, 1.f, s.CP, 1, NX, s.Sey, 1, NX, NY);

  // ---- M1 = S^{-1} CP, one refinement step; P' = Pm - (CP)^T M1 ----
  wl::gemm(s.M1, NX, nullptr, 0, 1.f, s.Si, NY, 1, s.CP, NX, 1, NY, NY, NX);
  __syncwarp();
  wl::gemm(s.T, NX, s.CP, NX, -1.f, s.S, NY, 1, s.M1, NX, 1, NY, NY, NX);
  __syncwarp();
  wl::gemm(s.M1, NX, s.M1, NX, 1.f, s.Si, NY, 1, s.T, NX, 1, NY, NY, NX);
  __syncwarp();
  wl::gemm(s.Pn, NX, s.Pm, NX, -1.f, s.CP, 1, NX, s.M1, NX, 1, NX, NY, NX);
  __syncwarp();

  // ---- symmetrise; the xy blow-up reset ----
  const float p01 = (s.Pn[1] + s.Pn[NX]) / 2.0f;
  const float det2 = s.Pn[0] * s.Pn[NX + 1] - p01 * p01;
  const float blowup = det2 > 1e-6f ? 1.0f : 0.0f;
  float* Po = P_out + NX * NX * b;
  for (int e = lane; e < NX * NX; e += 32) {
    const int i = e / NX, j = e - (e / NX) * NX;
    const bool xi = i < 2, xj = j < 2;
    const float cross = xi != xj ? 1.0f : 0.0f;
    const float xyblk = xi && xj ? 1.0f : 0.0f;
    const float scale = 1.0f - blowup * cross - blowup * xyblk * 0.9f;
    Po[e] = ((s.Pn[e] + s.Pn[j * NX + i]) / 2.0f) * scale;
  }
}

extern "C" int kf_launch(const float* x, const float* P, const float* a, const float* y,
                         const float* qd, const float* rd, float* x_out, float* P_out,
                         KfParams p, void* stream) {
  kf_kernel<<<p.B, 32, 0, (cudaStream_t)stream>>>(x, P, a, y, qd, rd, x_out, P_out, p);
  return (int)cudaGetLastError();
}
