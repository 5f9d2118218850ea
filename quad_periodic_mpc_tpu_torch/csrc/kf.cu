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
// Decomposition: one 64-thread block (two warps) per instance, grid = B:
// no padding, nothing to mask.  Pm, CP, S, S^{-1}, the vectors and one
// 512-float work area sit in shared memory, 12,264 B, so the covariance
// chain never goes to device memory; P is read once from global memory in
// the predict, x' and P' are written once.  At that size (and 48 registers
// a thread; __launch_bounds__(64, 16) holds it at 64 or fewer) 17 blocks
// stay resident on an SM, 2,244 on the card's 132 SMs, so B = 2048 runs in
// one wave (tools/time_tick_cuda.py reads it from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor).  The work area holds the
// Schur inverse's scratch, then M1; T = CP - S M1 is formed in place over
// CP, and CP = C Pm is formed again from Pm (the same sums, the same bits)
// before P' = Pm - (CP)^T M1 is formed in place over Pm.  A thread takes a
// tile of each product's output (4x2 of the 28x18 products, 3x2 of the
// 18x18, 2x2 of the Schur inverse's 14x14 blocks), so each value it loads
// from shared memory feeds two or three FMAs, and every entry is still one
// thread's sum in k order; S's and S^{-1}'s rows are padded to 29 floats so
// the row groups a warp reads fall on distinct banks.  The two solves run
// side by side: while the tiles of M1 = S^{-1} CP, its residual and its
// correction are formed, threads 0..27 take the entries of S_ey, its
// residual and its correction.  S^{-1}: the top level of the Schur
// recursion (split at 14) over the block, a __syncthreads() after each of
// its four products, and the two 14x14 inverses below it on warp 0
// (wl::SpdInv<14>, split at its top level) while warp 1 waits.
//
// What bounds it on this card: 761 floats in and out per instance (3 KB) and
// about 0.2 Mflop, most of it the four 28x28x18 products of the two-step M1
// solve and the Schur recursion.  At B = 2048 both the bytes (6.2 MB) and the
// operations are microseconds on an H100.  Alone (B = 1) an instance is the
// latency of its dependent chain (about 30 block-wide steps, and the
// lane-0 closed forms at the bottom of the recursion); at B = 2048 the 15
// or 16 instances on an SM share its issue slots and its shared-memory
// pipe, and take about 2.5x as long as one alone (tools/time_tick_cuda.py).
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

constexpr int kThreads = 64;
constexpr int kH = NY / 2;                // the Schur split of S: 14 + 14
constexpr int kLd = NY + 1;               // S's and S^{-1}'s row stride (see KfSmem)

struct KfSmem {
  float xp[NX], ey[NY], Sey[NY], rv[NY];
  float Pm[NX * NX];           // Pm; P' (before symmetrising) in place
  float CP[NY * NX];           // C Pm; T = CP - S M1 in place; C Pm again
  float S[NY * kLd], Si[NY * kLd];   // rows padded to 29: a warp's 4 row groups
                                     // (rows 8 apart) fall on distinct banks
  float work[512];             // the Schur inverse's scratch; then M1
};
static_assert(2 * kH * kH + wl::SpdInv<kH, false>::kScratch <= 512, "work area");
static_assert(NY * NX <= 512, "work area");

// Row r of C applied to the first index of M, at second index j, with
// M(k, j) = M[k * rs + j * cs] (k < NX).
__device__ __forceinline__ float c_row(const float* M, int rs, int cs, int r, int j) {
  const float* col = M + j * cs;
  if (r < 12) return col[(r % 3) * rs] - col[(6 + r) * rs];
  if (r < 24) return col[(3 + (r - 12) % 3) * rs];
  return col[(8 + 3 * (r - 24)) * rs];
}

// The TI x TJ tile at (i0, j0) of C(i,j) = [D(i,j) +] alpha * sum_k A(i,k) B(k,j),
// k < KK, with A(i,k) = A[i*ar + k*ac] and B(k,j) = B[k*br + j*bc]: each
// entry one thread's sum in the order k = 0, 1, ... (wl::gemm's), the
// loaded values shared across the tile.  D (may be null) may alias C entry
// for entry; A and B must not overlap C.
template <int TI, int TJ, int KK>
__device__ __forceinline__ void tile(float* C, int ldc, const float* D, int ldd, float alpha,
                                     const float* A, int ar, int ac, const float* B, int br,
                                     int bc, int i0, int j0) {
  float acc[TI][TJ];
#pragma unroll
  for (int ti = 0; ti < TI; ++ti)
#pragma unroll
    for (int tj = 0; tj < TJ; ++tj) acc[ti][tj] = A[(i0 + ti) * ar] * B[(j0 + tj) * bc];
#pragma unroll 4
  for (int k = 1; k < KK; ++k) {
    float a[TI], b[TJ];
#pragma unroll
    for (int ti = 0; ti < TI; ++ti) a[ti] = A[(i0 + ti) * ar + k * ac];
#pragma unroll
    for (int tj = 0; tj < TJ; ++tj) b[tj] = B[k * br + (j0 + tj) * bc];
#pragma unroll
    for (int ti = 0; ti < TI; ++ti)
#pragma unroll
      for (int tj = 0; tj < TJ; ++tj) acc[ti][tj] = fmaf(a[ti], b[tj], acc[ti][tj]);
  }
#pragma unroll
  for (int ti = 0; ti < TI; ++ti)
#pragma unroll
    for (int tj = 0; tj < TJ; ++tj) {
      const int i = i0 + ti, j = j0 + tj;
      if (D) {
        C[i * ldc + j] = D[i * ldd + j] + alpha * acc[ti][tj];
      } else {
        C[i * ldc + j] = alpha * acc[ti][tj];
      }
    }
}

// The whole product, R x S by TI x TJ tiles over the block's threads.
template <int R, int S, int KK, int TI, int TJ>
__device__ __forceinline__ void product(float* C, int ldc, const float* D, int ldd, float alpha,
                                        const float* A, int ar, int ac, const float* B, int br,
                                        int bc) {
  static_assert(R % TI == 0 && S % TJ == 0 && (R / TI) * (S / TJ) <= kThreads, "tiles");
  const int t = threadIdx.x, cols = S / TJ;
  if (t < (R / TI) * cols)
    tile<TI, TJ, KK>(C, ldc, D, ldd, alpha, A, ar, ac, B, br, bc, (t / cols) * TI,
                     (t % cols) * TJ);
}

// y(i) = [d(i) +] alpha * sum_k A(i,k) x(k), k < NY, entry i on thread i.
__device__ __forceinline__ void gemv_entry(float* y, const float* d, float alpha,
                                           const float* A, int ar, int ac, const float* x,
                                           int i) {
  tile<1, 1, NY>(y, 1, d, 1, alpha, A, ar, ac, x, 1, 0, i, 0);
}

// S^{-1} of the 28x28 SPD S: wl::SpdInv<28>'s top level (split at 14,
// its split schedule: the same sums, so the same bits) over the block, the
// 14x14 inverses below it on warp 0.  Ends with a __syncthreads().
__device__ void spd_inv28(const float* M, float* out, float* work) {
  constexpr int H = kH, R = NY - kH, L = kLd;
  float* AiB = work;              // H x R
  float* Sc = work + H * R;       // R x R
  float* Ai = out;
  float* Si = out + H * L + H;
  float* TR = out + H;
  const bool warp0 = threadIdx.x < 32;
  if (warp0) wl::SpdInv<H, false>::run(M, L, Ai, L, work);
  __syncthreads();
  product<H, R, H, 2, 2>(AiB, R, nullptr, 0, 1.0f, Ai, L, 1, M + H, L, 1);
  __syncthreads();
  product<R, R, H, 2, 2>(Sc, R, M + H * L + H, L, -1.0f, M + H, 1, L, AiB, R, 1);
  __syncthreads();
  if (warp0) wl::SpdInv<R, false>::run(Sc, R, Si, L, work + H * R + R * R);
  __syncthreads();
  product<H, R, R, 2, 2>(TR, L, nullptr, 0, -1.0f, AiB, R, 1, Si, L, 1);
  __syncthreads();
  // TL = Ai - TR AiB^T (in place), BL = TR^T
  product<H, H, R, 2, 2>(Ai, L, Ai, L, -1.0f, TR, L, 1, AiB, 1, R);
  for (int e = threadIdx.x; e < R * H; e += kThreads) {
    const int i = e / H, j = e - (e / H) * H;
    out[(H + i) * L + j] = TR[j * L + i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 16) kf_kernel(
    const float* __restrict__ x_in, const float* __restrict__ P_in,
    const float* __restrict__ a_in, const float* __restrict__ y_in,
    const float* __restrict__ qd_in, const float* __restrict__ rd_in,
    float* __restrict__ x_out, float* __restrict__ P_out, const KfParams p) {
  __shared__ KfSmem s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float dt = p.dt;
  const float* x = x_in + NX * b;
  const float* P = P_in + NX * NX * b;
  const float* rd = rd_in + NY * b;

  // ---- predict xp = A x + B a ----
  if (tid < NX) {
    float v = x[tid];
    if (tid < 3) v = v + dt * x[tid + 3];
    else if (tid < 6) v = v + dt * a_in[3 * b + tid - 3];
    s.xp[tid] = v;
  }
  // Pm = (I + dt E) P (I + dt E)^T + diag(q): rows 0..2 gain dt * rows 3..5,
  // then columns 0..2 gain dt * columns 3..5 of the row-updated matrix
  for (int e = tid; e < NX * NX; e += kThreads) {
    const int i = e / NX, j = e - (e / NX) * NX;
    float v = P[e];
    if (i < 3) v = v + dt * P[e + 3 * NX];
    if (j < 3) {
      float w = P[e + 3];
      if (i < 3) w = w + dt * P[e + 3 * NX + 3];
      v = v + dt * w;
    }
    if (i == j) v = v + qd_in[NX * b + i];
    s.Pm[e] = v;
  }
  __syncthreads();

  // ---- innovation: ey = y - C xp, CP = C Pm, S = C (CP)^T + diag(r) ----
  if (tid < NY) s.ey[tid] = y_in[NY * b + tid] - c_row(s.xp, 1, 0, tid, 0);
  for (int e = tid; e < NY * NX; e += kThreads) {
    const int r = e / NX, j = e - (e / NX) * NX;
    s.CP[e] = c_row(s.Pm, NX, 1, r, j);
  }
  __syncthreads();
  for (int e = tid; e < NY * NY; e += kThreads) {
    const int r = e / NY, c = e - (e / NY) * NY;
    float v = c_row(s.CP + c * NX, 1, 0, r, 0);   // over k: (CP)^T(k, c) = CP[c][k]
    if (r == c) v = v + rd[r];
    s.S[r * kLd + c] = v;
  }
  __syncthreads();

  spd_inv28(s.S, s.Si, s.work);

  // ---- the two solves side by side, each with one refinement step:
  //      M1 = S^{-1} CP and S_ey = S^{-1} ey ----
  float* M1 = s.work;
  product<NY, NX, NY, 4, 2>(M1, NX, nullptr, 0, 1.f, s.Si, kLd, 1, s.CP, NX, 1);
  if (tid < NY) gemv_entry(s.Sey, nullptr, 1.f, s.Si, kLd, 1, s.ey, tid);
  __syncthreads();
  // T = CP - S M1 in place over CP;  rv = ey - S S_ey
  product<NY, NX, NY, 4, 2>(s.CP, NX, s.CP, NX, -1.f, s.S, kLd, 1, M1, NX, 1);
  if (tid < NY) gemv_entry(s.rv, s.ey, -1.f, s.S, kLd, 1, s.Sey, tid);
  __syncthreads();
  // M1 += S^{-1} T;  S_ey += S^{-1} rv
  product<NY, NX, NY, 4, 2>(M1, NX, M1, NX, 1.f, s.Si, kLd, 1, s.CP, NX, 1);
  if (tid < NY) gemv_entry(s.Sey, s.Sey, 1.f, s.Si, kLd, 1, s.rv, tid);
  __syncthreads();
  // CP = C Pm again (T is dead)
  for (int e = tid; e < NY * NX; e += kThreads) {
    const int r = e / NX, j = e - (e / NX) * NX;
    s.CP[e] = c_row(s.Pm, NX, 1, r, j);
  }
  __syncthreads();
  // P' = Pm - (CP)^T M1 in place over Pm;  x' = xp + (CP)^T S_ey
  product<NX, NX, NY, 3, 2>(s.Pm, NX, s.Pm, NX, -1.f, s.CP, 1, NX, M1, NX, 1);
  for (int i = tid - (NX / 3) * (NX / 2); i >= 0 && i < NX; i += kThreads - (NX / 3) * (NX / 2))
    gemv_entry(x_out + NX * b, s.xp, 1.f, s.CP, 1, NX, s.Sey, i);
  __syncthreads();

  // ---- symmetrise; the xy blow-up reset ----
  const float* Pn = s.Pm;
  const float p01 = (Pn[1] + Pn[NX]) / 2.0f;
  const float det2 = Pn[0] * Pn[NX + 1] - p01 * p01;
  const float blowup = det2 > 1e-6f ? 1.0f : 0.0f;
  float* Po = P_out + NX * NX * b;
  for (int e = tid; e < NX * NX; e += kThreads) {
    const int i = e / NX, j = e - (e / NX) * NX;
    const bool xi = i < 2, xj = j < 2;
    const float cross = xi != xj ? 1.0f : 0.0f;
    const float xyblk = xi && xj ? 1.0f : 0.0f;
    const float scale = 1.0f - blowup * cross - blowup * xyblk * 0.9f;
    Po[e] = ((Pn[e] + Pn[j * NX + i]) / 2.0f) * scale;
  }
}

extern "C" int kf_launch(const float* x, const float* P, const float* a, const float* y,
                         const float* qd, const float* rd, float* x_out, float* P_out,
                         KfParams p, void* stream) {
  kf_kernel<<<p.B, kThreads, 0, (cudaStream_t)stream>>>(x, P, a, y, qd, rd, x_out, P_out, p);
  return (int)cudaGetLastError();
}
