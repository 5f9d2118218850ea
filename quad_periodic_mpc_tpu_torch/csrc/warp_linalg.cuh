// Warp-cooperative dense algebra on small row-major matrices, shared by the
// kernels that give one warp to one instance (kinematics.cu, wbc.cu).
//
// Every helper here is called by all 32 lanes of the warp (never inside a
// lane-0 section): the lanes take the output entries round-robin, and each
// entry is one lane's sequential sum in the order k = 0, 1, ..., as the
// TPU kernels' unrolled `_mm` / `_mv` sum them.  The caller puts a
// __syncwarp() between a helper and anything that reads its output.
// Operands live in shared memory (or read-only global memory); strides make
// transposed operands free.
#pragma once

#include <cuda_runtime.h>

namespace wl {

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

// C(i,j) = [D(i,j) +] alpha * sum_k A(i,k) B(k,j),  i < r, k < kk, j < s,
// with A(i,k) = A[i*ar + k*ac] and B(k,j) = B[k*br + j*bc].  D (may be
// null) may alias C entry for entry; A and B must not overlap C.
__device__ __forceinline__ void gemm(float* C, int ldc, const float* D, int ldd,
                                     float alpha, const float* A, int ar, int ac,
                                     const float* B, int br, int bc, int r, int kk,
                                     int s) {
  for (int e = lane(); e < r * s; e += 32) {
    const int i = e / s, j = e - (e / s) * s;
    const float* a = A + i * ar;
    const float* b = B + j * bc;
    float acc = a[0] * b[0];
    for (int k = 1; k < kk; ++k) acc = fmaf(a[k * ac], b[k * br], acc);
    if (D) {
      C[i * ldc + j] = D[i * ldd + j] + alpha * acc;
    } else {
      C[i * ldc + j] = alpha * acc;
    }
  }
}

// y(i) = [d(i) +] alpha * sum_k A(i,k) x(k)   (x(k) = x[k*xs])
__device__ __forceinline__ void gemv(float* y, const float* d, float alpha,
                                     const float* A, int ar, int ac, const float* x,
                                     int xs, int r, int kk) {
  gemm(y, 1, d, 1, alpha, A, ar, ac, x, xs, 0, r, kk, 1);
}

__device__ __forceinline__ void copy(float* dst, int ldd, const float* src, int lds,
                                     int r, int c) {
  for (int e = lane(); e < r * c; e += 32) {
    const int i = e / c, j = e - (e / c) * c;
    dst[i * ldd + j] = src[i * lds + j];
  }
}

__device__ __forceinline__ void fill(float* dst, int n, float v) {
  for (int e = lane(); e < n; e += 32) dst[e] = v;
}

// Closed-form inverse of the symmetric 3x3 M + reg I from its upper
// triangle (the TPU kernels' _inv3).  One lane.
__device__ __forceinline__ void inv3(const float* M, int ldm, float reg, float* out,
                                     int ldo) {
  const float a = M[0] + reg, b = M[1], c = M[2];
  const float d = M[ldm + 1] + reg, e = M[ldm + 2];
  const float f = M[2 * ldm + 2] + reg;
  const float co00 = d * f - e * e, co01 = c * e - b * f, co02 = b * e - c * d;
  const float co11 = a * f - c * c, co12 = b * c - a * e, co22 = a * d - b * b;
  const float det = a * co00 + b * co01 + c * co02;
  const float inv_det = 1.0f / det;
  out[0] = co00 * inv_det;
  out[1] = co01 * inv_det;
  out[2] = co02 * inv_det;
  out[ldo] = co01 * inv_det;
  out[ldo + 1] = co11 * inv_det;
  out[ldo + 2] = co12 * inv_det;
  out[2 * ldo] = co02 * inv_det;
  out[2 * ldo + 1] = co12 * inv_det;
  out[2 * ldo + 2] = co22 * inv_det;
}

// Exact inverse of an SPD N x N matrix by recursive 2x2-block Schur
// complements, split at (N+1)/2 (the TPU kernels' _spd_inv_rec; the split
// is a numerical choice), on 1x1, 2x2 and 3x3 closed forms:
//   M = [[A, B], [B^T, D]],  S = D - B^T A^{-1} B,
//   M^{-1} = [[A^{-1} - TR (A^{-1}B)^T, TR], [TR^T, S^{-1}]],
//   TR = -(A^{-1} B) S^{-1}.
// `out` must not overlap M; `scr` holds SpdInv<N>::kScratch floats.  The
// whole warp calls run(); it ends with a __syncwarp().
template <int N>
struct SpdInv;

template <>
struct SpdInv<1> {
  static constexpr int kScratch = 0;
  __device__ static void run(const float* M, int, float* out, int, float*) {
    if (lane() == 0) out[0] = 1.0f / M[0];
    __syncwarp();
  }
};

template <>
struct SpdInv<2> {
  static constexpr int kScratch = 0;
  __device__ static void run(const float* M, int ldm, float* out, int ldo, float*) {
    if (lane() == 0) {
      const float a = M[0], b = M[1], d = M[ldm + 1];
      const float inv_det = 1.0f / (a * d - b * b);
      out[0] = d * inv_det;
      out[1] = -b * inv_det;
      out[ldo] = -b * inv_det;
      out[ldo + 1] = a * inv_det;
    }
    __syncwarp();
  }
};

template <>
struct SpdInv<3> {
  static constexpr int kScratch = 0;
  __device__ static void run(const float* M, int ldm, float* out, int ldo, float*) {
    if (lane() == 0) inv3(M, ldm, 0.0f, out, ldo);
    __syncwarp();
  }
};

template <int N>
struct SpdInv {
  static constexpr int H = (N + 1) / 2;
  static constexpr int R = N - H;
  static constexpr int kOwn = H * R + R * R + SpdInv<R>::kScratch;
  static constexpr int kScratch =
      SpdInv<H>::kScratch > kOwn ? SpdInv<H>::kScratch : kOwn;

  __device__ static void run(const float* M, int ldm, float* out, int ldo,
                             float* scr) {
    float* AiB = scr;            // H x R
    float* S = scr + H * R;      // R x R
    float* Ai = out;             // top-left block of out, H x H
    float* Si = out + H * ldo + H;
    float* TR = out + H;
    SpdInv<H>::run(M, ldm, Ai, ldo, scr);
    gemm(AiB, R, nullptr, 0, 1.0f, Ai, ldo, 1, M + H, ldm, 1, H, H, R);
    __syncwarp();
    // S = D - B^T AiB
    gemm(S, R, M + H * ldm + H, ldm, -1.0f, M + H, 1, ldm, AiB, R, 1, R, H, R);
    __syncwarp();
    SpdInv<R>::run(S, R, Si, ldo, scr + H * R + R * R);
    gemm(TR, ldo, nullptr, 0, -1.0f, AiB, R, 1, Si, ldo, 1, H, R, R);
    __syncwarp();
    // TL = Ai - TR AiB^T (in place), BL = TR^T
    gemm(Ai, ldo, Ai, ldo, -1.0f, TR, ldo, 1, AiB, 1, R, H, R, H);
    for (int e = lane(); e < R * H; e += 32) {
      const int i = e / H, j = e - (e / H) * H;
      out[(H + i) * ldo + j] = TR[j * ldo + i];
    }
    __syncwarp();
  }
};

}  // namespace wl
