// Fused whole-body control (KinWBC + WBIC + cone PDIP) for Hopper (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/wbc_kernel.py
// ::fused_wbc (_kernel).  Per instance:
//   1. KinWBC (KinWBC.cpp:16-90): Nc = I - Jc^+ Jc with the stance-masked
//      contact Jacobian, then the six tasks [body ori, body pos, foot0..3]
//      in priority order, each with the damped pinv of J_i N (3x3 Gram with
//      `damping` on its diagonal) and the rank-3 projector update
//      N <- N - (N J^+) (J N); the last task's projector is never updated.
//      Outputs des_jpos = q + delta_q[6:], des_jvel = qdot[6:];
//   2. the WBIC cascade (WBIC.cpp:17-90): JcBar = A^{-1} Jc^T (Jc A^{-1}
//      Jc^T + lam I)^{-1}, qddot and Npre, then the six tasks with the
//      dynamically consistent inverses;
//   3. the relaxation QP (WBIC.cpp:91-261) with the 6 floating-base rows
//      eliminated: 12 variables dF, 24 cone rows (6 per leg, swing legs
//      pinned by fz_max = 0), degenerate rows opened by 1e-6, and a fixed
//      number of primal-dual interior-point iterations (fraction to the
//      boundary, mu floor, per-instance NaN freeze), each solving its KKT
//      system by the 12x12 Schur inverse plus one refinement step;
//   4. fr = fr_des + dF and tau = (A qddot + b - Jc^T fr)[6:].
//
// Decomposition: one 64-thread block (two warps) per instance, grid = B.
// Both warps load the instance's inputs into shared memory once, coalesced
// (A and A^{-1} included: every product reads them there).  Then the two
// cascades, which do not depend on each other, run side by side: warp 0
// runs KinWBC and then the QP set-up that needs no qddot (A_ff^{-1}, Mmat,
// P, the bounds), warp 1 the WBIC cascade; each has its own projector,
// Grams and temporaries.  After one __syncthreads() warp 0 alone takes the
// residual, the PDIP and the torques.  In the PDIP lane r < 24 owns cone
// row r (its slacks, duals, bounds and residuals stay in its registers) and
// lane j < 12 owns variable j.  The floors, the cone products (selects, no
// divergent branches), the residuals and the KKT right-hand side are spread
// over the lanes, and a lane gathers the six rows of its leg with
// shuffles.  Kr is P outside the legs' 3x3 blocks, written once; each
// iteration lanes 0..27 rewrite the 28 block entries that change.  The step
// length is four interleaved butterfly minima (fminf is exact in any order,
// and a NaN ratio drops out of it) and the NaN freeze an __all_sync.
// The two 24-term complementarity sums keep their sequential row order:
// every lane sums the rows from shared memory itself.  Block products take
// their output entries round-robin over the lanes (warp_linalg.cuh), with
// __syncwarp() between dependent steps.  The 12x12 and 6x6 inverses are
// wl::SpdInv's fused schedule: two barriers a Schur level instead of four.
//
// What bounds it on this card: about 0.2 Mflop per instance in a long
// chain of dependent small steps (six tasks per cascade, each an 18x18x3
// projector update, then 15 PDIP iterations each with a 12x12 Schur
// inverse), and about 4 KB of inputs per instance.  Neither the card's
// float32 rate nor its bandwidth is the limit: the chain's latency is, at
// B = 256 (512 warps, about four an SM) and at B = 1 alike: on an H100 a
// PDIP iteration takes 0.0025 ms, and the cascades with the QP set-up
// 0.017 ms of the kernel's 0.055 (tools/time_tick_cuda.py).
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.  Every output
// entry is one lane's sum in k order, as in the TPU kernel; the Schur
// inverses split at (n+1)/2 as the TPU kernel's _spd_inv_rec does.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_linalg.cuh"

#define ND 18
#define NJ 12
#define NT 6
#define NCON 24
#define FULL 0xffffffffu

struct WbcParams {
  int B, pdip_iters;
  float damping, w_floating, w_rf, mu, max_fz, pdip_reg, pdip_tau, pdip_mu_min,
      pdip_slack_floor, pdip_big_clamp;
};

// One cascade's working set (KinWBC on warp 0, WBIC on warp 1).
struct Cascade {
  float Gram[NJ * NJ], Grami[NJ * NJ];
  float scr[wl::SpdInv<NJ>::kScratch];
  float P18[ND * NJ], Bar[ND * NJ];
  float N[ND * ND];
  float JtPre[3 * ND], NP[ND * 3], pinv[ND * 3], AiJt3[ND * 3];
  float G3[9], G3i[9], t3[3], u3[3], t3b[3];
};

struct WbcSmem {
  // inputs, loaded once by both warps
  float A[ND * ND], Ainv[ND * ND];
  float R[9], cmask[4];
  float Jcm[NJ * ND];           // stance-masked contact Jacobian
  float Jf[4][3 * ND];          // swing-masked foot task Jacobians
  float Jcdqd_m[NJ], fr_des[NJ], q[NJ];
  float bvec[ND], err[ND], vel[ND], cmd[ND], jdqd[ND];
  Cascade kin, wbic;
  float dq[ND], qdot[ND];       // KinWBC's
  float qddot[ND];              // WBIC's
  // relaxation QP (warp 0)
  float resid[6], Affi[36], z0[6], Mmat[6 * NJ], P[NJ * NJ], qlin[NJ];
  float Kr[NJ * NJ], Ki[NJ * NJ], rhs[NJ], dx[NJ], rr[NJ], x[NJ];
  // the PDIP's cone rows as the lanes that own them publish them (for the
  // row-ordered complementarity sums)
  float sl[NCON], su[NCON], zl[NCON], zu[NCON];
  float fr[NJ], qf[ND];
};

// J_i @ Mat for an (ND x s) matrix with leading dim ld -> out (3 x s)
__device__ __forceinline__ void task_apply(const WbcSmem& s, int i, const float* Mat,
                                           int ld, int cols, float* out) {
  if (i < 2)
    wl::gemm(out, cols, nullptr, 0, 1.f, s.R, 3, 1, Mat + 3 * i * ld, ld, 1, 3, 3, cols);
  else
    wl::gemm(out, cols, nullptr, 0, 1.f, s.Jf[i - 2], ND, 1, Mat, ld, 1, 3, ND, cols);
}

// Row r of blockdiag(Uf x4) x, Uf = the 6x3 WBIC friction block: fz,
// fz mu + fx, fz mu - fx, fz mu + fy, fz mu - fy, -fz.  Selects, not
// branches, so the lanes of a warp do not diverge.
__device__ __forceinline__ float cone_row(float mu, const float* x, int r) {
  const int leg = r / 6, k = r - 6 * (r / 6);
  const float fx = x[3 * leg], fy = x[3 * leg + 1], fz = x[3 * leg + 2];
  const float f = k < 3 ? fx : fy;
  const float m = fmaf(fz, mu, (k & 1) ? f : -f);
  return k == 0 ? fz : k == 5 ? -fz : m;
}

// Entry k < 3 of Uf^T v for one leg's six rows v0..v5 (selects)
__device__ __forceinline__ float cone_col(float mu, float v0, float v1, float v2, float v3,
                                          float v4, float v5, int k) {
  const float c0 = v1 + v2 * -1.0f;
  const float c1 = v3 + v4 * -1.0f;
  const float c2 = ((((v0 + v1 * mu) + v2 * mu) + v3 * mu) + v4 * mu) + v5 * -1.0f;
  return k == 0 ? c0 : k == 1 ? c1 : c2;
}

// Entry `k` of Uf^T of the cone-row values the lanes hold: lane j gathers
// the six rows of its leg (j / 3) from the lanes that own them.  The whole
// warp calls it.
__device__ __forceinline__ float cone_col_gather(float mu, float v, int j) {
  const int base = 6 * ((j / 3) & 3);
  const float v0 = __shfl_sync(FULL, v, base), v1 = __shfl_sync(FULL, v, base + 1);
  const float v2 = __shfl_sync(FULL, v, base + 2), v3 = __shfl_sync(FULL, v, base + 3);
  const float v4 = __shfl_sync(FULL, v, base + 4), v5 = __shfl_sync(FULL, v, base + 5);
  return cone_col(mu, v0, v1, v2, v3, v4, v5, j - 3 * (j / 3));
}

// -v/dv for a row whose step shrinks v, else +inf (max_step's ratio)
__device__ __forceinline__ float step_ratio(float v, float dv) {
  return dv < 0.f ? -v / dv : INFINITY;
}

// lam on the diagonal of an n x n matrix (warp)
__device__ __forceinline__ void add_diag(float* M, int n, float lam) {
  for (int i = wl::lane(); i < n; i += 32) M[i * n + i] = M[i * n + i] + lam;
}

// KinWBC (warp 0): des_jpos, des_jvel
__device__ void kin_wbc(WbcSmem& s, float lam, float* jpos, float* jvel) {
  const int lane = wl::lane();
  Cascade& c = s.kin;
  // Nc = I - Jc^T (Jc Jc^T + lam I)^{-1} Jc
  wl::gemm(c.Gram, NJ, nullptr, 0, 1.f, s.Jcm, ND, 1, s.Jcm, 1, ND, NJ, ND, NJ);
  __syncwarp();
  add_diag(c.Gram, NJ, lam);
  __syncwarp();
  wl::SpdInv<NJ>::run(c.Gram, NJ, c.Grami, NJ, c.scr);
  wl::gemm(c.P18, NJ, nullptr, 0, 1.f, s.Jcm, 1, ND, c.Grami, NJ, 1, ND, NJ, NJ);
  __syncwarp();
  wl::gemm(c.N, ND, nullptr, 0, -1.f, c.P18, NJ, 1, s.Jcm, ND, 1, ND, NJ, ND);
  __syncwarp();
  add_diag(c.N, ND, 1.0f);
  __syncwarp();
  for (int i = 0; i < NT; ++i) {
    task_apply(s, i, c.N, ND, ND, c.JtPre);
    __syncwarp();
    wl::gemm(c.G3, 3, nullptr, 0, 1.f, c.JtPre, ND, 1, c.JtPre, 1, ND, 3, ND, 3);
    __syncwarp();
    if (lane == 0) wl::inv3(c.G3, 3, lam, c.G3i, 3);
    __syncwarp();
    wl::gemm(c.pinv, 3, nullptr, 0, 1.f, c.JtPre, 1, ND, c.G3i, 3, 1, ND, 3, 3);
    __syncwarp();
    if (i == 0) {
      wl::gemv(s.dq, nullptr, 1.f, c.pinv, 3, 1, s.err, 1, ND, 3);
      wl::gemv(s.qdot, nullptr, 1.f, c.pinv, 3, 1, s.vel, 1, ND, 3);
    } else {
      task_apply(s, i, s.dq, 1, 1, c.u3);
      task_apply(s, i, s.qdot, 1, 1, c.t3b);
      __syncwarp();
      if (lane < 3) {
        c.t3[lane] = s.err[3 * i + lane] - c.u3[lane];
        c.t3b[lane] = s.vel[3 * i + lane] - c.t3b[lane];
      }
      __syncwarp();
      wl::gemv(s.dq, s.dq, 1.f, c.pinv, 3, 1, c.t3, 1, ND, 3);
      wl::gemv(s.qdot, s.qdot, 1.f, c.pinv, 3, 1, c.t3b, 1, ND, 3);
    }
    __syncwarp();
    if (i < NT - 1) {           // the last task's projector is never used
      wl::gemm(c.NP, 3, nullptr, 0, 1.f, c.N, ND, 1, c.pinv, 3, 1, ND, ND, 3);
      __syncwarp();
      wl::gemm(c.N, ND, c.N, ND, -1.f, c.NP, 3, 1, c.JtPre, ND, 1, ND, 3, ND);
      __syncwarp();
    }
  }
  if (lane < NJ) {
    jpos[lane] = s.q[lane] + s.dq[6 + lane];
    jvel[lane] = s.qdot[6 + lane];
  }
}

// The WBIC cascade (warp 1): qddot
__device__ void wbic_cascade(WbcSmem& s, float lam) {
  const int lane = wl::lane();
  Cascade& c = s.wbic;
  // JcBar = A^{-1} Jc^T (Jc A^{-1} Jc^T + lam I)^{-1}
  wl::gemm(c.P18, NJ, nullptr, 0, 1.f, s.Ainv, ND, 1, s.Jcm, 1, ND, ND, ND, NJ);
  __syncwarp();
  wl::gemm(c.Gram, NJ, nullptr, 0, 1.f, s.Jcm, ND, 1, c.P18, NJ, 1, NJ, ND, NJ);
  __syncwarp();
  add_diag(c.Gram, NJ, lam);
  __syncwarp();
  wl::SpdInv<NJ>::run(c.Gram, NJ, c.Grami, NJ, c.scr);
  wl::gemm(c.Bar, NJ, nullptr, 0, 1.f, c.P18, NJ, 1, c.Grami, NJ, 1, ND, NJ, NJ);
  __syncwarp();
  wl::gemv(s.qddot, nullptr, -1.f, c.Bar, NJ, 1, s.Jcdqd_m, 1, ND, NJ);
  wl::gemm(c.N, ND, nullptr, 0, -1.f, c.Bar, NJ, 1, s.Jcm, ND, 1, ND, NJ, ND);
  __syncwarp();
  add_diag(c.N, ND, 1.0f);
  __syncwarp();
  for (int i = 0; i < NT; ++i) {
    task_apply(s, i, c.N, ND, ND, c.JtPre);
    __syncwarp();
    wl::gemm(c.AiJt3, 3, nullptr, 0, 1.f, s.Ainv, ND, 1, c.JtPre, 1, ND, ND, ND, 3);
    __syncwarp();
    wl::gemm(c.G3, 3, nullptr, 0, 1.f, c.JtPre, ND, 1, c.AiJt3, 3, 1, 3, ND, 3);
    __syncwarp();
    if (lane == 0) wl::inv3(c.G3, 3, lam, c.G3i, 3);
    __syncwarp();
    wl::gemm(c.pinv, 3, nullptr, 0, 1.f, c.AiJt3, 3, 1, c.G3i, 3, 1, ND, 3, 3);
    task_apply(s, i, s.qddot, 1, 1, c.u3);
    __syncwarp();
    if (lane < 3) c.t3[lane] = (s.cmd[3 * i + lane] - s.jdqd[3 * i + lane]) - c.u3[lane];
    __syncwarp();
    wl::gemv(s.qddot, s.qddot, 1.f, c.pinv, 3, 1, c.t3, 1, ND, 3);
    __syncwarp();
    if (i < NT - 1) {
      wl::gemm(c.NP, 3, nullptr, 0, 1.f, c.N, ND, 1, c.pinv, 3, 1, ND, ND, 3);
      __syncwarp();
      wl::gemm(c.N, ND, c.N, ND, -1.f, c.NP, 3, 1, c.JtPre, ND, 1, ND, 3, ND);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(64) wbc_kernel(
    const float* __restrict__ A_in, const float* __restrict__ Ainv_in,
    const float* __restrict__ bvec_in, const float* __restrict__ Jc_in,
    const float* __restrict__ Jcdqd_in, const float* __restrict__ cmask_in,
    const float* __restrict__ R_in, const float* __restrict__ err_in,
    const float* __restrict__ vel_in, const float* __restrict__ cmd_in,
    const float* __restrict__ jdqd_in, const float* __restrict__ frdes_in,
    const float* __restrict__ q_in, float* __restrict__ jpos_out,
    float* __restrict__ jvel_out, float* __restrict__ tau_out,
    float* __restrict__ fr_out, const WbcParams p) {
  __shared__ WbcSmem s;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = wl::lane();
  const int warp = t >> 5;
  const float lam = p.damping;

  // ---- load (both warps, coalesced) and mask ----
  constexpr int kJcPer = (NJ * ND + 63) / 64;
  float jc[kJcPer];
#pragma unroll
  for (int k = 0; k < kJcPer; ++k) {
    const int e = t + 64 * k;
    jc[k] = e < NJ * ND ? Jc_in[NJ * ND * b + e] : 0.f;
  }
  const float jcdqd = t < NJ ? Jcdqd_in[NJ * b + t] : 0.f;
#pragma unroll
  for (int k = 0; k < (ND * ND + 63) / 64; ++k) {
    const int e = t + 64 * k;
    if (e < ND * ND) {
      s.A[e] = A_in[ND * ND * b + e];
      s.Ainv[e] = Ainv_in[ND * ND * b + e];
    }
  }
  if (t < 4) s.cmask[t] = cmask_in[4 * b + t];
  if (t < 9) s.R[t] = R_in[9 * b + t];
  if (t < ND) {
    s.bvec[t] = bvec_in[ND * b + t];
    s.err[t] = err_in[ND * b + t];
    s.vel[t] = vel_in[ND * b + t];
    s.cmd[t] = cmd_in[ND * b + t];
    s.jdqd[t] = jdqd_in[ND * b + t];
  }
  if (t < NJ) {
    s.fr_des[t] = frdes_in[NJ * b + t];
    s.q[t] = q_in[NJ * b + t];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kJcPer; ++k) {
    const int e = t + 64 * k;
    if (e < NJ * ND) {
      const int leg = e / (3 * ND);
      const float c = s.cmask[leg];
      s.Jcm[e] = jc[k] * c;
      s.Jf[leg][e - leg * 3 * ND] = jc[k] * (1.0f - c);
    }
  }
  if (t < NJ) s.Jcdqd_m[t] = jcdqd * s.cmask[t / 3];
  __syncthreads();

  // ---- the two cascades side by side; warp 0 then sets up the QP ----
  const float mu = p.mu, mu2 = p.mu * p.mu, floor_ = p.pdip_slack_floor;
  const float c1 = 2.0f * p.w_floating, c2 = 2.0f * p.w_rf;
  float l_r = 0.f, u_r = 0.f;       // lane r's cone bounds
  if (warp == 0) {
    kin_wbc(s, lam, jpos_out + NJ * b, jvel_out + NJ * b);
    // z_f = A_ff^{-1} (resid + Jc_f^T dF): A_ff^{-1}, Mmat = A_ff^{-1} Jc_f^T,
    // P = 2 w_f Mmat^T Mmat + 2 w_rf I
    wl::SpdInv<6>::run(s.A, ND, s.Affi, 6, s.kin.scr);
    wl::gemm(s.Mmat, NJ, nullptr, 0, 1.f, s.Affi, 6, 1, s.Jcm, 1, ND, 6, 6, NJ);
    __syncwarp();
    for (int e = lane; e < NJ * NJ; e += 32) {
      const int i = e / NJ, j = e - (e / NJ) * NJ;
      float acc = s.Mmat[i] * s.Mmat[j];
      for (int k = 1; k < 6; ++k) acc = fmaf(s.Mmat[NJ * k + i], s.Mmat[NJ * k + j], acc);
      s.P[e] = c1 * acc + (i == j ? c2 : 0.f);
    }
    // l = ieq - Uf fr_des (ieq: -fz_max on row 5 of a stance leg), u = big;
    // degenerate rows opened by 1e-6
    if (lane < NCON) {
      const int leg = lane / 6;
      const float base = (lane % 6 == 5) ? -(p.max_fz * s.cmask[leg]) : 0.f;
      l_r = base - cone_row(mu, s.fr_des, lane);
      u_r = p.pdip_big_clamp;
      if (u_r - l_r < 1e-6f) u_r = l_r + 1e-6f;
    }
    if (lane < NJ) s.x[lane] = 0.f;
  } else {
    wbic_cascade(s, lam);
  }
  __syncthreads();
  if (warp != 0) return;

  // ---------------- relaxation QP (warp 0) ----------------
  // resid = -(A qddot + b - Jc^T fr_des)[0:6];  z0 = A_ff^{-1} resid;
  // qlin = 2 w_f Mmat^T z0
  if (lane < 6) {
    float a1 = s.A[ND * lane] * s.qddot[0];
    for (int k = 1; k < ND; ++k) a1 = fmaf(s.A[ND * lane + k], s.qddot[k], a1);
    float a2 = s.Jcm[lane] * s.fr_des[0];
    for (int k = 1; k < NJ; ++k) a2 = fmaf(s.Jcm[ND * k + lane], s.fr_des[k], a2);
    s.resid[lane] = -((a1 + s.bvec[lane]) - a2);
  }
  __syncwarp();
  wl::gemv(s.z0, nullptr, 1.f, s.Affi, 6, 1, s.resid, 1, 6, 6);
  __syncwarp();
  if (lane < NJ) {
    float acc = s.Mmat[lane] * s.z0[0];
    for (int k = 1; k < 6; ++k) acc = fmaf(s.Mmat[NJ * k + lane], s.z0[k], acc);
    s.qlin[lane] = c1 * acc;
  }
  __syncwarp();

  // Kr = P + blockdiag(Uf^T diag(d_leg) Uf) + reg I: the entries outside
  // the legs' 3x3 blocks, and the blocks' (0,1) and (1,0), stay P
  for (int e = lane; e < NJ * NJ; e += 32) s.Kr[e] = s.P[e];
  // lane r < 24 owns cone row r, lane j < 12 variable j; lane l < 28 one of
  // the 7 block entries that change, leg l / 7: (0,0) (0,2) (2,0) (1,1)
  // (1,2) (2,1) (2,2)
  const bool row = lane < NCON, var = lane < NJ;
  const int kleg = lane / 7, slot = lane - 7 * (lane / 7);
  const int ka = slot == 0 || slot == 1 ? 0 : slot == 3 || slot == 4 ? 1 : 2;
  const int kc = slot == 0 || slot == 2 ? 0 : slot == 3 || slot == 5 ? 1 : 2;
  const int kidx = (3 * (kleg & 3) + ka) * NJ + 3 * (kleg & 3) + kc;   // lanes >= 28 idle
  float sl = 1.0f, su = 1.0f, zl = 1.0f, zu = 1.0f;
  for (int it = 0; it < p.pdip_iters; ++it) {
    // floors; publish the rows; A x and zl - zu
    float ax = 0.f;
    if (row) {
      sl = fmaxf(sl, floor_);
      su = fmaxf(su, floor_);
      zl = fmaxf(zl, floor_);
      zu = fmaxf(zu, floor_);
      s.sl[lane] = sl;
      s.su[lane] = su;
      s.zl[lane] = zl;
      s.zu[lane] = zu;
      ax = cone_row(mu, s.x, lane);
    }
    const float t24 = zl - zu;
    __syncwarp();
    // mu_c: both complementarity sums in row order, on every lane
    float sum_l = s.sl[0] * s.zl[0], sum_u = s.su[0] * s.zu[0];
#pragma unroll
    for (int r = 1; r < NCON; ++r) {
      sum_l = sum_l + s.sl[r] * s.zl[r];
      sum_u = sum_u + s.su[r] * s.zu[r];
    }
    const float mu_c = (sum_l + sum_u) / (2.0f * NCON);
    const float mu_t = fmaxf(0.1f * mu_c, p.pdip_mu_min);
    float r_pl = 0.f, r_pu = 0.f, r_cl = 0.f, r_cu = 0.f, d = 0.f, ta = 0.f, tb = 0.f;
    if (row) {
      r_pl = sl - (ax - l_r);
      r_pu = su - (u_r - ax);
      r_cl = sl * zl - mu_t;
      r_cu = su * zu - mu_t;
      d = zl / sl + zu / su;
      ta = (r_cl - zl * r_pl) / sl;
      tb = (r_cu - zu * r_pu) / su;
    }
    // the legs' blocks Uf^T diag(d_leg) Uf: lane l computes leg l & 3's five
    // distinct entries from its six rows, lane l < 28 takes its entry's
    {
      const int base = 6 * (lane & 3);
      const float d0 = __shfl_sync(FULL, d, base), d1 = __shfl_sync(FULL, d, base + 1);
      const float d2 = __shfl_sync(FULL, d, base + 2), d3 = __shfl_sync(FULL, d, base + 3);
      const float d4 = __shfl_sync(FULL, d, base + 4), d5 = __shfl_sync(FULL, d, base + 5);
      const float k00 = d1 * 1.0f + d2 * 1.0f;
      const float k02 = d1 * mu + d2 * -mu;
      const float k11 = d3 * 1.0f + d4 * 1.0f;
      const float k12 = d3 * mu + d4 * -mu;
      const float k22 = ((((d0 * 1.0f + d1 * mu2) + d2 * mu2) + d3 * mu2) + d4 * mu2) +
                        d5 * 1.0f;
      const int src = kleg & 3;
      const float g00 = __shfl_sync(FULL, k00, src), g02 = __shfl_sync(FULL, k02, src);
      const float g11 = __shfl_sync(FULL, k11, src), g12 = __shfl_sync(FULL, k12, src);
      const float g22 = __shfl_sync(FULL, k22, src);
      const float k =
          slot == 0 ? g00 : slot <= 2 ? g02 : slot == 3 ? g11 : slot <= 5 ? g12 : g22;
      float v = s.P[kidx] + k;
      if (p.pdip_reg != 0.f && ka == kc) v = v + p.pdip_reg;
      if (lane < 28) s.Kr[kidx] = v;
    }
    // rhs = -r_dual - Uf^T ta + Uf^T tb, r_dual = P x + qlin - Uf^T (zl - zu)
    {
      const float ct24 = cone_col_gather(mu, t24, lane);
      const float cta = cone_col_gather(mu, ta, lane);
      const float ctb = cone_col_gather(mu, tb, lane);
      if (var) {
        float acc = s.P[NJ * lane] * s.x[0];
#pragma unroll
        for (int k = 1; k < NJ; ++k) acc = fmaf(s.P[NJ * lane + k], s.x[k], acc);
        const float rdual = (acc + s.qlin[lane]) - ct24;
        s.rhs[lane] = (-rdual - cta) + ctb;
      }
    }
    __syncwarp();
    // dx = Kr^{-1} rhs refined once: dx += Kr^{-1} (rhs - Kr dx)
    wl::SpdInv<NJ>::run(s.Kr, NJ, s.Ki, NJ, s.kin.scr);   // KinWBC's scratch is free
    wl::gemv(s.dx, nullptr, 1.f, s.Ki, NJ, 1, s.rhs, 1, NJ, NJ);
    __syncwarp();
    wl::gemv(s.rr, s.rhs, -1.f, s.Kr, NJ, 1, s.dx, 1, NJ, NJ);
    __syncwarp();
    wl::gemv(s.dx, s.dx, 1.f, s.Ki, NJ, 1, s.rr, 1, NJ, NJ);
    __syncwarp();
    // the step: each lane its row's ratios, then the four minima over the rows
    float dsl = 0.f, dsu = 0.f, dzl = 0.f, dzu = 0.f;
    float m_sl = INFINITY, m_su = INFINITY, m_zl = INFINITY, m_zu = INFINITY;
    bool finite = true;
    if (row) {
      const float adx = cone_row(mu, s.dx, lane);
      dsl = adx - r_pl;
      dsu = -adx - r_pu;
      dzl = -(r_cl + zl * dsl) / sl;
      dzu = -(r_cu + zu * dsu) / su;
      m_sl = step_ratio(sl, dsl);
      m_su = step_ratio(su, dsu);
      m_zl = step_ratio(zl, dzl);
      m_zu = step_ratio(zu, dzu);
      finite = isfinite(dsl) && isfinite(dsu) && isfinite(dzl) && isfinite(dzu);
    }
    const float dxj = var ? s.dx[lane] : 0.f;
    if (var) finite = finite && isfinite(dxj);
    for (int off = 16; off > 0; off >>= 1) {
      m_sl = fminf(m_sl, __shfl_xor_sync(FULL, m_sl, off));
      m_su = fminf(m_su, __shfl_xor_sync(FULL, m_su, off));
      m_zl = fminf(m_zl, __shfl_xor_sync(FULL, m_zl, off));
      m_zu = fminf(m_zu, __shfl_xor_sync(FULL, m_zu, off));
    }
    const float tau = p.pdip_tau;
    const float a = fminf(fminf(fminf(1.0f, tau * m_sl), fminf(1.0f, tau * m_su)),
                          fminf(fminf(1.0f, tau * m_zl), fminf(1.0f, tau * m_zu)));
    // late-path NaN freeze: a non-finite Newton step leaves the instance
    // at its current iterate
    if (__all_sync(FULL, finite)) {
      if (var) s.x[lane] = s.x[lane] + a * dxj;
      if (row) {
        sl = sl + a * dsl;
        su = su + a * dsu;
        zl = zl + a * dzl;
        zu = zu + a * dzu;
      }
    }
    __syncwarp();
  }

  // fr = fr_des + dF;  qddot_f += Mmat dF + z0;  tau = (A qddot + b - Jc^T fr)[6:]
  if (lane < NJ) s.fr[lane] = s.fr_des[lane] + s.x[lane];
  if (lane < ND) {
    float zf = 0.f;
    if (lane < 6) {
      float acc = s.Mmat[NJ * lane] * s.x[0];
      for (int k = 1; k < NJ; ++k) acc = fmaf(s.Mmat[NJ * lane + k], s.x[k], acc);
      zf = s.z0[lane] + acc;
    }
    s.qf[lane] = lane < 6 ? s.qddot[lane] + zf : s.qddot[lane];
  }
  __syncwarp();
  if (lane < NJ) {
    const int r = 6 + lane;
    float a1 = s.A[ND * r] * s.qf[0];
    for (int k = 1; k < ND; ++k) a1 = fmaf(s.A[ND * r + k], s.qf[k], a1);
    float a2 = s.Jcm[r] * s.fr[0];
    for (int k = 1; k < NJ; ++k) a2 = fmaf(s.Jcm[ND * k + r], s.fr[k], a2);
    tau_out[NJ * b + lane] = (a1 + s.bvec[r]) - a2;
    fr_out[NJ * b + lane] = s.fr[lane];
  }
}

extern "C" int wbc_launch(
    const float* A, const float* Ainv, const float* bvec, const float* Jc,
    const float* Jcdqd, const float* cmask, const float* R, const float* err,
    const float* vel, const float* cmd, const float* jdqd, const float* fr_des,
    const float* q, float* jpos, float* jvel, float* tau, float* fr, WbcParams p,
    void* stream) {
  wbc_kernel<<<p.B, 64, 0, (cudaStream_t)stream>>>(
      A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel, cmd, jdqd, fr_des, q, jpos, jvel,
      tau, fr, p);
  return (int)cudaGetLastError();
}
