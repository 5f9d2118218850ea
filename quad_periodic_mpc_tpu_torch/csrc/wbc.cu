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
// Decomposition: one warp per instance (one 32-thread block each, grid = B:
// no padding, nothing to mask).  The instance's matrices (masked Jc, the
// 18x18 projectors, the 12x12 Grams and their inverses, JcBar, the QP) sit
// in shared memory, about 12 KB; A and A^{-1} are read from global memory.
// The lanes take the entries of every block product and of each Schur
// step, with __syncwarp() between dependent steps; the 3x3 inverses and the
// PDIP's vector algebra (24 cone rows) are serial on lane 0.
//
// What bounds it on this card: about 0.3 Mflop per instance in a long
// chain of dependent small products (six tasks twice, each an 18x18x3
// projector update, then 15 PDIP iterations each with a 12x12 inverse), and
// about 3.5 KB of inputs per instance.  Neither the card's float32 rate nor
// its bandwidth is the limit: the chain's latency is, at B = 256 (256 warps,
// two per SM) and at B = 1.  Spreading each product over the lanes cuts
// the chain by the width of its output; the serial PDIP vector work is the
// next thing to spread (one lane per cone row).
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.  The Schur
// inverses split at (n+1)/2 as the TPU kernel's _spd_inv_rec does.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_linalg.cuh"

#define ND 18
#define NJ 12
#define NT 6
#define NCON 24

struct WbcParams {
  int B, pdip_iters;
  float damping, w_floating, w_rf, mu, max_fz, pdip_reg, pdip_tau, pdip_mu_min,
      pdip_slack_floor, pdip_big_clamp;
};

struct WbcSmem {
  float R[9], cmask[4];
  float Jcm[NJ * ND];           // stance-masked contact Jacobian
  float Jf[4][3 * ND];          // swing-masked foot task Jacobians
  float Jcdqd_m[NJ], fr_des[NJ];
  float Gram[NJ * NJ], Grami[NJ * NJ];
  float scr[wl::SpdInv<NJ>::kScratch];
  float P18[ND * NJ], Bar[ND * NJ];
  float N[ND * ND];
  float JtPre[3 * ND], NP[ND * 3], pinv[ND * 3], AiJt3[ND * 3];
  float G3[9], G3i[9], t3[3], u3[3], t3b[3];
  float dq[ND], qdot[ND], qddot[ND];
  // relaxation QP
  float resid[6], Affi[36], z0[6], Mmat[6 * NJ], P[NJ * NJ], qlin[NJ];
  float l[NCON], u[NCON];
  float Kr[NJ * NJ], Ki[NJ * NJ], rhs[NJ], dx[NJ], rr[NJ];
  float x[NJ], sl[NCON], su[NCON], zl[NCON], zu[NCON];
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

// blockdiag(Uf x4) x: (12) -> (24), Uf = the 6x3 WBIC friction block
__device__ __forceinline__ void cone_apply(float mu, const float* x, float* out) {
  for (int leg = 0; leg < 4; ++leg) {
    const float fx = x[3 * leg], fy = x[3 * leg + 1], fz = x[3 * leg + 2];
    float* o = out + 6 * leg;
    o[0] = fz;
    o[1] = fz * mu + fx;
    o[2] = fz * mu + fx * -1.0f;
    o[3] = fz * mu + fy;
    o[4] = fz * mu + fy * -1.0f;
    o[5] = fz * -1.0f;
  }
}

// blockdiag(Uf x4)^T v: (24) -> (12)
__device__ __forceinline__ void cone_apply_T(float mu, const float* v, float* out) {
  for (int leg = 0; leg < 4; ++leg) {
    const float* r = v + 6 * leg;
    out[3 * leg] = r[1] + r[2] * -1.0f;
    out[3 * leg + 1] = r[3] + r[4] * -1.0f;
    out[3 * leg + 2] = ((((r[0] + r[1] * mu) + r[2] * mu) + r[3] * mu) + r[4] * mu) +
                       r[5] * -1.0f;
  }
}

// min(1, tau * min over rows of -v/dv for dv < 0)
__device__ __forceinline__ float max_step(const float* v, const float* dv, float tau) {
  float m = INFINITY;
  for (int i = 0; i < NCON; ++i) {
    const float ratio = dv[i] < 0.f ? -v[i] / dv[i] : INFINITY;
    m = i == 0 ? ratio : fminf(m, ratio);
  }
  return fminf(1.0f, tau * m);
}

__device__ __forceinline__ bool all_finite(const float* v, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && isfinite(v[i]);
  return ok;
}

// lam on the diagonal of an n x n matrix (warp)
__device__ __forceinline__ void add_diag(float* M, int n, float lam) {
  for (int i = wl::lane(); i < n; i += 32) M[i * n + i] = M[i * n + i] + lam;
}

__global__ void __launch_bounds__(32) wbc_kernel(
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
  const int lane = wl::lane();
  const float lam = p.damping;
  const float* A = A_in + ND * ND * b;
  const float* Ainv = Ainv_in + ND * ND * b;
  const float* bvec = bvec_in + ND * b;
  const float* Jc = Jc_in + NJ * ND * b;
  const float* err = err_in + ND * b;
  const float* vel = vel_in + ND * b;
  const float* cmd = cmd_in + ND * b;
  const float* jdqd = jdqd_in + ND * b;

  // ---- load and mask ----
  if (lane < 4) s.cmask[lane] = cmask_in[4 * b + lane];
  if (lane < 9) s.R[lane] = R_in[9 * b + lane];
  __syncwarp();
  for (int e = lane; e < NJ * ND; e += 32) {
    const int leg = e / (3 * ND);
    const float c = s.cmask[leg];
    s.Jcm[e] = Jc[e] * c;
    s.Jf[leg][e - leg * 3 * ND] = Jc[e] * (1.0f - c);
  }
  if (lane < NJ) {
    s.Jcdqd_m[lane] = Jcdqd_in[NJ * b + lane] * s.cmask[lane / 3];
    s.fr_des[lane] = frdes_in[NJ * b + lane];
  }
  __syncwarp();

  // ---------------- KinWBC ----------------
  // Nc = I - Jc^T (Jc Jc^T + lam I)^{-1} Jc
  wl::gemm(s.Gram, NJ, nullptr, 0, 1.f, s.Jcm, ND, 1, s.Jcm, 1, ND, NJ, ND, NJ);
  __syncwarp();
  add_diag(s.Gram, NJ, lam);
  __syncwarp();
  wl::SpdInv<NJ>::run(s.Gram, NJ, s.Grami, NJ, s.scr);
  wl::gemm(s.P18, NJ, nullptr, 0, 1.f, s.Jcm, 1, ND, s.Grami, NJ, 1, ND, NJ, NJ);
  __syncwarp();
  wl::gemm(s.N, ND, nullptr, 0, -1.f, s.P18, NJ, 1, s.Jcm, ND, 1, ND, NJ, ND);
  __syncwarp();
  add_diag(s.N, ND, 1.0f);
  __syncwarp();
  for (int i = 0; i < NT; ++i) {
    task_apply(s, i, s.N, ND, ND, s.JtPre);
    __syncwarp();
    wl::gemm(s.G3, 3, nullptr, 0, 1.f, s.JtPre, ND, 1, s.JtPre, 1, ND, 3, ND, 3);
    __syncwarp();
    if (lane == 0) wl::inv3(s.G3, 3, lam, s.G3i, 3);
    __syncwarp();
    wl::gemm(s.pinv, 3, nullptr, 0, 1.f, s.JtPre, 1, ND, s.G3i, 3, 1, ND, 3, 3);
    __syncwarp();
    if (i == 0) {
      wl::gemv(s.dq, nullptr, 1.f, s.pinv, 3, 1, err, 1, ND, 3);
      wl::gemv(s.qdot, nullptr, 1.f, s.pinv, 3, 1, vel, 1, ND, 3);
    } else {
      task_apply(s, i, s.dq, 1, 1, s.u3);
      task_apply(s, i, s.qdot, 1, 1, s.t3b);
      __syncwarp();
      if (lane < 3) {
        s.t3[lane] = err[3 * i + lane] - s.u3[lane];
        s.t3b[lane] = vel[3 * i + lane] - s.t3b[lane];
      }
      __syncwarp();
      wl::gemv(s.dq, s.dq, 1.f, s.pinv, 3, 1, s.t3, 1, ND, 3);
      wl::gemv(s.qdot, s.qdot, 1.f, s.pinv, 3, 1, s.t3b, 1, ND, 3);
    }
    __syncwarp();
    if (i < NT - 1) {           // the last task's projector is never used
      wl::gemm(s.NP, 3, nullptr, 0, 1.f, s.N, ND, 1, s.pinv, 3, 1, ND, ND, 3);
      __syncwarp();
      wl::gemm(s.N, ND, s.N, ND, -1.f, s.NP, 3, 1, s.JtPre, ND, 1, ND, 3, ND);
      __syncwarp();
    }
  }
  if (lane < NJ) {
    jpos_out[NJ * b + lane] = q_in[NJ * b + lane] + s.dq[6 + lane];
    jvel_out[NJ * b + lane] = s.qdot[6 + lane];
  }

  // ---------------- WBIC cascade ----------------
  // JcBar = A^{-1} Jc^T (Jc A^{-1} Jc^T + lam I)^{-1}
  wl::gemm(s.P18, NJ, nullptr, 0, 1.f, Ainv, ND, 1, s.Jcm, 1, ND, ND, ND, NJ);
  __syncwarp();
  wl::gemm(s.Gram, NJ, nullptr, 0, 1.f, s.Jcm, ND, 1, s.P18, NJ, 1, NJ, ND, NJ);
  __syncwarp();
  add_diag(s.Gram, NJ, lam);
  __syncwarp();
  wl::SpdInv<NJ>::run(s.Gram, NJ, s.Grami, NJ, s.scr);
  wl::gemm(s.Bar, NJ, nullptr, 0, 1.f, s.P18, NJ, 1, s.Grami, NJ, 1, ND, NJ, NJ);
  __syncwarp();
  wl::gemv(s.qddot, nullptr, -1.f, s.Bar, NJ, 1, s.Jcdqd_m, 1, ND, NJ);
  wl::gemm(s.N, ND, nullptr, 0, -1.f, s.Bar, NJ, 1, s.Jcm, ND, 1, ND, NJ, ND);
  __syncwarp();
  add_diag(s.N, ND, 1.0f);
  __syncwarp();
  for (int i = 0; i < NT; ++i) {
    task_apply(s, i, s.N, ND, ND, s.JtPre);
    __syncwarp();
    wl::gemm(s.AiJt3, 3, nullptr, 0, 1.f, Ainv, ND, 1, s.JtPre, 1, ND, ND, ND, 3);
    __syncwarp();
    wl::gemm(s.G3, 3, nullptr, 0, 1.f, s.JtPre, ND, 1, s.AiJt3, 3, 1, 3, ND, 3);
    __syncwarp();
    if (lane == 0) wl::inv3(s.G3, 3, lam, s.G3i, 3);
    __syncwarp();
    wl::gemm(s.pinv, 3, nullptr, 0, 1.f, s.AiJt3, 3, 1, s.G3i, 3, 1, ND, 3, 3);
    task_apply(s, i, s.qddot, 1, 1, s.u3);
    __syncwarp();
    if (lane < 3) s.t3[lane] = (cmd[3 * i + lane] - jdqd[3 * i + lane]) - s.u3[lane];
    __syncwarp();
    wl::gemv(s.qddot, s.qddot, 1.f, s.pinv, 3, 1, s.t3, 1, ND, 3);
    __syncwarp();
    if (i < NT - 1) {
      wl::gemm(s.NP, 3, nullptr, 0, 1.f, s.N, ND, 1, s.pinv, 3, 1, ND, ND, 3);
      __syncwarp();
      wl::gemm(s.N, ND, s.N, ND, -1.f, s.NP, 3, 1, s.JtPre, ND, 1, ND, 3, ND);
      __syncwarp();
    }
  }

  // ---------------- relaxation QP ----------------
  // resid = -(A qddot + b - Jc^T fr_des)[0:6];  z_f = A_ff^{-1} (resid + Jc_f^T dF)
  if (lane < 6) {
    float a1 = A[ND * lane] * s.qddot[0];
    for (int k = 1; k < ND; ++k) a1 = fmaf(A[ND * lane + k], s.qddot[k], a1);
    float a2 = s.Jcm[lane] * s.fr_des[0];
    for (int k = 1; k < NJ; ++k) a2 = fmaf(s.Jcm[ND * k + lane], s.fr_des[k], a2);
    s.resid[lane] = -((a1 + bvec[lane]) - a2);
  }
  wl::SpdInv<6>::run(A, ND, s.Affi, 6, s.scr);
  wl::gemv(s.z0, nullptr, 1.f, s.Affi, 6, 1, s.resid, 1, 6, 6);
  wl::gemm(s.Mmat, NJ, nullptr, 0, 1.f, s.Affi, 6, 1, s.Jcm, 1, ND, 6, 6, NJ);
  __syncwarp();
  const float c1 = 2.0f * p.w_floating, c2 = 2.0f * p.w_rf;
  for (int e = lane; e < NJ * NJ; e += 32) {
    const int i = e / NJ, j = e - (e / NJ) * NJ;
    float acc = s.Mmat[i] * s.Mmat[j];
    for (int k = 1; k < 6; ++k) acc = fmaf(s.Mmat[NJ * k + i], s.Mmat[NJ * k + j], acc);
    s.P[e] = c1 * acc + (i == j ? c2 : 0.f);
  }
  if (lane < NJ) {
    float acc = s.Mmat[lane] * s.z0[0];
    for (int k = 1; k < 6; ++k) acc = fmaf(s.Mmat[NJ * k + lane], s.z0[k], acc);
    s.qlin[lane] = c1 * acc;
  }
  if (lane == 0) {
    // l = ieq - Uf fr_des (ieq: -fz_max on row 5 of a stance leg), u = big;
    // degenerate rows opened by 1e-6
    float uf[NCON];
    cone_apply(p.mu, s.fr_des, uf);
    for (int r = 0; r < NCON; ++r) {
      const int leg = r / 6;
      const float base = (r % 6 == 5) ? -(p.max_fz * s.cmask[leg]) : 0.f;
      const float l = base - uf[r];
      float u = p.pdip_big_clamp;
      if (u - l < 1e-6f) u = l + 1e-6f;
      s.l[r] = l;
      s.u[r] = u;
      s.sl[r] = s.su[r] = s.zl[r] = s.zu[r] = 1.0f;
    }
    for (int k = 0; k < NJ; ++k) s.x[k] = 0.f;
  }
  __syncwarp();

  const float mu = p.mu, mu2 = p.mu * p.mu, floor_ = p.pdip_slack_floor;
  float r_pl[NCON], r_pu[NCON], r_cl[NCON], r_cu[NCON];
  for (int it = 0; it < p.pdip_iters; ++it) {
    if (lane == 0) {
      float ax[NCON], t24[NCON], t12[NJ], d[NCON];
      for (int r = 0; r < NCON; ++r) {
        s.sl[r] = fmaxf(s.sl[r], floor_);
        s.su[r] = fmaxf(s.su[r], floor_);
        s.zl[r] = fmaxf(s.zl[r], floor_);
        s.zu[r] = fmaxf(s.zu[r], floor_);
      }
      cone_apply(mu, s.x, ax);
      for (int r = 0; r < NCON; ++r) t24[r] = s.zl[r] - s.zu[r];
      cone_apply_T(mu, t24, t12);
      float rdual[NJ];
      for (int i = 0; i < NJ; ++i) {
        float acc = s.P[NJ * i] * s.x[0];
        for (int k = 1; k < NJ; ++k) acc = fmaf(s.P[NJ * i + k], s.x[k], acc);
        rdual[i] = (acc + s.qlin[i]) - t12[i];
      }
      float sum_l = s.sl[0] * s.zl[0], sum_u = s.su[0] * s.zu[0];
      for (int r = 1; r < NCON; ++r) {
        sum_l = sum_l + s.sl[r] * s.zl[r];
        sum_u = sum_u + s.su[r] * s.zu[r];
      }
      const float mu_c = (sum_l + sum_u) / (2.0f * NCON);
      const float mu_t = fmaxf(0.1f * mu_c, p.pdip_mu_min);
      for (int r = 0; r < NCON; ++r) {
        r_pl[r] = s.sl[r] - (ax[r] - s.l[r]);
        r_pu[r] = s.su[r] - (s.u[r] - ax[r]);
        r_cl[r] = s.sl[r] * s.zl[r] - mu_t;
        r_cu[r] = s.su[r] * s.zu[r] - mu_t;
        d[r] = s.zl[r] / s.sl[r] + s.zu[r] / s.su[r];
      }
      float t12b[NJ];
      for (int r = 0; r < NCON; ++r) t24[r] = (r_cl[r] - s.zl[r] * r_pl[r]) / s.sl[r];
      cone_apply_T(mu, t24, t12);
      for (int r = 0; r < NCON; ++r) t24[r] = (r_cu[r] - s.zu[r] * r_pu[r]) / s.su[r];
      cone_apply_T(mu, t24, t12b);
      for (int i = 0; i < NJ; ++i) s.rhs[i] = (-rdual[i] - t12[i]) + t12b[i];
      // Kr = P + blockdiag(Uf^T diag(d_leg) Uf) + reg I
      for (int e = 0; e < NJ * NJ; ++e) s.Kr[e] = s.P[e];
      for (int leg = 0; leg < 4; ++leg) {
        const float* dl = d + 6 * leg;
        const int o = 3 * leg;
        const float k00 = dl[1] * 1.0f + dl[2] * 1.0f;
        const float k02 = dl[1] * mu + dl[2] * -mu;
        const float k11 = dl[3] * 1.0f + dl[4] * 1.0f;
        const float k12 = dl[3] * mu + dl[4] * -mu;
        const float k22 = ((((dl[0] * 1.0f + dl[1] * mu2) + dl[2] * mu2) + dl[3] * mu2) +
                           dl[4] * mu2) + dl[5] * 1.0f;
        s.Kr[(o) * NJ + o] += k00;
        s.Kr[(o) * NJ + o + 2] += k02;
        s.Kr[(o + 2) * NJ + o] += k02;
        s.Kr[(o + 1) * NJ + o + 1] += k11;
        s.Kr[(o + 1) * NJ + o + 2] += k12;
        s.Kr[(o + 2) * NJ + o + 1] += k12;
        s.Kr[(o + 2) * NJ + o + 2] += k22;
      }
      if (p.pdip_reg != 0.f)
        for (int i = 0; i < NJ; ++i) s.Kr[i * NJ + i] = s.Kr[i * NJ + i] + p.pdip_reg;
    }
    __syncwarp();
    // dx = Kr^{-1} rhs refined once: dx += Kr^{-1} (rhs - Kr dx)
    wl::SpdInv<NJ>::run(s.Kr, NJ, s.Ki, NJ, s.scr);
    wl::gemv(s.dx, nullptr, 1.f, s.Ki, NJ, 1, s.rhs, 1, NJ, NJ);
    __syncwarp();
    wl::gemv(s.rr, s.rhs, -1.f, s.Kr, NJ, 1, s.dx, 1, NJ, NJ);
    __syncwarp();
    wl::gemv(s.dx, s.dx, 1.f, s.Ki, NJ, 1, s.rr, 1, NJ, NJ);
    __syncwarp();
    if (lane == 0) {
      float adx[NCON], dsl[NCON], dsu[NCON], dzl[NCON], dzu[NCON];
      cone_apply(mu, s.dx, adx);
      for (int r = 0; r < NCON; ++r) {
        dsl[r] = adx[r] - r_pl[r];
        dsu[r] = -adx[r] - r_pu[r];
        dzl[r] = -(r_cl[r] + s.zl[r] * dsl[r]) / s.sl[r];
        dzu[r] = -(r_cu[r] + s.zu[r] * dsu[r]) / s.su[r];
      }
      const float tau = p.pdip_tau;
      const float a = fminf(fminf(max_step(s.sl, dsl, tau), max_step(s.su, dsu, tau)),
                            fminf(max_step(s.zl, dzl, tau), max_step(s.zu, dzu, tau)));
      // late-path NaN freeze: a non-finite Newton step leaves the instance
      // at its current iterate
      const bool finite = all_finite(s.dx, NJ) && all_finite(dsl, NCON) &&
                          all_finite(dsu, NCON) && all_finite(dzl, NCON) &&
                          all_finite(dzu, NCON);
      if (finite) {
        for (int k = 0; k < NJ; ++k) s.x[k] = s.x[k] + a * s.dx[k];
        for (int r = 0; r < NCON; ++r) {
          s.sl[r] = s.sl[r] + a * dsl[r];
          s.su[r] = s.su[r] + a * dsu[r];
          s.zl[r] = s.zl[r] + a * dzl[r];
          s.zu[r] = s.zu[r] + a * dzu[r];
        }
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
    const int row = 6 + lane;
    float a1 = A[ND * row] * s.qf[0];
    for (int k = 1; k < ND; ++k) a1 = fmaf(A[ND * row + k], s.qf[k], a1);
    float a2 = s.Jcm[row] * s.fr[0];
    for (int k = 1; k < NJ; ++k) a2 = fmaf(s.Jcm[ND * k + row], s.fr[k], a2);
    tau_out[NJ * b + lane] = (a1 + bvec[row]) - a2;
    fr_out[NJ * b + lane] = s.fr[lane];
  }
}

extern "C" int wbc_launch(
    const float* A, const float* Ainv, const float* bvec, const float* Jc,
    const float* Jcdqd, const float* cmask, const float* R, const float* err,
    const float* vel, const float* cmd, const float* jdqd, const float* fr_des,
    const float* q, float* jpos, float* jvel, float* tau, float* fr, WbcParams p,
    void* stream) {
  wbc_kernel<<<p.B, 32, 0, (cudaStream_t)stream>>>(
      A, Ainv, bvec, Jc, Jcdqd, cmask, R, err, vel, cmd, jdqd, fr_des, q, jpos, jvel,
      tau, fr, p);
  return (int)cudaGetLastError();
}
