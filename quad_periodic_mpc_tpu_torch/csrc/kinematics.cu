// Fused model evaluation and contact kinematics of the A1 floating-base
// tree for Hopper (sm_90a).
//
// Replaces two TPU kernels of quad_periodic_mpc_tpu/ops/pallas/
// kinematics_kernel.py:
//   model_eval_kernel          <- fused_model_eval (_model_kernel): forward
//       kinematics with rotors, the CRBA mass matrix A (massMatrix), A^{-1}
//       by the recursive Schur complement split at (n+1)/2 (18 -> 9+9 ->
//       5+4 -> 3+2 / 2+2, never a Cholesky factorization), generalized
//       gravity and Coriolis, and the contact kinematics: Jc, Jc qdot and the
//       world foot positions;
//   contact_kinematics_kernel  <- fused_contact_kinematics (_kernel): the
//       contact kinematics alone (link chain, no rotors).
// Both share the forward-kinematics and foot-Jacobian device code below.
//
// Transforms keep the TPU kernel's compact (R, r) form (docs/KERNELS.md
// design rule 4): X(R, r) = [[R, 0], [-R [r]x, R]],
//   X2 X1 = X(R2 R1, r1 + R1^T r2),  X v = [R w; R (v - r x w)],
//   X^T [n; f] = [R^T n + r x (R^T f); R^T f],
// so the tree walk is 3x3 products and crosses.  The tree's topology
// (parents, joint axes, gear ratios, contact bodies, gravity) comes in the
// Tree struct; the constant transforms and inertias are read from the
// ModelConstants tensors, and (R, r) of each tree transform is decomposed
// in the kernel ([r]x = -R^T BL).  Rotor terms are kept although A1's gears
// are 1.0.
//
// Decomposition: one warp per instance (one 32-thread block each, grid = B:
// no padding, nothing to mask).  The instance's tree (13 bodies of R, r,
// velocities, bias accelerations, composite inertias) sits in shared
// memory, about 11 KB.  The tree walk is serial (lane 0); the four foot
// Jacobian walks run on lanes 0..3; the 6x6 products of the CRBA sweep,
// the entries of H and every block product of the 18x18 Schur inverse are
// spread over the lanes, with __syncwarp() between dependent steps.
//
// What bounds it on this card: the work is small (about 50 kflop per
// instance, 1.3 KB of output per instance for A and A^{-1}) and serial:
// the tree walk, the CRBA sweep over 12 joints and the inverse's recursion
// are chains of dependent steps of a few dozen flops, so the kernel is
// latency bound at every batch size the stack uses (B = 256 is 256 warps,
// about two per SM; B = 1 is one warp).  The design keeps the whole
// evaluation in one launch and in shared memory and spreads each product's
// entries over the lanes; it does nothing yet to overlap instances.
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math (sinf/cosf of the
// joint angles are the full-precision ones).

#include <cuda_runtime.h>

#include "warp_linalg.cuh"

#define ND 18
#define NB 13

struct Tree {
  int parents[12];
  int axis[12];        // 0 = x, 1 = y
  int gc_body[4];
  float gear[12];
  float gravity[3];
  int B;
};

// Forward kinematics of one instance: link chain (and rotors if kRotors).
struct FK {
  float Rup[NB][9], rup[NB][3], Ra[NB][9], ra[NB][3];
  float v[NB][6], cb[NB][6], avp[NB][6];
  float Rupr[NB][9], rupr[NB][3], vrot[NB][6], crot[NB][6], avprot[NB][6];
};

// ---- serial 3-vector / 3x3 helpers (one lane) ----

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = A[3 * i] * B[j];
      acc = fmaf(A[3 * i + 1], B[3 + j], acc);
      C[3 * i + j] = fmaf(A[3 * i + 2], B[6 + j], acc);
    }
}

__device__ __forceinline__ void mv3(const float* A, const float* x, float* y) {
  for (int i = 0; i < 3; ++i) {
    float acc = A[3 * i] * x[0];
    acc = fmaf(A[3 * i + 1], x[1], acc);
    y[i] = fmaf(A[3 * i + 2], x[2], acc);
  }
}

__device__ __forceinline__ void mtv3(const float* A, const float* x, float* y) {
  for (int i = 0; i < 3; ++i) {
    float acc = A[i] * x[0];
    acc = fmaf(A[3 + i], x[1], acc);
    y[i] = fmaf(A[6 + i], x[2], acc);
  }
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void transpose3(const float* A, float* T) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T[3 * i + j] = A[3 * j + i];
}

__device__ __forceinline__ void skew3(const float* r, float* S) {
  S[0] = 0.f;   S[1] = -r[2]; S[2] = r[1];
  S[3] = r[2];  S[4] = 0.f;   S[5] = -r[0];
  S[6] = -r[1]; S[7] = r[0];  S[8] = 0.f;
}

// X(R, r) [w; v] = [R w; R (v - r x w)]
__device__ __forceinline__ void xapply(const float* R, const float* r,
                                       const float* in, float* out) {
  float rw[3], d[3];
  mv3(R, in, out);
  cross3(r, in, rw);
  for (int k = 0; k < 3; ++k) d[k] = in[3 + k] - rw[k];
  mv3(R, d, out + 3);
}

// X(R, r)^T [n; f] = [R^T n + r x (R^T f); R^T f]
__device__ __forceinline__ void xT_force(const float* R, const float* r,
                                         const float* in, float* out) {
  float Rtf[3], Rtn[3], rx[3];
  mtv3(R, in + 3, Rtf);
  mtv3(R, in, Rtn);
  cross3(r, Rtf, rx);
  for (int k = 0; k < 3; ++k) {
    out[k] = Rtn[k] + rx[k];
    out[3 + k] = Rtf[k];
  }
}

// crf(a) b = [w x bn + v x bf; w x bf]
__device__ __forceinline__ void force_cross(const float* a, const float* b, float* out) {
  float t1[3], t2[3], t3[3];
  cross3(a, b, t1);
  cross3(a + 3, b + 3, t2);
  cross3(a, b + 3, t3);
  for (int k = 0; k < 3; ++k) {
    out[k] = t1[k] + t2[k];
    out[3 + k] = t3[k];
  }
}

// 6x6 matrix (row-major, global) times 6-vector
__device__ __forceinline__ void mv6(const float* M, const float* x, float* y) {
  for (int i = 0; i < 6; ++i) {
    float acc = M[6 * i] * x[0];
    for (int k = 1; k < 6; ++k) acc = fmaf(M[6 * i + k], x[k], acc);
    y[i] = acc;
  }
}

// (R, r) of a motion transform X (6x6 row-major): [r]x = -R^T BL
__device__ __forceinline__ void decomp(const float* X, float* R, float* r) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[3 * i + j] = X[6 * i + j];
  // BL(i, j) = X[6 * (3 + i) + j];  rx(a, b) = -sum_k R(k, a) BL(k, b)
  float acc;
  acc = R[2] * X[19];  acc = fmaf(R[5], X[25], acc); acc = fmaf(R[8], X[31], acc);
  r[0] = -acc;                                        // rx(2, 1)
  acc = R[0] * X[20];  acc = fmaf(R[3], X[26], acc); acc = fmaf(R[6], X[32], acc);
  r[1] = -acc;                                        // rx(0, 2)
  acc = R[1] * X[18];  acc = fmaf(R[4], X[24], acc); acc = fmaf(R[7], X[30], acc);
  r[2] = -acc;                                        // rx(1, 0)
}

// Coordinate rotation about x (axis 0) or y (axis 1)
__device__ __forceinline__ void joint_R(int axis, float q, float* R) {
  const float c = cosf(q), s = sinf(q);
  if (axis == 0) {
    R[0] = 1.f; R[1] = 0.f; R[2] = 0.f;
    R[3] = 0.f; R[4] = c;   R[5] = s;
    R[6] = 0.f; R[7] = -s;  R[8] = c;
  } else {
    R[0] = c;   R[1] = 0.f; R[2] = -s;
    R[3] = 0.f; R[4] = 1.f; R[5] = 0.f;
    R[6] = s;   R[7] = 0.f; R[8] = c;
  }
}

// Unit quaternion (wxyz) -> body->world rotation
__device__ __forceinline__ void quat_to_rotmat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - w * z);
  R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y);
  R[7] = 2.f * (y * z + w * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
}

// The tree walk (forwardKinematics + biasAccelerations).  One lane.
template <bool kRotors>
__device__ void forward_kinematics(const float* quat, const float* pos,
                                   const float* vb, const float* q, const float* qd,
                                   const float* Xtree, const float* Xrot,
                                   const Tree& t, FK& d) {
  float Rbw[9];
  quat_to_rotmat(quat, Rbw);
  transpose3(Rbw, d.Rup[0]);
  for (int k = 0; k < 9; ++k) d.Ra[0][k] = d.Rup[0][k];
  for (int k = 0; k < 3; ++k) d.rup[0][k] = d.ra[0][k] = pos[k];
  for (int k = 0; k < 6; ++k) {
    d.v[0][k] = vb[k];
    d.cb[0][k] = 0.f;
    d.avp[0][k] = 0.f;
  }
  for (int j = 0; j < 12; ++j) {
    const int body = j + 1, parent = t.parents[j], a = t.axis[j];
    float Rt[9], Rj[9], tmp[3];
    decomp(Xtree + 36 * j, Rt, d.rup[body]);
    joint_R(a, q[j], Rj);
    mm3(Rj, Rt, d.Rup[body]);
    mm3(d.Rup[body], d.Ra[parent], d.Ra[body]);
    mtv3(d.Ra[parent], d.rup[body], tmp);
    for (int k = 0; k < 3; ++k) d.ra[body][k] = d.ra[parent][k] + tmp[k];
    // v = Xup v_parent + S qd;  c = v x (S qd) (motion cross, vJ = [a qd; 0])
    float aq[3] = {0.f, 0.f, 0.f};
    aq[a] = qd[j];
    xapply(d.Rup[body], d.rup[body], d.v[parent], d.v[body]);
    d.v[body][a] += qd[j];
    cross3(d.v[body], aq, d.cb[body]);
    cross3(d.v[body] + 3, aq, d.cb[body] + 3);
    if (kRotors) {
      const float gr = t.gear[j];
      float Rtr[9], Rjr[9];
      decomp(Xrot + 36 * j, Rtr, d.rupr[body]);
      joint_R(a, q[j] * gr, Rjr);
      mm3(Rjr, Rtr, d.Rupr[body]);
      float aqr[3] = {0.f, 0.f, 0.f};
      aqr[a] = qd[j] * gr;
      xapply(d.Rupr[body], d.rupr[body], d.v[parent], d.vrot[body]);
      d.vrot[body][a] += qd[j] * gr;
      cross3(d.vrot[body], aqr, d.crot[body]);
      cross3(d.vrot[body] + 3, aqr, d.crot[body] + 3);
    }
  }
  for (int j = 0; j < 12; ++j) {
    const int body = j + 1, parent = t.parents[j];
    xapply(d.Rup[body], d.rup[body], d.avp[parent], d.avp[body]);
    for (int k = 0; k < 6; ++k) d.avp[body][k] += d.cb[body][k];
    if (kRotors) {
      xapply(d.Rupr[body], d.rupr[body], d.avp[parent], d.avprot[body]);
      for (int k = 0; k < 6; ++k) d.avprot[body][k] += d.crot[body][k];
    }
  }
}

// Foot `leg`: Jc rows (3 x 18), Jc qdot (3) and the world foot position (3),
// written to the instance's outputs.  One lane per leg.
__device__ void foot_kinematics(int leg, const FK& d, const Tree& t,
                                const float* gcloc, float* Jc, float* Jcdqd,
                                float* pfoot) {
  const int i0 = t.gc_body[leg];
  const float* loc = gcloc + 3 * leg;
  float Rai[9], ac[6], vc[6], w[3];
  transpose3(d.Ra[i0], Rai);
  xapply(Rai, loc, d.avp[i0], ac);
  xapply(Rai, loc, d.v[i0], vc);
  cross3(vc, vc + 3, w);
  for (int k = 0; k < 3; ++k) Jcdqd[3 * leg + k] = ac[3 + k] + w[k];
  float locx[9], Wl[9], Wr[9], T1[9], T2[9], rx[9];
  skew3(loc, locx);
  mm3(Rai, locx, Wl);
  for (int k = 0; k < 9; ++k) {
    Wl[k] = -Wl[k];
    Wr[k] = Rai[k];
  }
  float* rows = Jc + 3 * leg * ND;
  for (int r = 0; r < 3; ++r)
    for (int c = 6; c < ND; ++c) rows[r * ND + c] = 0.f;
  int i = i0;
  while (i > 0) {
    const int j = i - 1, a = t.axis[j];
    for (int r = 0; r < 3; ++r) rows[r * ND + 6 + j] = Wl[3 * r + a];
    // [Wl | Wr] X(R_i, r_i) = [Wl R - Wr R [r]x | Wr R]
    skew3(d.rup[i], rx);
    mm3(Wr, d.Rup[i], T2);
    mm3(Wl, d.Rup[i], T1);
    mm3(T2, rx, Wr);        // Wr is rebuilt below from T2
    for (int k = 0; k < 9; ++k) {
      Wl[k] = T1[k] - Wr[k];
      Wr[k] = T2[k];
    }
    i = t.parents[j];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      rows[r * ND + c] = Wl[3 * r + c];
      rows[r * ND + 3 + c] = Wr[3 * r + c];
    }
  float p[3];
  mv3(Rai, loc, p);
  for (int k = 0; k < 3; ++k) pfoot[3 * leg + k] = d.ra[i0][k] + p[k];
}

struct ModelSmem {
  FK fk;
  float IC[NB][36];
  float X[36], Xr[36], T[36], T2[36];
  float H[ND * ND], Hi[ND * ND];
  float scr[wl::SpdInv<ND>::kScratch];
  float ag[NB][6], fvp[NB][6], fvprot[NB][6];
};

// Entry e of X(R, r) as a 6x6 matrix: [[R, 0], [-R [r]x, R]]
__device__ __forceinline__ float x66_entry(const float* R, const float* r, int e) {
  const int i = e / 6, c = e - (e / 6) * 6;
  if (i < 3) return c < 3 ? R[3 * i + c] : 0.f;
  if (c >= 3) return R[3 * (i - 3) + c - 3];
  // -(R [r]x)(i-3, c)
  float rx[9];
  skew3(r, rx);
  const int a = i - 3;
  float acc = R[3 * a] * rx[c];
  acc = fmaf(R[3 * a + 1], rx[3 + c], acc);
  acc = fmaf(R[3 * a + 2], rx[6 + c], acc);
  return -acc;
}

__global__ void __launch_bounds__(32) model_eval_kernel(
    const float* __restrict__ quat, const float* __restrict__ pos,
    const float* __restrict__ vb, const float* __restrict__ q,
    const float* __restrict__ qd, const float* __restrict__ Xtree,
    const float* __restrict__ Xrot, const float* __restrict__ Ilink,
    const float* __restrict__ Irot, const float* __restrict__ Ibase,
    const float* __restrict__ gcloc, float* __restrict__ A_out,
    float* __restrict__ Ainv_out, float* __restrict__ G_out,
    float* __restrict__ C_out, float* __restrict__ Jc_out,
    float* __restrict__ Jcdqd_out, float* __restrict__ pfoot_out, const Tree t) {
  __shared__ ModelSmem s;
  const int b = blockIdx.x;
  const int lane = wl::lane();
  FK& d = s.fk;

  if (lane == 0)
    forward_kinematics<true>(quat + 4 * b, pos + 3 * b, vb + 6 * b, q + 12 * b,
                             qd + 12 * b, Xtree, Xrot, t, d);
  // composite inertias start from the link inertias
  for (int e = lane; e < NB * 36; e += 32) {
    const int body = e / 36, k = e - body * 36;
    s.IC[body][k] = body == 0 ? Ibase[k] : Ilink[36 * (body - 1) + k];
  }
  __syncwarp();

  if (lane < 4)
    foot_kinematics(lane, d, t, gcloc, Jc_out + 12 * ND * b, Jcdqd_out + 12 * b,
                    pfoot_out + 12 * b);

  // ---- CRBA sweep, tips to base:
  //      IC[parent] += X^T IC[body] X + Xr^T I_rotor Xr ----
  for (int j = 11; j >= 0; --j) {
    const int body = j + 1, parent = t.parents[j];
    for (int e = lane; e < 36; e += 32) {
      s.X[e] = x66_entry(d.Rup[body], d.rup[body], e);
      s.Xr[e] = x66_entry(d.Rupr[body], d.rupr[body], e);
    }
    __syncwarp();
    wl::gemm(s.T, 6, nullptr, 0, 1.f, s.IC[body], 6, 1, s.X, 6, 1, 6, 6, 6);
    wl::gemm(s.T2, 6, nullptr, 0, 1.f, Irot + 36 * j, 6, 1, s.Xr, 6, 1, 6, 6, 6);
    __syncwarp();
    for (int e = lane; e < 36; e += 32) {
      const int i = e / 6, c = e - (e / 6) * 6;
      float a1 = s.X[i] * s.T[c], a2 = s.Xr[i] * s.T2[c];
      for (int k = 1; k < 6; ++k) {
        a1 = fmaf(s.X[6 * k + i], s.T[6 * k + c], a1);
        a2 = fmaf(s.Xr[6 * k + i], s.T2[6 * k + c], a2);
      }
      s.IC[parent][e] = (s.IC[parent][e] + a1) + a2;
    }
    __syncwarp();
  }

  // ---- H assembly: base block, then one lane per joint walks to the base ----
  wl::fill(s.H, ND * ND, 0.f);
  __syncwarp();
  for (int e = lane; e < 36; e += 32) s.H[(e / 6) * ND + e % 6] = s.IC[0][e];
  if (lane < 12) {
    const int j = lane, body = j + 1, a = t.axis[j];
    const float gr = t.gear[j];
    const float* Ir = Irot + 36 * j;
    float f[6], frot[6], f1[6], f2[6];
    for (int k = 0; k < 6; ++k) {
      f[k] = s.IC[body][6 * k + a];
      frot[k] = Ir[6 * k + a] * gr;
    }
    s.H[(6 + j) * ND + 6 + j] = f[a] + frot[a] * gr;
    xT_force(d.Rup[body], d.rup[body], f, f1);
    xT_force(d.Rupr[body], d.rupr[body], frot, f2);
    for (int k = 0; k < 6; ++k) f[k] = f1[k] + f2[k];
    int i = t.parents[j];
    while (i > 0) {
      const int ji = i - 1;
      const float Hij = f[t.axis[ji]];
      s.H[(6 + ji) * ND + 6 + j] = Hij;
      s.H[(6 + j) * ND + 6 + ji] = Hij;
      xT_force(d.Rup[i], d.rup[i], f, f1);
      for (int k = 0; k < 6; ++k) f[k] = f1[k];
      i = t.parents[ji];
    }
    for (int k = 0; k < 6; ++k) {
      s.H[k * ND + 6 + j] = f[k];
      s.H[(6 + j) * ND + k] = f[k];
    }
  }
  __syncwarp();
  wl::SpdInv<ND>::run(s.H, ND, s.Hi, ND, s.scr);
  for (int e = lane; e < ND * ND; e += 32) {
    A_out[ND * ND * b + e] = s.H[e];
    Ainv_out[ND * ND * b + e] = s.Hi[e];
  }

  if (lane == 0) {
    // ---- generalized gravity (reuses IC) ----
    float* G = G_out + ND * b;
    const float aG[6] = {0.f, 0.f, 0.f, t.gravity[0], t.gravity[1], t.gravity[2]};
    float g0[6], agr[6], ICag[6], Irag[6];
    xapply(d.Rup[0], d.rup[0], aG, s.ag[0]);
    for (int i = 0; i < 6; ++i) {
      float acc = s.IC[0][6 * i] * s.ag[0][0];
      for (int k = 1; k < 6; ++k) acc = fmaf(s.IC[0][6 * i + k], s.ag[0][k], acc);
      g0[i] = -acc;
    }
    for (int k = 0; k < 6; ++k) G[k] = g0[k];
    for (int j = 0; j < 12; ++j) {
      const int body = j + 1, parent = t.parents[j], a = t.axis[j];
      xapply(d.Rup[body], d.rup[body], s.ag[parent], s.ag[body]);
      xapply(d.Rupr[body], d.rupr[body], s.ag[parent], agr);
      for (int i = 0; i < 6; ++i) {
        float acc = s.IC[body][6 * i] * s.ag[body][0];
        for (int k = 1; k < 6; ++k) acc = fmaf(s.IC[body][6 * i + k], s.ag[body][k], acc);
        ICag[i] = acc;
      }
      mv6(Irot + 36 * j, agr, Irag);
      G[6 + j] = -(ICag[a] + t.gear[j] * Irag[a]);
    }

    // ---- generalized Coriolis ----
    float* C = C_out + ND * b;
    float h[6], fc[6], f1[6], f2[6];
    mv6(Ibase, d.v[0], h);
    mv6(Ibase, d.avp[0], s.fvp[0]);
    force_cross(d.v[0], h, fc);
    for (int k = 0; k < 6; ++k) s.fvp[0][k] += fc[k];
    for (int j = 0; j < 12; ++j) {
      const int body = j + 1;
      const float* Il = Ilink + 36 * j;
      const float* Ir = Irot + 36 * j;
      mv6(Il, d.v[body], h);
      mv6(Il, d.avp[body], s.fvp[body]);
      force_cross(d.v[body], h, fc);
      for (int k = 0; k < 6; ++k) s.fvp[body][k] += fc[k];
      mv6(Ir, d.vrot[body], h);
      mv6(Ir, d.avprot[body], s.fvprot[body]);
      force_cross(d.vrot[body], h, fc);
      for (int k = 0; k < 6; ++k) s.fvprot[body][k] += fc[k];
    }
    for (int j = 11; j >= 0; --j) {
      const int body = j + 1, parent = t.parents[j], a = t.axis[j];
      C[6 + j] = s.fvp[body][a] + t.gear[j] * s.fvprot[body][a];
      xT_force(d.Rup[body], d.rup[body], s.fvp[body], f1);
      xT_force(d.Rupr[body], d.rupr[body], s.fvprot[body], f2);
      for (int k = 0; k < 6; ++k) s.fvp[parent][k] = (s.fvp[parent][k] + f1[k]) + f2[k];
    }
    for (int k = 0; k < 6; ++k) C[k] = s.fvp[0][k];
  }
}

__global__ void __launch_bounds__(32) contact_kinematics_kernel(
    const float* __restrict__ quat, const float* __restrict__ pos,
    const float* __restrict__ vb, const float* __restrict__ q,
    const float* __restrict__ qd, const float* __restrict__ Xtree,
    const float* __restrict__ gcloc, float* __restrict__ Jc_out,
    float* __restrict__ Jcdqd_out, float* __restrict__ pfoot_out, const Tree t) {
  __shared__ FK d;
  const int b = blockIdx.x;
  const int lane = wl::lane();
  if (lane == 0)
    forward_kinematics<false>(quat + 4 * b, pos + 3 * b, vb + 6 * b, q + 12 * b,
                              qd + 12 * b, Xtree, nullptr, t, d);
  __syncwarp();
  if (lane < 4)
    foot_kinematics(lane, d, t, gcloc, Jc_out + 12 * ND * b, Jcdqd_out + 12 * b,
                    pfoot_out + 12 * b);
}

extern "C" int model_eval_launch(
    const float* quat, const float* pos, const float* vb, const float* q,
    const float* qd, const float* Xtree, const float* Xrot, const float* Ilink,
    const float* Irot, const float* Ibase, const float* gcloc, float* A,
    float* Ainv, float* G, float* C, float* Jc, float* Jcdqd, float* pfoot,
    Tree t, void* stream) {
  model_eval_kernel<<<t.B, 32, 0, (cudaStream_t)stream>>>(
      quat, pos, vb, q, qd, Xtree, Xrot, Ilink, Irot, Ibase, gcloc, A, Ainv, G, C,
      Jc, Jcdqd, pfoot, t);
  return (int)cudaGetLastError();
}

extern "C" int contact_kinematics_launch(
    const float* quat, const float* pos, const float* vb, const float* q,
    const float* qd, const float* Xtree, const float* gcloc, float* Jc,
    float* Jcdqd, float* pfoot, Tree t, void* stream) {
  contact_kinematics_kernel<<<t.B, 32, 0, (cudaStream_t)stream>>>(
      quat, pos, vb, q, qd, Xtree, gcloc, Jc, Jcdqd, pfoot, t);
  return (int)cudaGetLastError();
}
