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
// so the tree walk is 3x3 products and crosses.  The tree is the A1's:
// four legs, each a chain of three joints (joint 3l, the hip, hangs from
// the base; joints 3l + 1 and 3l + 2 from the joint before; the wrapper
// checks it).  Axes, gear ratios and gravity come in the Tree struct; the
// constant transforms and inertias are read from the ModelConstants
// tensors, and (R, r) of each tree transform is decomposed in the kernel
// ([r]x = -R^T BL).  Rotor terms are kept although A1's gears are 1.0.
//
// Decomposition of model_eval_kernel: one 96-thread block (three warps)
// per instance, grid = B, the instance's tree (13 bodies of R, r,
// velocities, bias accelerations, composite inertias), the staged
// inertias, the 6x6 transforms of the CRBA and the 18x18 pair in 21,248 B
// of shared memory.  Three phases, a __syncthreads() after each of the
// first two:
//   0. lanes 0..23 of warp 0 decompose the 12 joints' link and rotor
//      transforms (one each: R, r and the joint rotation), lane 24 the
//      base; lanes 0..23 of warp 1 decompose the same transforms and write
//      them out as the CRBA's 6x6 X and Xr; warp 2 stages the link, rotor
//      and base inertias;
//   1. warp 0: a leg per lane (lanes 0..3) walks the leg's three bodies
//      (link and rotor velocities, bias accelerations, world transforms),
//      then the leg's foot Jacobian, Jc qdot and foot position.  Warp 1:
//      the CRBA sweep with the four legs side by side (each level's
//      products over the lanes, a __syncwarp() between levels; the hips'
//      terms go into IC[0] in the order j = 9, 6, 3, 0, as the serial sweep
//      adds them).  Warp 2: a leg per lane walks the gravity accelerations
//      and the rotors' I_rotor a_g;
//   2. warp 0: Coriolis (a lane per body and per rotor for I v, I a_vp and
//      the force cross, then a leg per lane back to the base, summed there
//      in the serial order); warp 1: H assembly (a lane per joint) and
//      A^{-1} (wl::SpdInv<18>); warp 2: generalized gravity (a lane per
//      entry).
// Every output entry is the same sequence of f32 operations as in the
// serial walk (only who computes it, and when, changed), so the outputs
// are those of a one-lane walk bit for bit.
//
// contact_kinematics_kernel: one warp per instance, lanes 0..11 the link
// transforms, then a leg per lane for the walk and the foot.
//
// What bounds it on this card: the work is small (about 50 kflop per
// instance, 1.3 KB of output per instance for A and A^{-1}) and serial:
// the legs' walks, the CRBA's three levels and the inverse's recursion are
// chains of dependent steps of a few dozen flops, so the kernel is latency
// bound at every batch size the stack uses (B = 256 is 256 blocks, about
// two per SM; B = 1 is one).  The design shortens the chain: the four
// legs' walks side by side, the CRBA beside them on its own warp, Coriolis
// and gravity beside the inverse, and constants read once, coalesced.  On
// an H100 the launch with phase 0, phase 1 and phase 2 take about 0.004 ms
// each (the inverse 0.003 of phase 2; tools/time_tick_cuda.py).
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math (sinf/cosf of the
// joint angles are the full-precision ones).

#include <cuda_runtime.h>

#include "warp_linalg.cuh"

#define ND 18
#define NB 13
#define NJ 12

struct Tree {
  int parents[12];     // the A1's (see above): the wrapper checks, the kernel assumes
  int axis[12];        // 0 = x, 1 = y
  int gc_body[4];      // the calves 3, 6, 9, 12: likewise
  float gear[12];
  float gravity[3];
  int B;
};

// Joint j moves body j + 1; its parent body is the base for a hip (j = 3l)
// and body j otherwise.
__device__ __forceinline__ int parent_of(int j) { return j % 3 == 0 ? 0 : j; }

// Forward kinematics of one instance: link chain (and rotors).
struct FK {
  float Rup[NB][9], rup[NB][3], Ra[NB][9], ra[NB][3];
  float v[NB][6], avp[NB][6];
  float Rupr[NB][9], rupr[NB][3], vrot[NB][6], avprot[NB][6];
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

// (R, r) of a joint's tree (or rotor) transform at angle q: one lane.
__device__ __forceinline__ void joint_transform(const float* X, int axis, float q, float* R,
                                                float* r) {
  float Rt[9], Rj[9];
  decomp(X, Rt, r);
  joint_R(axis, q, Rj);
  mm3(Rj, Rt, R);
}

// The base body: X_up = (R_bw^T, pos), v = v_body, no bias acceleration.
__device__ __forceinline__ void base_body(const float* quat, const float* pos,
                                          const float* vb, FK& d) {
  float Rbw[9];
  quat_to_rotmat(quat, Rbw);
  transpose3(Rbw, d.Rup[0]);
  for (int k = 0; k < 9; ++k) d.Ra[0][k] = d.Rup[0][k];
  for (int k = 0; k < 3; ++k) d.rup[0][k] = d.ra[0][k] = pos[k];
  for (int k = 0; k < 6; ++k) {
    d.v[0][k] = vb[k];
    d.avp[0][k] = 0.f;
  }
}

// The walk of leg `leg` (forwardKinematics + biasAccelerations on its three
// bodies), after joint_transform and base_body.  One lane.
template <bool kRotors>
__device__ void leg_chain(int leg, const float* qd, const Tree& t, FK& d) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = 3 * leg + k, body = j + 1, parent = parent_of(j), a = t.axis[j];
    const float qdj = qd[j];
    float tmp[3], cb[6];
    mm3(d.Rup[body], d.Ra[parent], d.Ra[body]);
    mtv3(d.Ra[parent], d.rup[body], tmp);
    for (int m = 0; m < 3; ++m) d.ra[body][m] = d.ra[parent][m] + tmp[m];
    // v = Xup v_parent + S qd;  c = v x (S qd) (motion cross, vJ = [a qd; 0])
    const float aq[3] = {a == 0 ? qdj : 0.f, a == 1 ? qdj : 0.f, 0.f};
    xapply(d.Rup[body], d.rup[body], d.v[parent], d.v[body]);
    d.v[body][a] += qdj;
    cross3(d.v[body], aq, cb);
    cross3(d.v[body] + 3, aq, cb + 3);
    xapply(d.Rup[body], d.rup[body], d.avp[parent], d.avp[body]);
    for (int m = 0; m < 6; ++m) d.avp[body][m] += cb[m];
    if (kRotors) {
      const float gr = t.gear[j];
      const float aqr[3] = {a == 0 ? qdj * gr : 0.f, a == 1 ? qdj * gr : 0.f, 0.f};
      float crot[6];
      xapply(d.Rupr[body], d.rupr[body], d.v[parent], d.vrot[body]);
      d.vrot[body][a] += qdj * gr;
      cross3(d.vrot[body], aqr, crot);
      cross3(d.vrot[body] + 3, aqr, crot + 3);
      xapply(d.Rupr[body], d.rupr[body], d.avp[parent], d.avprot[body]);
      for (int m = 0; m < 6; ++m) d.avprot[body][m] += crot[m];
    }
  }
}

// Foot `leg`: Jc rows (3 x 18), Jc qdot (3) and the world foot position (3),
// written to the instance's outputs, after the leg's walk.  One lane.
__device__ void foot_kinematics(int leg, const FK& d, const Tree& t,
                                const float* gcloc, float* Jc, float* Jcdqd,
                                float* pfoot) {
  const int i0 = 3 * leg + 3;       // the calf
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
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    const int j = 3 * leg + k, i = j + 1, a = t.axis[j];
    for (int r = 0; r < 3; ++r) rows[r * ND + 6 + j] = a == 0 ? Wl[3 * r] : Wl[3 * r + 1];
    // [Wl | Wr] X(R_i, r_i) = [Wl R - Wr R [r]x | Wr R]
    skew3(d.rup[i], rx);
    mm3(Wr, d.Rup[i], T2);
    mm3(Wl, d.Rup[i], T1);
    mm3(T2, rx, Wr);        // Wr is rebuilt below from T2
    for (int m = 0; m < 9; ++m) {
      Wl[m] = T1[m] - Wr[m];
      Wr[m] = T2[m];
    }
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
  float Il[NJ][36], Ir[NJ][36], Ib[36];   // link, rotor and base inertias
  float IC[NB][36];                       // composite inertias
  float X[NJ][36], Xr[NJ][36], T[NJ][36], T2[NJ][36];
  float hip[4][2][36];                    // each hip's two terms into IC[0]
  float H[ND * ND], Hi[ND * ND];
  float scr[wl::SpdInv<ND>::kScratch];
  float ag[NB][6], Irag[NJ];              // gravity: a_g by body, (I_rotor a_g,r)[axis]
  float fvp[NB][6], fvprot[NB][6], hipf[4][12];   // Coriolis
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


// Entry e of the 6x6 product A B: one lane's sum in k order.
__device__ __forceinline__ float m6_entry(const float* A, const float* B, int e) {
  const int i = e / 6, c = e - (e / 6) * 6;
  float acc = A[6 * i] * B[c];
  for (int k = 1; k < 6; ++k) acc = fmaf(A[6 * i + k], B[6 * k + c], acc);
  return 1.f * acc;
}

// Entry e of X^T T + Xr^T T2 added to IC: (IC + sum X T) + sum Xr T2.
__device__ __forceinline__ float crba_entry(float ic, const float* X, const float* T,
                                            const float* Xr, const float* T2, int e) {
  const int i = e / 6, c = e - (e / 6) * 6;
  float a1 = X[i] * T[c], a2 = Xr[i] * T2[c];
  for (int k = 1; k < 6; ++k) {
    a1 = fmaf(X[6 * k + i], T[6 * k + c], a1);
    a2 = fmaf(Xr[6 * k + i], T2[6 * k + c], a2);
  }
  return (ic + a1) + a2;
}

// CRBA sweep, tips to base: IC[parent] += X^T IC[body] X + Xr^T I_rotor Xr,
// the four legs side by side, from X and Xr built in phase 0.  The whole of
// one warp.
__device__ void crba(ModelSmem& s) {
  const int lane = wl::lane();
  // T2 = I_rotor Xr of every joint; T = IC X of the calves
  for (int e = lane; e < (NJ + 4) * 36; e += 32) {
    const int n = e / 36, k = e - n * 36;
    if (n < NJ) {
      s.T2[n][k] = m6_entry(s.Ir[n], s.Xr[n], k);
    } else {
      const int j = 3 * (n - NJ) + 2;
      s.T[j][k] = m6_entry(s.IC[j + 1], s.X[j], k);
    }
  }
  __syncwarp();
  // calves into thighs, then thighs into hips
  for (int level = 2; level >= 1; --level) {
    for (int e = lane; e < 4 * 36; e += 32) {
      const int leg = e / 36, k = e - leg * 36, j = 3 * leg + level;
      s.IC[j][k] = crba_entry(s.IC[j][k], s.X[j], s.T[j], s.Xr[j], s.T2[j], k);
    }
    __syncwarp();
    for (int e = lane; e < 4 * 36; e += 32) {
      const int leg = e / 36, k = e - leg * 36, j = 3 * leg + level - 1;
      s.T[j][k] = m6_entry(s.IC[j + 1], s.X[j], k);
    }
    __syncwarp();
  }
  // the hips' terms, then into the base in the serial order j = 9, 6, 3, 0
  for (int e = lane; e < 4 * 36; e += 32) {
    const int leg = e / 36, k = e - leg * 36, i = k / 6, c = k - (k / 6) * 6, j = 3 * leg;
    float a1 = s.X[j][i] * s.T[j][c], a2 = s.Xr[j][i] * s.T2[j][c];
    for (int m = 1; m < 6; ++m) {
      a1 = fmaf(s.X[j][6 * m + i], s.T[j][6 * m + c], a1);
      a2 = fmaf(s.Xr[j][6 * m + i], s.T2[j][6 * m + c], a2);
    }
    s.hip[leg][0][k] = a1;
    s.hip[leg][1][k] = a2;
  }
  __syncwarp();
  for (int e = lane; e < 36; e += 32) {
    float v = s.IC[0][e];
    for (int leg = 3; leg >= 0; --leg) v = (v + s.hip[leg][0][e]) + s.hip[leg][1][e];
    s.IC[0][e] = v;
  }
}

// Leg `leg`'s gravity accelerations a_g (base: X_up a_gravity) and its
// rotors' (I_rotor Xr a_g,parent)[axis].  One lane.
__device__ void gravity_chain(int leg, const Tree& t, ModelSmem& s) {
  const FK& d = s.fk;
  const float aG[6] = {0.f, 0.f, 0.f, t.gravity[0], t.gravity[1], t.gravity[2]};
  float agp[6], agr[6], Irag[6];
  xapply(d.Rup[0], d.rup[0], aG, agp);
  if (leg == 0)
    for (int m = 0; m < 6; ++m) s.ag[0][m] = agp[m];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = 3 * leg + k, body = j + 1, a = t.axis[j];
    xapply(d.Rup[body], d.rup[body], agp, s.ag[body]);
    xapply(d.Rupr[body], d.rupr[body], agp, agr);
    mv6(s.Ir[j], agr, Irag);
    s.Irag[j] = a == 0 ? Irag[0] : Irag[1];
    for (int m = 0; m < 6; ++m) agp[m] = s.ag[body][m];
  }
}

// H assembly (base block, then one lane per joint walks to the base) and
// A^{-1}; stores A and A^{-1}.  The whole of one warp.
__device__ void mass_matrix(const Tree& t, ModelSmem& s, float* A_out, float* Ainv_out) {
  const FK& d = s.fk;
  const int lane = wl::lane();
  wl::fill(s.H, ND * ND, 0.f);
  __syncwarp();
  for (int e = lane; e < 36; e += 32) s.H[(e / 6) * ND + e % 6] = s.IC[0][e];
  if (lane < NJ) {
    const int j = lane, body = j + 1, a = t.axis[j];
    const float gr = t.gear[j];
    const float* Ir = s.Ir[j];
    float f[6], frot[6], f1[6], f2[6];
    for (int k = 0; k < 6; ++k) {
      f[k] = s.IC[body][6 * k + a];
      frot[k] = Ir[6 * k + a] * gr;
    }
    const float fa = a == 0 ? f[0] : f[1], fra = a == 0 ? frot[0] : frot[1];
    s.H[(6 + j) * ND + 6 + j] = fa + fra * gr;
    xT_force(d.Rup[body], d.rup[body], f, f1);
    xT_force(d.Rupr[body], d.rupr[body], frot, f2);
    for (int k = 0; k < 6; ++k) f[k] = f1[k] + f2[k];
    for (int i = parent_of(j); i > 0; i = parent_of(i - 1)) {
      const int ji = i - 1;
      const float Hij = t.axis[ji] == 0 ? f[0] : f[1];
      s.H[(6 + ji) * ND + 6 + j] = Hij;
      s.H[(6 + j) * ND + 6 + ji] = Hij;
      xT_force(d.Rup[i], d.rup[i], f, f1);
      for (int k = 0; k < 6; ++k) f[k] = f1[k];
    }
    for (int k = 0; k < 6; ++k) {
      s.H[k * ND + 6 + j] = f[k];
      s.H[(6 + j) * ND + k] = f[k];
    }
  }
  __syncwarp();
  for (int e = lane; e < ND * ND; e += 32) A_out[e] = s.H[e];
  wl::SpdInv<ND>::run(s.H, ND, s.Hi, ND, s.scr);
  for (int e = lane; e < ND * ND; e += 32) Ainv_out[e] = s.Hi[e];
}

// Generalized Coriolis: a lane per body and per rotor, then a leg per lane
// back to the base, summed there in the serial order.  The whole of one warp.
__device__ void coriolis(const Tree& t, ModelSmem& s, float* C) {
  const FK& d = s.fk;
  const int lane = wl::lane();
  if (lane < NB + NJ) {
    const bool rot = lane >= NB;
    const int body = rot ? lane - NB + 1 : lane;
    const float* I = rot ? s.Ir[body - 1] : body == 0 ? s.Ib : s.Il[body - 1];
    const float* v = rot ? d.vrot[body] : d.v[body];
    float* f = rot ? s.fvprot[body] : s.fvp[body];
    float h[6], fc[6];
    mv6(I, v, h);
    mv6(I, rot ? d.avprot[body] : d.avp[body], f);
    force_cross(v, h, fc);
    for (int k = 0; k < 6; ++k) f[k] += fc[k];
  }
  __syncwarp();
  if (lane < 4) {
#pragma unroll
    for (int k = 2; k >= 0; --k) {
      const int j = 3 * lane + k, body = j + 1, a = t.axis[j];
      float f1[6], f2[6];
      C[6 + j] = s.fvp[body][a] + t.gear[j] * s.fvprot[body][a];
      xT_force(d.Rup[body], d.rup[body], s.fvp[body], f1);
      xT_force(d.Rupr[body], d.rupr[body], s.fvprot[body], f2);
      for (int m = 0; m < 6; ++m) {
        if (k > 0) {
          s.fvp[j][m] = (s.fvp[j][m] + f1[m]) + f2[m];
        } else {
          s.hipf[lane][m] = f1[m];
          s.hipf[lane][6 + m] = f2[m];
        }
      }
    }
  }
  __syncwarp();
  if (lane < 6) {
    float v = s.fvp[0][lane];
    for (int leg = 3; leg >= 0; --leg) v = (v + s.hipf[leg][lane]) + s.hipf[leg][6 + lane];
    C[lane] = v;
  }
}

// Generalized gravity (reuses IC): a lane per entry.  One warp.
__device__ void gravity(const Tree& t, const ModelSmem& s, float* G) {
  const int lane = wl::lane();
  if (lane < 6) {
    float acc = s.IC[0][6 * lane] * s.ag[0][0];
    for (int k = 1; k < 6; ++k) acc = fmaf(s.IC[0][6 * lane + k], s.ag[0][k], acc);
    G[lane] = -acc;
  } else if (lane < ND) {
    const int j = lane - 6, body = j + 1, a = t.axis[j];
    float acc = s.IC[body][6 * a] * s.ag[body][0];
    for (int k = 1; k < 6; ++k) acc = fmaf(s.IC[body][6 * a + k], s.ag[body][k], acc);
    G[6 + j] = -(acc + t.gear[j] * s.Irag[j]);
  }
}

__global__ void __launch_bounds__(96) model_eval_kernel(
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
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = wl::lane();
  FK& d = s.fk;

  // ---- phase 0: the joints' transforms and the base (warp 0), the same
  //      transforms as 6x6 X and Xr (warp 1); the inertias staged (warp 2) ----
  if (warp < 2) {
    if (lane < 2 * NJ) {
      const int j = lane % NJ;
      const bool rot = lane >= NJ;
      const float qj = q[12 * b + j];
      float R[9], r[3];
      joint_transform((rot ? Xrot : Xtree) + 36 * j, t.axis[j], rot ? qj * t.gear[j] : qj, R,
                      r);
      if (warp == 0) {
        for (int k = 0; k < 9; ++k) (rot ? d.Rupr : d.Rup)[j + 1][k] = R[k];
        for (int k = 0; k < 3; ++k) (rot ? d.rupr : d.rup)[j + 1][k] = r[k];
      } else {
#pragma unroll
        for (int k = 0; k < 36; ++k) (rot ? s.Xr : s.X)[j][k] = x66_entry(R, r, k);
      }
    } else if (lane == 2 * NJ && warp == 0) {
      base_body(quat + 4 * b, pos + 3 * b, vb + 6 * b, d);
    }
  } else {
    for (int e = lane; e < NB * 36; e += 32) {
      const int body = e / 36, k = e - body * 36;
      if (body == 0) {
        s.IC[0][k] = s.Ib[k] = Ibase[k];
      } else {
        s.IC[body][k] = s.Il[body - 1][k] = Ilink[36 * (body - 1) + k];
        s.Ir[body - 1][k] = Irot[36 * (body - 1) + k];
      }
    }
  }
  __syncthreads();

  // ---- phase 1: the legs' walks and feet | the CRBA | gravity's walk ----
  if (warp == 0) {
    if (lane < 4) {
      leg_chain<true>(lane, qd + 12 * b, t, d);
      foot_kinematics(lane, d, t, gcloc, Jc_out + 12 * ND * b, Jcdqd_out + 12 * b,
                      pfoot_out + 12 * b);
    }
  } else if (warp == 1) {
    crba(s);
  } else if (lane < 4) {
    gravity_chain(lane, t, s);
  }
  __syncthreads();

  // ---- phase 2: Coriolis | H and A^{-1} | gravity ----
  if (warp == 0) {
    coriolis(t, s, C_out + ND * b);
  } else if (warp == 1) {
    mass_matrix(t, s, A_out + ND * ND * b, Ainv_out + ND * ND * b);
  } else {
    gravity(t, s, G_out + ND * b);
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
  if (lane < NJ)
    joint_transform(Xtree + 36 * lane, t.axis[lane], q[12 * b + lane], d.Rup[lane + 1],
                    d.rup[lane + 1]);
  else if (lane == NJ)
    base_body(quat + 4 * b, pos + 3 * b, vb + 6 * b, d);
  __syncwarp();
  if (lane < 4) {
    leg_chain<false>(lane, qd + 12 * b, t, d);
    foot_kinematics(lane, d, t, gcloc, Jc_out + 12 * ND * b, Jcdqd_out + 12 * b,
                    pfoot_out + 12 * b);
  }
}

extern "C" int model_eval_launch(
    const float* quat, const float* pos, const float* vb, const float* q,
    const float* qd, const float* Xtree, const float* Xrot, const float* Ilink,
    const float* Irot, const float* Ibase, const float* gcloc, float* A,
    float* Ainv, float* G, float* C, float* Jc, float* Jcdqd, float* pfoot,
    Tree t, void* stream) {
  model_eval_kernel<<<t.B, 96, 0, (cudaStream_t)stream>>>(
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
