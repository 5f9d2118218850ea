// Shared body of the stagewise Riccati-ADMM kernels for Hopper (sm_90a).
//
// The TPU package has one solve body (_solve_body in
// quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py, with
// _stage_quu_inverse, _ad_ops, _srb_assemble and _pack_sym/_unpack_sym)
// behind four entry points.  This header is that body for the port; the
// entry points are
//   stagewise_srb.cu     fused_stagewise_solve_srb (dynamics assembled in
//                        the kernel) and srb_build_dump (the same assembly,
//                        written out),
//   stagewise_solve.cu   fused_stagewise_solve (caller-built Ad, Bd, c; its
//                        dense-Ad variant is stagewise_solve_dense.cu),
//   stagewise_stream.cu  fused_stagewise_solve_stream (the long-horizon
//                        variant with packed Quu^{-1}).
//
// solve_body<SRB_AD, STREAM> runs, for one instance on one warp,
//   1. the sequential backward Riccati from P_h = diag(Q), with each
//      stage's Quu^{-1} from Newton-Schulz: stage h-1 cold (seed
//      I/||Quu||_inf, ns_it rounds); later stages warm from the previous
//      stage's inverse with the alpha = 1.8/(1+r) rescale when r >= 0.9,
//      ns_warm rounds in all, then a 2e-3 residual gate (NaN counts as bad)
//      that restarts a bad stage cold, and adds 1 to *Params::rescues
//      where the entry point passes a counter (null: no count);
//   2. `iters` ADMM sweeps: a backward costate sweep (storing v = Pc + p), a
//      forward closed-loop rollout with over-relaxation, the clip to [l, u]
//      and the dual update.
// SRB_AD: Ad = I + N with N supported on rows {0..5, 11} / columns {6..12}
//   and Bd's row 12 zero (every problem the nilpotent SRB discretisation
//   builds); `A` then holds N and each Ad product is the identity
//   pass-through plus 7 live terms.  Otherwise `A` holds a dense Ad and all
//   13 terms are taken, Bd's row 12 included.
// The affine term is c_k, read per stage where the instance has one per
//   stage (Io::cs), else the one vector cv.
// STREAM: Quu^{-1} is kept as its 78 upper-triangle entries and unpacked
//   where it is used; r_k = A20^T (rho z_k - y_k) and q_k = -Q xref_{k-1} are
//   recomputed in the sweeps instead of stored; U, z, y already hold the
//   warm start and are updated in place.
//
// What bounds it on this card.  Not bytes and not the FMA rate: the solve
// is a chain of h * (1 + 2 iters) dependent stage steps per instance (610 at
// h = 10, ADMM-30; 12,928 at h = 128, ADMM-50), each a handful of 12- and
// 13-term block products, so its time is that chain's latency.  One thread
// per instance (the first port) ran each step as a few thousand dependent
// FMAs out of local memory, ~17 us a step, and at B = 128 filled one SM.
//
// What the warp design does about it.  One warp per instance, one 32-thread
// block each, so B = 128 spreads over 128 SMs and B = 2048 is one wave of
// 16 warps an SM.  The lanes take the entries of each block product
// round-robin (csrc/warp_linalg.cuh's idiom); every entry is still one
// lane's sum in k order, as before, and a __syncwarp() separates a product
// from its reader, so a stage step is a dozen short chains instead of one
// long one.  The instance's working set (N or Ad, Bd, c, the Riccati carry
// P and the stage temporaries; Smem below, ~9 KB) lives in shared memory.
// The per-stage gains go to device memory laid out by instance
// ([instance][stage][record], Rec below), so a warp reads a stage's gains
// as contiguous 16-byte words, and the sweeps copy the next stage's record
// and rows of z, y, l, u, U into a double buffer in shared memory with
// cp.async while the current stage computes (the Hopper form of the TPU
// kernel's stage-block DMA double buffer).  The rescue stays per instance:
// every lane computes the same gate from the same row sums, so the branch
// is warp-uniform.
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.  The 20x12 cone
// products A20^T w and A20 u (A20 = kron(I4, F)) are written out per leg:
// the skipped entries of A20 are exact zeros.
//
// Rescue semantics: a bad stage restarts cold on its own instance.  On the
// TPU the rescue decision was taken per 128-lane chunk and the extra NS
// rounds then ran on every lane of the chunk; the plain PyTorch versions
// follow the per-instance rule, so kernel and plain version agree to
// roundoff.  The difference to the TPU kernel is bounded by the gate.

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "warp_linalg.cuh"

#define NX 13
#define NU 12
#define NC 20
#define NLIVE 7

struct Params {
  int B, h, iters, ns_it, ns_warm;
  int srb_ad, c_per_step;              // entry-point variants (solve, stream)
  float rho, rho_inv, a, one_minus_a;
  float dt, dt2, dt3;                  // dt, dt^2/2, dt^3/6
  float dt_inv_m, dt2_inv_m, dt3_inv_m;
  float d0, d1, d2;                    // 1 / I_body diagonal
  unsigned long long* rescues;         // stages restarted cold, or null
};

// Live rows of N = Ad - I ({0..5, 11}, = live columns of N^T) and its live
// columns ({6..12}).
__device__ __forceinline__ constexpr int n_row(int t) { return t < 6 ? t : 11; }
__device__ __forceinline__ constexpr int n_col(int t) { return 6 + t; }

// One stage's gains in device memory, [instance][stage][kSize] floats.
// Every part starts on a 16-byte boundary.  The backward sweep reads the
// first kBackward floats (K, P c and, resident, q); the forward sweep reads
// the whole record (K, Quu^{-1}, v and, resident, r_lin).
template <bool STREAM>
struct Rec {                           // resident: Quu^{-1} full, r and q stored
  static constexpr int kK = 0, kPc = 156, kQ = 172, kMinv = 188, kV = 332, kR = 348;
  static constexpr int kSize = 360, kBackward = 188;
};
template <>
struct Rec<true> {                     // streamed: Quu^{-1} packed
  static constexpr int kK = 0, kPc = 156, kMinv = 172, kV = 252;
  static constexpr int kSize = 268, kBackward = 172;
};

// A slot of the sweeps' copy pipeline in shared memory: the stage's gain
// record, then its rows of z, y, l, u, the previous U, c and x_ref.  The
// pipeline has kSlots slots: the copy of stage step i + kSlots - 1 is in
// flight while step i computes.
constexpr int kSlZ = Rec<false>::kSize, kSlY = kSlZ + NC, kSlL = kSlY + NC,
              kSlU = kSlL + NC, kSlUo = kSlU + NC, kSlC = kSlUo + NU,
              kSlXr = kSlC + NX, kSlot = 480;
constexpr int kSlots = 2;
static_assert(kSlXr + NX <= kSlot && kSlot % 4 == 0, "stage slot layout");

// One instance's working set.  The Riccati temporaries and the sweeps'
// copy slots are never live together and share storage.
struct alignas(16) Smem {
  union Scratch {
    struct Riccati {
      float BtP[NU * NX], Quu[NU * NU], X0[NU * NU], X1[NU * NU], T[NU * NU],
          M[NU * NU], Qux[NU * NX], K[NU * NX], AtP[NX * NX], Pn[NX * NX];
    } r;
    float slot[kSlots][kSlot];
  } u;
  float A[NX * NX], Bd[NX * NU], cv[NX], P[NX * NX], Qv[NX], Reff[NU * NU], F[15];
  float qT[NX], xa[NX], xb[NX], pv[NX], v[NX], s[NU], ut[NU], rk[NU], rows[NU];
};

// One instance's rows in device memory, and the shared inputs.
struct Io {
  const float* cs;                     // per-stage c (h x 13), or null: sm.cv
  const float *x0, *xr, *lb, *ub;
  const float *U0, *z0, *y0;           // the warm start (null when STREAM)
  const float *Qv, *Reff, *F;
  float *U, *Z, *Y;                    // outputs (STREAM: hold the warm start)
  float* gains;                        // this instance's h gain records
};

// Instance-parallel load of caller-built dynamics: A = N = Ad - I when
// SRB_AD, else Ad; Bd; cv = c (null: per-stage c, cv unused).
template <bool SRB_AD>
__device__ __forceinline__ void load_dynamics(Smem& sm, const float* Ad, const float* Bd,
                                              const float* c) {
  for (int e = wl::lane(); e < NX * NX; e += 32) {
    const float a = Ad[e];
    sm.A[e] = (SRB_AD && (e % (NX + 1)) == 0) ? a - 1.f : a;
  }
  for (int e = wl::lane(); e < NX * NU; e += 32) sm.Bd[e] = Bd[e];
  for (int e = wl::lane(); e < NX; e += 32) sm.cv[e] = c ? c[e] : 0.f;
}

// C = A (n x k) @ B (k x m), row-major, accumulated in k order (one thread;
// srb_assemble's 3x3 products).
template <int N, int K, int M>
__device__ __forceinline__ void mm(const float* A, const float* B, float* C) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < M; ++j) {
      float acc = A[i * K] * B[j];
      for (int k = 1; k < K; ++k) acc += A[i * K + k] * B[k * M + j];
      C[i * M + j] = acc;
    }
}

// In-kernel SRB build (_srb_assemble), on one thread: N = Ad - I (13 x 13),
// Bd (13 x 12) and the affine term cv (13) of one instance from its rotation
// R (9), foot positions rf (12), x-drag and estimated wrench fe (6), with the
// nilpotent-ZOH closed forms (A^2 lives in row 5 only, A^3 = 0).  Kernel 1
// solves on what this returns and srb_build_dump writes it out.
__device__ __forceinline__ void srb_assemble(const float* R_in, const float* rf,
                                             float xdrag, const float* fe,
                                             const Params& p, float* N, float* Bd,
                                             float* cv) {
  float Rm[9], RT[9];
  for (int i = 0; i < 9; ++i) Rm[i] = R_in[i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) RT[i * 3 + j] = Rm[j * 3 + i];
  const float dinv[3] = {p.d0, p.d1, p.d2};
  float Rd[9], Iinv[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rd[i * 3 + j] = Rm[i * 3 + j] * dinv[j];
  mm<3, 3, 3>(Rd, RT, Iinv);                       // R diag(1/I) R^T

  for (int i = 0; i < NX * NX; ++i) N[i] = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) N[i * NX + 6 + j] = p.dt * RT[i * 3 + j];
  N[3 * NX + 9] = p.dt;
  N[4 * NX + 10] = p.dt;
  N[5 * NX + 11] = p.dt;
  N[11 * NX + 9] = p.dt * xdrag;
  N[11 * NX + 12] = p.dt;
  N[5 * NX + 9] = p.dt2 * xdrag;                   // dt^2/2 A^2[5, 9]
  N[5 * NX + 12] = p.dt2;                          // dt^2/2 A^2[5, 12]

  for (int i = 0; i < NX * NU; ++i) Bd[i] = 0.f;
  for (int f = 0; f < 4; ++f) {
    const int c0 = 3 * f;
    const float rx = rf[c0], ry = rf[c0 + 1], rz = rf[c0 + 2];
    const float sk[9] = {0.f, -rz, ry, rz, 0.f, -rx, -ry, rx, 0.f};
    float Tb[9], RTTb[9];
    mm<3, 3, 3>(Iinv, sk, Tb);                     // I^{-1} [r]x
    mm<3, 3, 3>(RT, Tb, RTTb);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        Bd[i * NU + c0 + j] = p.dt2 * RTTb[i * 3 + j];
        Bd[(6 + i) * NU + c0 + j] = p.dt * Tb[i * 3 + j];
      }
    Bd[3 * NU + c0] = p.dt2_inv_m;
    Bd[4 * NU + c0 + 1] = p.dt2_inv_m;
    Bd[5 * NU + c0 + 2] = p.dt2_inv_m;
    Bd[5 * NU + c0] = p.dt3_inv_m * xdrag;
    Bd[9 * NU + c0] = p.dt_inv_m;
    Bd[10 * NU + c0 + 1] = p.dt_inv_m;
    Bd[11 * NU + c0 + 2] = p.dt_inv_m;
    Bd[11 * NU + c0] = p.dt2_inv_m * xdrag;
  }

  for (int i = 0; i < NX; ++i) cv[i] = 0.f;
  for (int i = 0; i < 3; ++i) {
    float rt = RT[i * 3] * fe[0];
    rt += RT[i * 3 + 1] * fe[1];
    rt += RT[i * 3 + 2] * fe[2];
    cv[i] = p.dt2 * rt;
    cv[6 + i] = p.dt * fe[i];
    cv[3 + i] = p.dt2 * fe[3 + i];
    cv[9 + i] = p.dt * fe[3 + i];
  }
  cv[5] = cv[5] + p.dt3 * xdrag * fe[3];
  cv[11] = cv[11] + p.dt2 * xdrag * fe[3];
}

// ---- Ad products (_ad_ops), one entry each: A holds N when SRB_AD, else Ad ----

// (x^T Ad)_j for a row x of 13.
template <bool SRB_AD>
__device__ __forceinline__ float row_times_A(const float* x, const float* A, int j) {
  if constexpr (SRB_AD) {
    float acc = x[j];
    for (int t = 0; t < NLIVE; ++t) acc += x[n_row(t)] * A[n_row(t) * NX + j];
    return acc;
  } else {
    float acc = x[0] * A[j];
    for (int m = 1; m < NX; ++m) acc += x[m] * A[m * NX + j];
    return acc;
  }
}

// (Ad^T P)_ij for a 13 x 13 P.
template <bool SRB_AD>
__device__ __forceinline__ float At_times_P(const float* A, const float* P, int i, int j) {
  if constexpr (SRB_AD) {
    float acc = P[i * NX + j];
    for (int t = 0; t < NLIVE; ++t) acc += A[n_row(t) * NX + i] * P[n_row(t) * NX + j];
    return acc;
  } else {
    float acc = A[i] * P[j];
    for (int m = 1; m < NX; ++m) acc += A[m * NX + i] * P[m * NX + j];
    return acc;
  }
}

// (Ad^T v)_j.
template <bool SRB_AD>
__device__ __forceinline__ float At_times_v(const float* A, const float* v, int j) {
  if constexpr (SRB_AD) {
    float acc = v[j];
    for (int t = 0; t < NLIVE; ++t) acc += A[n_row(t) * NX + j] * v[n_row(t)];
    return acc;
  } else {
    float acc = A[j] * v[0];
    for (int m = 1; m < NX; ++m) acc += A[m * NX + j] * v[m];
    return acc;
  }
}

// (Ad x)_i.
template <bool SRB_AD>
__device__ __forceinline__ float A_times_x(const float* A, const float* x, int i) {
  if constexpr (SRB_AD) {
    float acc = x[i];
    for (int t = 0; t < NLIVE; ++t) acc += A[i * NX + n_col(t)] * x[n_col(t)];
    return acc;
  } else {
    float acc = A[i * NX] * x[0];
    for (int m = 1; m < NX; ++m) acc += A[i * NX + m] * x[m];
    return acc;
  }
}

// (Bd^T v)_a over Bd's first NBD rows.
template <int NBD>
__device__ __forceinline__ float Bt_times_v(const float* Bd, const float* v, int a) {
  float acc = Bd[a] * v[0];
  for (int m = 1; m < NBD; ++m) acc += Bd[m * NU + a] * v[m];
  return acc;
}

// Index of entry (i, j), i <= j, in the packed upper triangle (_SYM_IDX).
__device__ __forceinline__ int sym_idx(int i, int j) {
  return i * NU - (i * (i - 1)) / 2 + (j - i);
}

// Entry e = 3 g + a of r_k = A20^T (rho z_k - y_k).
__device__ __forceinline__ float cone_rlin(const float* F, const float* zk, const float* yk,
                                           float rho, int e) {
  const int g = e / 3, a = e - 3 * g;
  float acc = 0.f;
  for (int c = 0; c < 5; ++c) {
    const float w = rho * zk[5 * g + c] - yk[5 * g + c];
    acc = (c == 0) ? F[a] * w : acc + F[c * 3 + a] * w;
  }
  return acc;
}

// ---- Newton-Schulz on one warp (12 x 12, shared memory) ----

// max_i sum_j |E_ij| with E = (I - M) if sub_from_eye, else M.  Lane i < 12
// sums row i in j order; then every lane takes the max over the rows in row
// order, NaN-propagating as jnp.maximum, so all lanes hold the same value.
__device__ __forceinline__ float inf_norm12(const float* M, bool sub_from_eye, float* rows) {
  const int i = wl::lane();
  if (i < NU) {
    float row = 0.f;
    for (int j = 0; j < NU; ++j) {
      const float e = sub_from_eye ? ((i == j ? 1.f : 0.f) - M[i * NU + j]) : M[i * NU + j];
      row = (j == 0) ? fabsf(e) : row + fabsf(e);
    }
    rows[i] = row;
  }
  __syncwarp();
  float norm = rows[0];
  for (int r = 1; r < NU; ++r) norm = (rows[r] > norm || rows[r] != rows[r]) ? rows[r] : norm;
  __syncwarp();                                    // rows is reused by the next norm
  return norm;
}

// One round X <- X (2I - Quu X) into Xs; swaps X and Xs.
__device__ __forceinline__ void ns_round(const float* Quu, float*& X, float*& Xs, float* T) {
  for (int e = wl::lane(); e < NU * NU; e += 32) {
    const int i = e / NU, j = e - i * NU;
    float acc = Quu[i * NU] * X[j];
    for (int k = 1; k < NU; ++k) acc += Quu[i * NU + k] * X[k * NU + j];
    T[e] = (i == j ? 2.f : 0.f) - acc;
  }
  __syncwarp();
  wl::gemm(Xs, NU, nullptr, 0, 1.f, X, NU, 1, T, NU, 1, NU, NU, NU);
  __syncwarp();
  float* t = X;
  X = Xs;
  Xs = t;
}

// X = I / ||Quu||_inf, non-finite entries zeroed when `zero_nonfinite`.
__device__ __forceinline__ void cold_seed(const float* Quu, float* X, float* rows,
                                          bool zero_nonfinite) {
  const float norm = inf_norm12(Quu, false, rows);
  for (int e = wl::lane(); e < NU * NU; e += 32) {
    const float x = ((e % (NU + 1)) == 0 ? 1.f : 0.f) / norm;
    X[e] = (zero_nonfinite && !isfinite(x)) ? 0.f : x;
  }
  __syncwarp();
}

// Stage Quu^{-1} into X (X holds the previous stage's inverse when !first).
__device__ __forceinline__ void stage_quu_inverse(const float* Quu, float*& X, float*& Xs,
                                                  bool first, int ns_it, int ns_warm,
                                                  float* T, float* M, float* rows,
                                                  unsigned long long* rescues) {
  if (first) {
    cold_seed(Quu, X, rows, false);
    for (int r = 0; r < ns_it; ++r) ns_round(Quu, X, Xs, T);
    return;
  }
  wl::gemm(M, NU, nullptr, 0, 1.f, X, NU, 1, Quu, NU, 1, NU, NU, NU);   // M = Xp Quu
  __syncwarp();
  const float r = inf_norm12(M, true, rows);
  const float alpha = (r < 0.9f) ? 1.f : 1.8f / (1.f + r);
  // round 1 reuses the seed product: X1 = (a Xp) (2I - a M)
  for (int e = wl::lane(); e < NU * NU; e += 32)
    T[e] = ((e % (NU + 1)) == 0 ? 2.f : 0.f) - alpha * M[e];
  __syncwarp();
  for (int e = wl::lane(); e < NU * NU; e += 32) {
    const int i = e / NU, j = e - i * NU;
    float acc = (alpha * X[i * NU]) * T[j];
    for (int k = 1; k < NU; ++k) acc += (alpha * X[i * NU + k]) * T[k * NU + j];
    Xs[e] = acc;
  }
  __syncwarp();
  float* t = X;
  X = Xs;
  Xs = t;
  for (int rr = 0; rr < ns_warm - 1; ++rr) ns_round(Quu, X, Xs, T);
  wl::gemm(M, NU, nullptr, 0, 1.f, Quu, NU, 1, X, NU, 1, NU, NU, NU);   // residual gate
  __syncwarp();
  const float err = inf_norm12(M, true, rows);
  if (!(err < 2e-3f)) {                            // catches NaN too; warp-uniform
    if (rescues != nullptr && wl::lane() == 0) atomicAdd(rescues, 1ull);
    cold_seed(Quu, X, rows, true);
    for (int rr = 0; rr < ns_it; ++rr) ns_round(Quu, X, Xs, T);
  }
}

// The solve of one instance on one warp (see the header note).  Called by
// all 32 lanes after sm.A, sm.Bd and sm.cv are loaded (the call's first
// __syncwarp() orders those writes).
template <bool SRB_AD, bool STREAM>
__device__ __forceinline__ void solve_body(Smem& sm, const Io& io, const Params& p) {
  using R = Rec<STREAM>;
  constexpr int NBD = SRB_AD ? NU : NX;            // Bd's row 12 is zero when SRB_AD
  const int lane = wl::lane();
  const int h = p.h;
  float* const gains = io.gains;                   // record k at gains + k * R::kSize

  for (int e = lane; e < NX; e += 32) sm.Qv[e] = io.Qv[e];
  for (int e = lane; e < NU * NU; e += 32) sm.Reff[e] = io.Reff[e];
  for (int e = lane; e < 15; e += 32) sm.F[e] = io.F[e];
  for (int e = lane; e < NX * NX; e += 32) {
    const int i = e / NX, j = e - i * NX;
    sm.P[e] = (i == j) ? io.Qv[i] : 0.f;
  }
  __syncwarp();

  // ---------------- backward Riccati ----------------
  auto& t = sm.u.r;
  float* X = t.X0;                                 // this stage's (then the last) inverse
  float* Xs = t.X1;
  for (int kk = 0; kk < h; ++kk) {
    const int k = h - 1 - kk;
    float* rec = gains + (size_t)k * R::kSize;
    const float* ck = io.cs ? io.cs + (size_t)k * NX : sm.cv;
    // BtP = Bd^T P, AtP = Ad^T P, and P c_k into the record
    for (int e = lane; e < NU * NX; e += 32) {
      const int a = e / NX, j = e - a * NX;
      float acc = sm.Bd[a] * sm.P[j];
      for (int m = 1; m < NBD; ++m) acc += sm.Bd[m * NU + a] * sm.P[m * NX + j];
      t.BtP[e] = acc;
    }
    for (int e = lane; e < NX * NX; e += 32) {
      const int i = e / NX, j = e - i * NX;
      t.AtP[e] = At_times_P<SRB_AD>(sm.A, sm.P, i, j);
    }
    if (lane < NX) {
      float acc = sm.P[lane * NX] * ck[0];
      for (int j = 1; j < NX; ++j) acc += sm.P[lane * NX + j] * ck[j];
      rec[R::kPc + lane] = acc;
    }
    __syncwarp();
    // Quu = Reff + BtP Bd, Qux = BtP Ad
    for (int e = lane; e < NU * NU; e += 32) {
      const int a = e / NU, c = e - a * NU;
      float acc = t.BtP[a * NX] * sm.Bd[c];
      for (int m = 1; m < NBD; ++m) acc += t.BtP[a * NX + m] * sm.Bd[m * NU + c];
      t.Quu[e] = sm.Reff[e] + acc;
    }
    for (int e = lane; e < NU * NX; e += 32) {
      const int a = e / NX, j = e - a * NX;
      t.Qux[e] = row_times_A<SRB_AD>(t.BtP + a * NX, sm.A, j);
    }
    __syncwarp();
    stage_quu_inverse(t.Quu, X, Xs, kk == 0, p.ns_it, p.ns_warm, t.T, t.M, sm.rows,
                      p.rescues);
    wl::gemm(t.K, NX, nullptr, 0, 1.f, X, NU, 1, t.Qux, NX, 1, NU, NU, NX);   // K = Minv Qux
    __syncwarp();
    // K and Quu^{-1} into the record; Pn = Qm + AtP Ad - Qux^T K
    for (int e = lane; e < NU * NX; e += 32) rec[R::kK + e] = t.K[e];
    for (int e = lane; e < NU * NU; e += 32) {
      if constexpr (STREAM) {
        const int i = e / NU, j = e - i * NU;
        if (i <= j) rec[R::kMinv + sym_idx(i, j)] = X[e];
      } else {
        rec[R::kMinv + e] = X[e];
      }
    }
    for (int e = lane; e < NX * NX; e += 32) {
      const int i = e / NX, j = e - i * NX;
      const float ata = row_times_A<SRB_AD>(t.AtP + i * NX, sm.A, j);
      float qk = t.Qux[i] * t.K[j];
      for (int a = 1; a < NU; ++a) qk += t.Qux[a * NX + i] * t.K[a * NX + j];
      t.Pn[e] = ((i == j ? sm.Qv[i] : 0.f) + ata) - qk;
    }
    __syncwarp();
    for (int e = lane; e < NX * NX; e += 32) {
      const int i = e / NX, j = e - i * NX;
      sm.P[e] = (t.Pn[e] + t.Pn[j * NX + i]) / 2.f;
    }
    __syncwarp();
  }

  // ---------------- ADMM iterations ----------------
  // (the sweeps' slots now take the Riccati temporaries' storage)
  if constexpr (!STREAM) {
    for (int e = lane; e < h * NX; e += 32) {      // q_k = -Q xref_{k-1}, q_0 = 0
      const int k = e / NX, i = e - k * NX;
      gains[(size_t)k * R::kSize + R::kQ + i] =
          (k >= 1) ? -(sm.Qv[i] * io.xr[(k - 1) * NX + i]) : 0.f;
    }
    for (int e = lane; e < h * NU; e += 32) io.U[e] = io.U0[e];
    for (int e = lane; e < h * NC; e += 32) {
      io.Z[e] = io.z0[e];
      io.Y[e] = io.y0[e];
    }
  }
  for (int e = lane; e < NX; e += 32) sm.qT[e] = -(sm.Qv[e] * io.xr[(h - 1) * NX + e]);
  __syncwarp();

  // Copy stage k's record (its first kBackward floats for the backward
  // sweep) and rows into `slot` asynchronously, as one commit group.
  auto fetch = [&](float* slot, int k, bool backward) {
    const float* rec = gains + (size_t)k * R::kSize;
    const int n4 = (backward ? R::kBackward : R::kSize) / 4;
    for (int e = lane; e < n4; e += 32) __pipeline_memcpy_async(slot + 4 * e, rec + 4 * e, 16);
    if (lane < NC) {
      __pipeline_memcpy_async(slot + kSlZ + lane, io.Z + k * NC + lane, 4);
      __pipeline_memcpy_async(slot + kSlY + lane, io.Y + k * NC + lane, 4);
      if (!backward) {
        __pipeline_memcpy_async(slot + kSlL + lane, io.lb + k * NC + lane, 4);
        __pipeline_memcpy_async(slot + kSlU + lane, io.ub + k * NC + lane, 4);
      }
    }
    if (!backward && lane < NU)
      __pipeline_memcpy_async(slot + kSlUo + lane, io.U + k * NU + lane, 4);
    if (!backward && io.cs && lane < NX)
      __pipeline_memcpy_async(slot + kSlC + lane, io.cs + k * NX + lane, 4);
    if (STREAM && backward && k >= 1 && lane < NX)
      __pipeline_memcpy_async(slot + kSlXr + lane, io.xr + (k - 1) * NX + lane, 4);
    __pipeline_commit();
  };
  // Step i of a sweep (stage h-1-i backward, i forward) computes on slot
  // i % kSlots.  The sweep's head starts the copies of its first
  // kSlots - 1 steps; before step i, start the copy of step i + kSlots - 1
  // (an empty group past the sweep's end) and wait for step i's.
  auto stage_of = [&](int i, bool backward) { return backward ? h - 1 - i : i; };
  auto start_sweep = [&](bool backward) {
    for (int j = 0; j < kSlots - 1; ++j) {
      if (j < h) fetch(sm.u.slot[j], stage_of(j, backward), backward);
      else __pipeline_commit();
    }
  };
  auto advance = [&](int i, bool backward) {
    const int j = i + kSlots - 1;
    if (j < h) fetch(sm.u.slot[j % kSlots], stage_of(j, backward), backward);
    else __pipeline_commit();
    __pipeline_wait_prior(kSlots - 1);
    __syncwarp();
  };

  float* x = sm.xa;
  float* xn = sm.xb;
  for (int it = 0; it < p.iters; ++it) {
    // backward costate sweep, fused with r_lin = A20^T (rho z - y)
    for (int e = lane; e < NX; e += 32) sm.pv[e] = sm.qT[e];
    start_sweep(true);
    for (int kk = 0; kk < h; ++kk) {
      const int k = h - 1 - kk;
      const float* S = sm.u.slot[kk % kSlots];
      float* rec = gains + (size_t)k * R::kSize;
      advance(kk, true);
      if (lane < NU) {
        const float r = cone_rlin(sm.F, S + kSlZ, S + kSlY, p.rho, lane);
        sm.rk[lane] = r;
        if constexpr (!STREAM) rec[R::kR + lane] = r;
      } else if (lane < NU + NX) {
        const int i = lane - NU;
        const float v = S[R::kPc + i] + sm.pv[i];
        sm.v[i] = v;
        rec[R::kV + i] = v;
      }
      __syncwarp();
      if (lane < NU) sm.s[lane] = Bt_times_v<NBD>(sm.Bd, sm.v, lane) - sm.rk[lane];
      __syncwarp();
      if (lane < NX) {
        const int j = lane;
        const float atv = At_times_v<SRB_AD>(sm.A, sm.v, j);
        float kts = S[R::kK + j] * sm.s[0];        // K^T s
        for (int a = 1; a < NU; ++a) kts += S[R::kK + a * NX + j] * sm.s[a];
        float qk;
        if constexpr (STREAM) {
          qk = (k >= 1) ? -(sm.Qv[j] * S[kSlXr + j]) : 0.f;
        } else {
          qk = S[R::kQ + j];
        }
        sm.pv[j] = (qk + atv) - kts;
      }
      __syncwarp();
    }
    // forward closed-loop rollout + relaxed projection and dual update
    for (int e = lane; e < NX; e += 32) x[e] = io.x0[e];
    start_sweep(false);
    for (int k = 0; k < h; ++k) {
      const float* S = sm.u.slot[k % kSlots];
      advance(k, false);
      if (lane < NU) {                             // s = Bd^T (Pc + p) - r_k
        float r;
        if constexpr (STREAM) {
          // z_k, y_k are not yet updated for this stage: the r_k the
          // backward sweep used
          r = cone_rlin(sm.F, S + kSlZ, S + kSlY, p.rho, lane);
        } else {
          r = S[R::kR + lane];
        }
        sm.s[lane] = Bt_times_v<NBD>(sm.Bd, S + R::kV, lane) - r;
      }
      __syncwarp();
      if (lane < NU) {                             // u = -K x - Minv s
        const int a = lane;
        const float* Ms = S + R::kMinv;
        float kff;
        if constexpr (STREAM) {
          kff = Ms[sym_idx(0, a)] * sm.s[0];
          for (int c = 1; c < NU; ++c)
            kff += Ms[c < a ? sym_idx(c, a) : sym_idx(a, c)] * sm.s[c];
        } else {
          kff = Ms[a * NU] * sm.s[0];
          for (int c = 1; c < NU; ++c) kff += Ms[a * NU + c] * sm.s[c];
        }
        const float* Ks = S + R::kK + a * NX;
        float kx = Ks[0] * x[0];
        for (int j = 1; j < NX; ++j) kx += Ks[j] * x[j];
        sm.ut[a] = -kx - kff;
      }
      __syncwarp();
      const float* ut = sm.ut;
      if (lane < NX) {                             // x' = Ad x + Bd u + c_k
        const int i = lane;
        const float* ck = io.cs ? S + kSlC : sm.cv;
        const float ax = A_times_x<SRB_AD>(sm.A, x, i);
        float bu = sm.Bd[i * NU] * ut[0];
        for (int a = 1; a < NU; ++a) bu += sm.Bd[i * NU + a] * ut[a];
        xn[i] = (ax + bu) + ck[i];
      }
      if (lane < NU) io.U[k * NU + lane] = p.a * ut[lane] + p.one_minus_a * S[kSlUo + lane];
      if (lane >= NU) {                            // lanes 12..31: the 20 cone rows
        const int j = lane - NU, g = j / 5, c = j - 5 * g;
        float fu = sm.F[c * 3] * ut[3 * g];
        fu += sm.F[c * 3 + 1] * ut[3 * g + 1];
        fu += sm.F[c * 3 + 2] * ut[3 * g + 2];
        const float z = S[kSlZ + j], y = S[kSlY + j];
        const float lb = S[kSlL + j], ub = S[kSlU + j];
        const float fur = p.a * fu + p.one_minus_a * z;
        float zn = fur + p.rho_inv * y;
        zn = (zn < lb) ? lb : zn;                  // jnp.clip, NaN-propagating
        zn = (zn > ub) ? ub : zn;
        io.Z[k * NC + j] = zn;
        io.Y[k * NC + j] = y + p.rho * (fur - zn);
      }
      __syncwarp();
      float* tmp = x;
      x = xn;
      xn = tmp;
    }
  }
}
