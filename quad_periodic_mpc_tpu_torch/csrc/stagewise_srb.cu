// Fused-build stagewise Riccati-ADMM solve for Hopper (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py
// ::fused_stagewise_solve_srb (_kernel_srb -> _srb_assemble, _solve_body,
// _stage_quu_inverse, _ad_ops).  Per instance it
//   1. assembles the discrete SRB dynamics Ad = I + N, Bd and the affine
//      disturbance term c from (R, r_feet, x_drag, f_est) with the
//      nilpotent-ZOH closed forms (A^2 lives in row 5 only, A^3 = 0);
//   2. runs the sequential backward Riccati from P_h = diag(Q), with each
//      stage's Quu^{-1} from Newton-Schulz: stage h-1 cold (seed I/||Quu||_inf,
//      ns_it rounds); later stages warm from the previous stage's inverse
//      with the alpha = 1.8/(1+r) rescale when r >= 0.9, ns_warm rounds in
//      all, then a 2e-3 residual gate (NaN counts as bad) that restarts a
//      bad stage cold;
//   3. runs `iters` ADMM sweeps: a backward costate sweep (storing
//      v = Pc + p), a forward closed-loop rollout with over-relaxation,
//      the clip to [l, u] and the dual update.
//
// Decomposition: one thread per instance.  The TPU kernel put 128
// instances on the lanes of a vector register and walked chunks in a grid;
// here the kernel masks b < B itself and needs no padding.  Per-stage gains
// (K, Quu^{-1}, P c, v, r_lin, q) and the Riccati carry P live in device
// scratch allocated by the wrapper, laid out instance-minor
// ([stage][row][col][B]) so neighbouring threads touch neighbouring words,
// as neighbouring lanes did.  Per-stage temporaries (Quu, the NS iterate,
// BtP, Qux, ...) are thread-local arrays, which the compiler places in
// local memory (cached in L1/L2, also interleaved per thread).
//
// What bounds it on this card: at h = 10 the solve is a latency-bound
// serial chain of about h * (1 + 2 * iters) = 610 dependent stage steps of
// small FMAs per instance (12x12 and 12x13 block products), not memory
// bandwidth (about 6.5 KB of inputs and outputs per instance).  B = 2048
// fills only 16 blocks of 128 threads on the 132 SMs, one warp per SM
// scheduler, so nothing hides the local-memory latency of each FMA.  This
// simple design does nothing about that beyond keeping the whole solve in
// one launch; spreading one instance over a warp (lanes over the rows of
// each block product) with the gains in shared memory is the next step.
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.  The 20x12 cone
// products A20^T w and A20 u (A20 = kron(I4, F)) are written out per leg:
// the skipped entries of A20 are exact zeros.  The structured Ad contractions
// touch only the 7 live rows {0..5, 11} / columns {6..12} of N = Ad - I, and
// contractions against Bd skip its structurally zero row 12, as on the TPU.
//
// Rescue semantics: a bad stage restarts cold on its own instance.  On the
// TPU the rescue decision was taken per 128-lane chunk and the extra NS
// rounds then ran on every lane of the chunk; the plain PyTorch version
// beside this kernel follows the per-instance rule, so the two agree to
// roundoff.  The difference to the TPU kernel is bounded by the gate.

#include <cuda_runtime.h>
#include <stddef.h>

#define NX 13
#define NU 12
#define NC 20
#define NLIVE 7

// Live rows of N = Ad - I (= live columns of N^T), and live columns of N.
__constant__ int kNRows[NLIVE] = {0, 1, 2, 3, 4, 5, 11};
__constant__ int kNCols[NLIVE] = {6, 7, 8, 9, 10, 11, 12};

struct Params {
  int B, h, iters, ns_it, ns_warm;
  float rho, rho_inv, a, one_minus_a;
  float dt, dt2, dt3;                  // dt, dt^2/2, dt^3/6
  float dt_inv_m, dt2_inv_m, dt3_inv_m;
  float d0, d1, d2;                    // 1 / I_body diagonal
};

// One thread's view of an instance-minor scratch array.
struct Strided {
  float* p;
  size_t s;
  __device__ __forceinline__ float& operator[](size_t i) const { return p[i * s]; }
};

// C = A (n x k) @ B (k x m), row-major, accumulated in k order.
template <int N, int K, int M>
__device__ __forceinline__ void mm(const float* A, const float* B, float* C) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < M; ++j) {
      float acc = A[i * K] * B[j];
      for (int k = 1; k < K; ++k) acc += A[i * K + k] * B[k * M + j];
      C[i * M + j] = acc;
    }
}

// max_i sum_j |E_ij| with E = (I - M) if sub_from_eye, else M  (12 x 12).
__device__ __forceinline__ float inf_norm12(const float* M, bool sub_from_eye) {
  float norm = 0.f;
  for (int i = 0; i < NU; ++i) {
    float row = 0.f;
    for (int j = 0; j < NU; ++j) {
      float e = sub_from_eye ? ((i == j ? 1.f : 0.f) - M[i * NU + j]) : M[i * NU + j];
      row = (j == 0) ? fabsf(e) : row + fabsf(e);
    }
    // jnp.maximum semantics: a NaN row propagates
    norm = (i == 0) ? row : ((row > norm || row != row) ? row : norm);
  }
  return norm;
}

// One Newton-Schulz round X <- X (2I - Quu X); T and W are temporaries.
__device__ __forceinline__ void ns_round(const float* Quu, float* X, float* T, float* W) {
  mm<NU, NU, NU>(Quu, X, T);
  for (int i = 0; i < NU * NU; ++i) T[i] = ((i % (NU + 1)) == 0 ? 2.f : 0.f) - T[i];
  mm<NU, NU, NU>(X, T, W);
  for (int i = 0; i < NU * NU; ++i) X[i] = W[i];
}

__device__ __forceinline__ void cold_seed(const float* Quu, float* X) {
  float norm = inf_norm12(Quu, false);
  for (int i = 0; i < NU * NU; ++i) X[i] = ((i % (NU + 1)) == 0 ? 1.f : 0.f) / norm;
}

// Stage Quu^{-1} into X (X holds the previous stage's inverse when !first).
__device__ void stage_quu_inverse(const float* Quu, float* X, bool first,
                                  int ns_it, int ns_warm, float* T, float* W,
                                  float* M) {
  if (first) {
    cold_seed(Quu, X);
    for (int r = 0; r < ns_it; ++r) ns_round(Quu, X, T, W);
    return;
  }
  mm<NU, NU, NU>(X, Quu, M);                       // M = Xp Quu
  float r = inf_norm12(M, true);
  float alpha = (r < 0.9f) ? 1.f : 1.8f / (1.f + r);
  // round 1 reuses the seed product: X1 = (a Xp) (2I - a M)
  for (int i = 0; i < NU * NU; ++i) {
    T[i] = ((i % (NU + 1)) == 0 ? 2.f : 0.f) - alpha * M[i];
    W[i] = alpha * X[i];
  }
  mm<NU, NU, NU>(W, T, X);
  for (int rr = 0; rr < ns_warm - 1; ++rr) ns_round(Quu, X, T, W);
  mm<NU, NU, NU>(Quu, X, M);                       // residual gate
  float err = inf_norm12(M, true);
  if (!(err < 2e-3f)) {                            // catches NaN too
    cold_seed(Quu, X);
    for (int i = 0; i < NU * NU; ++i) X[i] = isfinite(X[i]) ? X[i] : 0.f;
    for (int rr = 0; rr < ns_it; ++rr) ns_round(Quu, X, T, W);
  }
}

__global__ void __launch_bounds__(128) stagewise_srb_kernel(
    const float* __restrict__ R_in, const float* __restrict__ rf_in,
    const float* __restrict__ xd_in, const float* __restrict__ fe_in,
    const float* __restrict__ x0_in, const float* __restrict__ xref,
    const float* __restrict__ l_in, const float* __restrict__ u_in,
    const float* __restrict__ U0, const float* __restrict__ z0,
    const float* __restrict__ y0, const float* __restrict__ Qv,
    const float* __restrict__ Reff, const float* __restrict__ Fm,
    float* __restrict__ U, float* __restrict__ Z, float* __restrict__ Y,
    float* K_s, float* Minv_s, float* Pc_s, float* v_s, float* r_s,
    float* q_s, float* P_s, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int h = p.h;
  const size_t Bs = (size_t)p.B;

  // ---------------- in-kernel SRB build (_srb_assemble) ----------------
  float Rm[9], RT[9];
  for (int i = 0; i < 9; ++i) Rm[i] = R_in[(size_t)b * 9 + i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) RT[i * 3 + j] = Rm[j * 3 + i];
  const float dinv[3] = {p.d0, p.d1, p.d2};
  float Rd[9], Iinv[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rd[i * 3 + j] = Rm[i * 3 + j] * dinv[j];
  mm<3, 3, 3>(Rd, RT, Iinv);                       // R diag(1/I) R^T
  const float xdrag = xd_in[b];

  float N[NX * NX];                                // N = Ad - I
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

  float Bd[NX * NU];
  for (int i = 0; i < NX * NU; ++i) Bd[i] = 0.f;
  for (int f = 0; f < 4; ++f) {
    const int c0 = 3 * f;
    const float rx = rf_in[(size_t)b * NU + c0], ry = rf_in[(size_t)b * NU + c0 + 1],
                rz = rf_in[(size_t)b * NU + c0 + 2];
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

  float cv[NX];
  {
    const float* fe = fe_in + (size_t)b * 6;
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

  // ---------------- backward Riccati ----------------
  const Strided P{P_s + b, Bs};
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NX; ++j) P[i * NX + j] = (i == j) ? Qv[i] : 0.f;

  float BtP[NU * NX], Quu[NU * NU], X[NU * NU], T[NU * NU], W[NU * NU],
      M[NU * NU], Qux[NU * NX], Kl[NU * NX], AtP[NX * NX], Pn[NX * NX];
  for (int kk = 0; kk < h; ++kk) {
    const int k = h - 1 - kk;
    for (int a = 0; a < NU; ++a)                   // BtP = Bd^T P (k < 12)
      for (int j = 0; j < NX; ++j) {
        float acc = Bd[a] * P[j];
        for (int m = 1; m < NU; ++m) acc += Bd[m * NU + a] * P[m * NX + j];
        BtP[a * NX + j] = acc;
      }
    for (int a = 0; a < NU; ++a)                   // Quu = Reff + BtP Bd
      for (int c = 0; c < NU; ++c) {
        float acc = BtP[a * NX] * Bd[c];
        for (int m = 1; m < NU; ++m) acc += BtP[a * NX + m] * Bd[m * NU + c];
        Quu[a * NU + c] = Reff[a * NU + c] + acc;
      }
    stage_quu_inverse(Quu, X, kk == 0, p.ns_it, p.ns_warm, T, W, M);
    for (int a = 0; a < NU; ++a)                   // Qux = BtP Ad
      for (int j = 0; j < NX; ++j) {
        float acc = BtP[a * NX + j];
        for (int t = 0; t < NLIVE; ++t) {
          const int m = kNRows[t];
          acc += BtP[a * NX + m] * N[m * NX + j];
        }
        Qux[a * NX + j] = acc;
      }
    mm<NU, NU, NX>(X, Qux, Kl);                    // K = Minv Qux
    const Strided Ks{K_s + (size_t)k * NU * NX * Bs + b, Bs};
    const Strided Ms{Minv_s + (size_t)k * NU * NU * Bs + b, Bs};
    const Strided Pcs{Pc_s + (size_t)k * NX * Bs + b, Bs};
    for (int i = 0; i < NU * NX; ++i) Ks[i] = Kl[i];
    for (int i = 0; i < NU * NU; ++i) Ms[i] = X[i];
    for (int i = 0; i < NX; ++i) {                 // Pc = P c
      float acc = P[i * NX] * cv[0];
      for (int j = 1; j < NX; ++j) acc += P[i * NX + j] * cv[j];
      Pcs[i] = acc;
    }
    for (int i = 0; i < NX; ++i)                   // AtP = Ad^T P
      for (int j = 0; j < NX; ++j) {
        float acc = P[i * NX + j];
        for (int t = 0; t < NLIVE; ++t) {
          const int m = kNRows[t];
          acc += N[m * NX + i] * P[m * NX + j];
        }
        AtP[i * NX + j] = acc;
      }
    for (int i = 0; i < NX; ++i)                   // Qm + AtP Ad - Qux^T K
      for (int j = 0; j < NX; ++j) {
        float ata = AtP[i * NX + j];
        for (int t = 0; t < NLIVE; ++t) {
          const int m = kNRows[t];
          ata += AtP[i * NX + m] * N[m * NX + j];
        }
        float qk = Qux[i] * Kl[j];
        for (int a = 1; a < NU; ++a) qk += Qux[a * NX + i] * Kl[a * NX + j];
        Pn[i * NX + j] = ((i == j ? Qv[i] : 0.f) + ata) - qk;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j)
        P[i * NX + j] = (Pn[i * NX + j] + Pn[j * NX + i]) / 2.f;
  }

  // ---------------- ADMM iterations ----------------
  const float* xr = xref + (size_t)b * h * NX;
  for (int k = 0; k < h; ++k) {                    // q_k = -Q xref_{k-1}, q_0 = 0
    const Strided qs{q_s + (size_t)k * NX * Bs + b, Bs};
    for (int i = 0; i < NX; ++i) qs[i] = (k >= 1) ? -(Qv[i] * xr[(k - 1) * NX + i]) : 0.f;
  }
  float qT[NX];
  for (int i = 0; i < NX; ++i) qT[i] = -(Qv[i] * xr[(h - 1) * NX + i]);

  float* Ub = U + (size_t)b * h * NU;
  float* Zb = Z + (size_t)b * h * NC;
  float* Yb = Y + (size_t)b * h * NC;
  for (int i = 0; i < h * NU; ++i) Ub[i] = U0[(size_t)b * h * NU + i];
  for (int i = 0; i < h * NC; ++i) {
    Zb[i] = z0[(size_t)b * h * NC + i];
    Yb[i] = y0[(size_t)b * h * NC + i];
  }
  const float* lb = l_in + (size_t)b * h * NC;
  const float* ub = u_in + (size_t)b * h * NC;
  float F[15];
  for (int i = 0; i < 15; ++i) F[i] = Fm[i];

  float pv[NX], vv[NX], rk[NU], sv[NU], x[NX], xn[NX], ut[NU];
  for (int it = 0; it < p.iters; ++it) {
    // backward costate sweep, fused with r_lin = A20^T (rho z - y)
    for (int i = 0; i < NX; ++i) pv[i] = qT[i];
    for (int kk = 0; kk < h; ++kk) {
      const int k = h - 1 - kk;
      const Strided rs{r_s + (size_t)k * NU * Bs + b, Bs};
      const Strided vs{v_s + (size_t)k * NX * Bs + b, Bs};
      const Strided Pcs{Pc_s + (size_t)k * NX * Bs + b, Bs};
      const Strided Ks{K_s + (size_t)k * NU * NX * Bs + b, Bs};
      const Strided qs{q_s + (size_t)k * NX * Bs + b, Bs};
      for (int g = 0; g < 4; ++g)
        for (int a = 0; a < 3; ++a) {
          float acc = 0.f;
          for (int c = 0; c < 5; ++c) {
            const float w = p.rho * Zb[k * NC + 5 * g + c] - Yb[k * NC + 5 * g + c];
            acc = (c == 0) ? F[a] * w : acc + F[c * 3 + a] * w;
          }
          rk[3 * g + a] = acc;
          rs[3 * g + a] = acc;
        }
      for (int i = 0; i < NX; ++i) {
        vv[i] = Pcs[i] + pv[i];
        vs[i] = vv[i];
      }
      for (int a = 0; a < NU; ++a) {               // Bd^T v - r_k
        float acc = Bd[a] * vv[0];
        for (int m = 1; m < NU; ++m) acc += Bd[m * NU + a] * vv[m];
        sv[a] = acc - rk[a];
      }
      for (int j = 0; j < NX; ++j) {
        float atv = vv[j];                         // Ad^T v
        for (int t = 0; t < NLIVE; ++t) {
          const int m = kNRows[t];
          atv += N[m * NX + j] * vv[m];
        }
        float kts = Ks[j] * sv[0];                 // K^T s
        for (int a = 1; a < NU; ++a) kts += Ks[a * NX + j] * sv[a];
        pv[j] = (qs[j] + atv) - kts;
      }
    }
    // forward closed-loop rollout + relaxed projection and dual update
    for (int i = 0; i < NX; ++i) x[i] = x0_in[(size_t)b * NX + i];
    for (int k = 0; k < h; ++k) {
      const Strided rs{r_s + (size_t)k * NU * Bs + b, Bs};
      const Strided vs{v_s + (size_t)k * NX * Bs + b, Bs};
      const Strided Ks{K_s + (size_t)k * NU * NX * Bs + b, Bs};
      const Strided Ms{Minv_s + (size_t)k * NU * NU * Bs + b, Bs};
      for (int i = 0; i < NX; ++i) vv[i] = vs[i];
      for (int a = 0; a < NU; ++a) {               // Bd^T (Pc + p) - r_k
        float acc = Bd[a] * vv[0];
        for (int m = 1; m < NU; ++m) acc += Bd[m * NU + a] * vv[m];
        sv[a] = acc - rs[a];
      }
      for (int a = 0; a < NU; ++a) {               // u = -K x - Minv s
        float kff = Ms[a * NU] * sv[0];
        for (int c = 1; c < NU; ++c) kff += Ms[a * NU + c] * sv[c];
        float kx = Ks[a * NX] * x[0];
        for (int j = 1; j < NX; ++j) kx += Ks[a * NX + j] * x[j];
        ut[a] = -kx - kff;
      }
      for (int i = 0; i < NX; ++i) {               // x' = Ad x + Bd u + c
        float ax = x[i];
        for (int t = 0; t < NLIVE; ++t) {
          const int m = kNCols[t];
          ax += N[i * NX + m] * x[m];
        }
        float bu = Bd[i * NU] * ut[0];
        for (int a = 1; a < NU; ++a) bu += Bd[i * NU + a] * ut[a];
        xn[i] = (ax + bu) + cv[i];
      }
      for (int a = 0; a < NU; ++a)
        Ub[k * NU + a] = p.a * ut[a] + p.one_minus_a * Ub[k * NU + a];
      for (int g = 0; g < 4; ++g)
        for (int c = 0; c < 5; ++c) {
          float fu = F[c * 3] * ut[3 * g];
          fu += F[c * 3 + 1] * ut[3 * g + 1];
          fu += F[c * 3 + 2] * ut[3 * g + 2];
          const int j = k * NC + 5 * g + c;
          const float z = Zb[j], y = Yb[j];
          const float fur = p.a * fu + p.one_minus_a * z;
          float zn = fur + p.rho_inv * y;
          zn = (zn < lb[j]) ? lb[j] : zn;          // jnp.clip, NaN-propagating
          zn = (zn > ub[j]) ? ub[j] : zn;
          Zb[j] = zn;
          Yb[j] = y + p.rho * (fur - zn);
        }
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
  }
}

extern "C" int stagewise_srb_launch(
    const float* R, const float* rf, const float* xd, const float* fe,
    const float* x0, const float* xref, const float* l, const float* u,
    const float* U0, const float* z0, const float* y0, const float* Q,
    const float* Reff, const float* F, float* U, float* Z, float* Y,
    float* K_s, float* Minv_s, float* Pc_s, float* v_s, float* r_s,
    float* q_s, float* P_s, Params p, void* stream) {
  const int threads = 128;
  const int blocks = (p.B + threads - 1) / threads;
  stagewise_srb_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      R, rf, xd, fe, x0, xref, l, u, U0, z0, y0, Q, Reff, F, U, Z, Y,
      K_s, Minv_s, Pc_s, v_s, r_s, q_s, P_s, p);
  return (int)cudaGetLastError();
}
