// Fused-build stagewise Riccati-ADMM solve, and the audit dump of its build,
// for Hopper (sm_90a).
//
// stagewise_srb_kernel replaces the TPU kernel
// quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py
// ::fused_stagewise_solve_srb (_kernel_srb -> _srb_assemble, _solve_body).
// Per instance it assembles the discrete SRB dynamics Ad = I + N, Bd and the
// affine disturbance term c from (R, r_feet, x_drag, f_est) with
// srb_assemble, then runs solve_body (both in stagewise_body.cuh: the
// backward Riccati with warm gated Newton-Schulz inverses, then `iters`
// ADMM sweeps) with the structured Ad products and the one shared c.
//
// srb_build_dump_kernel replaces ::srb_build_dump (_kernel_srb_dump): it
// calls the same srb_assemble device function and writes Ad, Bd and c out,
// so that a caller can hold the in-kernel build against the independent
// problem build.
//
// Decomposition: one thread per instance.  The TPU kernel put 128
// instances on the lanes of a vector register and walked chunks in a grid;
// here the kernel masks b < B itself and needs no padding.  Per-stage gains
// (K, Quu^{-1}, P c, v, r_lin, q) and the Riccati carry P live in device
// scratch allocated by the wrapper, laid out instance-minor
// ([stage][row][col][B]) so neighbouring threads touch neighbouring words,
// as neighbouring lanes did.
//
// What bounds them on this card.  The solve at h = 10 is a latency-bound
// serial chain of about h * (1 + 2 * iters) = 610 dependent stage steps of
// small FMAs per instance (12x12 and 12x13 block products), not memory
// bandwidth (about 6.5 KB of inputs and outputs per instance).  B = 2048
// fills only 16 blocks of 128 threads on the 132 SMs, one warp per SM
// scheduler, so nothing hides the local-memory latency of each FMA.  This
// simple design does nothing about that beyond keeping the whole solve in
// one launch; spreading one instance over a warp (lanes over the rows of
// each block product) with the gains in shared memory is the next step.
// The dump is bound by bytes: 28 floats in and 338 out per instance against
// a few hundred FMAs.  Each thread writes its instance's 338 contiguous
// floats, so a warp's stores are strided by 1352 B; staging a block's
// outputs through shared memory would coalesce them, which an audit hook
// does not need.

#include "stagewise_body.cuh"

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

  float N[NX * NX], Bd[NX * NU], cv[NX];
  srb_assemble(R_in + (size_t)b * 9, rf_in + (size_t)b * NU, xd_in[b],
               fe_in + (size_t)b * 6, p, N, Bd, cv);
  const size_t hb = (size_t)b * h;
  solve_body<true, false>(
      b, N, Bd, cv, nullptr, x0_in + (size_t)b * NX, xref + hb * NX, l_in + hb * NC,
      u_in + hb * NC, U0 + hb * NU, z0 + hb * NC, y0 + hb * NC, Qv, Reff, Fm,
      U + hb * NU, Z + hb * NC, Y + hb * NC, K_s, Minv_s, Pc_s, v_s, r_s, q_s, P_s, p);
}

__global__ void __launch_bounds__(128) srb_build_dump_kernel(
    const float* __restrict__ R_in, const float* __restrict__ rf_in,
    const float* __restrict__ xd_in, const float* __restrict__ fe_in,
    float* __restrict__ Ad_out, float* __restrict__ Bd_out,
    float* __restrict__ c_out, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  float N[NX * NX], Bd[NX * NU], cv[NX];
  srb_assemble(R_in + (size_t)b * 9, rf_in + (size_t)b * NU, xd_in[b],
               fe_in + (size_t)b * 6, p, N, Bd, cv);
  float* Ad = Ad_out + (size_t)b * NX * NX;
  float* Bo = Bd_out + (size_t)b * NX * NU;
  float* co = c_out + (size_t)b * NX;
  for (int i = 0; i < NX * NX; ++i) Ad[i] = ((i % (NX + 1)) == 0 ? 1.f : 0.f) + N[i];
  for (int i = 0; i < NX * NU; ++i) Bo[i] = Bd[i];
  for (int i = 0; i < NX; ++i) co[i] = cv[i];
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

extern "C" int srb_build_dump_launch(
    const float* R, const float* rf, const float* xd, const float* fe,
    float* Ad, float* Bd, float* c, Params p, void* stream) {
  const int threads = 128;
  const int blocks = (p.B + threads - 1) / threads;
  srb_build_dump_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      R, rf, xd, fe, Ad, Bd, c, p);
  return (int)cudaGetLastError();
}
