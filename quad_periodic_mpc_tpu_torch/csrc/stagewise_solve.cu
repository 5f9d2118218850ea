// Stagewise Riccati-ADMM solve on caller-built dynamics, for Hopper (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py
// ::fused_stagewise_solve (_kernel -> _solve_body, _stage_quu_inverse,
// _ad_ops): the backward Riccati with warm gated Newton-Schulz inverses and
// `iters` ADMM sweeps of stagewise_body.cuh, on Ad (B,13,13), Bd (B,13,12)
// and an affine term c that is one vector per instance (B,13) or one per
// stage (B,h,13; the predictive disturbance horizon).  With srb_ad the Ad
// products take only the live rows {0..5, 11} / columns {6..12} of
// N = Ad - I and skip Bd's zero row 12; without it they are dense.
//
// Decomposition: one thread per instance, per-stage gains in instance-minor
// device scratch, as the fused-build kernel (stagewise_srb.cu).  Structured
// and dense Ad are two instantiations of one template
// (stagewise_solve.cuh), so the common case pays nothing for the dense
// products; each is its own translation unit (this file and
// stagewise_solve_dense.cu) so that the two compile side by side.  Shared
// or per-stage c is a pointer chosen at run time.
//
// One layout for every horizon.  The TPU kernel switched to a "lean" layout
// above h = 40 (packed Quu^{-1}, r_lin and q recomputed per sweep) only to
// fit its on-chip vector memory.  Here the gains live in device memory
// (h * 339 floats per instance), so the resident layout serves every h that
// the dispatch in ops/qp_stagewise.solve sends here (h <= 64).
//
// What bounds it on this card: as the fused-build kernel, the serial chain
// of about h * (1 + 2 * iters) dependent stage steps per instance, each a
// few thousand FMAs on thread-local arrays in local memory; not bytes
// (h * 118 + 351 floats of input and output per instance with a per-stage
// c).  The design does nothing about the latency beyond keeping the whole
// solve in one launch; one warp per instance with the gains in shared
// memory is the next step for all the stagewise kernels.

#include "stagewise_solve.cuh"

extern "C" int stagewise_solve_launch(
    const float* Ad, const float* Bd, const float* c, const float* x0,
    const float* xref, const float* l, const float* u, const float* U0,
    const float* z0, const float* y0, const float* Q, const float* Reff,
    const float* F, float* U, float* Z, float* Y, float* K_s, float* Minv_s,
    float* Pc_s, float* v_s, float* r_s, float* q_s, float* P_s, Params p,
    void* stream) {
  const int threads = 128;
  const int blocks = (p.B + threads - 1) / threads;
  auto kern = stagewise_solve_kernel<true>;
  kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Ad, Bd, c, x0, xref, l, u, U0, z0, y0, Q, Reff, F, U, Z, Y, K_s, Minv_s, Pc_s,
      v_s, r_s, q_s, P_s, p);
  return (int)cudaGetLastError();
}
