// Long-horizon stagewise Riccati-ADMM solve (64 < h <= 128), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/stagewise_kernel.py
// ::fused_stagewise_solve_stream (_kernel_stream).  The arithmetic is that of
// fused_stagewise_solve (stagewise_solve.cu, stagewise_body.cuh) with what
// the TPU's streaming variant has of its own:
//   - Quu^{-1} is stored as its 78 upper-triangle entries and unpacked where
//     the forward sweep uses it (so the inverse it applies is exactly
//     symmetric);
//   - r_k = A20^T (rho z_k - y_k) and the stage cost q_k = -Q xref_{k-1} are
//     recomputed in the sweeps instead of stored;
//   - U, z, y are updated in place: the wrapper copies the warm start into
//     the outputs before the launch (the TPU kernel aliased them).
// Ad is structured (N = Ad - I on its live rows and columns), as in the TPU
// kernel's only use; c is one vector per instance or one per stage.
//
// The TPU kernel spilled K and Quu^{-1} in blocks of 8 stages to device
// memory and streamed them back through a double buffer in its on-chip
// vector memory, because the gains of h = 128 do not fit there.  Here every
// stage's gains (268 floats: K, packed Quu^{-1}, P c, v) go to device memory
// by instance, 17 MB at B = 128, h = 128, which stays in the 50 MB L2, and
// the sweeps copy the next stage's record into a two-slot buffer in shared
// memory with cp.async while the current stage computes.
//
// What bounds it on this card: the latency of the chain of
// h * (1 + 2 * iters) dependent stage steps per instance (12,928 at
// h = 128, ADMM-50); not bytes, not the FMA rate.  One thread per instance
// put that chain on one SM at B = 128.  One warp per instance, one 32-thread
// block each, spreads B = 128 over 128 SMs and shortens each step to a
// dozen short lane-parallel chains (stagewise_body.cuh).

#include "stagewise_body.cuh"

__global__ void __launch_bounds__(32, 16) stagewise_stream_kernel(
    const float* __restrict__ Ad_in, const float* __restrict__ Bd_in,
    const float* __restrict__ c_in, const float* __restrict__ x0_in,
    const float* __restrict__ xref, const float* __restrict__ l_in,
    const float* __restrict__ u_in, const float* __restrict__ Qv,
    const float* __restrict__ Reff, const float* __restrict__ Fm, float* U,
    float* Z, float* Y, float* gains, Params p) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const size_t hb = (size_t)b * p.h;
  load_dynamics<true>(sm, Ad_in + (size_t)b * NX * NX, Bd_in + (size_t)b * NX * NU,
                      p.c_per_step ? nullptr : c_in + (size_t)b * NX);
  const Io io{p.c_per_step ? c_in + hb * NX : nullptr, x0_in + (size_t)b * NX,
              xref + hb * NX, l_in + hb * NC, u_in + hb * NC, nullptr, nullptr, nullptr,
              Qv, Reff, Fm, U + hb * NU, Z + hb * NC, Y + hb * NC,
              gains + hb * Rec<true>::kSize};
  solve_body<true, true>(sm, io, p);
}

extern "C" int stagewise_stream_launch(
    const float* Ad, const float* Bd, const float* c, const float* x0,
    const float* xref, const float* l, const float* u, const float* Q,
    const float* Reff, const float* F, float* U, float* Z, float* Y, float* gains,
    Params p, void* stream) {
  stagewise_stream_kernel<<<p.B, 32, 0, (cudaStream_t)stream>>>(
      Ad, Bd, c, x0, xref, l, u, Q, Reff, F, U, Z, Y, gains, p);
  return (int)cudaGetLastError();
}
