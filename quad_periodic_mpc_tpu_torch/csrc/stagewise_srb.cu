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
// Params::rescues, where the caller passes one, counts the (instance, stage)
// pairs whose warm Newton-Schulz inverse failed the gate and restarted cold:
// one atomicAdd a rescue, nothing else, so the solve's arithmetic is as
// without it.
//
// srb_build_dump_kernel replaces ::srb_build_dump (_kernel_srb_dump): it
// calls the same srb_assemble device function and writes Ad, Bd and c out,
// so that a caller can hold the in-kernel build against the independent
// problem build.
//
// What bounds the solve on this card, and what the design does about it:
// the latency of its chain of h * (1 + 2 * iters) dependent stage steps
// (610 at h = 10, ADMM-30), not bytes (about 6.5 KB of inputs and outputs
// per instance) and not the FMA rate.  One warp per instance, one 32-thread
// block each (B = 2048 is one wave of 16 warps an SM), with the lanes over
// the entries of each block product, the working set in shared memory and
// the gains streamed through a cp.async double buffer: stagewise_body.cuh
// says how.  Lane 0 runs the one-thread srb_assemble into shared memory, a
// few hundred FMAs once per solve.
//
// The dump is bound by bytes: 28 floats in and 338 out per instance against
// a few hundred FMAs, so what matters is that every SM takes part and that
// the stores are coalesced.  One warp per instance, four to a 128-thread
// block (B = 2048 is 512 blocks over all 132 SMs): lane 0 runs the same
// srb_assemble into the warp's slice of shared memory, as kernel 1's
// prologue does, and after a __syncwarp() the warp writes Ad = I + N, Bd and
// c, each a contiguous run of the instance's outputs, consecutive lanes on
// consecutive words.  No per-thread array is left to live in local memory.

#include "stagewise_body.cuh"

__global__ void __launch_bounds__(32, 16) stagewise_srb_kernel(
    const float* __restrict__ R_in, const float* __restrict__ rf_in,
    const float* __restrict__ xd_in, const float* __restrict__ fe_in,
    const float* __restrict__ x0_in, const float* __restrict__ xref,
    const float* __restrict__ l_in, const float* __restrict__ u_in,
    const float* __restrict__ U0, const float* __restrict__ z0,
    const float* __restrict__ y0, const float* __restrict__ Qv,
    const float* __restrict__ Reff, const float* __restrict__ Fm,
    float* __restrict__ U, float* __restrict__ Z, float* __restrict__ Y,
    float* gains, Params p) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  if (wl::lane() == 0)
    srb_assemble(R_in + (size_t)b * 9, rf_in + (size_t)b * NU, xd_in[b],
                 fe_in + (size_t)b * 6, p, sm.A, sm.Bd, sm.cv);
  const size_t hb = (size_t)b * p.h;
  const Io io{nullptr, x0_in + (size_t)b * NX, xref + hb * NX, l_in + hb * NC,
              u_in + hb * NC, U0 + hb * NU, z0 + hb * NC, y0 + hb * NC, Qv, Reff, Fm,
              U + hb * NU, Z + hb * NC, Y + hb * NC, gains + hb * Rec<false>::kSize};
  solve_body<true, false>(sm, io, p);
}

constexpr int kDumpWarps = 4;   // instances a block, one warp each

__global__ void __launch_bounds__(32 * kDumpWarps) srb_build_dump_kernel(
    const float* __restrict__ R_in, const float* __restrict__ rf_in,
    const float* __restrict__ xd_in, const float* __restrict__ fe_in,
    float* __restrict__ Ad_out, float* __restrict__ Bd_out,
    float* __restrict__ c_out, Params p) {
  __shared__ float built[kDumpWarps][NX * NX + NX * NU + NX];
  const int w = threadIdx.x / 32, lane = wl::lane();
  const int b = blockIdx.x * kDumpWarps + w;
  if (b >= p.B) return;                      // a whole warp: no block barrier follows
  float* N = built[w];
  float* Bd = N + NX * NX;
  float* cv = Bd + NX * NU;
  if (lane == 0)
    srb_assemble(R_in + (size_t)b * 9, rf_in + (size_t)b * NU, xd_in[b],
                 fe_in + (size_t)b * 6, p, N, Bd, cv);
  __syncwarp();
  float* Ad = Ad_out + (size_t)b * NX * NX;
  float* Bo = Bd_out + (size_t)b * NX * NU;
  float* co = c_out + (size_t)b * NX;
  for (int i = lane; i < NX * NX; i += 32) Ad[i] = ((i % (NX + 1)) == 0 ? 1.f : 0.f) + N[i];
  for (int i = lane; i < NX * NU; i += 32) Bo[i] = Bd[i];
  if (lane < NX) co[lane] = cv[lane];
}

extern "C" int stagewise_srb_launch(
    const float* R, const float* rf, const float* xd, const float* fe,
    const float* x0, const float* xref, const float* l, const float* u,
    const float* U0, const float* z0, const float* y0, const float* Q,
    const float* Reff, const float* F, float* U, float* Z, float* Y,
    float* gains, Params p, void* stream) {
  stagewise_srb_kernel<<<p.B, 32, 0, (cudaStream_t)stream>>>(
      R, rf, xd, fe, x0, xref, l, u, U0, z0, y0, Q, Reff, F, U, Z, Y, gains, p);
  return (int)cudaGetLastError();
}

extern "C" int srb_build_dump_launch(
    const float* R, const float* rf, const float* xd, const float* fe,
    float* Ad, float* Bd, float* c, Params p, void* stream) {
  const int blocks = (p.B + kDumpWarps - 1) / kDumpWarps;
  srb_build_dump_kernel<<<blocks, 32 * kDumpWarps, 0, (cudaStream_t)stream>>>(
      R, rf, xd, fe, Ad, Bd, c, p);
  return (int)cudaGetLastError();
}
