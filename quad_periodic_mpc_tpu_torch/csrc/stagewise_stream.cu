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
// What is not carried over.  The TPU kernel spilled K and Quu^{-1} in blocks
// of 8 stages to device memory and streamed them back through a double
// buffer in its on-chip vector memory with asynchronous copies, because the
// gains of h = 128 do not fit there.  Per thread a stage's gains are
// 156 + 78 floats, so an 8-stage block for the 128 threads of a CUDA block
// is about 960 KB: it cannot sit in the 227 KB of shared memory.  This kernel
// reads each stage's gains straight from instance-minor device scratch
// (coalesced across the threads of a warp), one thread per instance.
//
// What bounds it on this card: the serial chain of h * (1 + 2 * iters)
// dependent stage steps per instance (12,928 at h = 128, 50 sweeps); each
// forward stage also waits on 234 dependent-address global loads of gains
// (10 MB of K and 5 MB of Quu^{-1} at B = 128, which stay in the 50 MB L2).
// With B = 128 the launch is one block on one of 132 SMs.  Not bytes.
// Later work: stage the next stage's K through shared memory with cp.async
// while the current stage computes (hides the L2 latency of the gain loads,
// at most the share of a stage step that those loads take), or give one
// warp to each instance (lanes over the rows of each block product, gains
// in shared memory per stage), which shortens the chain itself by up to the
// warp's width and fills 128 SM sub-partitions instead of 4.

#include "stagewise_body.cuh"

__global__ void __launch_bounds__(128) stagewise_stream_kernel(
    const float* __restrict__ Ad_in, const float* __restrict__ Bd_in,
    const float* __restrict__ c_in, const float* __restrict__ x0_in,
    const float* __restrict__ xref, const float* __restrict__ l_in,
    const float* __restrict__ u_in, const float* __restrict__ Qv,
    const float* __restrict__ Reff, const float* __restrict__ Fm, float* U,
    float* Z, float* Y, float* K_s, float* Minv_s, float* Pc_s, float* v_s,
    float* P_s, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int h = p.h;
  const size_t hb = (size_t)b * h;

  float A[NX * NX], Bd[NX * NU], cv[NX];
  for (int i = 0; i < NX * NX; ++i) {              // N = Ad - I
    const float a = Ad_in[(size_t)b * NX * NX + i];
    A[i] = ((i % (NX + 1)) == 0) ? a - 1.f : a;
  }
  for (int i = 0; i < NX * NU; ++i) Bd[i] = Bd_in[(size_t)b * NX * NU + i];
  for (int i = 0; i < NX; ++i) cv[i] = p.c_per_step ? 0.f : c_in[(size_t)b * NX + i];
  solve_body<true, true>(
      b, A, Bd, cv, p.c_per_step ? c_in + hb * NX : nullptr, x0_in + (size_t)b * NX,
      xref + hb * NX, l_in + hb * NC, u_in + hb * NC, nullptr, nullptr, nullptr, Qv,
      Reff, Fm, U + hb * NU, Z + hb * NC, Y + hb * NC, K_s, Minv_s, Pc_s, v_s,
      nullptr, nullptr, P_s, p);
}

extern "C" int stagewise_stream_launch(
    const float* Ad, const float* Bd, const float* c, const float* x0,
    const float* xref, const float* l, const float* u, const float* Q,
    const float* Reff, const float* F, float* U, float* Z, float* Y, float* K_s,
    float* Minv_s, float* Pc_s, float* v_s, float* P_s, Params p, void* stream) {
  const int threads = 128;
  const int blocks = (p.B + threads - 1) / threads;
  stagewise_stream_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Ad, Bd, c, x0, xref, l, u, Q, Reff, F, U, Z, Y, K_s, Minv_s, Pc_s, v_s, P_s, p);
  return (int)cudaGetLastError();
}
