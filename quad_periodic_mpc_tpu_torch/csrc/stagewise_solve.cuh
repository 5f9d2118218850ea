// The kernel of fused_stagewise_solve, for structured (SRB_AD) or dense Ad
// products; stagewise_solve.cu says what it computes and why it
// is laid out so.

#pragma once

#include "stagewise_body.cuh"

template <bool SRB_AD>
__global__ void __launch_bounds__(128) stagewise_solve_kernel(
    const float* __restrict__ Ad_in, const float* __restrict__ Bd_in,
    const float* __restrict__ c_in, const float* __restrict__ x0_in,
    const float* __restrict__ xref, const float* __restrict__ l_in,
    const float* __restrict__ u_in, const float* __restrict__ U0,
    const float* __restrict__ z0, const float* __restrict__ y0,
    const float* __restrict__ Qv, const float* __restrict__ Reff,
    const float* __restrict__ Fm, float* __restrict__ U, float* __restrict__ Z,
    float* __restrict__ Y, float* K_s, float* Minv_s, float* Pc_s, float* v_s,
    float* r_s, float* q_s, float* P_s, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int h = p.h;
  const size_t hb = (size_t)b * h;

  float A[NX * NX], Bd[NX * NU], cv[NX];
  for (int i = 0; i < NX * NX; ++i) {              // N = Ad - I when structured
    const float a = Ad_in[(size_t)b * NX * NX + i];
    A[i] = (SRB_AD && (i % (NX + 1)) == 0) ? a - 1.f : a;
  }
  for (int i = 0; i < NX * NU; ++i) Bd[i] = Bd_in[(size_t)b * NX * NU + i];
  for (int i = 0; i < NX; ++i) cv[i] = p.c_per_step ? 0.f : c_in[(size_t)b * NX + i];
  solve_body<SRB_AD, false>(
      b, A, Bd, cv, p.c_per_step ? c_in + hb * NX : nullptr, x0_in + (size_t)b * NX,
      xref + hb * NX, l_in + hb * NC, u_in + hb * NC, U0 + hb * NU, z0 + hb * NC,
      y0 + hb * NC, Qv, Reff, Fm, U + hb * NU, Z + hb * NC, Y + hb * NC, K_s, Minv_s,
      Pc_s, v_s, r_s, q_s, P_s, p);
}
