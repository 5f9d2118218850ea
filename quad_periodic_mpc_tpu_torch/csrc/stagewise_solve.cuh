// The kernel of fused_stagewise_solve, for structured (SRB_AD) or dense Ad
// products; stagewise_solve.cu says what it computes and why it
// is laid out so.

#pragma once

#include "stagewise_body.cuh"

template <bool SRB_AD>
__global__ void __launch_bounds__(32, 16) stagewise_solve_kernel(
    const float* __restrict__ Ad_in, const float* __restrict__ Bd_in,
    const float* __restrict__ c_in, const float* __restrict__ x0_in,
    const float* __restrict__ xref, const float* __restrict__ l_in,
    const float* __restrict__ u_in, const float* __restrict__ U0,
    const float* __restrict__ z0, const float* __restrict__ y0,
    const float* __restrict__ Qv, const float* __restrict__ Reff,
    const float* __restrict__ Fm, float* __restrict__ U, float* __restrict__ Z,
    float* __restrict__ Y, float* gains, Params p) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const size_t hb = (size_t)b * p.h;
  load_dynamics<SRB_AD>(sm, Ad_in + (size_t)b * NX * NX, Bd_in + (size_t)b * NX * NU,
                        p.c_per_step ? nullptr : c_in + (size_t)b * NX);
  const Io io{p.c_per_step ? c_in + hb * NX : nullptr, x0_in + (size_t)b * NX,
              xref + hb * NX, l_in + hb * NC, u_in + hb * NC, U0 + hb * NU, z0 + hb * NC,
              y0 + hb * NC, Qv, Reff, Fm, U + hb * NU, Z + hb * NC, Y + hb * NC,
              gains + hb * Rec<false>::kSize};
  solve_body<SRB_AD, false>(sm, io, p);
}
