// Branch-free float division for the port's kernels (plant.cu).
//
// The compiler's IEEE division checks its operands and branches to a slow
// path; that splits a branch-free step into blocks which the scheduler
// cannot overlap with independent work beside it (a plant substep took
// 0.0010 ms with it and takes 0.0007 ms without on an H100,
// tools/time_tick_cuda.py).  div_rn gives the same value without the
// branch for the operands it is used on.
#pragma once

#include <cuda_runtime.h>

// a / b, correctly rounded (the value IEEE division gives), for b normal
// with |b| < 2^126.  y, a float estimate of 1 / b refined by two Newton
// steps in double, lies within 2^-51 (relative) of 1 / b, so a * y in
// double lies within 2^-50 of a / b.  The quotient of two floats is never
// a float midpoint and lies at least 2^-49 (relative) from one, so a * y
// rounded once to float is the correctly rounded quotient; a zero dividend
// keeps its sign.  The plant's divisors are max(|f_t|, 1e-9) and the
// tangential stiffness.  tests/test_torch_device_helpers.py holds this
// function bit for bit against IEEE division, on the card and emulated.
__device__ __forceinline__ float div_rn(float a, float b) {
  double y = (double)__fdividef(1.0f, b);
  const double bd = b;
  y = fma(fma(-bd, y, 1.0), y, y);
  y = fma(fma(-bd, y, 1.0), y, y);
  return (float)((double)a * y);
}
