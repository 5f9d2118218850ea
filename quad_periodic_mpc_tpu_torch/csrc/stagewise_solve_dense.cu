// fused_stagewise_solve with dense Ad products (srb_ad = false): the second
// instantiation of the kernel in stagewise_solve.cuh.  stagewise_solve.cu
// says what the kernel replaces, what bounds it and how it is laid out.

#include "stagewise_solve.cuh"

extern "C" int stagewise_solve_dense_launch(
    const float* Ad, const float* Bd, const float* c, const float* x0,
    const float* xref, const float* l, const float* u, const float* U0,
    const float* z0, const float* y0, const float* Q, const float* Reff,
    const float* F, float* U, float* Z, float* Y, float* gains, Params p,
    void* stream) {
  auto kern = stagewise_solve_kernel<false>;
  kern<<<p.B, 32, 0, (cudaStream_t)stream>>>(
      Ad, Bd, c, x0, xref, l, u, U0, z0, y0, Q, Reff, F, U, Z, Y, gains, p);
  return (int)cudaGetLastError();
}
