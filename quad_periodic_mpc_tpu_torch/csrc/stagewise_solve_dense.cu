// fused_stagewise_solve with dense Ad products (srb_ad = false): the second
// instantiation of the kernel in stagewise_solve.cuh.  stagewise_solve.cu
// says what the kernel replaces, what bounds it and how it is laid out.

#include "stagewise_solve.cuh"

extern "C" int stagewise_solve_dense_launch(
    const float* Ad, const float* Bd, const float* c, const float* x0,
    const float* xref, const float* l, const float* u, const float* U0,
    const float* z0, const float* y0, const float* Q, const float* Reff,
    const float* F, float* U, float* Z, float* Y, float* K_s, float* Minv_s,
    float* Pc_s, float* v_s, float* r_s, float* q_s, float* P_s, Params p,
    void* stream) {
  const int threads = 128;
  const int blocks = (p.B + threads - 1) / threads;
  auto kern = stagewise_solve_kernel<false>;
  kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Ad, Bd, c, x0, xref, l, u, U0, z0, y0, Q, Reff, F, U, Z, Y, K_s, Minv_s, Pc_s,
      v_s, r_s, q_s, P_s, p);
  return (int)cudaGetLastError();
}
