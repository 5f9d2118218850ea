// One step of the analytic SRB plant for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's sim/srb_sim.py::step is XLA's
// fusion of its dense form.  The port's plain version (srb_sim.step_dense)
// builds A (13x13), B (13x12) and Qc (13x6) per instance, squares A, forms
// Phi B and Phi Qc with batched GEMMs and applies three matrix-vector
// products: about a hundred PyTorch operations a step.  This kernel
// computes the same exact nilpotent ZOH matrix-free, per instance, in one
// pass:
//
//   R = Rz(yaw) Ry(pitch) Rx(roll)          (ops/rotations.rpy_to_rotmat)
//   u_i = forces_i * stance_i,  r_i = p_feet_i - p
//   c = Bu + Qc w = [0; 0; R diag(1/I) R^T sum r_i x u_i + w[0:3];
//                    sum u_i / m + w[3:6]; 0]
//   x' = x + dt A x + dt^2/2 A^2 x + Phi c,
//   Phi v = dt v + dt^2/2 A v + dt^3/6 A^2 v,
//
// with A v = [R^T v[6:9]; v[9:12]; 0 (6); row 11 = v[12]; 0] (the plant
// has no drag) and A^2 v nonzero in row 5 only (= v[12]), the structure of
// ops/estimator.residual_discrete.  Since c[12] = 0, A^2 c = 0 and A c has
// rows 0:6 only, so
//
//   rpy' = rpy + R^T (dt omega + dt^2/2 c_omega)
//   p'   = p + dt v + dt^2/2 c_v,     p_z' += dt^2/2 x[12]
//   omega' = omega + dt c_omega
//   v'   = v + dt c_v,                v_z' += dt x[12]
//   x[12]' = x[12];
//   feet' = stance > 0.5 ? p_feet : p_foot_des;  t' = t + dt.
//
// The disturbance w is the acceleration-space wrench of srb_sim: for
// DisturbanceParams (kWrench false) F_x = static + amp sin(2 pi f t + phi)
// as F_x / m in slot 3; for WrenchDisturbance (kWrench true) six such
// sinusoids.  The sine's argument is formed in the plain path's order,
// (2 pi f) t + phi, each product rounded on its own (mul_rn), since t
// runs to tens of seconds and 2 pi f t to ~100 rad.
//
// What bounds it on this card: per instance ~230 B in, ~110 B out (float)
// and a few hundred operations, so bytes (3.35 TB/s) bound it: ~3.3 us at
// B = 32,768.  Design: one thread per instance, kBlock<T> instances a block
// (128 in float, 64 in double: the same 43.5 KB of static shared memory);
// the block stages its instances' rows of x (13), p_feet, forces,
// p_foot_des (12 each) and stance (4) through shared memory with coalesced
// loads (neighbouring threads on neighbouring words), each row padded to an
// odd stride so a thread's row reads are free of bank conflicts, and
// writes x' and feet' back the same way.  Nothing is shared between
// threads but the staging; the batch's ragged edge is masked.
//
// Precision: the scalar type T of the tensors, float (the port's policy)
// or double (the CLI's --f64); no --use_fast_math: precise sin / cos.

#include <cuda_runtime.h>

// instances (threads) a block: 2 KB of each staged word a block
template <typename T>
constexpr int kBlock = 512 / sizeof(T);
constexpr int NX = 13;

// The scalars of the step, in double whatever T (each already rounded to T
// by the wrapper, so the conversion to T is exact).
struct SrbPlantParams {
  int B, wrench;                // wrench: the disturbance is a WrenchDisturbance
  double dt, mass, two_pi;
  double inv_inertia[3];        // 1 / I_body, the plain version's reciprocals in T
};

// Row stride in shared memory: odd, so threads t and t + 1 read their rows
// in different banks.
__host__ __device__ constexpr int padded(int n) { return n | 1; }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sin_t(float a) { return sinf(a); }
__device__ __forceinline__ double sin_t(double a) { return sin(a); }
__device__ __forceinline__ float cos_t(float a) { return cosf(a); }
__device__ __forceinline__ double cos_t(double a) { return cos(a); }

// Copy rows [b0, b0 + n) of a (B, N) array into shared rows of stride
// padded(N), coalesced over the block.
template <int N, typename T>
__device__ __forceinline__ void stage_in(T* __restrict__ s, const T* __restrict__ g, int b0,
                                         int n) {
  for (int i = threadIdx.x; i < n * N; i += kBlock<T>) s[(i / N) * padded(N) + i % N] = g[b0 * N + i];
}

template <int N, typename T>
__device__ __forceinline__ void stage_out(T* __restrict__ g, const T* __restrict__ s, int b0,
                                          int n) {
  for (int i = threadIdx.x; i < n * N; i += kBlock<T>) g[b0 * N + i] = s[(i / N) * padded(N) + i % N];
}

// static + amp sin((2 pi freq) t + phase), each step rounded as the plain
// path rounds it
template <typename T>
__device__ __forceinline__ T sinusoid(T two_pi, T t, T s, T a, T f, T ph) {
  const T arg = mul_rn(mul_rn(two_pi, f), t) + ph;
  return s + mul_rn(a, sin_t(arg));
}

template <typename T, bool kWrench>
__global__ void __launch_bounds__(kBlock<T>) srb_plant_step_kernel(
    const T* __restrict__ x_in, const T* __restrict__ feet_in, const T* __restrict__ t_in,
    const T* __restrict__ forces_in, const T* __restrict__ feet_des_in,
    const T* __restrict__ stance_in, const T* __restrict__ d_static,
    const T* __restrict__ d_amp, const T* __restrict__ d_freq, const T* __restrict__ d_phase,
    T* __restrict__ x_out, T* __restrict__ feet_out, T* __restrict__ t_out,
    const SrbPlantParams p) {
  constexpr int NB = kBlock<T>;
  constexpr int NW = kWrench ? 6 : 1;   // disturbance components an instance
  __shared__ T sx[NB * padded(NX)], sfeet[NB * padded(12)];
  __shared__ T sforce[NB * padded(12)], sdes[NB * padded(12)];
  __shared__ T sstance[NB * padded(4)];
  __shared__ T sdist[4][NB * padded(NW)];

  const int b0 = blockIdx.x * NB;
  const int n = p.B - b0 < NB ? p.B - b0 : NB;
  stage_in<NX>(sx, x_in, b0, n);
  stage_in<12>(sfeet, feet_in, b0, n);
  stage_in<12>(sforce, forces_in, b0, n);
  stage_in<12>(sdes, feet_des_in, b0, n);
  stage_in<4>(sstance, stance_in, b0, n);
  stage_in<NW>(sdist[0], d_static, b0, n);
  stage_in<NW>(sdist[1], d_amp, b0, n);
  stage_in<NW>(sdist[2], d_freq, b0, n);
  stage_in<NW>(sdist[3], d_phase, b0, n);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < n) {
    T* x = sx + i * padded(NX);
    T* feet = sfeet + i * padded(12);
    const T* force = sforce + i * padded(12);
    const T* des = sdes + i * padded(12);
    const T* stance = sstance + i * padded(4);
    const T t = t_in[b0 + i];
    const T mass = T(p.mass), two_pi = T(p.two_pi);

    // R = Rz(yaw) Ry(pitch) Rx(roll), entry by entry as rpy_to_rotmat
    const T cr = cos_t(x[0]), sr = sin_t(x[0]);
    const T cp = cos_t(x[1]), sp = sin_t(x[1]);
    const T cy = cos_t(x[2]), sy = sin_t(x[2]);
    const T R[3][3] = {
        {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr},
        {sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr},
        {-sp, cp * sr, cp * cr}};

    // the stance feet's torque about the CoM and their summed force
    T tau[3] = {0, 0, 0}, fsum[3] = {0, 0, 0};
    for (int k = 0; k < 4; ++k) {
      T u[3], r[3];
      for (int j = 0; j < 3; ++j) {
        u[j] = force[3 * k + j] * stance[k];
        r[j] = feet[3 * k + j] - x[3 + j];
        fsum[j] += u[j];
      }
      tau[0] += r[1] * u[2] - r[2] * u[1];
      tau[1] += r[2] * u[0] - r[0] * u[2];
      tau[2] += r[0] * u[1] - r[1] * u[0];
    }

    // the disturbance wrench w = [tau_acc; lin_acc]
    T w[6] = {0, 0, 0, 0, 0, 0};
    const T* ds = sdist[0] + i * padded(NW);
    const T* da = sdist[1] + i * padded(NW);
    const T* df = sdist[2] + i * padded(NW);
    const T* dp = sdist[3] + i * padded(NW);
    if (kWrench) {
      for (int j = 0; j < 6; ++j) w[j] = sinusoid(two_pi, t, ds[j], da[j], df[j], dp[j]);
    } else {
      w[3] = sinusoid(two_pi, t, ds[0], da[0], df[0], dp[0]) / mass;
    }

    // c_omega = R diag(1/I) R^T tau + w[0:3],  c_v = sum u / m + w[3:6]
    T body[3], c_om[3], c_v[3];
    for (int j = 0; j < 3; ++j)
      body[j] = (R[0][j] * tau[0] + R[1][j] * tau[1] + R[2][j] * tau[2]) * T(p.inv_inertia[j]);
    for (int j = 0; j < 3; ++j) {
      c_om[j] = R[j][0] * body[0] + R[j][1] * body[1] + R[j][2] * body[2] + w[j];
      c_v[j] = fsum[j] / mass + w[3 + j];
    }

    const T dt = T(p.dt), half_dt2 = dt * dt * T(0.5);
    T spin[3];   // dt omega + dt^2/2 c_omega, mapped to rpy rates by R^T
    for (int j = 0; j < 3; ++j) spin[j] = dt * x[6 + j] + half_dt2 * c_om[j];
    T xn[NX];
    for (int j = 0; j < 3; ++j) {
      xn[j] = x[j] + (R[0][j] * spin[0] + R[1][j] * spin[1] + R[2][j] * spin[2]);
      xn[3 + j] = x[3 + j] + dt * x[9 + j] + half_dt2 * c_v[j];
      xn[6 + j] = x[6 + j] + dt * c_om[j];
      xn[9 + j] = x[9 + j] + dt * c_v[j];
    }
    xn[5] += half_dt2 * x[12];
    xn[11] += dt * x[12];
    xn[12] = x[12];
    for (int j = 0; j < NX; ++j) x[j] = xn[j];   // this thread's row only

    for (int k = 0; k < 4; ++k) {
      if (!(stance[k] > T(0.5)))
        for (int j = 0; j < 3; ++j) feet[3 * k + j] = des[3 * k + j];
    }
    t_out[b0 + i] = t + dt;
  }
  __syncthreads();
  stage_out<NX>(x_out, sx, b0, n);
  stage_out<12>(feet_out, sfeet, b0, n);
}

template <typename T>
int launch(const T* x, const T* feet, const T* t, const T* forces, const T* feet_des,
           const T* stance, const T* d_static, const T* d_amp, const T* d_freq,
           const T* d_phase, T* x_o, T* feet_o, T* t_o, SrbPlantParams p, void* stream) {
  const int blocks = (p.B + kBlock<T> - 1) / kBlock<T>;
  auto kern = p.wrench ? srb_plant_step_kernel<T, true> : srb_plant_step_kernel<T, false>;
  kern<<<blocks, kBlock<T>, 0, (cudaStream_t)stream>>>(
      x, feet, t, forces, feet_des, stance, d_static, d_amp, d_freq, d_phase, x_o, feet_o,
      t_o, p);
  return (int)cudaGetLastError();
}

extern "C" int srb_plant_launch_f32(
    const float* x, const float* feet, const float* t, const float* forces,
    const float* feet_des, const float* stance, const float* d_static, const float* d_amp,
    const float* d_freq, const float* d_phase, float* x_o, float* feet_o, float* t_o,
    SrbPlantParams p, void* stream) {
  return launch(x, feet, t, forces, feet_des, stance, d_static, d_amp, d_freq, d_phase, x_o,
                feet_o, t_o, p, stream);
}

extern "C" int srb_plant_launch_f64(
    const double* x, const double* feet, const double* t, const double* forces,
    const double* feet_des, const double* stance, const double* d_static, const double* d_amp,
    const double* d_freq, const double* d_phase, double* x_o, double* feet_o, double* t_o,
    SrbPlantParams p, void* stream) {
  return launch(x, feet, t, forces, feet_des, stance, d_static, d_amp, d_freq, d_phase, x_o,
                feet_o, t_o, p, stream);
}
