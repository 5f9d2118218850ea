// Fused articulated-plant substeps for Hopper (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/plant_kernel.py
// ::fused_substeps (_kernel): `substeps` semi-implicit Euler steps of the
// 18-DoF plant on the model frozen for the control tick (the tick's A^{-1},
// G + C and contact Jacobian Jc; foot positions integrated from Jc qdot),
// the same arithmetic as chained articulated_sim.step_fast calls:
//   per foot: penalty normal force on penetration, a tangential stiction
//   spring from the foot's anchor with damping, the Coulomb cap with the
//   anchor slid to the capped force, the anchor reset for feet out of
//   contact;
//   qdd = A^{-1} ([0; tau] + Jc^T f - (C + G));  v += dt qdd, q += dt qd;
//   pos += dt R v;  quat <- quat (x) [cos(|w|dt/2); sin(|w|dt/2) w/|w|],
//   renormalized with rsqrt;  p_foot += dt Jc qdot (qdot before the update).
//
// Decomposition: one thread per instance, 32-thread blocks, the batch masked
// b < B (no padding).  The state (pose, velocities, anchors, feet, tau,
// G + C) stays in registers across the substeps; A^{-1} (18x18) and Jc
// (12x18) are re-read from global memory each substep (L1-resident).
//
// What bounds it on this card: each substep is about 1.4 kflop of dependent
// mat-vecs (Jc qdot, Jc^T f, A^{-1} rhs) per instance, 10 substeps in a row,
// and about 2.3 KB of inputs per instance: the chain's latency, not
// bandwidth or throughput, bounds it at B = 256 (8 blocks on 132 SMs) and
// at B = 1.  The design keeps all substeps in one launch and the state in
// registers.
//
// Precision: exact f32 FMAs, no --use_fast_math: sinf, cosf and the
// quaternion's rsqrtf enter the plant state.

#include <cuda_runtime.h>

#define ND 18

struct PlantParams {
  int B, substeps;
  float dt, k_normal, d_normal, mu, k_tangent, d_tangent;
};

__global__ void __launch_bounds__(32) plant_kernel(
    const float* __restrict__ quat_in, const float* __restrict__ pos_in,
    const float* __restrict__ vb_in, const float* __restrict__ q_in,
    const float* __restrict__ qd_in, const float* __restrict__ anchor_in,
    const float* __restrict__ tau_in, const float* __restrict__ Ainv_in,
    const float* __restrict__ G_in, const float* __restrict__ C_in,
    const float* __restrict__ Jc_in, const float* __restrict__ pf_in,
    float* __restrict__ quat_out, float* __restrict__ pos_out,
    float* __restrict__ vb_out, float* __restrict__ q_out,
    float* __restrict__ qd_out, float* __restrict__ anchor_out,
    float* __restrict__ pf_out, float* __restrict__ contact_out,
    const PlantParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const float* Ainv = Ainv_in + ND * ND * b;
  const float* Jc = Jc_in + 12 * ND * b;
  float quat[4], pos[3], qdot[ND], q[12], anchor[8], pf[12], tau[12], bvec[ND];
  float contact[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < 4; ++k) quat[k] = quat_in[4 * b + k];
  for (int k = 0; k < 3; ++k) pos[k] = pos_in[3 * b + k];
  for (int k = 0; k < 6; ++k) qdot[k] = vb_in[6 * b + k];
  for (int k = 0; k < 12; ++k) {
    qdot[6 + k] = qd_in[12 * b + k];
    q[k] = q_in[12 * b + k];
    pf[k] = pf_in[12 * b + k];
    tau[k] = tau_in[12 * b + k];
  }
  for (int k = 0; k < 8; ++k) anchor[k] = anchor_in[8 * b + k];
  for (int k = 0; k < ND; ++k) bvec[k] = C_in[ND * b + k] + G_in[ND * b + k];
  const float dt = p.dt;

  for (int step = 0; step < p.substeps; ++step) {
    float v_feet[12], f[12];
    for (int r = 0; r < 12; ++r) {
      float acc = Jc[ND * r] * qdot[0];
      for (int k = 1; k < ND; ++k) acc = fmaf(Jc[ND * r + k], qdot[k], acc);
      v_feet[r] = acc;
    }
    // penalty contact per foot (articulated_sim.contact_forces)
    for (int k = 0; k < 4; ++k) {
      const float z = pf[3 * k + 2], vz = v_feet[3 * k + 2];
      const float active = z < 0.f ? 1.f : 0.f;
      const float pen = fmaxf(-z, 0.f);
      const float fz = fmaxf(p.k_normal * pen - p.d_normal * vz * active, 0.f) * active;
      const float ax = anchor[2 * k], ay = anchor[2 * k + 1];
      float ftx = (-p.k_tangent * (pf[3 * k] - ax) - p.d_tangent * v_feet[3 * k]) * active;
      float fty = (-p.k_tangent * (pf[3 * k + 1] - ay) - p.d_tangent * v_feet[3 * k + 1]) * active;
      const float ft_norm = sqrtf(ftx * ftx + fty * fty);
      const float limit = p.mu * fz;
      const bool slide = ft_norm > limit;
      const float scale = slide ? limit / fmaxf(ft_norm, 1e-9f) : 1.f;
      ftx = ftx * scale;
      fty = fty * scale;
      float ax_new = slide ? pf[3 * k] + ftx / p.k_tangent : ax;
      float ay_new = slide ? pf[3 * k + 1] + fty / p.k_tangent : ay;
      if (!(active > 0.f)) {
        ax_new = pf[3 * k];
        ay_new = pf[3 * k + 1];
      }
      f[3 * k] = ftx;
      f[3 * k + 1] = fty;
      f[3 * k + 2] = fz;
      anchor[2 * k] = ax_new;
      anchor[2 * k + 1] = ay_new;
      contact[k] = fz > 0.f ? 1.f : 0.f;
    }
    // rhs = [0(6); tau] + Jc^T f - (C + G);  qdd = A^{-1} rhs
    float rhs[ND], qdd[ND];
    for (int c = 0; c < ND; ++c) {
      float acc = Jc[c] * f[0];
      for (int r = 1; r < 12; ++r) acc = fmaf(Jc[ND * r + c], f[r], acc);
      rhs[c] = acc - bvec[c];
      if (c >= 6) rhs[c] += tau[c - 6];
    }
    for (int i = 0; i < ND; ++i) {
      float acc = Ainv[ND * i] * rhs[0];
      for (int k = 1; k < ND; ++k) acc = fmaf(Ainv[ND * i + k], rhs[k], acc);
      qdd[i] = acc;
    }
    // pose update uses R of the quaternion before this substep
    const float w = quat[0], x = quat[1], y = quat[2], zq = quat[3];
    const float R[9] = {
        1.f - 2.f * (y * y + zq * zq), 2.f * (x * y - w * zq), 2.f * (x * zq + w * y),
        2.f * (x * y + w * zq), 1.f - 2.f * (x * x + zq * zq), 2.f * (y * zq - w * x),
        2.f * (x * zq - w * y), 2.f * (y * zq + w * x), 1.f - 2.f * (x * x + y * y)};
    for (int k = 0; k < ND; ++k) qdot[k] = qdot[k] + dt * qdd[k];
    for (int k = 0; k < 12; ++k) q[k] = q[k] + dt * qdot[6 + k];
    for (int i = 0; i < 3; ++i) {
      float acc = R[3 * i] * qdot[3];
      acc = fmaf(R[3 * i + 1], qdot[4], acc);
      acc = fmaf(R[3 * i + 2], qdot[5], acc);
      pos[i] = pos[i] + dt * acc;
    }
    const float wx = qdot[0] * dt, wy = qdot[1] * dt, wz = qdot[2] * dt;
    const float angle = sqrtf(wx * wx + wy * wy + wz * wz);
    const float inv_a = 1.0f / fmaxf(angle, 1e-12f);
    const float half = angle / 2.0f;
    const float ch = cosf(half), sh = sinf(half);
    const float s = inv_a * sh;
    const float dw = ch, dx = wx * s, dy = wy * s, dz = wz * s;
    const float nw = w * dw - x * dx - y * dy - zq * dz;
    const float nx = w * dx + x * dw + y * dz - zq * dy;
    const float ny = w * dy - x * dz + y * dw + zq * dx;
    const float nz = w * dz + x * dy - y * dx + zq * dw;
    const float norm = rsqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
    quat[0] = nw * norm;
    quat[1] = nx * norm;
    quat[2] = ny * norm;
    quat[3] = nz * norm;
    for (int k = 0; k < 12; ++k) pf[k] = pf[k] + dt * v_feet[k];
  }

  for (int k = 0; k < 4; ++k) quat_out[4 * b + k] = quat[k];
  for (int k = 0; k < 3; ++k) pos_out[3 * b + k] = pos[k];
  for (int k = 0; k < 6; ++k) vb_out[6 * b + k] = qdot[k];
  for (int k = 0; k < 12; ++k) {
    q_out[12 * b + k] = q[k];
    qd_out[12 * b + k] = qdot[6 + k];
    pf_out[12 * b + k] = pf[k];
  }
  for (int k = 0; k < 8; ++k) anchor_out[8 * b + k] = anchor[k];
  for (int k = 0; k < 4; ++k) contact_out[4 * b + k] = contact[k];
}

extern "C" int plant_launch(
    const float* quat, const float* pos, const float* vb, const float* q,
    const float* qd, const float* anchor, const float* tau, const float* Ainv,
    const float* G, const float* C, const float* Jc, const float* pf,
    float* quat_o, float* pos_o, float* vb_o, float* q_o, float* qd_o,
    float* anchor_o, float* pf_o, float* contact_o, PlantParams p, void* stream) {
  const int threads = 32;
  const int blocks = (p.B + threads - 1) / threads;
  plant_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      quat, pos, vb, q, qd, anchor, tau, Ainv, G, C, Jc, pf, quat_o, pos_o, vb_o,
      q_o, qd_o, anchor_o, pf_o, contact_o, p);
  return (int)cudaGetLastError();
}
