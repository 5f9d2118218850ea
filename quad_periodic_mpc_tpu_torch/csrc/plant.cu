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
// Decomposition: one warp per instance, kWarps instances to a block, the
// batch masked (a warp past B returns whole; nothing synchronises across
// warps).  Each warp stages its instance's A^{-1} (18x18) and Jc (12x18) in
// shared memory once, coalesced, with the velocities, foot positions and
// forces.  In a substep lane r < 12 takes row r of Jc qdot and p_foot[r],
// lanes 0..3 one foot's penalty contact each (its anchor and flag in
// registers), lane c < 18 column c of Jc^T f - (C + G) (+ tau), then row c
// of A^{-1} rhs and qdot[c]; lanes 6..17 the joint angles, lanes 0..2 the
// base position, and every lane carries the quaternion and updates it
// identically.  Four __syncwarp() a substep separate the dependent steps.
// Within a warp the lanes share one instruction stream, so work that sits
// on lanes apart does not overlap; what does is independent work in one
// branch-free step.  So the contact is computed with selects on every lane
// (lanes 0..3 keep theirs), and a substep's pose update, which reads only
// the new qdot and the old quaternion, runs beside the next substep's
// contact (the last one after the loop); the contact divides by div_rn
// (div_rn.cuh), which does not branch.  Every entry is one lane's sum in
// the k order of the first port and the TPU kernel, and the updates keep
// their order: qdot first, q and pos from the new qdot, R from the
// quaternion before the substep, p_foot from the old Jc qdot.
//
// What bounds it on this card: each substep is about 1.4 kflop of dependent
// mat-vecs (Jc qdot, Jc^T f, A^{-1} rhs) per instance, 10 substeps in a row,
// and about 2.3 KB of inputs per instance: the chain's latency, not
// bandwidth or throughput, bounds it at B = 256 (128 blocks of two warps)
// and at B = 1.  A substep's chain is Jc qdot (18 FMAs), the contact (a
// square root and two divisions deep), Jc^T f (12) and A^{-1} rhs (18),
// with four barriers.
//
// Precision: exact f32 FMAs, no --use_fast_math: sinf, cosf and the
// quaternion's rsqrtf enter the plant state.

#include <cuda_runtime.h>

#include "div_rn.cuh"

#define ND 18
#define NF 12                   // contact rows (4 feet x 3)

constexpr int kWarps = 2;       // instances (warps) a block

struct PlantParams {
  int B, substeps;
  float dt, k_normal, d_normal, mu, k_tangent, d_tangent;
};

// One instance's working set (one warp).
struct PlantWarp {
  float Ainv[ND * ND], Jc[NF * ND];
  float qdot[ND], rhs[ND], pf[NF], v_feet[NF], f[NF];
};

// What a lane carries in registers across the substeps.
struct Lane {
  float quat[4];                // every lane: the quaternion
  float pos;                    // lanes 0..2: the base position
  float q;                      // lanes 6..17: joint angle lane - 6
  float ax, ay, contact;        // lanes 0..3: foot lane's anchor and flag
};

// Penalty contact of foot k = lane & 3 (articulated_sim.contact_forces),
// computed on every lane with selects so that the warp does not diverge;
// lanes 0..3 keep their foot's anchor and flag and publish its force.  Both
// quotients are taken whether or not they are used: the values kept are
// those of the conditional form.
__device__ __forceinline__ void contact_step(const PlantParams p, PlantWarp& s, int lane,
                                             Lane& L) {
  const int k = lane & 3;
  const float* pfk = s.pf + 3 * k;
  const float* vk = s.v_feet + 3 * k;
  const float z = pfk[2], vz = vk[2];
  const float active = z < 0.f ? 1.f : 0.f;
  const float pen = fmaxf(-z, 0.f);
  const float fz = fmaxf(p.k_normal * pen - p.d_normal * vz * active, 0.f) * active;
  float ftx = (-p.k_tangent * (pfk[0] - L.ax) - p.d_tangent * vk[0]) * active;
  float fty = (-p.k_tangent * (pfk[1] - L.ay) - p.d_tangent * vk[1]) * active;
  const float ft_norm = sqrtf(ftx * ftx + fty * fty);
  const float limit = p.mu * fz;
  const bool slide = ft_norm > limit;
  const float capped = div_rn(limit, fmaxf(ft_norm, 1e-9f));
  const float scale = slide ? capped : 1.f;
  ftx = ftx * scale;
  fty = fty * scale;
  const float sx = pfk[0] + div_rn(ftx, p.k_tangent), sy = pfk[1] + div_rn(fty, p.k_tangent);
  float ax_new = slide ? sx : L.ax;
  float ay_new = slide ? sy : L.ay;
  const bool out = !(active > 0.f);
  ax_new = out ? pfk[0] : ax_new;
  ay_new = out ? pfk[1] : ay_new;
  if (lane < 4) {
    s.f[3 * k] = ftx;
    s.f[3 * k + 1] = fty;
    s.f[3 * k + 2] = fz;
  }
  L.ax = ax_new;
  L.ay = ay_new;
  L.contact = fz > 0.f ? 1.f : 0.f;
}

// The pose update of a substep whose new qdot is in s.qdot: pos += dt R v
// with R of the quaternion before the substep (lanes 0..2 keep row lane),
// then the quaternion, identically on every lane.
__device__ __forceinline__ void pose_step(const PlantWarp& s, int lane, float dt, Lane& L) {
  const float w = L.quat[0], x = L.quat[1], y = L.quat[2], zq = L.quat[3];
  const float R[9] = {
      1.f - 2.f * (y * y + zq * zq), 2.f * (x * y - w * zq), 2.f * (x * zq + w * y),
      2.f * (x * y + w * zq), 1.f - 2.f * (x * x + zq * zq), 2.f * (y * zq - w * x),
      2.f * (x * zq - w * y), 2.f * (y * zq + w * x), 1.f - 2.f * (x * x + y * y)};
  const float r0 = lane == 0 ? R[0] : lane == 1 ? R[3] : R[6];
  const float r1 = lane == 0 ? R[1] : lane == 1 ? R[4] : R[7];
  const float r2 = lane == 0 ? R[2] : lane == 1 ? R[5] : R[8];
  float acc = r0 * s.qdot[3];
  acc = fmaf(r1, s.qdot[4], acc);
  acc = fmaf(r2, s.qdot[5], acc);
  L.pos = L.pos + dt * acc;
  const float wx = s.qdot[0] * dt, wy = s.qdot[1] * dt, wz = s.qdot[2] * dt;
  const float angle = sqrtf(wx * wx + wy * wy + wz * wz);
  const float inv_a = 1.0f / fmaxf(angle, 1e-12f);
  const float half = angle / 2.0f;
  const float ch = cosf(half), sh = sinf(half);
  const float sc = inv_a * sh;
  const float dw = ch, dx = wx * sc, dy = wy * sc, dz = wz * sc;
  const float nw = w * dw - x * dx - y * dy - zq * dz;
  const float nx = w * dx + x * dw + y * dz - zq * dy;
  const float ny = w * dy - x * dz + y * dw + zq * dx;
  const float nz = w * dz + x * dy - y * dx + zq * dw;
  const float norm = rsqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
  L.quat[0] = nw * norm;
  L.quat[1] = nx * norm;
  L.quat[2] = ny * norm;
  L.quat[3] = nz * norm;
}

// One substep; with kPose the previous substep's pose update runs beside
// the contact (both need only what the previous substep left), so their
// two latency chains overlap.
template <bool kPose>
__device__ __forceinline__ void substep(const PlantParams p, PlantWarp& s, int lane,
                                        float bvec, float tau, Lane& L) {
  const float dt = p.dt;
  // v_feet = Jc qdot
  if (lane < NF) {
    float acc = s.Jc[ND * lane] * s.qdot[0];
#pragma unroll
    for (int k = 1; k < ND; ++k) acc = fmaf(s.Jc[ND * lane + k], s.qdot[k], acc);
    s.v_feet[lane] = acc;
  }
  __syncwarp();
  contact_step(p, s, lane, L);
  if (kPose) pose_step(s, lane, dt, L);
  __syncwarp();
  // rhs = [0(6); tau] + Jc^T f - (C + G)
  if (lane < ND) {
    float acc = s.Jc[lane] * s.f[0];
#pragma unroll
    for (int r = 1; r < NF; ++r) acc = fmaf(s.Jc[ND * r + lane], s.f[r], acc);
    const float rhs = acc - bvec;
    s.rhs[lane] = lane >= 6 ? rhs + tau : rhs;
  }
  __syncwarp();
  // qdd = A^{-1} rhs;  v += dt qdd;  q += dt qd (new);  p_foot += dt v_feet (old)
  if (lane < ND) {
    float acc = s.Ainv[ND * lane] * s.rhs[0];
#pragma unroll
    for (int k = 1; k < ND; ++k) acc = fmaf(s.Ainv[ND * lane + k], s.rhs[k], acc);
    const float qd = s.qdot[lane] + dt * acc;
    s.qdot[lane] = qd;
    if (lane >= 6) L.q = L.q + dt * qd;
  }
  if (lane < NF) s.pf[lane] = s.pf[lane] + dt * s.v_feet[lane];
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kWarps) plant_kernel(
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
  __shared__ PlantWarp warps[kWarps];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;
  PlantWarp& s = warps[threadIdx.x >> 5];

  // ---- stage the instance (fixed trip counts: every load in flight at once) ----
#pragma unroll
  for (int k = 0; k < (ND * ND + 31) / 32; ++k) {
    const int e = lane + 32 * k;
    if (e < ND * ND) s.Ainv[e] = Ainv_in[ND * ND * b + e];
  }
#pragma unroll
  for (int k = 0; k < (NF * ND + 31) / 32; ++k) {
    const int e = lane + 32 * k;
    if (e < NF * ND) s.Jc[e] = Jc_in[NF * ND * b + e];
  }
  if (lane < ND) s.qdot[lane] = lane < 6 ? vb_in[6 * b + lane] : qd_in[NF * b + lane - 6];
  if (lane < NF) s.pf[lane] = pf_in[NF * b + lane];
  Lane L;
  for (int k = 0; k < 4; ++k) L.quat[k] = quat_in[4 * b + k];
  const float bvec = lane < ND ? C_in[ND * b + lane] + G_in[ND * b + lane] : 0.f;
  const float tau = lane >= 6 && lane < ND ? tau_in[NF * b + lane - 6] : 0.f;
  L.q = lane >= 6 && lane < ND ? q_in[NF * b + lane - 6] : 0.f;
  L.pos = lane < 3 ? pos_in[3 * b + lane] : 0.f;
  L.ax = anchor_in[8 * b + 2 * (lane & 3)];
  L.ay = anchor_in[8 * b + 2 * (lane & 3) + 1];
  L.contact = 0.f;
  __syncwarp();

  if (p.substeps > 0) substep<false>(p, s, lane, bvec, tau, L);
  for (int step = 1; step < p.substeps; ++step) substep<true>(p, s, lane, bvec, tau, L);
  if (p.substeps > 0) pose_step(s, lane, p.dt, L);

  if (lane < 4) {
    quat_out[4 * b + lane] =
        lane == 0 ? L.quat[0] : lane == 1 ? L.quat[1] : lane == 2 ? L.quat[2] : L.quat[3];
    anchor_out[8 * b + 2 * lane] = L.ax;
    anchor_out[8 * b + 2 * lane + 1] = L.ay;
    contact_out[4 * b + lane] = L.contact;
  }
  if (lane < 3) pos_out[3 * b + lane] = L.pos;
  if (lane < 6) vb_out[6 * b + lane] = s.qdot[lane];
  if (lane >= 6 && lane < ND) {
    q_out[NF * b + lane - 6] = L.q;
    qd_out[NF * b + lane - 6] = s.qdot[lane];
  }
  if (lane < NF) pf_out[NF * b + lane] = s.pf[lane];
}

extern "C" int plant_launch(
    const float* quat, const float* pos, const float* vb, const float* q,
    const float* qd, const float* anchor, const float* tau, const float* Ainv,
    const float* G, const float* C, const float* Jc, const float* pf,
    float* quat_o, float* pos_o, float* vb_o, float* q_o, float* qd_o,
    float* anchor_o, float* pf_o, float* contact_o, PlantParams p, void* stream) {
  const int blocks = (p.B + kWarps - 1) / kWarps;
  plant_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      quat, pos, vb, q, qd, anchor, tau, Ainv, G, C, Jc, pf, quat_o, pos_o, vb_o,
      q_o, qd_o, anchor_o, pf_o, contact_o, p);
  return (int)cudaGetLastError();
}
