// The swing update of one control tick for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's control/mpc.py::swing_update
// is one XLA fusion.  The port's plain version (control/mpc.py
// swing_update_plain, ops/gait.py, ops/swing.py, ops/rotations.py)
// dispatches ~300 PyTorch operations an update, each of a few bytes an
// instance, so on the card it runs at the launch floor (~1-2 us a graph
// node), not at its bytes.  This kernel computes the same update, one
// thread per instance with its four legs in registers:
//
//   R = quat_to_rotmat(q),  v_des_world = R [x_vel_des, y_vel_des, 0]
//   the gait's phase, contact and swing states, swing and stance times
//   swing timers: first_swing ? swing_time : remaining - dt
//   pf_target = the Raibert foothold (ConvexMPCLocomotion.cpp:287-331)
//   p0 locked at a swing's start, pf taken while swinging
//   the Bezier swing curve in swing, the foot held in stance (v = a = 0)
//   first_swing = !in_swing, iteration + 1
//   world_position_desired += dt v_des_world unless the gait stands
//   the roll/pitch integral from quat_to_rpy, its guards and clamp
//
// mode 0 does all of it; around the terrain tier's foothold hook (a PyTorch
// function between the Raibert target and the rest) mode 1 writes the
// Raibert targets and mode 2 finishes from the hook's targets.
//
// Rounding: every operation is the plain version's, in its order, rounded
// once as a separate PyTorch kernel rounds it (the _rn intrinsics: nvcc
// contracts no FMA across them), in the plain version's types: the gait's
// phases, states and times are float32 whatever T (ops/gait.py's
// .float()), and T promotes them where PyTorch does.  A tensor divided by
// a Python number is multiplied by its reciprocal, as PyTorch's CUDA
// division does.  sinf / cosf / atan2f / asinf are libdevice's, as
// PyTorch's CUDA kernels call them.  The two 3x3 products (R v_des and the
// Raibert rotation; cuBLAS bmm on the plain path) are summed here in index
// order, so the Raibert target and world_position_desired may lie an ulp
// or two from the plain path's; every other output is the plain path's
// bit for bit on the same inputs.
//
// What bounds it on this card: per instance ~300 B read and ~350 B
// written in float, and a few hundred operations, so bytes (3.35 TB/s):
// ~6 us at B = 32,768.  Design: one thread per instance, 128 a block;
// each input is read where it lies, through a (row, column) stride pair,
// so the wrapper copies nothing (an observation sliced from the plant
// state, a gait or a tunable shared by the batch); a thread reads all of
// its inputs before it writes anything (Instance::load), so the loads are
// in flight together; outputs are written contiguous.
//
// Precision: the scalar type T of the state, float (the port's policy) or
// double (the CLI's --f64); no --use_fast_math.

#include <cuda_runtime.h>

constexpr int kBlock = 128;

// A per-instance input viewed as (B, k): element j of instance b lies at
// p[b * row + j * col]; a broadcast axis has stride 0.
struct Strided {
  const void* p;
  long long row, col;
};

// The update's scalars (Python floats, converted to T or float in the
// kernel as PyTorch converts a Python number) and its tensors.
struct SwingParams {
  int B, mode, iters_per_mpc;
  double dt, dt_mpc, abad_link_length, interleave_gain;
  double half_plus_bonus, swing_height, p_rel_max;   // used where the tensor is absent
  double hip[12], side_sign[4], interleave_y[4];
  Strided p, v, quat, p_feet;                         // the observation
  Strided iteration, x_vel_des, y_vel_des, wpd, rpy_int, first_swing, str, swing_p0, swing_pf;
  Strided yaw_rate, offsets, durations, n_segments;
  Strided swing_height_t, bonus_swing_t, p_rel_max_t;  // (B, 4) views; p null: the scalar
  Strided pf_in;                                      // mode 2: the hook's targets
  void *iteration_o, *wpd_o, *rpy_int_o, *rpy_comp_o, *first_swing_o, *str_o;
  void *p0_o, *pf_o, *p_des_o, *v_des_o, *a_des_o, *contact_o, *swing_o, *pf_target_o;
};

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sin_t(float a) { return sinf(a); }
__device__ __forceinline__ double sin_t(double a) { return sin(a); }
__device__ __forceinline__ float cos_t(float a) { return cosf(a); }
__device__ __forceinline__ double cos_t(double a) { return cos(a); }
__device__ __forceinline__ float atan2_t(float a, float b) { return atan2f(a, b); }
__device__ __forceinline__ double atan2_t(double a, double b) { return atan2(a, b); }
__device__ __forceinline__ float asin_t(float a) { return asinf(a); }
__device__ __forceinline__ double asin_t(double a) { return asin(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

// torch.clamp: a NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_t(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename E>
__device__ __forceinline__ E at(const Strided& s, long long b, int j) {
  return static_cast<const E*>(s.p)[b * s.row + j * s.col];
}

// ops/swing.py's Bezier factors of x (float32: the gait's phase)
__device__ __forceinline__ float bezier_basis(float x) {   // x^3 + 3 x^2 (1 - x)
  const float xx = rn_mul(x, x);
  return rn_add(rn_mul(xx, x), rn_mul(rn_mul(xx, rn_sub(1.0f, x)), 3.0f));
}
__device__ __forceinline__ float bezier_d1(float x) {      // 6 x (1 - x)
  return rn_mul(rn_mul(x, 6.0f), rn_sub(1.0f, x));
}
__device__ __forceinline__ float bezier_d2(float x) {      // 6 - 12 x
  return rn_sub(6.0f, rn_mul(x, 12.0f));
}

// One instance's inputs, all read before anything is written: the outputs
// may not alias the inputs for all the compiler knows, so a load after a
// store would wait for it, one memory latency each.
template <typename T>
struct Instance {
  T q[4], pos[3], vel[2], feet[12], xvd, yvd, wpd[3], rpy_int[2], str[4];
  T p0[12], pf[12], yaw, height[4], bonus[4], prm[4], pf_in[12];
  int it, nseg, off[4], dur[4];
  bool first[4];

  __device__ __forceinline__ void load(const SwingParams& p, long long b) {
    for (int j = 0; j < 4; ++j) q[j] = at<T>(p.quat, b, j);
    for (int j = 0; j < 3; ++j) pos[j] = at<T>(p.p, b, j);
    for (int j = 0; j < 2; ++j) vel[j] = at<T>(p.v, b, j);
    for (int j = 0; j < 12; ++j) {
      feet[j] = at<T>(p.p_feet, b, j);
      p0[j] = at<T>(p.swing_p0, b, j);
      pf[j] = at<T>(p.swing_pf, b, j);
      pf_in[j] = p.pf_in.p ? at<T>(p.pf_in, b, j) : T(0);
    }
    xvd = at<T>(p.x_vel_des, b, 0);
    yvd = at<T>(p.y_vel_des, b, 0);
    yaw = at<T>(p.yaw_rate, b, 0);
    for (int j = 0; j < 3; ++j) wpd[j] = at<T>(p.wpd, b, j);
    for (int j = 0; j < 2; ++j) rpy_int[j] = at<T>(p.rpy_int, b, j);
    it = at<int>(p.iteration, b, 0);
    nseg = at<int>(p.n_segments, b, 0);
    for (int k = 0; k < 4; ++k) {
      str[k] = at<T>(p.str, b, k);
      first[k] = at<unsigned char>(p.first_swing, b, k);
      off[k] = at<int>(p.offsets, b, k);
      dur[k] = at<int>(p.durations, b, k);
      height[k] = p.swing_height_t.p ? at<T>(p.swing_height_t, b, k) : T(p.swing_height);
      // 0.5 + bonus_swing: Python's sum rounded to T, or the tensor's in T
      bonus[k] = p.bonus_swing_t.p ? rn_add(at<T>(p.bonus_swing_t, b, k), T(0.5))
                                   : T(p.half_plus_bonus);
      prm[k] = p.p_rel_max_t.p ? at<T>(p.p_rel_max_t, b, k) : T(p.p_rel_max);
    }
  }
};

// the Raibert foothold of leg k (swing.raibert_foothold), z = 0
template <typename T>
__device__ __forceinline__ void raibert(const SwingParams& p, const Instance<T>& in, int k,
                                        const T R[3][3], const T vdw[3], float stance_time,
                                        T str_new, T out[3]) {
  const T v_abs = abs_t(in.xvd);
  const T offset_y = rn_mul(T(p.side_sign[k]), T(p.abad_link_length));
  const T px = T(p.hip[3 * k]);
  const T py = rn_add(T(p.hip[3 * k + 1]),
                      rn_add(offset_y, rn_mul(rn_mul(T(p.interleave_y[k]), v_abs),
                                              T(p.interleave_gain))));
  const T pz = T(p.hip[3 * k + 2]);
  const T st = T(stance_time), yaw = in.yaw;
  const T ang = rn_mul(rn_mul(yaw, st), T(0.5));
  const T c = cos_t(ang), s = sin_t(ang);
  const T local[3] = {rn_add(rn_sub(rn_mul(c, px), rn_mul(s, py)), rn_mul(in.xvd, str_new)),
                      rn_add(rn_add(rn_mul(s, px), rn_mul(c, py)), rn_mul(in.yvd, str_new)),
                      rn_add(pz, rn_mul(T(0), str_new))};
  T pf[2];
  for (int i = 0; i < 2; ++i)
    pf[i] = rn_add(in.pos[i],
                   rn_add(rn_add(rn_mul(R[i][0], local[0]), rn_mul(R[i][1], local[1])),
                          rn_mul(R[i][2], local[2])));
  const T v0 = in.vel[0], v1 = in.vel[1];
  const T lean = rn_mul(rn_mul(T(0.5), in.pos[2]), rn_div(T(1), T(9.81)));
  T pfx = rn_add(rn_add(rn_mul(rn_mul(v0, in.bonus[k]), st), rn_mul(rn_sub(v0, vdw[0]), T(0.03))),
                 rn_mul(lean, rn_mul(v1, yaw)));
  T pfy = rn_add(rn_add(rn_mul(rn_mul(rn_mul(v1, T(0.5)), st), T(p.dt_mpc)),
                        rn_mul(rn_sub(v1, vdw[1]), T(0.03))),
                 rn_mul(lean, rn_mul(-v0, yaw)));
  pfx = clamp_t(pfx, -in.prm[k], in.prm[k]);
  pfy = clamp_t(pfy, -in.prm[k], in.prm[k]);
  out[0] = rn_add(pf[0], pfx);
  out[1] = rn_add(pf[1], pfy);
  out[2] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) swing_update_kernel(const SwingParams p) {
  const long long b = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (b >= p.B) return;
  Instance<T> in;
  in.load(p, b);

  // R = quat_to_rotmat(q), entry by entry
  const T w = in.q[0], x = in.q[1], y = in.q[2], z = in.q[3];
  const T n = rn_add(rn_add(rn_add(rn_mul(w, w), rn_mul(x, x)), rn_mul(y, y)), rn_mul(z, z));
  const T s = n > T(0) ? rn_mul(rn_div(T(1), n), T(2)) : T(0);
  const T sw = rn_mul(s, w), sx = rn_mul(s, x), sy = rn_mul(s, y), sz = rn_mul(s, z);
  const T wx = rn_mul(sw, x), wy = rn_mul(sw, y), wz = rn_mul(sw, z);
  const T xx = rn_mul(sx, x), xy = rn_mul(sx, y), xz = rn_mul(sx, z);
  const T yy = rn_mul(sy, y), yz = rn_mul(sy, z), zz = rn_mul(sz, z);
  const T R[3][3] = {{rn_sub(T(1), rn_add(yy, zz)), rn_sub(xy, wz), rn_add(xz, wy)},
                     {rn_add(xy, wz), rn_sub(T(1), rn_add(xx, zz)), rn_sub(yz, wx)},
                     {rn_sub(xz, wy), rn_add(yz, wx), rn_sub(T(1), rn_add(xx, yy))}};
  T vdw[3];
  for (int i = 0; i < 3; ++i)
    vdw[i] = rn_add(rn_add(rn_mul(R[i][0], in.xvd), rn_mul(R[i][1], in.yvd)),
                    rn_mul(R[i][2], T(0)));

  // the gait (ops/gait.py, float32)
  const int period = p.iters_per_mpc * in.nseg;
  int r = in.it % period;
  if (r != 0 && ((r < 0) != (period < 0))) r += period;   // Python's %
  const float ph = rn_div((float)r, (float)period);
  const float seg = (float)in.nseg;
  const float dt_mpc_f = (float)p.dt_mpc;
  const T dt = T(p.dt);
  float contact[4], swing[4], swing_time[4], stance_time[4];
  T str_new[4];
  bool standing = true;
  for (int k = 0; k < 4; ++k) {
    const float off = rn_div((float)in.off[k], seg), dur = rn_div((float)in.dur[k], seg);
    const float off_c = off < 0.0f ? rn_add(off, 1.0f) : off;
    float prog = rn_sub(ph, off_c);
    prog = prog < 0.0f ? rn_add(prog, 1.0f) : prog;
    contact[k] = (prog > dur || dur <= 0.0f) ? 0.0f : rn_div(prog, dur > 0.0f ? dur : 1.0f);
    float s_off = rn_add(off, dur);
    s_off = s_off > 1.0f ? rn_sub(s_off, 1.0f) : s_off;
    const float s_dur = rn_sub(1.0f, dur);
    float s_prog = rn_sub(ph, s_off);
    s_prog = s_prog < 0.0f ? rn_add(s_prog, 1.0f) : s_prog;
    swing[k] = s_prog >= s_dur ? 0.0f : rn_div(s_prog, s_dur > 0.0f ? s_dur : 1.0f);
    swing_time[k] = rn_mul((float)(in.nseg - in.dur[k]), dt_mpc_f);
    stance_time[k] = rn_mul((float)in.dur[k], dt_mpc_f);
    standing = standing && in.dur[k] >= in.nseg;
    // swing timers (:287-296)
    str_new[k] = in.first[k] ? T(swing_time[k]) : rn_sub(in.str[k], dt);
  }

  if (p.mode == 1) {
    T* pf_t = static_cast<T*>(p.pf_target_o) + 12 * b;
    for (int k = 0; k < 4; ++k)
      raibert(p, in, k, R, vdw, stance_time[k], str_new[k], pf_t + 3 * k);
    return;
  }

  T p0[12], pf[12], p_des[12], v_des[12], a_des[12];
  for (int k = 0; k < 4; ++k) {
    const bool in_swing = swing[k] > 0.0f;
    T target[3];
    if (p.mode == 0) {
      raibert(p, in, k, R, vdw, stance_time[k], str_new[k], target);
    } else {
      for (int j = 0; j < 3; ++j) target[j] = in.pf_in[3 * k + j];
    }
    const T* foot = in.feet + 3 * k;
    for (int j = 0; j < 3; ++j) {
      const int i = 3 * k + j;
      p0[i] = in_swing && in.first[k] ? foot[j] : in.p0[i];   // lock p0 (:376-381)
      pf[i] = in_swing ? target[j] : in.pf[i];
      // stance: hold position, zero velocity (:413-421)
      p_des[i] = foot[j];
      v_des[i] = T(0);
      a_des[i] = T(0);
    }
    if (!in_swing) continue;
    // swing.evaluate: xy one Bezier, z a lift/land pair
    const float ph_s = swing[k], st_f = swing_time[k];
    const T st = T(st_f), st2 = T(rn_mul(st_f, st_f));
    const T basis = T(bezier_basis(ph_s)), d1 = T(bezier_d1(ph_s)), d2 = T(bezier_d2(ph_s));
    for (int j = 0; j < 2; ++j) {
      const int i = 3 * k + j;
      const T d = rn_sub(pf[i], p0[i]);
      p_des[i] = rn_add(p0[i], rn_mul(basis, d));
      v_des[i] = rn_div(rn_mul(d1, d), st);
      a_des[i] = rn_div(rn_mul(d2, d), st2);
    }
    const int i = 3 * k + 2;
    const T zmid = rn_add(p0[i], in.height[k]);
    const bool lift = ph_s < 0.5f;
    const float xq = lift ? rn_mul(ph_s, 2.0f) : rn_sub(rn_mul(ph_s, 2.0f), 1.0f);
    const T za = lift ? p0[i] : zmid, zb = lift ? zmid : pf[i];
    const T dz = rn_sub(zb, za);
    p_des[i] = rn_add(za, rn_mul(T(bezier_basis(xq)), dz));
    v_des[i] = rn_div(rn_mul(rn_mul(T(bezier_d1(xq)), dz), T(2)), st);
    a_des[i] = rn_div(rn_mul(rn_mul(T(bezier_d2(xq)), dz), T(4)), st2);
  }

  // integrate the desired world position (:237-240)
  T wpd[3];
  for (int i = 0; i < 3; ++i) wpd[i] = rn_add(in.wpd[i], standing ? T(0) : rn_mul(vdw[i], dt));

  // roll/pitch integral compensation (:217-230), quat_to_rpy's roll and pitch
  const T as_ = clamp_t(rn_mul(rn_sub(rn_mul(x, z), rn_mul(w, y)), T(-2)), T(-1), T(0.99999));
  const T pitch = asin_t(as_);
  const T roll = atan2_t(rn_mul(rn_add(rn_mul(y, z), rn_mul(w, x)), T(2)),
                         rn_add(rn_sub(rn_sub(rn_mul(w, w), rn_mul(x, x)), rn_mul(y, y)),
                                rn_mul(z, z)));
  const T vx = in.vel[0], vy = in.vel[1];
  const T d_pitch = abs_t(vx) > T(0.2)
      ? rn_div(rn_mul(rn_sub(T(0), pitch), dt), vx == T(0) ? T(1) : vx) : T(0);
  const T d_roll = abs_t(vy) > T(0.1)
      ? rn_div(rn_mul(rn_sub(T(0), roll), dt), vy == T(0) ? T(1) : vy) : T(0);
  const T int0 = clamp_t(rn_add(in.rpy_int[0], d_roll), T(-0.25), T(0.25));
  const T int1 = clamp_t(rn_add(in.rpy_int[1], d_pitch), T(-0.25), T(0.25));

  // every store after every load
  for (int i = 0; i < 12; ++i) {
    static_cast<T*>(p.p0_o)[12 * b + i] = p0[i];
    static_cast<T*>(p.pf_o)[12 * b + i] = pf[i];
    static_cast<T*>(p.p_des_o)[12 * b + i] = p_des[i];
    static_cast<T*>(p.v_des_o)[12 * b + i] = v_des[i];
    static_cast<T*>(p.a_des_o)[12 * b + i] = a_des[i];
  }
  for (int k = 0; k < 4; ++k) {
    static_cast<unsigned char*>(p.first_swing_o)[4 * b + k] = !(swing[k] > 0.0f);
    static_cast<float*>(p.contact_o)[4 * b + k] = contact[k];
    static_cast<float*>(p.swing_o)[4 * b + k] = swing[k];
    static_cast<T*>(p.str_o)[4 * b + k] = str_new[k];
  }
  static_cast<int*>(p.iteration_o)[b] = in.it + 1;
  for (int i = 0; i < 3; ++i) static_cast<T*>(p.wpd_o)[3 * b + i] = wpd[i];
  static_cast<T*>(p.rpy_int_o)[2 * b] = int0;
  static_cast<T*>(p.rpy_int_o)[2 * b + 1] = int1;
  static_cast<T*>(p.rpy_comp_o)[2 * b] = rn_mul(vy, int0);
  static_cast<T*>(p.rpy_comp_o)[2 * b + 1] = rn_mul(vx, int1);
}

template <typename T>
int launch(const SwingParams& p, void* stream) {
  const int blocks = (p.B + kBlock - 1) / kBlock;
  auto kern = swing_update_kernel<T>;
  kern<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int swing_update_launch_f32(SwingParams p, void* stream) {
  return launch<float>(p, stream);
}

extern "C" int swing_update_launch_f64(SwingParams p, void* stream) {
  return launch<double>(p, stream);
}
