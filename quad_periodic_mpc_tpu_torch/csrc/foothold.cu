// The terrain tier's foothold update for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's control/cmpc_variant.py::
// foothold_update is one XLA fusion.  The port's plain version
// (control/cmpc_variant.py foothold_update_plain, terrain/heightmap.py
// select_foothold) builds (B, 4, 49, 2) int64 candidate indices and passes
// over them some hundred PyTorch operations a tick, 51-103 MB a pass at
// B = 32,768.  This kernel computes the same update, one thread per
// (instance, leg), _updateFoothold / _idxMapChecking
// (CMPC_Locomotion_cv.cpp:768-940):
//
//   p0 = first_swing ? p_feet : swing_p0             (the loop's hook)
//   (row, col) = world_to_index(pf): ceil((xy - center) / res), the
//       W/2 - / H/2 + offsets, clamped to the grid
//   the spiral's offsets in order, each candidate clamped to the grid; the
//       first with traversability > traversability_min is taken, else the
//       target's own cell with no valid cell ("moved" either way)
//   xy = the Raibert xy where the taken cell is the target's own or none is
//       valid, else center + res * (W/2 - col, row - H/2)
//   z  = p0_z + min(elevation(taken) - elevation(world_to_index(p0)),
//                   max_step_height)
//
// The plain version's first-valid argmax over where(valid, k..1, 0) picks
// the first valid candidate in spiral order, so stopping at it decides the
// same.  Rounding: every operation is the plain version's in its order and
// type, rounded once as a separate PyTorch kernel rounds it (the _rn
// intrinsics, so nvcc contracts no FMA): the division by the resolution is
// an IEEE division (heightmap.div), the cell's xy a product then a sum.
// There is no sum over elements, so on the same inputs the output is the
// plain version's bit for bit.
//
// Counters: FOOTHOLD_MOVED gets one integer atomicAdd per warp (the warp's
// moved legs counted by a ballot), FOOTHOLD_SEARCHED one add of every leg
// by thread 0; either pointer is null where the counter does not exist yet
// (a capture before the first eager update).  Integer sums are the same in
// any order.
//
// What bounds it on this card: per leg ~50 B read and written where they
// lie, and scattered reads of the maps, a 32-B sector each: the taken cell's
// traversability (more where the search moves on), two elevations.  At
// B = 32,768 that is ~20 MB, ~6 us at 3.35 TB/s; in the terrain cell
// (~7 % of the legs searching on) a launch takes 13-16 us.  Design: one
// thread per (instance, leg), 128 a block; the spiral's offsets (a device
// constant of the caller, any radius) staged in shared memory; inputs read
// through (row, column) stride pairs, so the wrapper copies nothing; the
// spiral walked one candidate at a time.  Reading eight candidates a round
// (fewer dependent loads for a leg that searches on) took 64 registers
// against 54 and ran ~9 % slower in the terrain cell on an H100.
//
// Precision: the scalar type T of the map and the targets, float (the
// port's policy) or double (the CLI's --f64); no --use_fast_math.

#include <cuda_runtime.h>

constexpr int kBlock = 128;

// A per-instance input viewed as (B, k): element j of instance b lies at
// p[b * row + j * col]; a broadcast axis has stride 0.
struct Strided {
  const void* p;
  long long row, col;
};

struct FootholdParams {
  int n, legs, H, W, k;         // n = instances x legs; k spiral offsets
  double res, trav_min, max_step;
  const int* offsets;           // (k, 2) (drow, dcol), in search order
  Strided pf, swing_p0;         // (B, legs * 3)
  Strided p_feet, first_swing;  // (B, legs * 3), (B, legs); p null: p0 = swing_p0
  Strided elevation, traversability;  // (B, H * W)
  Strided center;               // (B, 2)
  void* out;                    // (B, legs, 3) contiguous
  unsigned long long* moved;    // int64 device counters, or null
  unsigned long long* searched;
};

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float ceil_t(float a) { return ceilf(a); }
__device__ __forceinline__ double ceil_t(double a) { return ceil(a); }

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename E>
__device__ __forceinline__ E at(const Strided& s, long long b, long long j) {
  return static_cast<const E*>(s.p)[b * s.row + j * s.col];
}

// heightmap.world_to_index: the cell (row, col) of world (x, y), clamped
template <typename T>
__device__ __forceinline__ void cell_of(T x, T y, T cx, T cy, T res, int H, int W,
                                        long long& row, long long& col) {
  const T rx = rn_div(rn_sub(x, cx), res), ry = rn_div(rn_sub(y, cy), res);
  col = clamp_ll(W / 2 - (long long)ceil_t(rx), 0, W - 1);
  row = clamp_ll(H / 2 + (long long)ceil_t(ry), 0, H - 1);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) foothold_update_kernel(FootholdParams p) {
  extern __shared__ int offs[];
  for (int j = threadIdx.x; j < 2 * p.k; j += blockDim.x) offs[j] = p.offsets[j];
  __syncthreads();

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool active = i < p.n;
  bool moved = false;
  if (active) {
    const long long b = i / p.legs;
    const int leg = (int)(i - b * p.legs), c3 = 3 * leg;
    const T res = T(p.res), cx = at<T>(p.center, b, 0), cy = at<T>(p.center, b, 1);
    const T px = at<T>(p.pf, b, c3), py = at<T>(p.pf, b, c3 + 1);
    const bool first = p.first_swing.p && at<unsigned char>(p.first_swing, b, leg);
    const Strided& start = first ? p.p_feet : p.swing_p0;
    const T sx = at<T>(start, b, c3), sy = at<T>(start, b, c3 + 1),
            sz = at<T>(start, b, c3 + 2);

    long long row, col, row0, col0;
    cell_of(px, py, cx, cy, res, p.H, p.W, row, col);
    cell_of(sx, sy, cx, cy, res, p.H, p.W, row0, col0);

    // the first traversable cell in spiral order; none: the target's own
    const T tmin = T(p.trav_min);
    long long r = row, c = col;
    bool valid = false;
    for (int j = 0; j < p.k && !valid; ++j) {
      const long long rj = clamp_ll(row + offs[2 * j], 0, p.H - 1);
      const long long cj = clamp_ll(col + offs[2 * j + 1], 0, p.W - 1);
      if (at<T>(p.traversability, b, rj * p.W + cj) > tmin) {
        r = rj;
        c = cj;
        valid = true;
      }
    }
    const bool own = r == row && c == col;
    moved = !own || !valid;

    // select_foothold's z + foot_offset (0): -0 becomes +0 as there
    const T z = rn_add(at<T>(p.elevation, b, r * p.W + c), T(0));
    const T z0 = at<T>(p.elevation, b, row0 * p.W + col0);
    T x = px, y = py;
    if (valid && !own) {
      x = rn_add(cx, rn_mul(res, T(p.W / 2 - c)));
      y = rn_add(cy, rn_mul(res, T(r - p.H / 2)));
    }
    T dz = rn_sub(z, z0);
    dz = dz > T(p.max_step) ? T(p.max_step) : dz;   // torch.clamp(max=): NaN passes
    T* out = static_cast<T*>(p.out) + 3 * i;
    out[0] = x;
    out[1] = y;
    out[2] = rn_add(sz, dz);
  }

  // every thread of the warp votes, the inactive ones with false
  const unsigned votes = __ballot_sync(0xffffffffu, moved);
  if (p.moved && (threadIdx.x & 31) == 0 && votes)
    atomicAdd(p.moved, (unsigned long long)__popc(votes));
  if (p.searched && i == 0) atomicAdd(p.searched, (unsigned long long)p.n);
}

template <typename T>
int launch(const FootholdParams& p, void* stream) {
  const int blocks = (p.n + kBlock - 1) / kBlock;
  const int smem = 2 * p.k * (int)sizeof(int);
  auto kern = foothold_update_kernel<T>;
  kern<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int foothold_launch_f32(FootholdParams p, void* stream) {
  return launch<float>(p, stream);
}

extern "C" int foothold_launch_f64(FootholdParams p, void* stream) {
  return launch<double>(p, stream);
}
