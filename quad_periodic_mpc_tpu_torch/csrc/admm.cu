// Fused ADMM iterations with K^{-1} held on chip, for Hopper (sm_90a).
//
// Replaces the TPU kernel quad_periodic_mpc_tpu/ops/pallas/admm_kernel.py
// ::fused_admm_iterations (_kernel).  Per instance, `iters` OSQP iterations
// of the condensed MPC QP (n = 3k force variables, m = 5k pyramid rows,
// A = I_k (x) F with the shared 5x3 block F):
//   w   = rho z - y
//   rhs = sigma x - q + A^T w
//   x~  = K^{-1} rhs          (x~_i = sum_j K^{-1}[j][i] rhs_j: K^{-1} is
//                              symmetric, read by columns as the TPU kernel
//                              reads it; f32 accumulation in the order j = 0..)
//   x   = alpha x~ + (1 - alpha) x
//   zr  = alpha A x~ + (1 - alpha) z
//   z+  = clip(zr + y / rho, l, u);  y = y + rho (zr - z+);  z = z+
// The TPU kernel feeds A and A^T to its matrix unit as dense (m, n) matrices;
// here each is the 5x3 block per foot-step.
//
// What bounds it on this card.  K^{-1} read once is 4 n^2 bytes an instance
// (118 MB at B = 2048, h = 10: ~0.035 ms at 3.35 TB/s) and the products are
// 2 n^2 flop an iteration (~2 Gflop at 30 iterations: ~0.03 ms).  The first
// design (a thread a row, K^{-1} and every vector in shared memory, three
// barriers an iteration) was bound by neither but by the SM's shared-memory
// pipe: a load for every FMA, ~0.0098 ms an iteration at B = 2048, h = 10.
// This one reads K^{-1} from device memory once, at about that rate (the
// intercept, 0.048 ms), and then issues no load of it at h = 10; what is
// left is latency: an iteration is one thread's chain of n dependent FMAs
// (x~_i in j order), with three blocks (f32) or two (bf16) of four warps on
// an SM to hide it, ~0.003 ms an iteration (PERF.md).
//
// The layout.  One thread block per instance (grid = B) of ceil(n / 30)
// warps.  Warp w holds 10 foot-steps: lane l < 30 owns variable i = 30 w + l
// (step s = i / 3), its x and q, and one or two of the step's five pyramid
// rows (5 s + c and 5 s + 3 + c for c = l % 3 < 2), with their z, y, l, u,
// rho, 1/rho, all in registers for the whole loop; lanes 30 and 31 idle.  A
// step's A x~ and A^T w need only its own three variables and five rows, so
// they go through warp shuffles, and the only block-wide exchange is rhs:
// written once an iteration into one of two shared buffers and read back as
// 16-byte broadcasts (four j a load), one __syncthreads() an iteration.  The
// first J columns of K^{-1} in a thread's row (K^{-1}[j][i], j < J) sit in
// its registers, J = kJF32 / kJBf16 = 120 (all of them at h = 10):
// f32, or with kinv_bf16 two bf16 entries a 32-bit register, widened exactly
// as from_bf16 does.  Past kSmallWarps warps (h > 15) a block takes J / 2
// register columns in at most 128 registers.  The rest (j >= J) stays in
// dynamic shared memory: f32 rows copied with cp.async while the first rhs
// is formed, bf16 as pairs of rows in 32-bit words, one load for two
// entries.  Each x~_i is still one thread's chain of n fmaf in j order from
// 0.0f, and every other formula is the first design's, with the two sums of
// two products that the compiler could contract either way pinned by
// __fmul_rn to the way it contracted them there, so the outputs are that
// design's bit for bit.
//
// Resident sizes (227 KB of shared memory a block): f32 up to n = 264
// (h = 22), bf16 up to n = 360 (h = 30).  Beyond that K^{-1} is read from
// device memory in every iteration (the same arithmetic; with kinv_bf16
// rounded on the fly) by blocks of up to 32 warps with no register part,
// two variables a thread past n = 960; n up to 1920 (h = 160) is taken,
// and admm_launch returns cudaErrorInvalidValue past that.
//
// Precision: exact f32 FMAs, no TF32, no --use_fast_math.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_SMEM 232448

// Columns of K^{-1} in a thread's registers (multiples of 8): f32, and bf16
// two to a register.
constexpr int kJF32 = 120, kJBf16 = 120;
constexpr int kRowsWarp = 30;   // ten foot-steps: three variables, five rows each
constexpr int kMaxWarps = 32;
// K^{-1} held on chip: up to kSmallWarps warps with J register columns (f32
// in at most 170 registers a thread, so that two such blocks fit an SM;
// bf16, whose packing load needs more, in up to 255), else up to
// kLargeWarps warps with J / 2 columns in at most 128 registers.
constexpr int kSmallWarps = 6, kLargeWarps = 16;

struct AdmmParams {
  int B, n, m, iters, kinv_bf16;
  float sigma, over_relax;
};

// round to nearest even, as a float32 -> bfloat16 conversion does (a NaN
// stays a quiet NaN); branch-free
__device__ __forceinline__ uint16_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  const uint32_t rounded = (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  return (uint16_t)((u & 0x7fffffffu) > 0x7f800000u ? (u >> 16) | 0x40u : rounded);
}

__device__ __forceinline__ float from_bf16(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// The two entries of a pair word: the even row in the low half.
__device__ __forceinline__ float pair_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float pair_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// K^{-1}[j][i] for j < J of one thread's row i, in registers: J f32 words,
// or with BF16 J / 2 words of two bf16 entries.  get(j) is read only with j
// a constant (inside fully unrolled loops), so the array stays in registers.
template <bool BF16, int J>
struct KReg {
  static constexpr int kWords = BF16 ? J / 2 : J;
  uint32_t v[kWords > 0 ? kWords : 1];

  // Rows j >= n (only where n < J) load row n - 1 instead, never to be
  // read: no load waits on a predicate, so they all issue together.
  __device__ __forceinline__ static uint32_t entry(const float* Kg, int n, int i, int j) {
    const float k = Kg[(size_t)(j < n ? j : n - 1) * n + i];
    return BF16 ? (uint32_t)to_bf16(k) : __float_as_uint(k);
  }
  __device__ __forceinline__ void load(const float* Kg, int n, int i) {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      v[w] = BF16 ? entry(Kg, n, i, 2 * w) | (entry(Kg, n, i, 2 * w + 1) << 16)
                  : entry(Kg, n, i, w);
  }
  __device__ __forceinline__ float get(int j) const {
    if (BF16) return (j & 1) ? pair_hi(v[j >> 1]) : pair_lo(v[j >> 1]);
    return __uint_as_float(v[j]);
  }
};

// Words of dynamic shared memory: two rhs buffers, then the columns j >= J
// of K^{-1} where resident (f32 rows, or bf16 pairs of rows).
__host__ __device__ inline int padded(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int shared_words(int n, int J, bool bf16, bool resident) {
  const int rest = resident && n > J ? n - J : 0;
  return 2 * padded(n) + (bf16 ? (rest + 1) / 2 : rest) * n;
}

template <bool BF16, int J, int T, int MAXW>
__global__ void __launch_bounds__(32 * MAXW,
                                  MAXW == kSmallWarps && !BF16 ? 2 : 1)
    admm_kernel(const float* __restrict__ Kinv, const float* __restrict__ q_in,
                const float* __restrict__ l_in, const float* __restrict__ u_in,
                const float* __restrict__ rho_in, const float* __restrict__ F_in,
                const float* __restrict__ x0, const float* __restrict__ z0,
                const float* __restrict__ y0, float* __restrict__ x_out,
                float* __restrict__ z_out, float* __restrict__ y_out, const AdmmParams p) {
  constexpr bool RESIDENT = J > 0;   // else K^{-1} is read from device memory
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, pn = padded(n);
  const size_t b = blockIdx.x;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % 3, lb = lane - c;   // the step's component; its first lane
  const bool two = c < 2;                  // owns a second pyramid row
  float* Ks = smem + 2 * pn;               // K^{-1}[j][i], j >= J: f32 rows
  const uint32_t* Kp = reinterpret_cast<const uint32_t*>(Ks);   // or bf16 row pairs
  const float* Kg = Kinv + b * n * n;
  const float a = p.over_relax, sigma = p.sigma;

  // The shared part of K^{-1} starts first: f32 rows by cp.async.
  const int rest = n > J ? n - J : 0;
  if (RESIDENT && !BF16 && rest > 0) {
    const float* src = Kg + (size_t)J * n;
    const int count = rest * n;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && count % 4 == 0) {
      for (int e = 4 * threadIdx.x; e < count; e += 4 * blockDim.x)
        __pipeline_memcpy_async(Ks + e, src + e, 16);
    } else {
      for (int e = threadIdx.x; e < count; e += blockDim.x)
        __pipeline_memcpy_async(Ks + e, src + e, 4);
    }
    __pipeline_commit();
  }

  // This thread's rows: variable i, pyramid rows r1 = 5 s + c and r2 = r1 + 3.
  int row[T];
  bool live[T];
  float x[T], q[T], z1[T], y1[T], l1[T], u1[T], rh1[T], ri1[T];
  float z2[T], y2[T], l2[T], u2[T], rh2[T], ri2[T], w1[T], w2[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = kRowsWarp * (warp + warps * t) + lane;
    live[t] = lane < kRowsWarp && i < n;
    row[t] = live[t] ? i : c;
  }
  KReg<BF16, J> kr[T];
#pragma unroll
  for (int t = 0; t < T; ++t)
    if (J > 0) kr[t].load(Kg, n, row[t]);

  // F's entries this thread multiplies: A^T w for component c, A x~ for
  // rows c and 3 + c of the block.
  float fa[5], f1[3], f2[3];
#pragma unroll
  for (int r = 0; r < 5; ++r) fa[r] = F_in[3 * r + c];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f1[k] = F_in[3 * c + k];
    f2[k] = F_in[3 * (two ? 3 + c : c) + k];
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = row[t];
    const size_t g1 = b * m + 5 * (i / 3) + c, g2 = two ? g1 + 3 : g1;
    x[t] = x0[b * n + i];
    q[t] = q_in[b * n + i];
    z1[t] = z0[g1];
    y1[t] = y0[g1];
    l1[t] = l_in[g1];
    u1[t] = u_in[g1];
    rh1[t] = rho_in[g1];
    ri1[t] = 1.0f / rho_in[g1];
    w1[t] = rho_in[g1] * z0[g1] - y0[g1];
    z2[t] = z0[g2];
    y2[t] = y0[g2];
    l2[t] = l_in[g2];
    u2[t] = u_in[g2];
    rh2[t] = rho_in[g2];
    ri2[t] = 1.0f / rho_in[g2];
    w2[t] = rho_in[g2] * z0[g2] - y0[g2];
  }

  // rhs = sigma x - q + A^T w for this thread's variables, into buffer `dst`;
  // the step's five w come from the lanes that own its rows.
  auto form_rhs = [&](float* dst) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float wk0 = __shfl_sync(0xffffffffu, w1[t], lb);
      const float wk1 = __shfl_sync(0xffffffffu, w1[t], lb + 1);
      const float wk2 = __shfl_sync(0xffffffffu, w1[t], lb + 2);
      const float wk3 = __shfl_sync(0xffffffffu, w2[t], lb);
      const float wk4 = __shfl_sync(0xffffffffu, w2[t], lb + 1);
      float atw = fa[0] * wk0;
      atw = fmaf(fa[1], wk1, atw);
      atw = fmaf(fa[2], wk2, atw);
      atw = fmaf(fa[3], wk3, atw);
      atw = fmaf(fa[4], wk4, atw);
      if (live[t]) dst[row[t]] = (sigma * x[t] - q[t]) + atw;
    }
  };
  form_rhs(smem);

  // bf16 rows j >= J as pair words: rows J + 2 r (low half) and J + 2 r + 1.
  if (RESIDENT && BF16 && rest > 0) {
    uint32_t* Kw = reinterpret_cast<uint32_t*>(Ks);
    const int words = (rest + 1) / 2 * n;
    for (int e = threadIdx.x; e < words; e += blockDim.x) {
      const int r = e / n, i = e - r * n, j = J + 2 * r;
      const uint32_t lo = to_bf16(Kg[(size_t)j * n + i]);
      const uint32_t hi = j + 1 < n ? to_bf16(Kg[(size_t)(j + 1) * n + i]) : 0u;
      Kw[e] = lo | (hi << 16);
    }
  }
  if (RESIDENT && !BF16 && rest > 0) __pipeline_wait_prior(0);
  __syncthreads();

  // K^{-1}[j][row t] for j >= J, one entry or a quad (j - J a multiple of 4,
  // j + 3 < n: with bf16 two pair words)
  auto kcol = [&](int t, int j) -> float {
    if (RESIDENT) {
      if (BF16) {
        const uint32_t w = Kp[((j - J) >> 1) * n + row[t]];
        return ((j - J) & 1) ? pair_hi(w) : pair_lo(w);
      }
      return Ks[(j - J) * n + row[t]];
    }
    const float k = Kg[(size_t)j * n + row[t]];
    return BF16 ? from_bf16(to_bf16(k)) : k;
  };
  auto kquad = [&](int t, int j, float (&k)[4]) {
    if (RESIDENT && BF16) {
      const uint32_t* w = Kp + ((j - J) >> 1) * n + row[t];
      const uint32_t w0 = w[0], w1 = w[n];
      k[0] = pair_lo(w0);
      k[1] = pair_hi(w0);
      k[2] = pair_lo(w1);
      k[3] = pair_hi(w1);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) k[e] = kcol(t, j + e);
    }
  };

  for (int it = 0; it < p.iters; ++it) {
    const float4* r4 = reinterpret_cast<const float4*>(smem + (it & 1) * pn);
    // x~ = K^{-1} rhs by columns: the register part, then the rest
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.0f;
    if (J > 0) {
      if (n >= J) {
#pragma unroll
        for (int d = 0; d < J / 4; ++d) {
          const float4 r = r4[d];
#pragma unroll
          for (int t = 0; t < T; ++t) {
            acc[t] = fmaf(kr[t].get(4 * d), r.x, acc[t]);
            acc[t] = fmaf(kr[t].get(4 * d + 1), r.y, acc[t]);
            acc[t] = fmaf(kr[t].get(4 * d + 2), r.z, acc[t]);
            acc[t] = fmaf(kr[t].get(4 * d + 3), r.w, acc[t]);
          }
        }
      } else {
#pragma unroll
        for (int d = 0; d < J / 4; ++d) {
          if (4 * d >= n) break;
          const float4 r = r4[d];
#pragma unroll
          for (int t = 0; t < T; ++t) {
            acc[t] = fmaf(kr[t].get(4 * d), r.x, acc[t]);
            if (4 * d + 1 < n) acc[t] = fmaf(kr[t].get(4 * d + 1), r.y, acc[t]);
            if (4 * d + 2 < n) acc[t] = fmaf(kr[t].get(4 * d + 2), r.z, acc[t]);
            if (4 * d + 3 < n) acc[t] = fmaf(kr[t].get(4 * d + 3), r.w, acc[t]);
          }
        }
      }
    }
    int j = J;
#pragma unroll 4
    for (; j + 4 <= n; j += 4) {
      const float4 r = r4[j / 4];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float k[4];
        kquad(t, j, k);
        acc[t] = fmaf(k[0], r.x, acc[t]);
        acc[t] = fmaf(k[1], r.y, acc[t]);
        acc[t] = fmaf(k[2], r.z, acc[t]);
        acc[t] = fmaf(k[3], r.w, acc[t]);
      }
    }
    if (j < n) {
      const float4 r = r4[j / 4];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        acc[t] = fmaf(kcol(t, j), r.x, acc[t]);
        if (j + 1 < n) acc[t] = fmaf(kcol(t, j + 1), r.y, acc[t]);
        if (j + 2 < n) acc[t] = fmaf(kcol(t, j + 2), r.z, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      x[t] = a * acc[t] + __fmul_rn(1.0f - a, x[t]);
      // z~ = A x~ for this thread's rows, relax, clip, dual update, w
      const float xk0 = __shfl_sync(0xffffffffu, acc[t], lb);
      const float xk1 = __shfl_sync(0xffffffffu, acc[t], lb + 1);
      const float xk2 = __shfl_sync(0xffffffffu, acc[t], lb + 2);
      {
        float zt = f1[0] * xk0;
        zt = fmaf(f1[1], xk1, zt);
        zt = fmaf(f1[2], xk2, zt);
        const float zr = a * zt + __fmul_rn(1.0f - a, z1[t]);
        const float zn = fminf(fmaxf(zr + ri1[t] * y1[t], l1[t]), u1[t]);
        const float yn = y1[t] + rh1[t] * (zr - zn);
        z1[t] = zn;
        y1[t] = yn;
        w1[t] = rh1[t] * zn - yn;
      }
      {
        float zt = f2[0] * xk0;
        zt = fmaf(f2[1], xk1, zt);
        zt = fmaf(f2[2], xk2, zt);
        const float zr = a * zt + __fmul_rn(1.0f - a, z2[t]);
        const float zn = fminf(fmaxf(zr + ri2[t] * y2[t], l2[t]), u2[t]);
        const float yn = y2[t] + rh2[t] * (zr - zn);
        z2[t] = zn;
        y2[t] = yn;
        w2[t] = rh2[t] * zn - yn;
      }
    }
    if (it + 1 < p.iters) form_rhs(smem + ((it + 1) & 1) * pn);
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (!live[t]) continue;
    const int i = row[t];
    const size_t g1 = b * m + 5 * (i / 3) + c;
    x_out[b * n + i] = x[t];
    z_out[g1] = z1[t];
    y_out[g1] = y1[t];
    if (two) {
      z_out[g1 + 3] = z2[t];
      y_out[g1 + 3] = y2[t];
    }
  }
}

struct AdmmArgs {
  const float *Kinv, *q, *l, *u, *rho, *F, *x0, *z0, *y0;
  float *x, *z, *y;
};

template <bool BF16, int J, int T, int MAXW>
static int launch(const AdmmArgs& a, const AdmmParams& p, int threads, void* stream) {
  auto kern = admm_kernel<BF16, J, T, MAXW>;
  const int smem = 4 * shared_words(p.n, J, BF16, J > 0);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
  }
  kern<<<p.B, threads, smem, (cudaStream_t)stream>>>(a.Kinv, a.q, a.l, a.u, a.rho, a.F, a.x0,
                                                     a.z0, a.y0, a.x, a.z, a.y, p);
  return (int)cudaGetLastError();
}

// warps for n variables, `rows` a thread
static int warps_for(int n, int rows) {
  const int groups = (n + kRowsWarp - 1) / kRowsWarp;
  return (groups + rows - 1) / rows;
}

// Register columns where K^{-1} of n variables is held on chip: J (the
// storage's) up to kSmallWarps warps, J / 2 up to kLargeWarps; 0 past that.
static int columns_on_chip(int n, bool bf16) {
  const int J = bf16 ? kJBf16 : kJF32, warps = warps_for(n, 1);
  return warps <= kSmallWarps ? J : warps <= kLargeWarps ? J / 2 : 0;
}

// Bytes of dynamic shared memory a block takes with K^{-1} of an (n, m)
// problem held on chip: the rhs buffers and the columns past the register
// part.
extern "C" long admm_shared_bytes(int n, int m, int kinv_bf16) {
  (void)m;
  const bool bf16 = kinv_bf16 != 0;
  return 4L * shared_words(n, columns_on_chip(n, bf16), bf16, true);
}

// 1 if K^{-1} of an (n, m) problem is held on chip (registers and shared
// memory), else 0.
extern "C" int admm_resident(int n, int m, int kinv_bf16) {
  const bool on_chip = columns_on_chip(n, kinv_bf16 != 0) > 0;
  return on_chip && admm_shared_bytes(n, m, kinv_bf16) <= MAX_SMEM ? 1 : 0;
}

template <bool BF16>
static int launch_storage(const AdmmArgs& a, const AdmmParams& p, void* stream) {
  constexpr int J = BF16 ? kJBf16 : kJF32;
  if (admm_resident(p.n, p.m, BF16)) {
    const int threads = 32 * warps_for(p.n, 1);
    return columns_on_chip(p.n, BF16) == J
               ? launch<BF16, J, 1, kSmallWarps>(a, p, threads, stream)
               : launch<BF16, J / 2, 1, kLargeWarps>(a, p, threads, stream);
  }
  if (warps_for(p.n, 1) <= kMaxWarps)
    return launch<BF16, 0, 1, kMaxWarps>(a, p, 32 * warps_for(p.n, 1), stream);
  if (warps_for(p.n, 2) <= kMaxWarps)
    return launch<BF16, 0, 2, kMaxWarps>(a, p, 32 * warps_for(p.n, 2), stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int admm_launch(const float* Kinv, const float* q, const float* l, const float* u,
                           const float* rho, const float* F, const float* x0,
                           const float* z0, const float* y0, float* x, float* z, float* y,
                           AdmmParams p, void* stream) {
  const AdmmArgs a{Kinv, q, l, u, rho, F, x0, z0, y0, x, z, y};
  return p.kinv_bf16 ? launch_storage<true>(a, p, stream) : launch_storage<false>(a, p, stream);
}
