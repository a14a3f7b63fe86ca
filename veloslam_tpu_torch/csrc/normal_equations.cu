// One Gauss-Newton iteration of batched point-to-plane registration on the
// card: the fused normal equations and the damped 6x6 step in one launch
// (sm_90a, plain C interface for ctypes).
//
// Replaces: veloslam_tpu/registration/pallas_kernels.py::fused_normal_equations
// (body _ne_kernel) together with the XLA code around it in
// veloslam_tpu/registration/gicp.py::register (normal_equations_fixed's
// prologue, and gn_iter's damped Cholesky solve, step guard, step clamp and
// se3.retract).  One call covers all F frame slots.  Per point:
//   p' = R(q) p + t;  r = n . (p' - mu);  hit &= |r| < max_dist;
//   w = Huber(r) * hit;  J = [p' x n | n];
// per slot: H = sum (w J) J^T (21 upper entries, mirrored), b = sum (w J) r,
// err_sum = sum w |r|, w_sum = sum w, n_hit = sum hit; and, when a pose is
// asked for, Hd = H + damping I + 1e-6 trace(H) I = L L^T, delta = -Hd^-1 b,
// ok = finite delta, n_hit > 10 and every pivot finite and > 0 (else
// delta = 0), delta clamped to 1 m and 0.3 rad, pose' = exp(delta) o pose.
//
// What bounds it (NVIDIA H100 80GB HBM3 at 700 W; profile_ne.py's device
// time a GN step, chip_smoke.py's torch.sum):
// - Bytes.  The result depends on every point's p, mu and n: a point
//   without a correspondence adds w = 0 times its terms, an exact 0 only
//   while they are finite, and NaN (as in the plain version) where not.
//   So every point's 37 bytes are read: 58 MB at (96, 16384), 17.4 us at
//   3.35 TB/s; torch.sum over as many bytes takes 25.0 us.  At 1% hits,
//   where almost no point is linearized, a step takes 27.7-28.1 us there
//   and 49.3-49.4 us at (222, 16384) (135 MB): the floor of streaming
//   the inputs.
// - Arithmetic.  At 80% hits a step takes 30.4-30.5 us at 96 slots and
//   52.6-53.1 us at 222: the linearization overlaps the loads short of
//   fully.
// - Registers: 128 a thread (ptxas -v, no spills; 101 in the scalar-load
//   instance), two 256-thread blocks an SM, which the 76 KB of staging
//   each also allows.
// - Few slots (the per-frame path's 1-8): 8.3-9.9 us a step, the
//   latency of one short item, the ticket and the step.
//
// The design:
// - Work items are (slot, chunk of the wrapper's `chunk` points), one
//   block each.  The wrapper picks `chunk` from (F, P) alone (a slot cut
//   into the fewest near-equal items that give at least 192 a call), so
//   the sums do not depend on the card.  A block takes 1024 points a step: each warp
//   copies its 128 points' p, mu, n and flags with cp.async, coalesced,
//   into a two-stage ring in shared memory, so the next step's bytes are
//   in flight, in no register, while this one is added up; each thread
//   then takes 4 points.  P not a multiple of 4 takes a scalar-load
//   instance.
// - Only points that can add something are linearized.  Each point's 9
//   floats are tested (x * 0 + s is NaN iff some x is not finite: 9 FFMA);
//   a point with no flag and finite data and pose adds exact 0s and is
//   skipped, and a warp none of whose threads needs a point skips it.
// - Precision.  b's terms cancel: near convergence |b| is a few hundredths
//   while w J r reaches tens, and r = n.(p'-mu) subtracts positions tens
//   of metres out, so r in float32 is ~4e-6 off and b up to 2e-2 (the
//   HDL-64 and VLP-16 drives).  p', r, J for b and the b sums are float64.
//   H's terms do not cancel that way (its tolerance is relative to
//   max|H|): J, w and each thread's H, err and w sums over its own 4 to
//   64 points are float32, and so is the shuffle tree over a warp's 32
//   lanes (a partial over 128 points a step, up to 2048 an item); the
//   sums across warps and items are float64
//   (registration/normal_equations.py::normal_equations_mixed, lane by
//   lane).  Float64 lane sums, tried, move the long drive's
//   trajectory past its gate, which holds one rounding (PERF.md).
// - Each item's sums are reduced in a fixed order (warp shuffles, then the
//   8 warps) into an (F, k, 30) scratch.  The last block of a slot to
//   finish (an integer ticket per slot, reset by that block) adds the k
//   partials in a fixed order, writes H, b, the sums and n_hit, and with a
//   pose takes the step in float64 from the float32 H and b it wrote: one
//   launch a GN iteration.  No float atomics, so two runs give
//   bitwise-equal results on any card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFloatSums = 29;        // 21 H (upper) + 6 b + err + w
constexpr int kSums = kFloatSums + 1;  // + n_hit (exact in a double)

__constant__ int kRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                             2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int kCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                             2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

struct Layout {
  int F, P, chunk, k;
};

// The slot's rotation as a matrix of core/se3.quat_rotate's formula
// (p + 2 (w (u x p) + u x (u x p)), the same linear map for any q), and t.
struct Pose {
  double r[9];
  double t[3];
};

__device__ __forceinline__ Pose load_pose(const float* q, const float* t) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  Pose p;
  p.r[0] = 1.0 - 2.0 * (y * y + z * z);
  p.r[1] = 2.0 * (x * y - w * z);
  p.r[2] = 2.0 * (x * z + w * y);
  p.r[3] = 2.0 * (x * y + w * z);
  p.r[4] = 1.0 - 2.0 * (x * x + z * z);
  p.r[5] = 2.0 * (y * z - w * x);
  p.r[6] = 2.0 * (x * z - w * y);
  p.r[7] = 2.0 * (y * z + w * x);
  p.r[8] = 1.0 - 2.0 * (x * x + y * y);
  p.t[0] = t[0];
  p.t[1] = t[1];
  p.t[2] = t[2];
  return p;
}

// NaN iff one of x[0..n) is not finite (0 * inf and 0 * NaN are NaN).
template <int n>
__device__ __forceinline__ float nan_probe(const float* x, float s) {
#pragma unroll
  for (int i = 0; i < n; ++i) s = __fmaf_rn(x[i], 0.0f, s);
  return s;
}

// A thread's sums: H in float32 over its few points, the rest as needed.
struct Sums {
  float h[21];
  double b[6];
  float err, w;
  int count;
};

// One point's terms added to a thread's sums (the full linearization).
__device__ __forceinline__ void accumulate(Sums& s, float vx, float vy,
                                           float vz, float mx, float my,
                                           float mz, float nx, float ny,
                                           float nz, bool flagged,
                                           const Pose& T, double huber,
                                           double max_dist) {
  const double px = vx, py = vy, pz = vz;
  const double x = fma(T.r[0], px, fma(T.r[1], py, fma(T.r[2], pz, T.t[0])));
  const double y = fma(T.r[3], px, fma(T.r[4], py, fma(T.r[5], pz, T.t[1])));
  const double z = fma(T.r[6], px, fma(T.r[7], py, fma(T.r[8], pz, T.t[2])));
  const double dx = nx, dy = ny, dz = nz;
  const double r = dx * (x - static_cast<double>(mx)) +
                   dy * (y - static_cast<double>(my)) +
                   dz * (z - static_cast<double>(mz));
  const double ar = fabs(r);
  const bool use = flagged && ar < max_dist;
  // w r: r inside the Huber radius, huber * sign(r) outside (w = huber/|r|);
  // 0 * r without a correspondence (NaN where r is, as the plain version's
  // (J w) r).
  const double wr = use ? (ar <= huber ? r : copysign(huber, r)) : 0.0 * r;
  const double j0 = y * dz - z * dy, j1 = z * dx - x * dz,
               j2 = x * dy - y * dx;
  s.b[0] = fma(j0, wr, s.b[0]);
  s.b[1] = fma(j1, wr, s.b[1]);
  s.b[2] = fma(j2, wr, s.b[2]);
  s.b[3] = fma(dx, wr, s.b[3]);
  s.b[4] = fma(dy, wr, s.b[4]);
  s.b[5] = fma(dz, wr, s.b[5]);
  const float arf = static_cast<float>(ar);
  const float hf = static_cast<float>(huber);
  const float w = use ? (arf <= hf ? 1.0f : __fdividef(hf, arf)) : 0.0f;
  s.err += use ? fminf(arf, hf) : 0.0f * arf;
  s.w += w;
  s.count += use;
  const float J[6] = {static_cast<float>(j0), static_cast<float>(j1),
                      static_cast<float>(j2), nx, ny, nz};
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wa = w * J[a];
#pragma unroll
    for (int c = a; c < 6; ++c) {
      s.h[k] = fmaf(wa, J[c], s.h[k]);
      ++k;
    }
  }
}

// kPts consecutive points of one slot: p, mu, n and the hit flags.
template <int kPts>
struct Group {
  alignas(16) float v[3 * kPts];
  alignas(16) float m[3 * kPts];
  alignas(16) float n[3 * kPts];
  unsigned flags;
};

// One point, loaded as scalars (any P).
__device__ __forceinline__ void load_point(Group<1>& g, const float* pts,
                                           const float* mu, const float* nrm,
                                           const uint8_t* hit, int64_t p0) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.v[i] = __ldg(pts + 3 * p0 + i);
    g.m[i] = __ldg(mu + 3 * p0 + i);
    g.n[i] = __ldg(nrm + 3 * p0 + i);
  }
  g.flags = __ldg(hit + p0);
}

template <int kPts>
__device__ __forceinline__ void add_group(Sums& s, const Group<kPts>& g,
                                          bool pose_finite, const Pose& T,
                                          double huber, double max_dist) {
  float probe = nan_probe<3 * kPts>(g.v, 0.0f);
  probe = nan_probe<3 * kPts>(g.m, probe);
  probe = nan_probe<3 * kPts>(g.n, probe);
  // Without a flag and with finite data and pose, a point adds exact 0s.
  const bool all = !(pose_finite && probe == probe);
#pragma unroll
  for (int u = 0; u < kPts; ++u) {
    const bool flagged = (g.flags >> (8 * u)) & 0xffu;
    if (flagged || all)
      accumulate(s, g.v[3 * u], g.v[3 * u + 1], g.v[3 * u + 2], g.m[3 * u],
                 g.m[3 * u + 1], g.m[3 * u + 2], g.n[3 * u], g.n[3 * u + 1],
                 g.n[3 * u + 2], flagged, T, huber, max_dist);
  }
}

// A warp's share of one step of the item: 128 points' p, mu, n as they lie
// in device memory, and the 4 hit flags of each lane's 4 points.
struct WarpStage {
  float4 p[96], m[96], n[96];
  unsigned flags[32];
};
constexpr int kStages = 2;
constexpr int kStageBytes = kStages * kWarps * sizeof(WarpStage);

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies points [start, min(start + 128, end)) of the slot at `base` into
// `st`, coalesced (lane l: 16-byte words l, l + 32, l + 64 of each array);
// the rest of the stage is zero-filled: no flag, finite, adds nothing.
__device__ __forceinline__ void copy_step(WarpStage& st, const float* pts,
                                          const float* mu, const float* nrm,
                                          const uint8_t* hit, int64_t base,
                                          int start, int end, int lane) {
  const int valid = max(0, min(128, end - start));
  const int64_t p0 = base + start;
  const char* src[3] = {reinterpret_cast<const char*>(pts + 3 * p0),
                        reinterpret_cast<const char*>(mu + 3 * p0),
                        reinterpret_cast<const char*>(nrm + 3 * p0)};
  const char* safe[3] = {reinterpret_cast<const char*>(pts),
                         reinterpret_cast<const char*>(mu),
                         reinterpret_cast<const char*>(nrm)};
  float4* dst[3] = {st.p, st.m, st.n};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = lane + 32 * i;
      const int bytes = max(0, min(16, 12 * valid - 16 * c));
      cp_async(dst[a] + c, bytes ? src[a] + 16 * c : safe[a], bytes);
    }
  }
  const int fb = 4 * lane < valid ? 4 : 0;
  cp_async4(st.flags + lane, fb ? hit + p0 + 4 * lane : hit, fb);
}

__device__ __forceinline__ void read_step(Group<4>& g, const WarpStage& st,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    reinterpret_cast<float4*>(g.v)[i] = st.p[3 * lane + i];
    reinterpret_cast<float4*>(g.m)[i] = st.m[3 * lane + i];
    reinterpret_cast<float4*>(g.n)[i] = st.n[3 * lane + i];
  }
  g.flags = st.flags[lane];
}

// The damped step of one slot from its sums (one thread), in float64:
// registration/normal_equations.py::_gn_step.
__device__ void gn_step(const double* sum, int n_hit, double damping,
                        const float* q, const float* t, float* q_out,
                        float* t_out, int* step) {
  // Fully unrolled (constant indices), so A stays in registers.
  double A[6][6];
  int s = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) A[a][c] = A[c][a] = sum[s++];
  }
  double trace = 0.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) trace += A[i][i];
  const double ridge = 1e-6 * trace;
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = (A[i][i] + damping) + ridge;
  // Cholesky A = L L^T in place (lower triangle).  A pivot that is not
  // finite and > 0 is the plain version's cholesky_ex info != 0.
  bool ok = n_hit > 10;
  double inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    double d = A[j][j];
#pragma unroll
    for (int c = 0; c < j; ++c) d -= A[j][c] * A[j][c];
    ok = ok && d > 0.0 && isfinite(d);
    // One division a column (a float64 division is a long serial
    // sequence on the card): the factor's and the solves' by L_jj.
    const double ljj = sqrt(d);
    inv[j] = 1.0 / ljj;
    A[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      double v = A[i][j];
#pragma unroll
      for (int c = 0; c < j; ++c) v -= A[i][c] * A[j][c];
      A[i][j] = v * inv[j];
    }
  }
  // L y = b, then L^T x = y; delta = -x.
  double y[6], x[6], delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double v = sum[21 + i];
#pragma unroll
    for (int c = 0; c < i; ++c) v -= A[i][c] * y[c];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double v = y[i];
#pragma unroll
    for (int c = i + 1; c < 6; ++c) v -= A[c][i] * x[c];
    x[i] = v * inv[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = ok ? -x[i] : 0.0;
  // Clamp runaway steps (> 1 m or > 0.3 rad per iteration).
  const double tn =
      sqrt(delta[3] * delta[3] + delta[4] * delta[4] + delta[5] * delta[5]);
  const double rn =
      sqrt(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
  const double scale =
      fmin(fmin(1.0 / fmax(tn, 1e-12), 0.3 / fmax(rn, 1e-12)), 1.0);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] *= scale;
  *step = !ok ? 0 : (scale < 1.0 ? 2 : 1);
  // exp(delta) o pose: quat_exp of the rotation part, then compose.
  const double vx = delta[0], vy = delta[1], vz = delta[2];
  const double angle = sqrt(fmax(vx * vx + vy * vy + vz * vz, 1e-24));
  double sh, ch;
  sincos(0.5 * angle, &sh, &ch);
  const double kk = angle < 1e-6 ? 0.5 - angle * angle / 48.0 : sh / angle;
  const double aw = ch, ax = kk * vx, ay = kk * vy, az = kk * vz;
  const double bw = q[0], bx = q[1], by = q[2], bz = q[3];
  q_out[0] = static_cast<float>(aw * bw - ax * bx - ay * by - az * bz);
  q_out[1] = static_cast<float>(aw * bx + ax * bw + ay * bz - az * by);
  q_out[2] = static_cast<float>(aw * by - ax * bz + ay * bw + az * bx);
  q_out[3] = static_cast<float>(aw * bz + ax * by - ay * bx + az * bw);
  const double tx = t[0], ty = t[1], tz = t[2];
  const double uvx = ay * tz - az * ty;
  const double uvy = az * tx - ax * tz;
  const double uvz = ax * ty - ay * tx;
  t_out[0] = static_cast<float>(
      delta[3] + (tx + 2.0 * (aw * uvx + (ay * uvz - az * uvy))));
  t_out[1] = static_cast<float>(
      delta[4] + (ty + 2.0 * (aw * uvy + (az * uvx - ax * uvz))));
  t_out[2] = static_cast<float>(
      delta[5] + (tz + 2.0 * (aw * uvz + (ax * uvy - ay * uvx))));
}

struct Outputs {
  float *H, *b, *err_sum, *w_sum;
  int* n_hit;
  float damping;
  float *q_out, *t_out, *err;
  int* step;
};

// kPts: points a thread takes at a time; 4 streams through the staging
// ring (P and chunk multiples of 4, base pointers 16-byte aligned), 1 loads
// scalars.
template <int kPts>
__global__ void __launch_bounds__(kThreads, 2)
ne_kernel(const float* __restrict__ pts, const float* __restrict__ q,
          const float* __restrict__ t, const float* __restrict__ mu,
          const float* __restrict__ nrm, const uint8_t* __restrict__ hit,
          Layout L, double huber, double max_dist,
          double* __restrict__ partial, unsigned* __restrict__ tickets,
          Outputs out) {
  __shared__ double red[kWarps][kSums];
  __shared__ double total[kSums];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x;
  const int f = item / L.k;
  const int begin = (item % L.k) * L.chunk;
  const int end = min(L.P, begin + L.chunk);
  const int64_t base = static_cast<int64_t>(f) * L.P;
  Sums s;
#pragma unroll
  for (int i = 0; i < 21; ++i) s.h[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) s.b[i] = 0.0;
  s.err = 0.0f;
  s.w = 0.0f;
  s.count = 0;
  constexpr int kStride = kPts * kThreads;
  if constexpr (kPts == 4) {
    // Each warp streams its 128 points of every step through two stages
    // in shared memory: the next step's copy is in flight while this one
    // is added up, and holds no registers.
    extern __shared__ float4 stage_mem[];
    WarpStage* st = reinterpret_cast<WarpStage*>(stage_mem) + kStages * warp;
    const int steps = (end - begin + kStride - 1) / kStride;
    const int start = begin + 128 * warp;
    if (steps > 0) copy_step(st[0], pts, mu, nrm, hit, base, start, end, lane);
    cp_async_commit();
    const Pose T = load_pose(q + 4 * f, t + 3 * f);
    const bool pose_finite =
        nan_probe<3>(t + 3 * f, nan_probe<4>(q + 4 * f, 0.0f)) == 0.0f;
    for (int j = 0; j < steps; ++j) {
      if (j + 1 < steps)
        copy_step(st[(j + 1) & 1], pts, mu, nrm, hit, base,
                  start + (j + 1) * kStride, end, lane);
      cp_async_commit();
      cp_async_wait_prior();
      __syncwarp();
      Group<4> cur;
      read_step(cur, st[j & 1], lane);
      add_group(s, cur, pose_finite, T, huber, max_dist);
      __syncwarp();     // the stage is copied into again two steps on
    }
  } else {
    const Pose T = load_pose(q + 4 * f, t + 3 * f);
    const bool pose_finite =
        nan_probe<3>(t + 3 * f, nan_probe<4>(q + 4 * f, 0.0f)) == 0.0f;
    for (int g = begin + threadIdx.x; g < end; g += kThreads) {
      Group<1> cur;
      load_point(cur, pts, mu, nrm, hit, base + g);
      add_group(s, cur, pose_finite, T, huber, max_dist);
    }
  }
  // The item's sums in a fixed order: warp shuffles, then warp 0..7.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 21; ++i)
      s.h[i] += __shfl_down_sync(0xffffffffu, s.h[i], off);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      s.b[i] += __shfl_down_sync(0xffffffffu, s.b[i], off);
    s.err += __shfl_down_sync(0xffffffffu, s.err, off);
    s.w += __shfl_down_sync(0xffffffffu, s.w, off);
    s.count += __shfl_down_sync(0xffffffffu, s.count, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 21; ++i) red[warp][i] = s.h[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) red[warp][21 + i] = s.b[i];
    red[warp][27] = s.err;
    red[warp][28] = s.w;
    red[warp][29] = s.count;
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < kSums) {
    double v = 0.0;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) v += red[w8][j];
    if (L.k == 1)
      total[j] = v;
    else
      partial[static_cast<size_t>(item) * kSums + j] = v;
  }
  if (L.k > 1) {
    // The slot's last block to finish adds its k partials.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(tickets + f, 1u) == static_cast<unsigned>(L.k - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // Warp w adds sums w, w + 8, ...: lane l the partials l, l + 32, ...,
    // then a shuffle tree; a fixed order for each k.
    const double* p = partial + static_cast<size_t>(f) * L.k * kSums;
    for (int sum = warp; sum < kSums; sum += kWarps) {
      double v = 0.0;
      for (int i = lane; i < L.k; i += 32) v += __ldcg(p + i * kSums + sum);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) total[sum] = v;
    }
    if (threadIdx.x == 0) tickets[f] = 0;   // ready for the next launch
  }
  __syncthreads();
  // The sums as written out (float32, n_hit exact), which the step reads.
  if (j < kSums) {
    const double acc = total[j];
    if (j == kFloatSums) {
      out.n_hit[f] = static_cast<int>(acc);
    } else {
      const float v = static_cast<float>(acc);
      total[j] = v;
      if (j < 21) {
        out.H[f * 36 + kRow[j] * 6 + kCol[j]] = v;
        out.H[f * 36 + kCol[j] * 6 + kRow[j]] = v;
      } else if (j < 27) {
        out.b[f * 6 + (j - 21)] = v;
      } else if (j == 27 && out.err_sum) {
        out.err_sum[f] = v;
      } else if (j == 28 && out.w_sum) {
        out.w_sum[f] = v;
      }
    }
  }
  if (!out.q_out) return;
  __syncthreads();
  if (threadIdx.x != 0) return;
  out.err[f] = static_cast<float>(total[27] / fmax(total[28], 1.0));
  gn_step(total, static_cast<int>(total[kFloatSums]), out.damping, q + 4 * f,
          t + 3 * f, out.q_out + 4 * f, out.t_out + 3 * f, out.step + f);
}

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 = ok).
// `chunk` points per work item (a multiple of 4 where P is), k =
// ceil(P / chunk) items a slot (at least 1).  `partial` is scratch of F * k
// * 30 doubles and `tickets` F unsigned zeros, both left for the next call
// as found (used only when k > 1).  pts, mu, nrm and hit are 16-byte
// aligned.  err_sum and w_sum may be null.  With q_out non-null the kernel
// also takes the damped step: q_out (F, 4), t_out (F, 3), err (F,) =
// err_sum / max(w_sum, 1) and step (F,): 0 rejected, 1 taken, 2 taken
// clamped.
extern "C" int veloslam_normal_equations(
    const float* pts, const float* q, const float* t, const float* mu,
    const float* nrm, const uint8_t* hit, int F, int P, float huber_delta,
    float max_dist, int chunk, double* partial, unsigned* tickets, float* H,
    float* b, float* err_sum, float* w_sum, int* n_hit, float damping,
    float* q_out, float* t_out, float* err, int* step, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int k = max(1, (P + chunk - 1) / chunk);
  const Layout L{F, P, chunk, k};
  const Outputs out{H, b, err_sum, w_sum, n_hit, damping,
                    q_out, t_out, err, step};
  if (P % 4 == 0 && chunk % 4 == 0) {
    // The stages take more than the 48 KB a launch may use unasked; the
    // attribute is set once per device.
    static bool ready[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!ready[dev]) {
      e = cudaFuncSetAttribute(ne_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      ready[dev] = true;
    }
    ne_kernel<4><<<F * k, kThreads, kStageBytes, st>>>(
        pts, q, t, mu, nrm, hit, L, huber_delta, max_dist, partial, tickets,
        out);
  } else
    ne_kernel<1><<<F * k, kThreads, 0, st>>>(pts, q, t, mu, nrm, hit, L,
                                             huber_delta, max_dist, partial,
                                             tickets, out);
  return static_cast<int>(cudaGetLastError());
}
