// One Gauss-Newton iteration of batched point-to-plane registration on the
// card: the fused normal equations and the damped 6x6 step (sm_90a, plain C
// interface for ctypes).
//
// Replaces: veloslam_tpu/registration/pallas_kernels.py::fused_normal_equations
// (body _ne_kernel) together with the XLA code around it in
// veloslam_tpu/registration/gicp.py::register (normal_equations_fixed's
// prologue, and gn_iter's damped Cholesky solve, step guard, step clamp and
// se3.retract).  One call covers all F frame slots.  Per point:
//   p' = R(q) p + t;  r = n . (p' - mu);  hit &= |r| < max_dist;
//   w = Huber(r) * hit;  J = [p' x n | n];
// per slot: H = sum w J J^T (21 upper entries, mirrored), b = sum w J r,
// err_sum = sum w |r|, w_sum = sum w, n_hit = sum hit; and, when a pose is
// asked for, Hd = H + damping I + 1e-6 trace(H) I = L L^T, delta = -Hd^-1 b,
// ok = finite delta, n_hit > 10 and every pivot finite and > 0 (else
// delta = 0), delta clamped to 1 m and 0.3 rad, pose' = exp(delta) o pose.
//
// What bounds it: the partial pass must read the 1-byte hit flag of every
// point and p, mu, n (36 B) of each point with a correspondence: at F = 96,
// P = 16384 and 56-80% hits, 33-47 MB, 10-14 us at 3.35 TB/s, against
// ~110 flops per hit (under 2 us at the float32 peak).  It is bound by
// device-memory bandwidth.  Hits are scattered, and a 32-byte sector
// holds 2.7 points, so at 56-80% hits nearly every sector of p, mu and n
// holds one: DRAM must deliver nearly all of their 58 MB.  Around the
// kernel, the step was ~117 small torch launches per iteration, each
// costing more host time than the whole partial pass takes on the device.
//
// The design:
// - Partial pass.  Work items are (slot, chunk of the wrapper's `chunk`
//   points): the partition does not depend on the card, so the sums do
//   not either.  A grid sized from the SM count walks the items.  Each
//   thread takes 4 consecutive points at a time and loads them
//   unconditionally as 16-byte vectors, 3 each of p, mu and n and one
//   4-byte word of hit flags: ten independent loads in flight, none
//   waiting on a hit flag (the TPU port's first kernel loaded p, mu, n as
//   4-byte scalars behind each point's flag).  Every point is linearized;
//   a point without a correspondence adds w = 0, exact zeros, or NaN where
//   its data is not finite, as the plain version's sums do.  P not a
//   multiple of 4 takes a scalar-load instance of the same kernel.  Each
//   item's 30 sums are reduced in a fixed order (warp shuffles, then the
//   8 warps) into an (F, k, 30) scratch.  No float atomics.
//   Measured on an H100 against this design: staging tiles of 256 or 512
//   points through a 2- or 3-stage cp.async ring in shared memory was as
//   fast on the bulk shape and 50% slower at closure verification's
//   (128, 8192), whose 39 MB of inputs L2 serves (18.2 against 12 us):
//   the per-tile barriers and waits then cost more than the copies save.
// - Finalize pass.  One warp per slot adds the k partials in index order
//   and writes H, b, the sums and n_hit; with a pose, lane 0 then takes the
//   step in float32 (Cholesky, two triangular solves, guard, clamp, left
//   retraction with quat_exp's small-angle branch below 1e-6 rad).
// So a GN iteration is two launches, and two runs give bitwise-equal
// results on any card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFloatSums = 29;        // 21 H (upper) + 6 b + err + w
constexpr int kSums = kFloatSums + 1;  // + n_hit (int bits in a float slot)

__constant__ int kRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                             2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int kCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                             2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

struct Layout {
  int F, P, chunk, k;
  // Points [begin, end) of slot item / k that item `item` covers.
  __device__ int begin(int item) const { return (item % k) * chunk; }
  __device__ int end(int item) const {
    return min(P, (item % k + 1) * chunk);
  }
};

struct Pose7 {
  float qw, qx, qy, qz, tx, ty, tz;
};

// One point's terms added to a thread's 29 sums and its hit count.
__device__ __forceinline__ void accumulate(float* acc, int& count, float vx,
                                           float vy, float vz, float mx,
                                           float my, float mz, float nx,
                                           float ny, float nz, bool flagged,
                                           const Pose7& p, float huber_delta,
                                           float max_dist) {
  // p' = v + 2 (w (u x v) + u x (u x v)), u = (qx, qy, qz): the
  // quaternion rotation of core/se3.quat_rotate, then + t.
  const float uvx = p.qy * vz - p.qz * vy;
  const float uvy = p.qz * vx - p.qx * vz;
  const float uvz = p.qx * vy - p.qy * vx;
  const float px = vx + 2.f * (p.qw * uvx + (p.qy * uvz - p.qz * uvy)) + p.tx;
  const float py = vy + 2.f * (p.qw * uvy + (p.qz * uvx - p.qx * uvz)) + p.ty;
  const float pz = vz + 2.f * (p.qw * uvz + (p.qx * uvy - p.qy * uvx)) + p.tz;
  const float r = nx * (px - mx) + ny * (py - my) + nz * (pz - mz);
  const float ar = fabsf(r);
  const bool use = flagged && ar < max_dist;
  const float w =
      !use ? 0.f
           : (ar <= huber_delta ? 1.f : huber_delta / fmaxf(ar, 1e-12f));
  const float J[6] = {py * nz - pz * ny, pz * nx - px * nz,
                      px * ny - py * nx, nx, ny, nz};
  int s = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wa = w * J[a];
#pragma unroll
    for (int c = a; c < 6; ++c) acc[s++] += wa * J[c];
    acc[21 + a] += wa * r;
  }
  acc[27] += w * ar;
  acc[28] += w;
  count += use;
}

// kVec: P and chunk are multiples of 4, so each group of 4 points starts
// on a 16-byte boundary of p, mu, n (base pointers 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
ne_partial_kernel(const float* __restrict__ pts, const float* __restrict__ q,
                  const float* __restrict__ t, const float* __restrict__ mu,
                  const float* __restrict__ nrm,
                  const uint8_t* __restrict__ hit, Layout L,
                  float huber_delta, float max_dist,
                  float* __restrict__ partial) {
  __shared__ float red[kWarps][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int item = blockIdx.x; item < L.F * L.k; item += gridDim.x) {
    const int f = item / L.k;
    const int begin = L.begin(item), end = L.end(item);
    const Pose7 pose{__ldg(q + 4 * f),     __ldg(q + 4 * f + 1),
                     __ldg(q + 4 * f + 2), __ldg(q + 4 * f + 3),
                     __ldg(t + 3 * f),     __ldg(t + 3 * f + 1),
                     __ldg(t + 3 * f + 2)};
    const int64_t base = static_cast<int64_t>(f) * L.P;
    float acc[kFloatSums];
#pragma unroll
    for (int s = 0; s < kFloatSums; ++s) acc[s] = 0.f;
    int count = 0;
    if (kVec) {
      for (int g = begin + 4 * threadIdx.x; g < end; g += 4 * kThreads) {
        const int64_t p0 = base + g;
        const float4* p4 = reinterpret_cast<const float4*>(pts + 3 * p0);
        const float4* m4 = reinterpret_cast<const float4*>(mu + 3 * p0);
        const float4* n4 = reinterpret_cast<const float4*>(nrm + 3 * p0);
        float v[12], m[12], nn[12];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          reinterpret_cast<float4*>(v)[i] = __ldg(p4 + i);
          reinterpret_cast<float4*>(m)[i] = __ldg(m4 + i);
          reinterpret_cast<float4*>(nn)[i] = __ldg(n4 + i);
        }
        const unsigned flags =
            __ldg(reinterpret_cast<const unsigned*>(hit + p0));
#pragma unroll
        for (int u = 0; u < 4; ++u)
          accumulate(acc, count, v[3 * u], v[3 * u + 1], v[3 * u + 2],
                     m[3 * u], m[3 * u + 1], m[3 * u + 2], nn[3 * u],
                     nn[3 * u + 1], nn[3 * u + 2], (flags >> (8 * u)) & 0xffu,
                     pose, huber_delta, max_dist);
      }
    } else {
      for (int i = begin + threadIdx.x; i < end; i += kThreads) {
        const int64_t j = base + i;
        accumulate(acc, count, __ldg(pts + 3 * j), __ldg(pts + 3 * j + 1),
                   __ldg(pts + 3 * j + 2), __ldg(mu + 3 * j),
                   __ldg(mu + 3 * j + 1), __ldg(mu + 3 * j + 2),
                   __ldg(nrm + 3 * j), __ldg(nrm + 3 * j + 1),
                   __ldg(nrm + 3 * j + 2), __ldg(hit + j), pose,
                   huber_delta, max_dist);
      }
    }
    // The item's sums in a fixed order: warp shuffles, then warp 0..7.
#pragma unroll
    for (int s = 0; s < kFloatSums; ++s) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[s] += __shfl_down_sync(0xffffffffu, acc[s], off);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < kFloatSums; ++s) red[warp][s] = acc[s];
      red[warp][kFloatSums] = __int_as_float(count);
    }
    __syncthreads();
    const int s = threadIdx.x;
    if (s < kSums) {
      float* out = partial + static_cast<size_t>(item) * kSums;
      if (s < kFloatSums) {
        float v = 0.f;
        for (int w8 = 0; w8 < kWarps; ++w8) v += red[w8][s];
        out[s] = v;
      } else {
        int c = 0;
        for (int w8 = 0; w8 < kWarps; ++w8) c += __float_as_int(red[w8][s]);
        out[s] = __int_as_float(c);
      }
    }
    __syncthreads();          // `red` is written again for the next item
  }
}

// The damped step of one slot from its sums (lane 0 of the slot's warp):
// the float32 counterpart of registration/normal_equations.py::_gn_step.
__device__ void gn_step(const float* sum, int n_hit, float damping,
                        const float* q, const float* t, float* q_out,
                        float* t_out, int* step) {
  // Fully unrolled (constant indices), so A stays in registers.
  float A[6][6];
  int s = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) A[a][c] = A[c][a] = sum[s++];
  }
  float trace = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) trace += A[i][i];
  const float ridge = 1e-6f * trace;
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = (A[i][i] + damping) + ridge;
  // Cholesky A = L L^T in place (lower triangle).  A pivot that is not
  // finite and > 0 is the plain version's cholesky_ex info != 0.
  bool ok = n_hit > 10;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[j][j];
#pragma unroll
    for (int c = 0; c < j; ++c) d -= A[j][c] * A[j][c];
    ok = ok && d > 0.f && isfinite(d);
    const float ljj = sqrtf(d);
    A[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = A[i][j];
#pragma unroll
      for (int c = 0; c < j; ++c) v -= A[i][c] * A[j][c];
      A[i][j] = v / ljj;
    }
  }
  // L y = b, then L^T x = y; delta = -x.
  float y[6], x[6], delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = sum[21 + i];
#pragma unroll
    for (int c = 0; c < i; ++c) v -= A[i][c] * y[c];
    y[i] = v / A[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int c = i + 1; c < 6; ++c) v -= A[c][i] * x[c];
    x[i] = v / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = ok ? -x[i] : 0.f;
  // Clamp runaway steps (> 1 m or > 0.3 rad per iteration).
  const float tn =
      sqrtf(delta[3] * delta[3] + delta[4] * delta[4] + delta[5] * delta[5]);
  const float rn =
      sqrtf(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
  const float scale = fminf(
      fminf(1.f / fmaxf(tn, 1e-12f), 0.3f / fmaxf(rn, 1e-12f)), 1.f);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] *= scale;
  *step = !ok ? 0 : (scale < 1.f ? 2 : 1);
  // exp(delta) o pose: quat_exp of the rotation part, then compose.
  const float vx = delta[0], vy = delta[1], vz = delta[2];
  const float angle = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-24f));
  const float kk = angle < 1e-6f ? 0.5f - angle * angle / 48.f
                                 : sinf(0.5f * angle) / angle;
  const float aw = cosf(0.5f * angle), ax = kk * vx, ay = kk * vy,
              az = kk * vz;
  const float bw = q[0], bx = q[1], by = q[2], bz = q[3];
  q_out[0] = aw * bw - ax * bx - ay * by - az * bz;
  q_out[1] = aw * bx + ax * bw + ay * bz - az * by;
  q_out[2] = aw * by - ax * bz + ay * bw + az * bx;
  q_out[3] = aw * bz + ax * by - ay * bx + az * bw;
  const float tx = t[0], ty = t[1], tz = t[2];
  const float uvx = ay * tz - az * ty;
  const float uvy = az * tx - ax * tz;
  const float uvz = ax * ty - ay * tx;
  t_out[0] = delta[3] + (tx + 2.f * (aw * uvx + (ay * uvz - az * uvy)));
  t_out[1] = delta[4] + (ty + 2.f * (aw * uvy + (az * uvx - ax * uvz)));
  t_out[2] = delta[5] + (tz + 2.f * (aw * uvz + (ax * uvy - ay * uvx)));
}

__global__ void ne_finalize_kernel(const float* __restrict__ partial, int k,
                                   float* __restrict__ H,
                                   float* __restrict__ b,
                                   float* __restrict__ err_sum,
                                   float* __restrict__ w_sum,
                                   int* __restrict__ n_hit, float damping,
                                   const float* __restrict__ q,
                                   const float* __restrict__ t,
                                   float* __restrict__ q_out,
                                   float* __restrict__ t_out,
                                   float* __restrict__ err,
                                   int* __restrict__ step) {
  __shared__ float sum[kSums];
  const int f = blockIdx.x;
  const int s = threadIdx.x;
  if (s < kSums) {
    const float* p = partial + static_cast<size_t>(f) * k * kSums + s;
    if (s == kFloatSums) {
      int c = 0;
      for (int i = 0; i < k; ++i) c += __float_as_int(p[i * kSums]);
      n_hit[f] = c;
      sum[s] = __int_as_float(c);
    } else {
      float v = 0.f;
      for (int i = 0; i < k; ++i) v += p[i * kSums];
      sum[s] = v;
      if (s < 21) {
        H[f * 36 + kRow[s] * 6 + kCol[s]] = v;
        H[f * 36 + kCol[s] * 6 + kRow[s]] = v;
      } else if (s < 27) {
        b[f * 6 + (s - 21)] = v;
      } else if (s == 27 && err_sum) {
        err_sum[f] = v;
      } else if (s == 28 && w_sum) {
        w_sum[f] = v;
      }
    }
  }
  if (!q_out) return;
  __syncwarp();
  if (s != 0) return;
  err[f] = sum[27] / fmaxf(sum[28], 1.f);
  gn_step(sum, __float_as_int(sum[kFloatSums]), damping, q + 4 * f, t + 3 * f,
          q_out + 4 * f, t_out + 3 * f, step + f);
}

// Blocks of the partial pass that the card keeps resident at once.
int resident_blocks() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int cached[64];
  if (dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ne_partial_kernel<true>, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// Launches both passes on `stream`; returns a cudaError_t (0 = ok).
// `partial` is caller-allocated scratch of F * ceil(P / chunk) * 30 floats
// (at least F * 30).  pts, mu, nrm and hit are 16-byte aligned.
// err_sum and w_sum may be null.  With q_out non-null the finalize also
// takes the damped step: q_out (F, 4), t_out (F, 3), err (F,) = err_sum /
// max(w_sum, 1) and step (F,): 0 rejected, 1 taken, 2 taken clamped.
extern "C" int veloslam_normal_equations(
    const float* pts, const float* q, const float* t, const float* mu,
    const float* nrm, const uint8_t* hit, int F, int P, float huber_delta,
    float max_dist, int chunk, float* partial, float* H, float* b,
    float* err_sum, float* w_sum, int* n_hit, float damping, float* q_out,
    float* t_out, float* err, int* step, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = max(1, (P + chunk - 1) / chunk);
  const Layout L{F, P, chunk, k};
  const int resident = resident_blocks();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = min(F * k, resident);
  if (P % 4 == 0 && chunk % 4 == 0)
    ne_partial_kernel<true><<<grid, kThreads, 0, st>>>(
        pts, q, t, mu, nrm, hit, L, huber_delta, max_dist, partial);
  else
    ne_partial_kernel<false><<<grid, kThreads, 0, st>>>(
        pts, q, t, mu, nrm, hit, L, huber_delta, max_dist, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ne_finalize_kernel<<<F, 32, 0, st>>>(partial, k, H, b, err_sum, w_sum,
                                       n_hit, damping, q, t, q_out, t_out,
                                       err, step);
  return static_cast<int>(cudaGetLastError());
}
