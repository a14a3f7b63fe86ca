// Fused point-to-plane normal equations for the Gauss-Newton loop of
// batched GICP registration (sm_90a, plain C interface for ctypes).
//
// Replaces: veloslam_tpu/registration/pallas_kernels.py::fused_normal_equations
// (body _ne_kernel) together with the XLA prologue that fed it rows
// (veloslam_tpu/registration/gicp.py::normal_equations_fixed, use_pallas).
// One launch covers all F frame slots of one GN iteration.  Per point:
//   p' = R(q) p + t;  r = n . (p' - mu);  hit &= |r| < max_dist;
//   w = Huber(r) * hit;  J = [p' x n | n];
// and per slot: H = sum w J J^T (21 upper entries, mirrored), b = sum w J r,
// err_sum = sum w |r|, w_sum = sum w, n_hit = sum hit.
//
// What bounds it: at F = 96, P = 16384 a launch reads ~37 B per point
// (p, mu, n as 3 x 12 B plus the 1-byte hit flag), ~58 MB, against ~80
// flops per point, so it is bound by device-memory bandwidth, not FLOPs.
// The design answers that with one pass over the inputs: the pose
// transform, residual, Huber weight and Jacobian are formed in registers
// and J is never written; points without a correspondence cost one byte.
//
// The TPU kernel accumulated over a sequential grid into one scratch
// block.  Thread blocks here run in parallel and in no order, so the sum
// is split in two fixed-order passes instead: a (k, F) grid of blocks,
// each looping over its share of P and reducing its 30 partial sums with
// warp shuffles and shared memory into a (F, k, 30) scratch, then a small
// kernel that adds the k partials of each slot in index order.  No float
// atomics: two runs give bitwise-equal results.

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

__global__ void __launch_bounds__(kThreads)
ne_partial_kernel(const float* __restrict__ pts, const float* __restrict__ q,
                  const float* __restrict__ t, const float* __restrict__ mu,
                  const float* __restrict__ nrm,
                  const uint8_t* __restrict__ hit, int P, int chunk,
                  float huber_delta, float max_dist,
                  float* __restrict__ partial) {
  const int f = blockIdx.y;
  const int kb = blockIdx.x;
  const float qw = q[4 * f], qx = q[4 * f + 1], qy = q[4 * f + 2],
              qz = q[4 * f + 3];
  const float tx = t[3 * f], ty = t[3 * f + 1], tz = t[3 * f + 2];

  float acc[kFloatSums];
#pragma unroll
  for (int s = 0; s < kFloatSums; ++s) acc[s] = 0.f;
  int count = 0;

  const int begin = kb * chunk;
  const int end = min(P, begin + chunk);
  const size_t base = static_cast<size_t>(f) * P;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const size_t j = base + i;
    if (!hit[j]) continue;
    const float vx = pts[3 * j], vy = pts[3 * j + 1], vz = pts[3 * j + 2];
    // p' = v + 2 (w (u x v) + u x (u x v)), u = (qx, qy, qz): the
    // quaternion rotation of core/se3.quat_rotate, then + t.
    const float uvx = qy * vz - qz * vy;
    const float uvy = qz * vx - qx * vz;
    const float uvz = qx * vy - qy * vx;
    const float px = vx + 2.f * (qw * uvx + (qy * uvz - qz * uvy)) + tx;
    const float py = vy + 2.f * (qw * uvy + (qz * uvx - qx * uvz)) + ty;
    const float pz = vz + 2.f * (qw * uvz + (qx * uvy - qy * uvx)) + tz;
    const float nx = nrm[3 * j], ny = nrm[3 * j + 1], nz = nrm[3 * j + 2];
    const float r = nx * (px - mu[3 * j]) + ny * (py - mu[3 * j + 1]) +
                    nz * (pz - mu[3 * j + 2]);
    const float ar = fabsf(r);
    if (!(ar < max_dist)) continue;
    const float w = ar <= huber_delta ? 1.f : huber_delta / fmaxf(ar, 1e-12f);
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
    ++count;
  }

  // Block reduction in a fixed order: warp shuffles, then warp 0..7.
#pragma unroll
  for (int s = 0; s < kFloatSums; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[s] += __shfl_down_sync(0xffffffffu, acc[s], off);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);

  __shared__ float sh[kWarps][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kFloatSums; ++s) sh[warp][s] = acc[s];
    sh[warp][kFloatSums] = __int_as_float(count);
  }
  __syncthreads();
  const int s = threadIdx.x;
  if (s < kSums) {
    float* out = partial + (static_cast<size_t>(f) * gridDim.x + kb) * kSums;
    if (s < kFloatSums) {
      float v = 0.f;
      for (int w8 = 0; w8 < kWarps; ++w8) v += sh[w8][s];
      out[s] = v;
    } else {
      int c = 0;
      for (int w8 = 0; w8 < kWarps; ++w8) c += __float_as_int(sh[w8][s]);
      out[s] = __int_as_float(c);
    }
  }
}

__global__ void ne_finalize_kernel(const float* __restrict__ partial, int k,
                                   float* __restrict__ H,
                                   float* __restrict__ b,
                                   float* __restrict__ err_sum,
                                   float* __restrict__ w_sum,
                                   int* __restrict__ n_hit) {
  const int f = blockIdx.x;
  const int s = threadIdx.x;
  if (s >= kSums) return;
  const float* p = partial + static_cast<size_t>(f) * k * kSums + s;
  if (s == kFloatSums) {
    int c = 0;
    for (int i = 0; i < k; ++i) c += __float_as_int(p[i * kSums]);
    n_hit[f] = c;
    return;
  }
  float v = 0.f;
  for (int i = 0; i < k; ++i) v += p[i * kSums];
  if (s < 21) {
    H[f * 36 + kRow[s] * 6 + kCol[s]] = v;
    H[f * 36 + kCol[s] * 6 + kRow[s]] = v;
  } else if (s < 27) {
    b[f * 6 + (s - 21)] = v;
  } else if (s == 27) {
    err_sum[f] = v;
  } else {
    w_sum[f] = v;
  }
}

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
// `partial` is caller-allocated scratch of F * k * 30 floats.
extern "C" int veloslam_normal_equations(
    const float* pts, const float* q, const float* t, const float* mu,
    const float* nrm, const uint8_t* hit, int F, int P, float huber_delta,
    float max_dist, int k, float* partial, float* H, float* b,
    float* err_sum, float* w_sum, int* n_hit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = (P + k - 1) / k;
  ne_partial_kernel<<<dim3(k, F), kThreads, 0, st>>>(
      pts, q, t, mu, nrm, hit, P, chunk, huber_delta, max_dist, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ne_finalize_kernel<<<F, 32, 0, st>>>(partial, k, H, b, err_sum, w_sum,
                                       n_hit);
  return static_cast<int>(cudaGetLastError());
}
