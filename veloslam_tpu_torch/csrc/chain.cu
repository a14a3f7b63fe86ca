// The odometry-chain preconditioner of the PCG pose-graph solvers (sm_90a,
// plain C interface for ctypes): a block-Thomas factorisation of the
// block-tridiagonal chain matrix and its two-sweep solve.
//
// Replaces: veloslam_tpu/graph/pcg.py::_chain_precond (:105-131) and
// ::_chain_solve (:134-152), two lax.scan recurrences over the K poses
// (there is no Pallas original).  With D (K, 6, 6) the diagonal blocks
// (2% floor and gauge included) and B (K, 6, 6) the chain coupling, B[k]
// joining poses k and k + 1:
//
//   chain_factor:  Bprev_k = B[k-1] (0 for k = 0)
//                  L_k     = Bprev_k^T Uinv_{k-1}         (L_0 = 0)
//                  U_k     = D_k - L_k Bprev_k
//                  Uinv_k  = U_k^-1   (Gauss-Jordan, partial pivoting)
//   chain_solve:   y_k = r_k - L_k y_{k-1}                (forward)
//                  z_k = Uinv_k (y_k - Bn_k z_{k+1})      (backward;
//                        Bn_k = B[k] for k < K - 1, else 0)
//
// What bounds them: neither bytes nor operations.  Each step needs the
// previous step's result, so a call is K dependent steps: a 6x6 product
// chain and an inverse per factor step, two 6x6 matrix-vector products
// per solve step.  The bytes (~0.5 KB per pose for the solve, ~0.6 KB
// for the factor) take microseconds at 3.35 TB/s; the latency of K
// dependent FMA chains takes far longer, so both are latency-bound.
//
// Design (right and simple): one block per call.  Lane 0 of warp 0 runs
// the recurrence with its state (Uinv_{k-1}, y_{k-1} or z_{k+1}) in
// registers and every 6x6 block in registers, fully unrolled.  The
// blocks each step reads do not depend on the recurrence, so warps 1-3
// stage them into shared memory kChunk steps ahead, double-buffered: while
// lane 0 runs chunk c out of one buffer, the other warps fill the other
// with chunk c + 1, and a __syncthreads swaps them.  A step then pays its
// dependent FMA chain and shared-memory reads, not a device-memory round
// trip.  The solve's forward sweep writes y into z, and the backward
// sweep stages y back from there and overwrites it with z.
//
// Shapes: any K >= 1 (the wrapper skips K = 0); D, B, Uinv, L 16-byte
// aligned, r and z 8-byte aligned (checked by the wrapper).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLoaders = kThreads - 32;  // warps 1-3 stage; warp 0 computes
constexpr int kChunk = 32;               // steps per shared-memory stage
constexpr int kMat = 36;                 // floats per 6x6 block
constexpr int kVec = 6;                  // floats per 6-vector

// Rows [first, first + rows) of a (K, W) row-major array into dst, by the
// loader threads (tid in [0, kLoaders)); rows outside [0, limit) read as
// zero.  V is float4 (W = 36) or float2 (W = 6).  Plain loads: the solve
// stages y, which the same kernel wrote.
template <int W, typename V>
__device__ __forceinline__ void stage(float* dst, const float* src, int first,
                                      int rows, int limit, int tid) {
  constexpr int per = W / (sizeof(V) / sizeof(float));
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int i = tid; i < rows * per; i += kLoaders) {
    const int row = first + i / per;
    V v{};
    if (row >= 0 && row < limit)
      v = s[static_cast<int64_t>(row) * per + i % per];
    d[i] = v;
  }
}

__device__ __forceinline__ void load_mat(float (&m)[kMat], const float* p) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kMat / 4; ++i) {
    const float4 v = p4[i];
    m[4 * i] = v.x;
    m[4 * i + 1] = v.y;
    m[4 * i + 2] = v.z;
    m[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_mat(float* p, const float (&m)[kMat]) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < kMat / 4; ++i)
    p4[i] = make_float4(m[4 * i], m[4 * i + 1], m[4 * i + 2], m[4 * i + 3]);
}

__device__ __forceinline__ void load_vec(float (&v)[kVec], const float* p) {
  const float2* p2 = reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 x = p2[i];
    v[2 * i] = x.x;
    v[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  float2* p2 = reinterpret_cast<float2*>(p);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    p2[i] = make_float2(v[2 * i], v[2 * i + 1]);
}

// out = a^-1 by Gauss-Jordan elimination with partial pivoting (the row
// of largest |a[r][c]| at or below the diagonal is swapped up), as
// jnp.linalg.inv's LU with partial pivoting picks its pivots.  A singular
// a gives inf / NaN, as there.
__device__ __forceinline__ void inv6(const float (&a)[kMat],
                                     float (&out)[kMat]) {
  float m[6][12];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      m[i][j] = a[6 * i + j];
      m[i][6 + j] = i == j ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(m[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float v = fabsf(m[r][c]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    // Swap rows c and p with constant indices only (predicated selects),
    // so m stays in registers.
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const bool sw = p == r;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float x = m[c][j], y = m[r][j];
        m[c][j] = sw ? y : x;
        m[r][j] = sw ? x : y;
      }
    }
    const float inv = 1.0f / m[c][c];
#pragma unroll
    for (int j = 0; j < 12; ++j) m[c][j] *= inv;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (r == c) continue;
      const float f = m[r][c];
#pragma unroll
      for (int j = 0; j < 12; ++j) m[r][j] = fmaf(-f, m[c][j], m[r][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) out[6 * i + j] = m[i][6 + j];
  }
}

__global__ void __launch_bounds__(kThreads)
chain_factor_kernel(const float* __restrict__ D, const float* __restrict__ B,
                    float* __restrict__ Uinv, float* __restrict__ L, int K) {
  __shared__ __align__(16) float sD[2][kChunk * kMat];
  __shared__ __align__(16) float sB[2][kChunk * kMat];  // Bprev rows
  const int chunks = (K + kChunk - 1) / kChunk;
  const bool loader = threadIdx.x >= 32;
  const int tid = threadIdx.x - 32;
  if (loader) {
    stage<kMat, float4>(sD[0], D, 0, kChunk, K, tid);
    stage<kMat, float4>(sB[0], B, -1, kChunk, K, tid);
  }
  __syncthreads();
  float up[kMat];                  // Uinv_{k-1}; 0 before step 0
#pragma unroll
  for (int i = 0; i < kMat; ++i) up[i] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int k0 = c * kChunk;
    if (loader) {
      if (c + 1 < chunks) {
        stage<kMat, float4>(sD[buf ^ 1], D, k0 + kChunk, kChunk, K, tid);
        stage<kMat, float4>(sB[buf ^ 1], B, k0 + kChunk - 1, kChunk, K, tid);
      }
    } else if (threadIdx.x == 0) {
      const int n = min(kChunk, K - k0);
      for (int s = 0; s < n; ++s) {
        float bp[kMat], d[kMat], l[kMat], u[kMat];
        load_mat(bp, sB[buf] + s * kMat);
        load_mat(d, sD[buf] + s * kMat);
        // L = Bprev^T Uinv_{k-1} (0 at k = 0: Bprev and up are 0 there).
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int m = 0; m < 6; ++m)
              acc = fmaf(bp[6 * m + i], up[6 * m + j], acc);
            l[6 * i + j] = acc;
          }
        }
        // U = D - L Bprev.
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int m = 0; m < 6; ++m)
              acc = fmaf(l[6 * i + m], bp[6 * m + j], acc);
            u[6 * i + j] = d[6 * i + j] - acc;
          }
        }
        inv6(u, up);
        const int64_t k = k0 + s;
        store_mat(L + k * kMat, l);
        store_mat(Uinv + k * kMat, up);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
chain_solve_kernel(const float* __restrict__ Uinv, const float* __restrict__ L,
                   const float* __restrict__ B, const float* __restrict__ r,
                   float* z, int K) {
  __shared__ __align__(16) float sM[2][kChunk * kMat];  // L, then Uinv
  __shared__ __align__(16) float sN[2][kChunk * kMat];  // Bn (backward)
  __shared__ __align__(16) float sv[2][kChunk * kVec];  // r, then y
  const int chunks = (K + kChunk - 1) / kChunk;
  const bool loader = threadIdx.x >= 32;
  const int tid = threadIdx.x - 32;

  // Forward: y_k = r_k - L_k y_{k-1}, written into z.
  if (loader) {
    stage<kMat, float4>(sM[0], L, 0, kChunk, K, tid);
    stage<kVec, float2>(sv[0], r, 0, kChunk, K, tid);
  }
  __syncthreads();
  float y[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) y[i] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int k0 = c * kChunk;
    if (loader) {
      if (c + 1 < chunks) {
        stage<kMat, float4>(sM[buf ^ 1], L, k0 + kChunk, kChunk, K, tid);
        stage<kVec, float2>(sv[buf ^ 1], r, k0 + kChunk, kChunk, K, tid);
      }
    } else if (threadIdx.x == 0) {
      const int n = min(kChunk, K - k0);
      for (int s = 0; s < n; ++s) {
        float l[kMat], rk[kVec], yn[kVec];
        load_mat(l, sM[buf] + s * kMat);
        load_vec(rk, sv[buf] + s * kVec);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j) acc = fmaf(l[6 * i + j], y[j], acc);
          yn[i] = rk[i] - acc;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) y[i] = yn[i];
        store_vec(z + static_cast<int64_t>(k0 + s) * kVec, y);
      }
    }
    __syncthreads();
  }

  // Backward: z_k = Uinv_k (y_k - Bn_k z_{k+1}), chunks in reverse.  The
  // __syncthreads above makes lane 0's y stores visible to the loaders.
  const int last = chunks - 1;
  if (loader) {
    const int k0 = last * kChunk;
    stage<kMat, float4>(sM[0], Uinv, k0, kChunk, K, tid);
    stage<kMat, float4>(sN[0], B, k0, kChunk, K - 1, tid);
    stage<kVec, float2>(sv[0], z, k0, kChunk, K, tid);
  }
  __syncthreads();
  float zn[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) zn[i] = 0.0f;
  for (int c = last; c >= 0; --c) {
    const int buf = (last - c) & 1;
    const int k0 = c * kChunk;
    if (loader) {
      if (c > 0) {
        const int p0 = k0 - kChunk;
        stage<kMat, float4>(sM[buf ^ 1], Uinv, p0, kChunk, K, tid);
        stage<kMat, float4>(sN[buf ^ 1], B, p0, kChunk, K - 1, tid);
        stage<kVec, float2>(sv[buf ^ 1], z, p0, kChunk, K, tid);
      }
    } else if (threadIdx.x == 0) {
      const int n = min(kChunk, K - k0);
      for (int s = n - 1; s >= 0; --s) {
        float ui[kMat], bn[kMat], yk[kVec], t[kVec];
        load_mat(ui, sM[buf] + s * kMat);
        load_mat(bn, sN[buf] + s * kMat);
        load_vec(yk, sv[buf] + s * kVec);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j) acc = fmaf(bn[6 * i + j], zn[j], acc);
          t[i] = yk[i] - acc;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j) acc = fmaf(ui[6 * i + j], t[j], acc);
          zn[i] = acc;
        }
        store_vec(z + static_cast<int64_t>(k0 + s) * kVec, zn);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// (Uinv, L) = the block-Thomas factors of the chain (D, B), all (K, 6, 6)
// float32, on `stream`; returns a cudaError_t (0 = ok).
extern "C" int veloslam_chain_factor(const float* D, const float* B,
                                     float* Uinv, float* L, int64_t K,
                                     void* stream) {
  if (K <= 0) return 0;
  if (K > INT_MAX / kMat) return static_cast<int>(cudaErrorInvalidValue);
  chain_factor_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, B, Uinv, L, static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

// z (K, 6) = M^-1 r for the chain matrix M factored as (Uinv, L) with
// coupling B, on `stream`; returns a cudaError_t (0 = ok).
extern "C" int veloslam_chain_solve(const float* Uinv, const float* L,
                                    const float* B, const float* r, float* z,
                                    int64_t K, void* stream) {
  if (K <= 0) return 0;
  if (K > INT_MAX / kMat) return static_cast<int>(cudaErrorInvalidValue);
  chain_solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Uinv, L, B, r, z, static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}
