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
// What bounds them: neither bytes nor operations but latency.  Each step
// needs the previous step's result, so a call is K dependent steps.  The
// bytes (~0.5 KB per pose) take microseconds at 3.35 TB/s; a solve step
// cannot finish in fewer than 20 dependent float operations (forward: 6
// FMAs and the subtraction; backward: 6 FMAs, the subtraction, 6 FMAs),
// a factor step in fewer than its product chains and six pivots, each a
// reciprocal, a scaling and an elimination.
//
// Design: one block per call.  Warp 0 runs the recurrence with its six
// lanes on the six rows of a step: lane i owns output row i, reads row i
// of the step's blocks from shared memory, and takes the 6-vector or 6x6
// block it depends on from the other lanes (__shfl_sync for vectors and
// the pivot row, shared memory for the previous Uinv), so a step issues
// about a sixth of the instructions one lane would.  Lanes 6-31 repeat
// row 5 and store nothing, so every shuffle names the whole warp.  Each
// lane sums its dot products in the order one lane did (acc = 0, then
// fmaf over j = 0..5), and Gauss-Jordan keeps its pivot rule and its
// arithmetic (1.0f / pivot, the row scaled by it, fmaf eliminations), so
// the results are the bits of the one-lane kernel.  Rows are not swapped
// between lanes: each lane keeps the logical row it holds (`label`) and
// every lane the lane of each logical row (`at`).
//
// The blocks a step reads do not depend on the recurrence, so warps 1-3
// stage them into shared memory kChunk steps ahead, double-buffered, with
// cp.async (zero-filled outside the chain), every copy of a chunk in
// flight at once: while warp 0 runs chunk c out of one buffer, the others
// fill the other with chunk c + 1, and a __syncthreads swaps them.  The
// solve's forward sweep writes y into z; the backward sweep stages y back
// from there (the __syncthreads between the sweeps orders warp 0's stores
// before the loaders' reads) and overwrites it with z.
//
// Shapes: any K >= 1 (the wrapper skips K = 0); D, B, Uinv, L 16-byte
// aligned, r and z 8-byte aligned (checked by the wrapper).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLoaders = kThreads - 32;  // warps 1-3 stage; warp 0 computes
constexpr int kChunk = 64;               // steps per shared-memory stage
constexpr int kMat = 36;                 // floats per 6x6 block
constexpr int kVec = 6;                  // floats per 6-vector
constexpr unsigned kWarp = 0xffffffffu;

// One cp.async of 16 bytes (blocks) or 8 bytes (vectors) into shared
// memory; zero-filled (nothing read) when !valid.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    static_assert(kBytes == 8, "blocks move as 16 B, vectors as 8 B");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  }
}

// Wait for this thread's copies; a __syncthreads then shows them to all.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [first, first + rows) of a (K, W) row-major array into dst, by the
// loader threads (tid in [0, kLoaders)); rows outside [0, limit) are zero.
template <int W>
__device__ __forceinline__ void stage(float* dst, const float* src, int first,
                                      int rows, int limit, int tid) {
  constexpr int kPiece = W % 4 == 0 ? 4 : 2;  // floats per copy
  constexpr int per = W / kPiece;
  for (int i = tid; i < rows * per; i += kLoaders) {
    const int row = first + i / per;
    const bool ok = row >= 0 && row < limit;
    const float* s =
        ok ? src + static_cast<int64_t>(row) * W + i % per * kPiece : src;
    copy_async<kPiece * 4>(dst + i * kPiece, s, ok);
  }
}

// A 6-float row at an 8-byte aligned shared-memory address.
__device__ __forceinline__ void load_row(float (&v)[kVec], const float* p) {
  const float2* p2 = reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 x = p2[i];
    v[2 * i] = x.x;
    v[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void store_row(float* p, const float* v) {
  float2* p2 = reinterpret_cast<float2*>(p);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    p2[i] = make_float2(v[2 * i], v[2 * i + 1]);
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

// acc = 0, then fmaf(a[j], v[j], acc) for j = 0..5, with v[j] held by
// lane j: one lane's dot product of row a with a vector spread over lanes.
__device__ __forceinline__ float dot_lanes(const float (&a)[kVec], float v) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc = fmaf(a[j], __shfl_sync(kWarp, v, j), acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
chain_factor_kernel(const float* __restrict__ D, const float* __restrict__ B,
                    float* __restrict__ Uinv, float* __restrict__ L, int K) {
  __shared__ __align__(16) float sD[2][kChunk * kMat];
  __shared__ __align__(16) float sB[2][kChunk * kMat];  // Bprev rows
  __shared__ __align__(16) float sU[2][kMat];  // Uinv_k in sU[k & 1]
  const int chunks = (K + kChunk - 1) / kChunk;
  const bool loader = threadIdx.x >= 32;
  const int tid = threadIdx.x - 32;
  const int lane = threadIdx.x & 31;
  const int row = min(lane, kVec - 1);
  const bool writer = lane < kVec;
  if (loader) {
    stage<kMat>(sD[0], D, 0, kChunk, K, tid);
    stage<kMat>(sB[0], B, -1, kChunk, K, tid);
    copies_done();
  } else {
    float* su = &sU[0][0];
    for (int i = lane; i < 2 * kMat; i += 32) su[i] = 0.0f;  // Uinv_{-1}
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int k0 = c * kChunk;
    if (loader) {
      if (c + 1 < chunks) {
        stage<kMat>(sD[buf ^ 1], D, k0 + kChunk, kChunk, K, tid);
        stage<kMat>(sB[buf ^ 1], B, k0 + kChunk - 1, kChunk, K, tid);
        copies_done();
      }
    } else {
      const int n = min(kChunk, K - k0);
      for (int s = 0; s < n; ++s) {
        const int k = k0 + s;
        const float* bs = sB[buf] + s * kMat;
        float bp[kMat], up[kMat], bc[kVec], d[kVec], l[kVec], g[2 * kVec];
        load_mat(bp, bs);
        load_mat(up, sU[(k + 1) & 1]);       // Uinv_{k-1}
#pragma unroll
        for (int m = 0; m < kVec; ++m) bc[m] = bs[kVec * m + row];
        load_row(d, sD[buf] + s * kMat + kVec * row);
        // Row `row` of L = Bprev^T Uinv_{k-1} (0 at k = 0: both are 0).
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < kVec; ++m) acc = fmaf(bc[m], up[kVec * m + j], acc);
          l[j] = acc;
        }
        // Row `row` of U = D - L Bprev, beside row `row` of the identity.
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < kVec; ++m) acc = fmaf(l[m], bp[kVec * m + j], acc);
          g[j] = d[j] - acc;
          g[kVec + j] = row == j ? 1.0f : 0.0f;
        }
        // Gauss-Jordan with partial pivoting, one row per lane: the row of
        // largest |g[c]| among logical rows c..5 (the first one on ties,
        // and never one whose value is NaN: a strict > scan from row c)
        // becomes row c; the swap moves labels, not values.
        int label = row;                      // logical row this lane holds
        int at[kVec];                         // lane holding logical row r
#pragma unroll
        for (int r = 0; r < kVec; ++r) at[r] = r;
#pragma unroll
        for (int c2 = 0; c2 < kVec; ++c2) {
          // Every lane takes 1 / its own candidate (IEEE division, as one
          // lane did) before the search, so the reciprocal's latency runs
          // beside it; the pivot lane's is the one used.
          const float a = fabsf(g[c2]);
          const float inv = 1.0f / g[c2];
          int p = c2, lp = at[c2];            // the pivot row, its lane
          float best = __shfl_sync(kWarp, a, at[c2]);
#pragma unroll
          for (int r = c2 + 1; r < kVec; ++r) {
            const float v = __shfl_sync(kWarp, a, at[r]);
            if (v > best) {
              best = v;
              p = r;
              lp = at[r];
            }
          }
#pragma unroll
          for (int r = c2 + 1; r < kVec; ++r) at[r] = p == r ? at[c2] : at[r];
          at[c2] = lp;
          label = label == c2 ? p : (label == p ? c2 : label);
          // The pivot row scaled by 1 / pivot, sent to every lane; the
          // others eliminate column c2.
          const float f = g[c2];
          const bool pivot = label == c2;
#pragma unroll
          for (int j = 0; j < 2 * kVec; ++j) {
            const float pj = __shfl_sync(kWarp, g[j] * inv, lp);
            g[j] = pivot ? pj : fmaf(-f, pj, g[j]);
          }
        }
        if (writer) {
          const int64_t o = static_cast<int64_t>(k) * kMat;
          store_row(L + o + kVec * row, l);
          store_row(Uinv + o + kVec * label, g + kVec);
          store_row(sU[k & 1] + kVec * label, g + kVec);
        }
        __syncwarp();
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
  const int lane = threadIdx.x & 31;
  const int row = min(lane, kVec - 1);
  const bool writer = lane < kVec;

  // Forward: y_k = r_k - L_k y_{k-1}, written into z; lane i holds y[i].
  if (loader) {
    stage<kMat>(sM[0], L, 0, kChunk, K, tid);
    stage<kVec>(sv[0], r, 0, kChunk, K, tid);
    copies_done();
  }
  __syncthreads();
  float y = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int k0 = c * kChunk;
    if (loader) {
      if (c + 1 < chunks) {
        stage<kMat>(sM[buf ^ 1], L, k0 + kChunk, kChunk, K, tid);
        stage<kVec>(sv[buf ^ 1], r, k0 + kChunk, kChunk, K, tid);
        copies_done();
      }
    } else {
      const int n = min(kChunk, K - k0);
      const float* m = sM[buf] + kVec * row;
      const float* v = sv[buf] + row;
      float* out = z + static_cast<int64_t>(k0) * kVec + row;
      for (int s = 0; s < n; ++s) {
        float l[kVec];
        load_row(l, m + s * kMat);
        y = v[s * kVec] - dot_lanes(l, y);
        if (writer) out[s * kVec] = y;
      }
    }
    __syncthreads();
  }

  // Backward: z_k = Uinv_k (y_k - Bn_k z_{k+1}), chunks in reverse; lane i
  // holds z[i].  The __syncthreads above orders warp 0's y stores before
  // the loaders stage them back.
  const int last = chunks - 1;
  if (loader) {
    const int k0 = last * kChunk;
    stage<kMat>(sM[0], Uinv, k0, kChunk, K, tid);
    stage<kMat>(sN[0], B, k0, kChunk, K - 1, tid);
    stage<kVec>(sv[0], z, k0, kChunk, K, tid);
    copies_done();
  }
  __syncthreads();
  float zn = 0.0f;
  for (int c = last; c >= 0; --c) {
    const int buf = (last - c) & 1;
    const int k0 = c * kChunk;
    if (loader) {
      if (c > 0) {
        const int p0 = k0 - kChunk;
        stage<kMat>(sM[buf ^ 1], Uinv, p0, kChunk, K, tid);
        stage<kMat>(sN[buf ^ 1], B, p0, kChunk, K - 1, tid);
        stage<kVec>(sv[buf ^ 1], z, p0, kChunk, K, tid);
        copies_done();
      }
    } else {
      const int n = min(kChunk, K - k0);
      const float* mu = sM[buf] + kVec * row;
      const float* mb = sN[buf] + kVec * row;
      const float* v = sv[buf] + row;
      float* out = z + static_cast<int64_t>(k0) * kVec + row;
      for (int s = n - 1; s >= 0; --s) {
        float u[kVec], b[kVec];
        load_row(u, mu + s * kMat);
        load_row(b, mb + s * kMat);
        const float t = v[s * kVec] - dot_lanes(b, zn);
        zn = dot_lanes(u, t);
        if (writer) out[s * kVec] = zn;
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
