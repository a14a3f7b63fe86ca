// Table gathers of the association step (sm_90a, plain C interface for
// ctypes): a flat int32 gather and a gather of 8-float rows.
//
// Replaces: scripts/bench_pallas_gather.py::make_gather.run (out[i] =
// table[idx[i]], int32) and ::make_rowgather.run (out[i, :] =
// table[idx[i], :], 8 float lanes).  On the main path the first is the
// dilated-index lookup (registration/voxel.py::lookup_dilated) and the
// key check of the binary-search lookup (voxel.py::lookup); the second is
// the per-point plane fetch of registration/gicp.py::associate, whose
// table row packs [mu (3), n (3), 0, 0].
//
// What bounds them: no arithmetic, only bytes.  Each output costs one
// 4-byte index read, one random table read and one write (4 B for int32,
// 32 B for a row).  The TPU kernels held the whole table in VMEM; here the
// tables (8 MB for the 256x256x32 dilated index, 1-2 MB of rows) fit in
// the 50 MB L2, so the random reads hit L2 after first touch and the
// kernels are bound by L2 latency and the streamed index/output traffic.
// The design answers that with many independent loads in flight: each
// thread of the int32 gather issues kPerThread read-only loads before it
// stores, and a row moves as two 16-byte vector loads and stores (one per
// thread of a pair, so neighbouring threads write neighbouring 16 bytes).
//
// Indices are in range by contract (callers clamp); any M works.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__global__ void __launch_bounds__(kThreads)
gather_i32_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  int64_t m) {
  // A block covers kThreads * kPerThread consecutive outputs; thread t
  // takes t, t + kThreads, ... so each of its loads and the final stores
  // are coalesced across the warp.
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kThreads * kPerThread + threadIdx.x;
  int32_t v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    v[k] = i < m ? __ldg(table + __ldg(idx + i)) : 0;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    if (i < m) out[i] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows8_kernel(const float4* __restrict__ table,
                    const int32_t* __restrict__ idx, float4* __restrict__ out,
                    int64_t m) {
  // Thread j moves half h = j & 1 of output row j >> 1: a 32-byte row is
  // two float4 (table and out are 16-byte aligned, checked by the wrapper).
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= 2 * m) return;
  const int64_t row = __ldg(idx + (j >> 1));
  out[j] = __ldg(table + 2 * row + (j & 1));
}

}  // namespace

// out[i] = table[idx[i]] for i < m, on `stream`; returns cudaGetLastError().
extern "C" int veloslam_gather_i32(const int32_t* table, const int32_t* idx,
                                   int32_t* out, int64_t m, void* stream) {
  if (m <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPerThread;
  const unsigned blocks = static_cast<unsigned>((m + per_block - 1) / per_block);
  gather_i32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, m);
  return static_cast<int>(cudaGetLastError());
}

// out[i, :] = table[idx[i], :] for 8-float rows, i < m, on `stream`;
// returns cudaGetLastError().
extern "C" int veloslam_gather_rows8(const float* table, const int32_t* idx,
                                     float* out, int64_t m, void* stream) {
  if (m <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((2 * m + kThreads - 1) / kThreads);
  gather_rows8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
