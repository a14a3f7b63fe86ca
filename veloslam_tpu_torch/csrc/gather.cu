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
// 4-byte index read and one write (4 B for int32, 32 B for a row); each
// table row the indices touch is read once: 13-17 MB for the bulk path's
// int32 gather, 4-5 us at 3.35 TB/s.  The TPU kernels held the whole
// table in VMEM; here the tables (8 MB for the 256x256x32 dilated index,
// 1-4 MB of keys, 1-32 MB of rows) fit in the 50 MB L2, but a random
// 4-byte read still moves a whole 32-byte L2 sector.  So the int32
// gather on scattered indices is bound by L2 sector traffic (1.57M
// sectors + the streams, ~63 MB, in 14 us on an H100: ~4.4 TB/s), as
// torch.index_select is; a row of 32 bytes is one sector, so the row
// gather is not.
//
// gather_i32: persistent blocks (a grid sized from the SM count walks the
// input); each thread loads kVecs 16-byte index vectors, then issues their
// 4 * kVecs independent table loads before its first store, so 16 table
// reads per thread are in flight.  A scalar tail takes the last m % 4
// outputs; idx and out are 16-byte aligned (checked by the wrapper).  On
// the main paths' own index streams, of 1, 2 or 4 vectors per thread with
// and without L2 hints (evict-first on the index and output streams,
// evict-last on the table), 4 vectors without hints measured fastest on
// an H100: the tables stay in L2 without the hints, and the hints cost
// 2-6%.
// gather_rows8: a row moves as two 16-byte vector loads and stores (one
// per thread of a pair, so neighbouring threads write neighbouring 16
// bytes).
//
// Indices are in range by contract (callers clamp); any M works.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;     // int4 index vectors per thread per pass

__global__ void __launch_bounds__(kThreads)
gather_i32_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  int64_t m) {
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  const int64_t nvec = m / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // A pass covers kVecs * stride vectors; thread j takes j, j + stride,
  // ..., so each load and store instruction is coalesced across the warp.
  for (int64_t v0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v0 < nvec; v0 += kVecs * stride) {
    int4 ix[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t v = v0 + u * stride;
      ix[u] = v < nvec ? __ldg(idx4 + v) : make_int4(0, 0, 0, 0);
    }
    int4 val[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      val[u].x = __ldg(table + ix[u].x);
      val[u].y = __ldg(table + ix[u].y);
      val[u].z = __ldg(table + ix[u].z);
      val[u].w = __ldg(table + ix[u].w);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) out4[v] = val[u];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (m & 3)) {
    const int64_t i = 4 * nvec + threadIdx.x;
    out[i] = __ldg(table + __ldg(idx + i));
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

// Blocks of gather_i32_kernel that the card keeps resident at once.
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
            &per_sm, gather_i32_kernel, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// out[i] = table[idx[i]] for i < m, on `stream`; idx and out 16-byte
// aligned; returns a cudaError_t (0 = ok).
extern "C" int veloslam_gather_i32(const int32_t* table, const int32_t* idx,
                                   int32_t* out, int64_t m, void* stream) {
  if (m <= 0) return 0;
  const int resident = resident_blocks();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Enough blocks for one pass, at most the resident ones.
  const int64_t per_block = static_cast<int64_t>(kThreads) * kVecs;
  const int64_t wanted = (m / 4 + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(
      wanted < 1 ? 1 : (wanted < resident ? wanted : resident));
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
