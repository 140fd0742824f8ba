// Row gather: out[j, :] = table[ids[j], :], bit-exact.
//
// Replaces scripts/bench_dma_gather.py::dma_gather (body `_copy_kernel`): on
// the TPU one row DMA per grid step, addressed through scalar-prefetched
// indices. The [V, 8, D/8] view there is a Mosaic block-shape workaround and
// is not carried over.
//
// What bounds it on an H100: bytes. J rows of D elements are read once and
// written once (2 * 9856 * 1024 B = 20 MB at the text tower's B128 x 77 ids
// of a [49408, 512] bf16 table, 0.006 ms at 3.35 TB/s). At that size a
// copy is a chain of latencies (the id, then the row, then the store) more
// than a stream, so what counts is how many bytes are in flight at once.
//
// Design: a warp copies `rows` consecutive rows (the host picks the fewest
// that keep the whole grid resident on the card in one wave: 2 at 9856
// ids); the warp's lanes read its ids first, then, row by row, each lane
// issues all of its 16-byte loads of the row (up to U of them, neighbouring
// lanes on neighbouring addresses) before any of its stores, which stream
// past L2 (st.global.cs: the output is not read again here). An id outside
// [0, V) is clamped to the nearest row, so the kernel never reads outside
// the table (the plain version raises instead).
//
// Requirements checked by the Python wrapper: a contiguous 2-D table whose
// row is a multiple of 16 bytes, int32 ids, everything 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int WARPS = 8;         // warps a block
constexpr int U = 4;             // 16-byte loads a lane keeps in flight
constexpr int MAX_ROWS = 32;     // rows a warp, at most (one id a lane)

__global__ void __launch_bounds__(32 * WARPS)
    row_gather(const uint4* __restrict__ table, const int* __restrict__ ids,
               uint4* __restrict__ out, int J, int V, int chunks, int rows) {
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * WARPS + threadIdx.x / 32) * rows;
  if (row0 >= J) return;
  const int n = min(rows, J - row0);
  const int my_id = lane < n ? min(max(__ldg(ids + row0 + lane), 0), V - 1) : 0;
  for (int r = 0; r < n; ++r) {
    const int id = __shfl_sync(0xffffffffu, my_id, r);
    const uint4* src = table + static_cast<size_t>(id) * chunks;
    uint4* dst = out + static_cast<size_t>(row0 + r) * chunks;
    for (int c0 = 0; c0 < chunks; c0 += 32 * U) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c < chunks) v[u] = __ldg(src + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c < chunks) __stcs(dst + c, v[u]);
      }
    }
  }
}

}  // namespace

// table [V, row_bytes]; ids [J] int32; out [J, row_bytes]. row_bytes is a
// multiple of 16. Returns cudaGetLastError() after the launch.
extern "C" int vitlens_row_gather_fwd(const void* table, const void* ids,
                                      void* out, int J, int V, int row_bytes,
                                      void* stream) {
  static int resident = 0;  // warps the card holds at once
  if (resident == 0) resident = sm_count() * (2048 / 32);
  int rows = (J + resident - 1) / resident;
  rows = rows < 1 ? 1 : rows > MAX_ROWS ? MAX_ROWS : rows;
  const int warps = (J + rows - 1) / rows;
  row_gather<<<(warps + WARPS - 1) / WARPS, 32 * WARPS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(ids),
      static_cast<uint4*>(out), J, V, row_bytes / 16, rows);
  return static_cast<int>(cudaGetLastError());
}
