// Row gather: out[j, :] = table[ids[j], :], bit-exact.
//
// Replaces scripts/bench_dma_gather.py::dma_gather (body `_copy_kernel`): on
// the TPU one row DMA per grid step, addressed through scalar-prefetched
// indices. The [V, 8, D/8] view there is a Mosaic block-shape workaround and
// is not carried over.
//
// What bounds it on an H100: bytes. J rows of D elements are read once and
// written once (2 * 9856 * 1024 B = 20 MB at the text tower's B128 x 77 ids
// of a [49408, 512] bf16 table, 0.006 ms at 3.35 TB/s); at that size the
// launch itself costs about as much.
//
// Design: one warp per output row; the warp reads its id from global memory
// and copies the row in 16-byte pieces, neighbouring lanes on neighbouring
// addresses. An id outside [0, V) is clamped to the nearest row, so the
// kernel never reads outside the table (the plain version raises instead).
//
// Requirements checked by the Python wrapper: a contiguous 2-D table whose
// row is a multiple of 16 bytes, int32 ids, everything 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;

__global__ void row_gather(const uint4* __restrict__ table,
                           const int* __restrict__ ids, uint4* __restrict__ out,
                           int J, int V, int chunks) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= J) return;
  const int id = min(max(ids[row], 0), V - 1);
  const uint4* src = table + static_cast<size_t>(id) * chunks;
  uint4* dst = out + static_cast<size_t>(row) * chunks;
  for (int c = lane; c < chunks; c += 32) dst[c] = __ldg(src + c);
}

}  // namespace

// table [V, row_bytes]; ids [J] int32; out [J, row_bytes]. row_bytes is a
// multiple of 16. Returns cudaGetLastError() after the launch.
extern "C" int vitlens_row_gather_fwd(const void* table, const void* ids,
                                      void* out, int J, int V, int row_bytes,
                                      void* stream) {
  row_gather<<<(J + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(ids),
      static_cast<uint4*>(out), J, V, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
