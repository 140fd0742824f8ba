// Hopper copy primitives shared by the sm_90a kernels (gemm_sm90.cuh,
// flash_attention.cu, int8_matmul.cu): mbarriers, TMA tile loads (cp.async.bulk.tensor) and
// the host-side tensor-map encoder.
//
// The encoder, cuTensorMapEncodeTiled, lives in libcuda. It is fetched once
// through the runtime's entry-point query, so the library links against
// the runtime alone (no -lcuda). A map is built on the host for each
// call and passed to the kernel by value as a `const __grid_constant__
// CUtensorMap`, which keeps it in parameter space where TMA can read it.
//
// Each translation unit that includes this header gets its own copy (an
// anonymous namespace), so the objects link together.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 2-D and 4-D TMA tile loads into shared memory; completion is counted in
// bytes on `bar`. Coordinates are innermost first. Out-of-bounds elements of
// the box are written as zeros (and still counted).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 2-D TMA tile store from shared memory (one thread issues it): rows and
// columns of the box outside the tensor are not written. Commit the stores
// as a bulk group; wait until the groups' shared-memory reads are done (the
// source may be written again) or until they are complete.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later async-proxy (TMA)
// reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- host side -------------------------------------------------------------

// The current device's SM count (132 on an H100 SXM).
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first; dim 0 contiguous) of
// `elem_bytes`-byte elements, strides in elements for dims 1.., a box of
// `box` elements, 128-byte swizzle (box[0] must span at most 128 bytes) and
// zero fill out of bounds. Returns false if it cannot be encoded.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType dtype,
                       int elem_bytes, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = strides[i] * elem_bytes;  // bytes
  }
  CUresult r = fn(map, dtype, rank, const_cast<void*>(base), gdim, gstride,
                  bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// A bf16 tensor map (box[0] at most 64 elements = 128 bytes).
inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rank, dims,
                    strides, box);
}

// An 8-bit (int8) tensor map (box[0] at most 128 elements = 128 bytes).
inline bool encode_i8_map(CUtensorMap* map, const void* base, int rank,
                          const uint64_t* dims, const uint64_t* strides,
                          const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rank, dims,
                    strides, box);
}

}  // namespace
