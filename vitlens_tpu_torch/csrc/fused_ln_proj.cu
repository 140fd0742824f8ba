// LayerNorm + linear projection, forward:
//
//     out = LN(x) @ W + b          x [M, D] -> out [M, N]
//
// Replaces vitlens_tpu/ops/fused_ln_proj.py::_pallas_ln_proj (body
// `_kernel`): the resblock front half, ln_1 + the packed qkv projection
// (N = 3D). Numerics follow that kernel: per-row mean, then the mean of the
// squared deviations (two passes, not E[x^2] - mean^2), in fp32;
// y = ((x - mean) * rsqrt(var + eps)) * w + b in fp32, rounded to bf16; the
// product accumulated in fp32 and the bias added in fp32 before the one
// rounding of the output.
//
// What bounds it on an H100: at the audio encode's B64 x 3 clips shape
// (M = 49344, D = 1024, N = 3072) it does 2*M*D*N = 310 GFLOP (0.314 ms at
// 989 TFLOP/s) against ~0.41 GB of x/out/W bytes (0.122 ms at 3.35 TB/s):
// the operations bound it.
//
// Design (first, simple and correct): two launches on the caller's stream.
//   1. ln_stats: one warp per row -> mean [M], rstd [M] fp32 (8 bytes a
//      row; x is read once more by the GEMM).
//   2. gemm (gemm_bf16.cuh): each A tile is normalised in
//      shared memory as it lands, before the mma.sync, so LN(x) never
//      reaches HBM; the epilogue adds b in fp32 and rounds once.
// A CTA re-reads its rows' statistics and the LN affine from L2; wgmma and
// TMA are later work.
//
// Requirements checked by the Python wrapper: bf16 x/W, fp32 LN params and
// bias, everything contiguous, D and N multiples of 128, D <= 8192.

#include "gemm_bf16.cuh"

namespace {

// mean[row], rstd[row] of x[row] in fp32. One warp per row.
__global__ void ln_stats(const __nv_bfloat16* __restrict__ x,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int M, int D,
                         float eps) {
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += __bfloat162float(e[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / D;
  float sq = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rsqrtf(sq / D + eps);
  }
}

}  // namespace

// x [M, D] bf16; lnw, lnb [D] fp32; w [D, N] bf16; b [N] fp32; scratch
// mean, rstd [M] fp32; out [M, N] bf16.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitlens_fused_ln_proj_fwd(const void* x, const void* lnw,
                                         const void* lnb, const void* w,
                                         const void* b, void* mean, void* rstd,
                                         void* out, int M, int D, int N,
                                         float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = 8;
  ln_stats<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0,
             s>>>(static_cast<const __nv_bfloat16*>(x),
                  static_cast<float*>(mean), static_cast<float*>(rstd), M, D,
                  eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const LnPrologue ln{static_cast<const float*>(mean),
                      static_cast<const float*>(rstd),
                      static_cast<const float*>(lnw),
                      static_cast<const float*>(lnb)};
  err = launch_gemm(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), ln, M, N,
      D, s);
  return static_cast<int>(err);
}
