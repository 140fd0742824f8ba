// The row-wise LayerNorm pass shared by the fused MLP (fused_mlp.cu) and the
// fused LayerNorm + projection (fused_ln_proj.cu): one warp a row, 16-byte
// loads, fp32 sums: the mean, then the mean of the squared deviations (two
// passes, not E[x^2] - mean^2), rstd = rsqrt(var + eps), and
// y = bf16(((x - mean) * rstd) * w + b) [M, D], each operation rounded (no
// FMA contraction), as the plain versions compute it.
// D must be a multiple of 8. Each translation unit that includes this header
// gets its own copy (an anonymous namespace), so the objects link together.

#pragma once

#include <cuda_bf16.h>

namespace {

// y[row] = LN(x[row]) in fp32, rounded to bf16. One warp per row.
__global__ void ln_rows(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ b,
                        __nv_bfloat16* __restrict__ y, int M, int D,
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
  float mean = sum / D;
  float sq = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d = __bfloat162float(e[i]) - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  float rstd = rsqrtf(sq / D + eps);
  __nv_bfloat16* yr = y + static_cast<size_t>(row) * D;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(e[i]), mean), rstd),
                    w[c + i]),
          b[c + i]);
      oe[i] = __float2bfloat16(v);
    }
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

}  // namespace
