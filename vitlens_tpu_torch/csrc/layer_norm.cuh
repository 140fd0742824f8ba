// The row-wise LayerNorm pass shared by the fused MLP (fused_mlp.cu) and the
// fused LayerNorm + projection (fused_ln_proj.cu): one warp a row, 16-byte
// loads, fp32 sums: the mean, then the mean of the squared deviations (two
// passes, not E[x^2] - mean^2), rstd = rsqrt(var + eps), and
// y = bf16(((x - mean) * rstd) * w + b) [M, D], each operation rounded (no
// FMA contraction), as the plain versions compute it. The rows are bf16 or,
// for the attention out-projection's fp32 row (fused_mlp_chain.cu, through
// fused_mlp.cu), fp32.
// D must be a multiple of 8. Each translation unit that includes this header
// gets its own copy (an anonymous namespace), so the objects link together.

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// y[row] = LN(x[row]) in fp32, rounded to bf16. One warp per row.
template <class T>
__global__ void ln_rows(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b,
                        __nv_bfloat16* __restrict__ y, int M, int D,
                        float eps) {
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  float v[8];
  float sum = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float mean = sum / D;
  float sq = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d = v[i] - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  float rstd = rsqrtf(sq / D + eps);
  __nv_bfloat16* yr = y + static_cast<size_t>(row) * D;
  for (int c = lane * 8; c < D; c += 256) {
    load8(xr + c, v);
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd), w[c + i]), b[c + i]);
      oe[i] = __float2bfloat16(t);
    }
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

}  // namespace
