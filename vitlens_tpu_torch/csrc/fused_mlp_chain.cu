// The attention out-projection and its residual in front of the residual MLP
// half of a transformer block:
//
//   row32 = (x + ctx @ Wo) + bo                                   (fp32)
//   out = bf16((row32 + b2) + act(LN(row32) @ W1 + b1) @ W2)
//
// Replaces scripts/fused_attnout_mlp_pallas.py::fused (body `kernel`). The
// other chained prototype, scripts/fused_mlp_pallas.py::fused_mlp, is kernel
// 1's function with the tanh GELU and runs on fused_mlp.cu's
// vitlens_fused_mlp_fwd (act 2). Numerics follow the prototype: every product
// accumulates in fp32; row32 is never rounded, and both the LayerNorm (fp32,
// the mean, then the mean of the squared deviations, rounded to bf16) and the
// residual read it; b1 and the activation in fp32 before the one rounding of
// h; row32, b2 and the second product summed in fp32, in that order, and
// rounded once. The activation is 0 = exact (erf) GELU, which is what the
// resblock means, or 2 = tanh GELU, which is what the TPU prototype computes
// (Mosaic has no erf): gemm_sm90.cuh's act_fn codes.
//
// What bounds it on an H100: the operations (2*M*D*D + 4*M*D*H, 0.31 ms at
// M = 16448, D = 1024, H = 4096 against ~0.1 GB of x/ctx/out/weights). The
// TPU prototype keeps the hidden activation in VMEM; an SM cannot hold the
// 16.8 MB of W1 and W2 that a row block needs (the first port of these
// prototypes, one kernel with an fp32 [32, 1024] accumulator a CTA, streamed
// all the weights from L2 for every 32 rows: 8.6 GB of L2 traffic, 2.31 ms at
// this shape), so this design writes h to HBM and reads it back, as kernel 1
// (fused_mlp.cu) does.
//
// Design: on the caller's stream, on gemm_sm90.cuh's TMA + wgmma GEMM (a
// producer warpgroup, a 4-stage mbarrier ring, two consumer warpgroups, fused
// epilogues):
//   0. ctx @ Wo with the EPI_ROW_F32 epilogue -> row32 [M, D] fp32
//      ((x + acc) + bo, never rounded);
//   1-3. kernel 1's launches on the fp32 rows (vitlens_fused_mlp_f32_rows
//      in fused_mlp.cu): ln_rows -> y [M, D] bf16, y @ W1 with EPI_BIAS_ACT
//      -> h [M, H] bf16, h @ W2 with EPI_BIAS_RESIDUAL_F32 -> out [M, D] bf16.
// The scratch y, h and row32 is one workspace the wrapper allocates:
// 2*M*D + 2*M*H + 4*M*D bytes.
//
// Requirements checked by the Python wrapper: bf16 x/ctx/Wo/W1/W2, fp32 LN
// params and biases, everything contiguous and 16-byte aligned (TMA's base
// and row strides), D and H multiples of 64.

#include "gemm_sm90.cuh"

// Kernel 1's launches on fp32 rows (fused_mlp.cu).
int vitlens_fused_mlp_f32_rows(
    const float* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, void* y, void* h,
    void* out, int M, int D, int H, int act, float eps, void* stream);

// x, ctx [M, D] bf16; wo [D, D] bf16; bo [D] fp32; lnw, lnb [D] fp32;
// w1 [D, H] bf16; b1 [H] fp32; w2 [H, D] bf16; b2 [D] fp32; work:
// 2*M*D + 2*M*H + 4*M*D bytes of scratch; out [M, D] bf16.
// act: 0 = exact GELU, 2 = tanh GELU.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitlens_fused_attnout_mlp_fwd(
    const void* x, const void* ctx, const void* wo, const void* bo,
    const void* lnw, const void* lnb, const void* w1, const void* b1,
    const void* w2, const void* b2, void* work, void* out, int M, int D, int H,
    int act, float eps, void* stream) {
  auto* y = static_cast<__nv_bfloat16*>(work);
  auto* h = y + static_cast<size_t>(M) * D;
  auto* row32 = reinterpret_cast<float*>(h + static_cast<size_t>(M) * H);
  sm90::Params op{};
  op.bias = static_cast<const float*>(bo);
  op.resid = static_cast<const __nv_bfloat16*>(x);
  op.C32 = row32;
  op.M = M;
  op.N = D;
  op.K = D;
  cudaError_t err = sm90::launch_gemm<sm90::EPI_ROW_F32>(
      static_cast<const __nv_bfloat16*>(ctx),
      static_cast<const __nv_bfloat16*>(wo), op,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return vitlens_fused_mlp_f32_rows(row32, lnw, lnb, w1, b1, w2, b2, y, h, out,
                                    M, D, H, act, eps, stream);
}
