// LayerNorm + linear projection, forward:
//
//     out = LN(x) @ W + b          x [M, D] -> out [M, N]
//
// Replaces vitlens_tpu/ops/fused_ln_proj.py::_pallas_ln_proj (body
// `_kernel`): the resblock front half, ln_1 + the packed qkv projection
// (N = 3D). Numerics follow that kernel: per-row mean, then the mean of the
// squared deviations (two passes, not E[x^2] - mean^2), in fp32;
// y = ((x - mean) * rsqrt(var + eps)) * w + b in fp32 with no FMA
// contraction, rounded to bf16; the product accumulated in fp32 and the bias
// added in fp32 before the one rounding of the output.
//
// What bounds it on an H100: at the audio encode's B64 x 3 clips shape
// (M = 49344, D = 1024, N = 3072) it does 2*M*D*N = 310 GFLOP (0.314 ms at
// 989 TFLOP/s) against ~0.41 GB of x/out/W bytes (0.122 ms at 3.35 TB/s):
// the operations bound it, and only wgmma reaches the tensor cores' rate.
//
// Design: two launches on the caller's stream.
//   1. ln_rows (layer_norm.cuh, the fused MLP's LN pass): one warp per row
//      -> y = LN(x) [M, D] bf16 (0.1 GB written and read back at M = 49344).
//   2. sm90::gemm_tma<EPI_BIAS> (gemm_sm90.cuh), the fused MLP's GEMM: a TMA
//      producer warpgroup feeds a 4-stage ring of 48 KB stages (A [128, 64]
//      of y, W [64, 256] read as stored through the MN-major descriptor),
//      two consumer warpgroups run wgmma m64n256k16, and the epilogue adds
//      b in fp32 and rounds once. Ragged M and N (bigG's N = 4992 = 19.5 x
//      256) as the GEMM handles them: zero-filled loads, masked stores.
// The design that keeps LN(x) out of HBM, consumers that normalise each A
// tile of x in shared memory inside the GEMM
// (tools/ln_proj_variants/fused_ln_proj_inplace.cu), reads the same numbers
// but is slower on an H100 (0.91 against 0.76 ms at M = 49344, N = 3072;
// tools/kernel_variants.py lnproj times both): each of the N / 256 column
// tiles of a row block normalises its A tiles again (12 times at N = 3072),
// and that scalar work (~0.2 ms) does not hide under the products, while y
// costs ~0.06 ms of HBM traffic.
//
// Requirements checked by the Python wrapper: bf16 x/W, fp32 LN params and
// bias, everything contiguous and 16-byte aligned, D and N multiples of
// 128, D <= 8192.

#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

namespace {

constexpr int LN_ROWS_PER_BLOCK = 8;

sm90::Params bias_params(const void* b, void* out, int M, int D, int N) {
  sm90::Params p{};
  p.bias = static_cast<const float*>(b);
  p.C = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.N = N;
  p.K = D;
  return p;
}

}  // namespace

// x [M, D] bf16; lnw, lnb [D] fp32; w [D, N] bf16; b [N] fp32; scratch
// y [M, D] bf16; out [M, N] bf16.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitlens_fused_ln_proj_fwd(const void* x, const void* lnw,
                                         const void* lnb, const void* w,
                                         const void* b, void* y, void* out,
                                         int M, int D, int N, float eps,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_rows<<<(M + LN_ROWS_PER_BLOCK - 1) / LN_ROWS_PER_BLOCK,
            32 * LN_ROWS_PER_BLOCK, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<__nv_bfloat16*>(y), M, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sm90::launch_gemm<sm90::EPI_BIAS>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(w),
      bias_params(b, out, M, D, N), s);
  return static_cast<int>(err);
}
