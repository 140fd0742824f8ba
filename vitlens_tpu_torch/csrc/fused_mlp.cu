// Residual MLP half of a pre-LN transformer block, forward:
//
//     out = x + b2 + act(LN(x) @ W1 + b1) @ W2
//
// Replaces vitlens_tpu/ops/fused_mlp.py::_pallas_fused_mlp (body `_kernel`),
// both variants: vitlens_fused_mlp_fwd is save_preact=False, and
// vitlens_fused_mlp_fwd_save_preact also writes the pre-activation
// a = bf16(LN(x) @ W1 + b1) [M, H] that the training backward recomputes h
// and act' from, rounded exactly where the TPU kernel rounds it
// (`a32.astype(bf16)`). Numerics follow that kernel: LayerNorm in fp32 (eps
// given, 1e-5 in every tower) rounded to bf16; W1 product accumulated in fp32
// with b1 added in fp32 and the activation (exact erff GELU or QuickGELU)
// applied in fp32 before the one rounding to bf16; the W2 product
// accumulated in fp32 and added to x and b2 in fp32, rounded once.
//
// What bounds it on an H100: at the audio encode's B64 x 3 clips shape
// (M = 49344 rows, D = 1024, H = 4096) it does 4*M*D*H ~ 0.83 TFLOP against
// ~0.2 GB of x/out/weight bytes (plus 0.4 GB of `a` in the save-preact
// variant), far above the card's ~295 FLOP/byte ridge, so it is bound by the
// tensor cores (0.84 ms at 989 TFLOP/s).
//
// Design: three launches on the caller's stream.
//   1. ln_rows: one warp per row, LN in fp32 -> y [M, D] bf16.
//   2. sm90::gemm_tma<EPI_BIAS_ACT> (or <EPI_BIAS_ACT_PREACT>): y @ W1 with
//      the b1 + act epilogue -> h [M, H] bf16 (and a [M, H] bf16, a second
//      coalesced 16-byte store of the same staged tile).
//   3. sm90::gemm_tma<EPI_BIAS_RESIDUAL>: h @ W2 with the b2 + x epilogue ->
//      out [M, D].
// Both products run on gemm_sm90.cuh's warp-specialised GEMM: TMA loads
// into a 4-stage mbarrier ring and wgmma.mma_async from two consumer
// warpgroups, reading W1 and W2 as stored ([K, N], through the MN-major
// descriptor). The TPU kernel keeps the weights in VMEM and never writes h;
// an SM cannot hold 16.8 MB of weights, so this design writes h (~0.4 GB at
// B64) to HBM and reads it back, about 0.25 ms of the call's bytes.
//
// The chained-MLP prototypes (fused_mlp_chain.cu, ops/fused_mlp_chain.py) run
// these same launches: the chunked MLP through vitlens_fused_mlp_fwd with the
// tanh GELU, the attention out-projection + MLP on its fp32 row through
// vitlens_fused_mlp_f32_rows.
//
// Requirements checked by the Python wrapper: bf16 x/W1/W2, fp32 LN params and
// biases, everything contiguous and 16-byte aligned (TMA's base and row
// strides), D and H multiples of 64.

#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

namespace {

// out = bf16(x + b2 + act(LN(x) @ W1 + b1) @ W2) for bf16 rows x (the
// residual epilogue EPI_BIAS_RESIDUAL) or fp32 rows (EPI_BIAS_RESIDUAL_F32).
template <class T>
int fused_mlp(const T* x, const void* lnw, const void* lnb, const void* w1,
              const void* b1, const void* w2, const void* b2, void* y, void* h,
              void* a, void* out, int M, int D, int H, int act, float eps,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = 8;
  ln_rows<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0,
            s>>>(x, static_cast<const float*>(lnw),
                 static_cast<const float*>(lnb),
                 static_cast<__nv_bfloat16*>(y), M, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  sm90::Params fc{static_cast<const float*>(b1), nullptr, hb,
                  static_cast<__nv_bfloat16*>(a), M, H, D, act};
  err = a != nullptr
            ? sm90::launch_gemm<sm90::EPI_BIAS_ACT_PREACT>(
                  yb, static_cast<const __nv_bfloat16*>(w1), fc, s)
            : sm90::launch_gemm<sm90::EPI_BIAS_ACT>(
                  yb, static_cast<const __nv_bfloat16*>(w1), fc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sm90::Params proj{static_cast<const float*>(b2), nullptr,
                    static_cast<__nv_bfloat16*>(out), nullptr, M, D, H, act};
  const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
  if constexpr (sizeof(T) == 4) {
    proj.resid32 = x;
    err = sm90::launch_gemm<sm90::EPI_BIAS_RESIDUAL_F32>(hb, w2b, proj, s);
  } else {
    proj.resid = x;
    err = sm90::launch_gemm<sm90::EPI_BIAS_RESIDUAL>(hb, w2b, proj, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// x [M, D] bf16; lnw, lnb [D] fp32; w1 [D, H] bf16; b1 [H] fp32;
// w2 [H, D] bf16; b2 [D] fp32; scratch y [M, D] and h [M, H] bf16;
// out [M, D] bf16. act: 0 = exact GELU, 1 = QuickGELU, 2 = tanh GELU (the
// chained-MLP prototype scripts/fused_mlp_pallas.py::fused_mlp, whose port is
// ops/fused_mlp_chain.py::fused_mlp_chunked).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitlens_fused_mlp_fwd(const void* x, const void* lnw,
                                     const void* lnb, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* y, void* h,
                                     void* out, int M, int D, int H, int act,
                                     float eps, void* stream) {
  return fused_mlp(static_cast<const __nv_bfloat16*>(x), lnw, lnb, w1, b1, w2,
                   b2, y, h, nullptr, out, M, D, H, act, eps, stream);
}

// As vitlens_fused_mlp_fwd, and also writes the pre-activation a [M, H] bf16.
extern "C" int vitlens_fused_mlp_fwd_save_preact(
    const void* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, void* y, void* h, void* a,
    void* out, int M, int D, int H, int act, float eps, void* stream) {
  return fused_mlp(static_cast<const __nv_bfloat16*>(x), lnw, lnb, w1, b1, w2,
                   b2, y, h, a, out, M, D, H, act, eps, stream);
}

// As vitlens_fused_mlp_fwd on fp32 rows x [M, D]: the attention
// out-projection's row of fused_mlp_chain.cu, which both the LayerNorm and
// the residual read unrounded. Called from that source, not bound.
int vitlens_fused_mlp_f32_rows(
    const float* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, void* y, void* h,
    void* out, int M, int D, int H, int act, float eps, void* stream) {
  return fused_mlp(x, lnw, lnb, w1, b1, w2, b2, y, h, nullptr, out, M, D, H,
                   act, eps, stream);
}
