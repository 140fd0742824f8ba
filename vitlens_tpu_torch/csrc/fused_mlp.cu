// Residual MLP half of a pre-LN transformer block, forward only:
//
//     out = x + b2 + act(LN(x) @ W1 + b1) @ W2
//
// Replaces vitlens_tpu/ops/fused_mlp.py::_pallas_fused_mlp (body `_kernel`,
// save_preact=False). Numerics follow that kernel: LayerNorm in fp32
// (eps given, 1e-5 in every tower) rounded to bf16; W1 product accumulated in
// fp32 with b1 added in fp32 and the activation (exact erff GELU or
// QuickGELU) applied in fp32 before the one rounding to bf16; the W2 product
// accumulated in fp32 and added to x and b2 in fp32, rounded once.
//
// What bounds it on an H100: at the audio encode's B64 x 3 clips shape
// (M = 49344 rows, D = 1024, H = 4096) it does 4*M*D*H ~ 0.83 TFLOP against
// ~0.2 GB of x/out/weight bytes, far above the card's ~295 FLOP/byte ridge, so
// it is tensor-core bound.
//
// Design (first, simple and correct): three launches on the caller's stream.
//   1. ln_rows: one warp per row, LN in fp32 -> y [M, D] bf16.
//   2. gemm<EPI_BIAS_ACT>: y @ W1 with the b1 + act epilogue -> h [M, H] bf16.
//   3. gemm<EPI_BIAS_RESIDUAL>: h @ W2 with the b2 + x epilogue -> out [M, D].
// The GEMM is a shared-memory tiled bf16 tensor-core kernel: 128x256x64 CTA
// tiles over 8 warps (64x64 each), a 3-stage cp.async pipeline, ldmatrix
// operand loads and mma.sync m16n8k16 with fp32 accumulators in registers;
// the epilogue stages the fp32 tile in shared memory and finishes it with
// coalesced 16-byte loads and stores. The ragged M tail (and an N that is
// not a multiple of 256) is handled by zero-filled loads and masked stores. This design writes h (~0.4 GB at
// B64) to HBM and reads it back; the one-kernel design that streams H chunks
// into an fp32 [tm, D] accumulator, with wgmma and TMA, is later work.
//
// Requirements checked by the Python wrapper: bf16 x/W1/W2, fp32 LN params and
// biases, everything contiguous, D and H multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;               // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64;                     // warp tile rows
constexpr int WN = 64;                     // warp tile cols
constexpr int MT = WM / 16;                // m16 tiles per warp
constexpr int NT = WN / 8;                 // n8 tiles per warp
constexpr int A_LD = BK + 8;               // padded smem rows (bf16): the 8
constexpr int B_LD = BN + 8;               // rows an ldmatrix reads hit 8 banks
constexpr int A_STAGE = BM * A_LD;         // elements per stage
constexpr int B_STAGE = BK * B_LD;
constexpr int C_LD = BN + 8;               // fp32 epilogue tile row
constexpr int SMEM_PIPE = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int SMEM_BYTES =
    SMEM_PIPE > BM * C_LD * 4 ? SMEM_PIPE : BM * C_LD * 4;

enum Epilogue { EPI_BIAS_ACT = 0, EPI_BIAS_RESIDUAL = 1 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  return v / (1.0f + __expf(-1.702f * v));
}

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
      float v = (__bfloat162float(e[i]) - mean) * rstd * w[c + i] + b[c + i];
      oe[i] = __float2bfloat16(v);
    }
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

// C[M, N] = A[M, K] @ B[K, N] (both row-major bf16) with a fused epilogue.
// K must be a multiple of BK and N a multiple of 8.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
         const float* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
         __nv_bfloat16* __restrict__ C, int M, int N, int K, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = K / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
    constexpr int A_CHUNKS = BK / 8, B_CHUNKS = BN / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < BM * A_CHUNKS / THREADS; ++i) {
      int c = tid + i * THREADS;
      int r = c / A_CHUNKS, kc = (c % A_CHUNKS) * 8;
      int gr = row0 + r;
      bool ok = gr < M;
      const __nv_bfloat16* src = A + static_cast<size_t>(ok ? gr : 0) * K + k0 + kc;
      cp_async16(as + r * A_LD + kc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * B_CHUNKS / THREADS; ++i) {
      int c = tid + i * THREADS;
      int r = c / B_CHUNKS, nc = (c % B_CHUNKS) * 8;
      int gc = col0 + nc;
      bool ok = gc < N;
      const __nv_bfloat16* src = B + static_cast<size_t>(k0 + r) * N + (ok ? gc : 0);
      cp_async16(bs + r * B_LD + nc, src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addressing. A (x4): lanes 0-15 give rows 0-15 at k 0,
  // lanes 16-31 rows 0-15 at k 8 -> a0..a3 in mma order. B (x4.trans):
  // lane%8 + 8*((lane/8)%2) is the k row, 8*(lane/16) the n offset ->
  // (b0, b1) of two adjacent n8 tiles.
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    int next = kt + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], as + (wm * WM + i * 16 + a_row) * A_LD + kk + a_col);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + b_row) * B_LD + wn * WN + j * 8 + b_col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: the fp32 accumulators go to a [BM, BN] tile in shared memory
  // (reusing the pipeline's buffers; c0,c1 are row g, cols 2t,2t+1 and
  // c2,c3 row g+8), then each warp finishes whole rows in 8-column chunks
  // so that loads of x and stores of C are 16-byte and coalesced.
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * WM + i * 16 + g + half * 8;
        const int c = wn * WN + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(&Cs[r * C_LD + c]) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
  __syncthreads();
  constexpr int CHUNKS = BN / 8;
#pragma unroll 4
  for (int idx = tid; idx < BM * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    const float4 p0 = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c]);
    const float4 p1 = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c + 4]);
    const float part[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const size_t off = static_cast<size_t>(gr) * N + gc;
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
    if (EPI == EPI_BIAS_ACT) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        oe[e] = __float2bfloat16(act_fn(part[e] + bias[gc + e], act));
    } else {  // x + b2 + part, as the TPU kernel sums it
      const uint4 xr = *reinterpret_cast<const uint4*>(resid + off);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        oe[e] = __float2bfloat16(__bfloat162float(xe[e]) + bias[gc + e] + part[e]);
    }
    *reinterpret_cast<uint4*>(C + off) = o;
  }
}

template <int EPI>
cudaError_t launch_gemm(const __nv_bfloat16* A, const __nv_bfloat16* B,
                        const float* bias, const __nv_bfloat16* resid,
                        __nv_bfloat16* C, int M, int N, int K, int act,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(A, B, bias, resid, C, M, N,
                                                   K, act);
  return cudaGetLastError();
}

}  // namespace

// x [M, D] bf16; lnw, lnb [D] fp32; w1 [D, H] bf16; b1 [H] fp32;
// w2 [H, D] bf16; b2 [D] fp32; scratch y [M, D] and h [M, H] bf16;
// out [M, D] bf16. act: 0 = exact GELU, 1 = QuickGELU.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int vitlens_fused_mlp_fwd(const void* x, const void* lnw,
                                     const void* lnb, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* y, void* h,
                                     void* out, int M, int D, int H, int act,
                                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = 8;
  ln_rows<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0,
            s>>>(static_cast<const __nv_bfloat16*>(x),
                 static_cast<const float*>(lnw), static_cast<const float*>(lnb),
                 static_cast<__nv_bfloat16*>(y), M, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<EPI_BIAS_ACT>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), nullptr, static_cast<__nv_bfloat16*>(h), M,
      H, D, act, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<EPI_BIAS_RESIDUAL>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), M, D, H, act, s);
  return static_cast<int>(err);
}
