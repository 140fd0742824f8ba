// bf16 tensor-core GEMM of the fused LayerNorm + projection
// (fused_ln_proj.cu):
//
//     C[M, N] = LN(A)[M, K] @ B[K, N] + bias    (row-major bf16)
//
// 128x256x64 CTA tiles over 8 warps (64x64 each), a 3-stage cp.async
// pipeline, ldmatrix operand loads and mma.sync m16n8k16 with fp32
// accumulators in registers. The epilogue stages the fp32 tile in shared
// memory and finishes it with coalesced 16-byte loads and stores. The ragged
// M tail (and an N that is not a multiple of 256) is handled by zero-filled
// loads and masked stores. K must be a multiple of 64 and N of 8.
//
// The A tiles are LayerNorm-ed in shared memory as they land, before the
// mma: y = bf16(((a - mean[row]) * rstd[row]) * w[k] + b[k]) in fp32 with no
// fused multiply-add, so that y rounds as the plain PyTorch version's does.
// The per-row statistics come from a separate pass; the normalised rows
// never reach HBM. (The fused MLP's products moved to gemm_sm90.cuh.)
//
// Each translation unit that includes this header gets its own copy (an
// anonymous namespace), so the objects link together.

#pragma once

#include "ptx.cuh"

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

// Per-row statistics and per-column affine of the LayerNorm prologue.
struct LnPrologue {
  const float* mean;  // [M]
  const float* rstd;  // [M]
  const float* w;     // [K]
  const float* b;     // [K]
};

// Extra dynamic shared memory of the LayerNorm prologue: w and b [K], mean and
// rstd of the CTA's BM rows.
inline int ln_smem_bytes(int K) { return 4 * (2 * K + 2 * BM); }

__global__ void __launch_bounds__(THREADS, 1)
    gemm(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
         const float* __restrict__ bias, __nv_bfloat16* __restrict__ C,
         LnPrologue ln, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;
  // Past the pipeline and epilogue buffers, alive all along.
  float* ln_w = reinterpret_cast<float*>(smem_raw + SMEM_BYTES);
  float* ln_b = ln_w + K;
  float* row_mean = ln_b + K;
  float* row_rstd = row_mean + BM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = K / BK;
  constexpr int A_CHUNKS = BK / 8, B_CHUNKS = BN / 8;  // 16-byte chunks a row

  // Read by the first iteration, after its barrier.
  for (int i = tid; i < K; i += THREADS) {
    ln_w[i] = ln.w[i];
    ln_b[i] = ln.b[i];
  }
  for (int i = tid; i < BM; i += THREADS) {
    const bool ok = row0 + i < M;
    row_mean[i] = ok ? ln.mean[row0 + i] : 0.f;
    row_rstd[i] = ok ? ln.rstd[row0 + i] : 0.f;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
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

    __nv_bfloat16* as = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_STAGE;
    // Normalise this stage's A tile in place: the same chunk mapping as
    // load_stage, 8 values per 16-byte chunk.
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * A_CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / A_CHUNKS, kc = (c % A_CHUNKS) * 8;
      uint4* p = reinterpret_cast<uint4*>(as + r * A_LD + kc);
      uint4 u = *p;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
      const float mu = row_mean[r], rs = row_rstd[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(__bfloat162float(e[j]), mu);
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(d, rs), ln_w[k0 + kc + j]),
                                  ln_b[k0 + kc + j]);
        e[j] = __float2bfloat16(y);
      }
      *p = u;
    }
    __syncthreads();
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
  // so that stores of C are 16-byte and coalesced.
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
#pragma unroll 4
  for (int idx = tid; idx < BM * B_CHUNKS; idx += THREADS) {
    const int r = idx / B_CHUNKS, c = (idx % B_CHUNKS) * 8;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    const float4 p0 = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c]);
    const float4 p1 = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c + 4]);
    const float part[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const size_t off = static_cast<size_t>(gr) * N + gc;
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16(part[e] + bias[gc + e]);
    *reinterpret_cast<uint4*>(C + off) = o;
  }
}

inline cudaError_t launch_gemm(const __nv_bfloat16* A, const __nv_bfloat16* B,
                               const float* bias, __nv_bfloat16* C,
                               LnPrologue ln, int M, int N, int K,
                               cudaStream_t stream) {
  const int smem = SMEM_BYTES + ln_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm<<<grid, THREADS, smem, stream>>>(A, B, bias, C, ln, M, N, K);
  return cudaGetLastError();
}

}  // namespace
