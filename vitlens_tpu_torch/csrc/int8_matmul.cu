// int8 x int8 -> int32 matrix product, exact:
//
//     C[M, N] = A[M, K] @ B[K, N]       A, B int8; C int32
//
// Replaces scripts/bench_int8_native.py::pallas_int8_matmul (body
// `_mm_kernel`), the product inside the W8A8 serving mode's
// quant.int8_matmul. As on the TPU, the kernel only multiplies: the per-row
// activation quantisation before it and the scale/bias dequantisation after
// it are plain tensor code in the caller.
//
// B is handed over TRANSPOSED, Bt [N, K] (K contiguous). The .col operand of
// mma.sync m16n8k32 wants 4 consecutive k in a register, and ldmatrix can
// transpose only 16-bit elements; with K contiguous in both operands a plain
// ldmatrix of int8 pairs delivers both fragments. A quantized module makes
// that copy once, when it is quantized or loaded.
//
// What bounds it on an H100: at the quantized audio encode's fc shape
// (M = 49344, K = 1024, N = 4096) it does 2*M*K*N = 0.41 TOP (0.21 ms at
// 1979 TOP/s) and writes 4*M*N = 808 MB of int32 (0.24 ms at 3.35 TB/s): the
// output bytes bound the fc and qkv shapes, the operations the proj shape
// (K = 4096, N = 1024).
//
// Design (first, simple and correct): 128x256 CTA tiles with a k-step of 128
// over 8 warps (64x64 each), a 3-stage cp.async pipeline, ldmatrix operand
// loads, mma.sync m16n8k32 with int32 accumulators in registers, and 8-byte
// stores straight from the fragments (a quad writes one full 32-byte
// sector). The ragged M tail and a K that is not a multiple of 128 are
// zero-filled on load; rows past M and columns past N are not stored. wgmma
// and TMA, and a fused quantise prologue / dequantise epilogue that would
// spare the int32 round trip, are later work.
//
// Requirements checked by the Python wrapper: int8 A [M, K] and Bt [N, K],
// contiguous, 16-byte aligned, K a multiple of 32 and N of 128.

#include "ptx.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 128;                    // int8 elements = bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;               // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64;
constexpr int WN = 64;
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;
constexpr int LD = BK + 16;                // padded row: 8 ldmatrix rows, 8 bank groups
constexpr int A_STAGE = BM * LD;
constexpr int B_STAGE = BN * LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);

__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
              int32_t* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;
  constexpr int CHUNKS = BK / 16;  // 16-byte chunks a row

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    int8_t* as = As + stage * A_STAGE;
    int8_t* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < BM * CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / CHUNKS, kc = (c % CHUNKS) * 16;
      const bool ok = row0 + r < M && k0 + kc < K;
      const int8_t* src =
          A + (ok ? static_cast<size_t>(row0 + r) * K + k0 + kc : 0);
      cp_async16(as + r * LD + kc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / CHUNKS, kc = (c % CHUNKS) * 16;
      const bool ok = col0 + r < N && k0 + kc < K;
      const int8_t* src =
          Bt + (ok ? static_cast<size_t>(col0 + r) * K + k0 + kc : 0);
      cp_async16(bs + r * LD + kc, src, ok);
    }
  };

  int32_t acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addressing, int8 pairs as 16-bit elements. A (x4): lanes
  // 0-15 give rows 0-15 at k bytes 0-15, lanes 16-31 the same rows at k
  // bytes 16-31 -> a0..a3 in mma order. Bt (x4, not transposed): lanes 0-7
  // rows n 0-7 at k bytes 0-15 (b0), lanes 8-15 the same rows at k bytes
  // 16-31 (b1), lanes 16-31 the next n8 tile.
  const int a_row = lane % 16, a_col = (lane / 16) * 16;
  const int b_row = (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 16;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    cp_async_commit();

    const int8_t* as = As + (kt % STAGES) * A_STAGE;
    const int8_t* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], as + (wm * WM + i * 16 + a_row) * LD + kk + a_col);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn * WN + j * 8 + b_row) * LD + kk + b_col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // c0,c1 are row g, cols 2t,2t+1 and c2,c3 row g+8.
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wm * WM + i * 16 + g + half * 8;
        const int c = col0 + wn * WN + j * 8 + 2 * t;
        if (r < M && c < N)
          *reinterpret_cast<int2*>(C + static_cast<size_t>(r) * N + c) =
              make_int2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

}  // namespace

// a [M, K] int8; bt [N, K] int8 (B transposed); c [M, N] int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_int8_matmul_fwd(const void* a, const void* bt, void* c,
                                       int M, int N, int K, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
      static_cast<int32_t*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
