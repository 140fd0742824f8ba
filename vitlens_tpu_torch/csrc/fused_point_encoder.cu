// Eval-mode PointBERT mini-PointNet, one pass per tile of groups, forward only:
//
//     h1 = relu(BN1(x @ W1 + b1))                      [M, C1]
//     h2 = h1 @ W2 + b2;  g = max over M of h2         [M, C2], [C2]
//     h3 = relu(BN2(h2 @ W3[C2:] + g @ W3[:C2] + b3))  [M, C3]
//     out = max over M of (h3 @ W4 + b4)               [C4]
//
// Replaces vitlens_tpu/ops/fused_point_encoder.py::_pallas_point_encoder
// (:116, body `_kernel`). Numerics follow that kernel and `xla_reference`
// cast for cast: each matmul accumulated in fp32 and rounded once to bf16,
// then the bias (rounded to bf16) added in bf16; eval BatchNorm as
// (x - mean) * inv + bias in fp32 with inv = rsqrt(var + eps) * scale folded
// by the wrapper, each operation rounded (no FMA contraction), then rounded to
// bf16; conv3 as (h2 @ W3[C2:] + g @ W3[:C2]) + b3 in fp32, rounded once. The
// max of conv4 is taken over the fp32 accumulators and rounded after: rounding
// and adding a bias are monotone, so that equals rounding every row first.
//
// What bounds it on an H100: at the pc encode's B64 (32768 groups of M = 32
// points, C1..C4 = 128, 256, 512, 256) it does
// 2*(32768*32)*(3*128 + 128*256 + 256*512 + 512*256) + 2*32768*256*512
// ~ 628 GFLOP against ~24 MB of input and output, ~0.64 ms at 989 TFLOP/s
// bf16: compute-bound. The weights (0.8 MB bf16) are re-read from L2 by every
// block, 0.8 MB per 64 rows.
//
// Design (first, simple and correct): one 256-thread block per 64 rows
// (64 / M whole groups, M in {16, 32, 64}); everything between the input
// points and the output features stays in shared memory:
//   1. x [64, 3] -> conv1 on CUDA cores (K = 3) -> +b1, BN1, ReLU -> h1.
//   2. conv2 = h1 @ W2 in 128-column chunks: a bf16 tensor-core GEMM
//      (8 warps of 32x32, ldmatrix + mma.sync m16n8k16, fp32 accumulators,
//      W2 streamed from L2 in 32-deep k-tiles by a 3-stage cp.async ring)
//      -> +b2 -> h2; then g = per-group column max of h2.
//   3. conv3 in 128-column chunks: the same GEMM over h2 @ W3[C2:], with the
//      W3[:C2] tile riding in the same ring stage for a 16-row g @ W3[:C2]
//      product (rows past the tile's groups are zero) -> +g-term, +b3,
//      BN2, ReLU -> h3.
//   4. conv4 in 128-column chunks over h3 @ W4; the fp32 tile is staged in
//      shared memory and reduced per group and column -> +b4 -> out.
// Shared memory at the pc shape: h2 34 KB, h3 67 KB (h1 lives in its first
// 17 KB until conv2 ends), the ring 52 KB (between conv4's chunks it holds
// the fp32 staging tile), g and its product 11 KB: 164 KB, one block per SM.
// With one block of 8 warps per SM nothing hides the scalar stages, the
// barriers and the ldmatrix traffic of mma.sync (PERF.md has the
// measurements); a 128-row tile (half the L2 weight traffic) does not fit
// next to h2 and h3. wgmma, persistent blocks that overlap one tile's
// epilogue with the next tile's loads, and TMA multicast of the weights
// across a cluster are later work.
//
// Requirements checked by the Python wrapper: bf16 nb [BG, M, 3] and W1..W4,
// fp32 biases and folded BN vectors, all contiguous, M in {16, 32, 64},
// C1..C4 multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;      // points per block
constexpr int THREADS = 256;  // 8 warps
constexpr int NC = 128;       // output columns per GEMM chunk
constexpr int BK = 32;        // k-tile depth
constexpr int STAGES = 3;
constexpr int WM = 32, WN = NC / 4;  // main warp tile: warps 2 (rows) x 4 (cols)
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;
constexpr int G_ROWS = 16;    // the g rows of a block, padded to one m16 tile
constexpr int G_NT = NC / 64; // n8 tiles of the g product per warp (8 warps)
constexpr int B_LD = NC + 8;  // padded rows: ldmatrix rows hit distinct banks
constexpr int B_TILE = BK * B_LD;
constexpr int C_LD = NC + 4;  // fp32 staging row
// conv4's fp32 staging tile reuses the ring between chunks
static_assert(STAGES * 2 * B_TILE * 2 >= ROWS * C_LD * 4, "staging > ring");

__host__ __device__ inline size_t round_up(size_t v) { return (v + 127) / 128 * 128; }

struct Layout {
  size_t h2, h13, ring, gs, gw, xs, total;
};

// Byte offsets of the shared-memory regions (host and device agree).
__host__ __device__ inline Layout layout(int C1, int C2, int C3) {
  Layout L;
  const size_t b1 = static_cast<size_t>(ROWS) * (C1 + 8) * 2;
  const size_t b3 = static_cast<size_t>(ROWS) * (C3 + 8) * 2;
  L.h2 = 0;
  L.h13 = round_up(static_cast<size_t>(ROWS) * (C2 + 8) * 2);
  L.ring = L.h13 + round_up(b1 > b3 ? b1 : b3);
  L.gs = L.ring + round_up(static_cast<size_t>(STAGES) * 2 * B_TILE * 2);
  L.gw = L.gs + round_up(static_cast<size_t>(G_ROWS) * (C2 + 8) * 2);
  L.xs = L.gw + round_up(static_cast<size_t>(ROWS / 16) * NC * 4);
  L.total = L.xs + round_up(static_cast<size_t>(ROWS) * 3 * 4);
  return L;
}

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

__device__ __forceinline__ float to_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16(bf16(v) + bf16(b)): a matmul output rounded once, then its bias added
// in bf16.
__device__ __forceinline__ float bias_bf(float v, float b) {
  return to_bf(to_bf(v) + to_bf(b));
}

// Eval BatchNorm of a bf16 value, each operation rounded, rounded to bf16.
__device__ __forceinline__ float bn_bf(float v, float mean, float inv,
                                       float bias) {
  return to_bf(__fadd_rn(__fmul_rn(__fsub_rn(v, mean), inv), bias));
}

// acc = A[ROWS, K] @ B[K, col0 : col0 + NC]. A is bf16 in shared memory with
// row stride lda; B is row-major bf16 [K, N] in global memory (columns past N
// read as zero). With WITH_G, gacc = Gs[16, K] @ Bg[K, col0 : col0 + NC] as
// well (Gs in shared memory, row stride ldg): each warp owns NC / 8 of its
// columns, and the Bg tile shares the ring stage with the B tile.
template <bool WITH_G>
__device__ __forceinline__ void gemm_chunk(
    const bf16* As, int lda, const bf16* __restrict__ B, int N, int K,
    int col0, bf16* ring, float (&acc)[MT][NT][4], const bf16* Gs, int ldg,
    const bf16* __restrict__ Bg, float (&gacc)[G_NT][4]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < G_NT; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  __syncthreads();  // every warp is done with the ring and the caller's tiles

  const int KT = K / BK;
  auto load_stage = [&](int stage, int kt) {
    bf16* bs = ring + stage * 2 * B_TILE;
    constexpr int CH = NC / 8;  // 16-byte chunks a tile row
#pragma unroll
    for (int i = 0; i < BK * CH / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / CH, nc = (c % CH) * 8;
      const int gc = col0 + nc;
      const bool ok = gc < N;
      const size_t off = static_cast<size_t>(kt * BK + r) * N + (ok ? gc : 0);
      cp_async16(bs + r * B_LD + nc, B + off, ok);
      if (WITH_G) cp_async16(bs + B_TILE + r * B_LD + nc, Bg + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addressing, as in fused_mlp.cu. A (x4): lanes 0-15 give
  // rows 0-15 at k 0, lanes 16-31 rows 0-15 at k 8. B (x4.trans):
  // lane%8 + 8*((lane/8)%2) is the k row, 8*(lane/16) the n offset.
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    cp_async_commit();

    const bf16* bs = ring + (kt % STAGES) * 2 * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int k = kt * BK + kk;
      uint32_t af[MT][4];
      uint32_t bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], As + (wm * WM + i * 16 + a_row) * lda + k + a_col);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + b_row) * B_LD + wn * WN + j * 8 + b_col);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      if (WITH_G) {
        uint32_t ga[4];
        ldmatrix_x4(ga, Gs + a_row * ldg + k + a_col);
#pragma unroll
        for (int j = 0; j < G_NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bs + B_TILE + (kk + b_row) * B_LD +
                                   warp * (NC / 8) + j * 8 + b_col);
          mma_bf16(gacc[j], ga, r[0], r[1]);
          mma_bf16(gacc[j + 1], ga, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(THREADS, 1)
    point_encoder_kernel(const bf16* __restrict__ nb,
                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ m1, const float* __restrict__ i1,
                         const float* __restrict__ s1,
                         const bf16* __restrict__ w2, const float* __restrict__ b2,
                         const bf16* __restrict__ w3h, const bf16* __restrict__ w3g,
                         const float* __restrict__ b3,
                         const float* __restrict__ m2, const float* __restrict__ i2,
                         const float* __restrict__ s2,
                         const bf16* __restrict__ w4, const float* __restrict__ b4,
                         bf16* __restrict__ out, int BG, int M, int C1, int C2,
                         int C3, int C4) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C1, C2, C3);
  bf16* H2 = reinterpret_cast<bf16*>(smem + L.h2);
  float* Cs = reinterpret_cast<float*>(smem + L.ring);  // conv4 staging
  bf16* H1 = reinterpret_cast<bf16*>(smem + L.h13);
  bf16* H3 = H1;                                      // h1 is dead after conv2
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L.gs);
  float* GW = reinterpret_cast<float*>(smem + L.gw);
  float* Xs = reinterpret_cast<float*>(smem + L.xs);
  const int ld1 = C1 + 8, ld2 = C2 + 8, ld3 = C3 + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gq = lane / 4, tq = lane % 4;  // mma accumulator row / column pair
  const int TG = ROWS / M;
  const int g0 = blockIdx.x * TG;
  const int ng = min(TG, BG - g0);  // groups of this block that exist

  float acc[MT][NT][4];
  float gacc[G_NT][4];

  // 1. the block's points (zeros past the last group), then conv1 + b1, BN1, ReLU
  const bf16* x = nb + static_cast<size_t>(g0) * M * 3;
  for (int e = tid; e < ROWS * 3; e += THREADS)
    Xs[e] = e < ng * M * 3 ? __bfloat162float(x[e]) : 0.f;
  __syncthreads();
  for (int e = tid; e < ROWS * C1; e += THREADS) {
    const int r = e / C1, c = e - r * C1;
    float v = Xs[r * 3] * __bfloat162float(w1[c]);
    v = fmaf(Xs[r * 3 + 1], __bfloat162float(w1[C1 + c]), v);
    v = fmaf(Xs[r * 3 + 2], __bfloat162float(w1[2 * C1 + c]), v);
    v = bn_bf(bias_bf(v, b1[c]), m1[c], i1[c], s1[c]);
    H1[r * ld1 + c] = __float2bfloat16(fmaxf(v, 0.f));
  }

  // 2. conv2 + b2 -> h2
  for (int col0 = 0; col0 < C2; col0 += NC) {
    gemm_chunk<false>(H1, ld1, w2, C2, C1, col0, ring, acc, nullptr, 0, nullptr, gacc);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = col0 + wn * WN + j * 8 + 2 * tq;
        if (c >= C2) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * WM + i * 16 + gq + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(&H2[r * ld2 + c]) = __floats2bfloat162_rn(
              bias_bf(acc[i][j][2 * h], b2[c]), bias_bf(acc[i][j][2 * h + 1], b2[c + 1]));
        }
      }
  }
  __syncthreads();

  // g = per-group column max of h2, as the 16-row bf16 A tile of conv3's g term
  for (int e = tid; e < G_ROWS * C2; e += THREADS) {
    const int t = e / C2, c = e - t * C2;
    float m = 0.f;
    if (t < TG) {
      m = __bfloat162float(H2[t * M * ld2 + c]);
      for (int r = t * M + 1; r < (t + 1) * M; ++r)
        m = fmaxf(m, __bfloat162float(H2[r * ld2 + c]));
    }
    Gs[t * ld2 + c] = __float2bfloat16(m);
  }

  // 3. conv3: (h2 @ W3[C2:] + g @ W3[:C2]) + b3 -> BN2, ReLU -> h3
  for (int col0 = 0; col0 < C3; col0 += NC) {
    gemm_chunk<true>(H2, ld2, w3h, C3, C2, col0, ring, acc, Gs, ld2, w3g, gacc);
    if (gq < TG) {  // accumulator row gq of the g product is group gq
#pragma unroll
      for (int j = 0; j < G_NT; ++j) {
        const int c = warp * (NC / 8) + j * 8 + 2 * tq;
        GW[gq * NC + c] = gacc[j][0];
        GW[gq * NC + c + 1] = gacc[j][1];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cl = wn * WN + j * 8 + 2 * tq, c = col0 + cl;
        if (c >= C3) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * WM + i * 16 + gq + 8 * h, t = r / M;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = __fadd_rn(__fadd_rn(acc[i][j][2 * h + e], GW[t * NC + cl + e]),
                                      b3[c + e]);
            v[e] = fmaxf(bn_bf(to_bf(s), m2[c + e], i2[c + e], s2[c + e]), 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(&H3[r * ld3 + c]) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
  }

  // 4. conv4, per-group max, + b4 -> out
  for (int col0 = 0; col0 < C4; col0 += NC) {
    gemm_chunk<false>(H3, ld3, w4, C4, C3, col0, ring, acc, nullptr, 0, nullptr, gacc);
    __syncthreads();  // every warp is done reading the ring
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * WM + i * 16 + gq + 8 * h;
          const int c = wn * WN + j * 8 + 2 * tq;
          *reinterpret_cast<float2*>(&Cs[r * C_LD + c]) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    __syncthreads();
    for (int e = tid; e < ng * NC; e += THREADS) {
      const int t = e / NC, cl = e - t * NC, c = col0 + cl;
      if (c >= C4) continue;
      float m = Cs[t * M * C_LD + cl];
      for (int r = t * M + 1; r < (t + 1) * M; ++r) m = fmaxf(m, Cs[r * C_LD + cl]);
      out[static_cast<size_t>(g0 + t) * C4 + c] = __float2bfloat16(bias_bf(m, b4[c]));
    }
  }
}

}  // namespace

// nb [BG, M, 3] bf16; w1 [3, C1], w2 [C1, C2], w3 [2*C2, C3], w4 [C3, C4]
// bf16; b1..b4 fp32; BN1 (m1, i1, s1) [C1] and BN2 (m2, i2, s2) [C3] fp32
// with i = rsqrt(var + eps) * scale; out [BG, C4] bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_point_encoder_fwd(
    const void* nb, const void* w1, const void* b1, const void* m1,
    const void* i1, const void* s1, const void* w2, const void* b2,
    const void* w3, const void* b3, const void* m2, const void* i2,
    const void* s2, const void* w4, const void* b4, void* out, int BG, int M,
    int C1, int C2, int C3, int C4, void* stream) {
  if (BG < 1 || (M != 16 && M != 32 && M != 64) || C1 % 64 || C2 % 64 ||
      C3 % 64 || C4 % 64 || C1 < 64 || C2 < 64 || C3 < 64 || C4 < 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(C1, C2, C3);
  if (L.total > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      point_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tg = ROWS / M;
  const bf16* w3g = static_cast<const bf16*>(w3);
  const bf16* w3h = w3g + static_cast<size_t>(C2) * C3;
  point_encoder_kernel<<<(BG + tg - 1) / tg, THREADS, L.total,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(nb), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(m1),
      static_cast<const float*>(i1), static_cast<const float*>(s1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), w3h, w3g,
      static_cast<const float*>(b3), static_cast<const float*>(m2),
      static_cast<const float*>(i2), static_cast<const float*>(s2),
      static_cast<const bf16*>(w4), static_cast<const float*>(b4),
      static_cast<bf16*>(out), BG, M, C1, C2, C3, C4);
  return static_cast<int>(cudaGetLastError());
}
