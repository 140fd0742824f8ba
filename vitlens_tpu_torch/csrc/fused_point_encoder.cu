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
// bf16: compute-bound. What held the first design back was not its
// mma.sync math (~0.4 ms of 6.2) but 64-row blocks that each streamed the
// 0.83 MB of weights from L2, and scalar stages between CTA-wide barriers.
// On an H100 (700 W) this design takes 2.24 ms at that shape, 1.40 ms of it
// with its products cut out: ~0.8 ms of wgmma in series with ~1.4 ms of
// scalar epilogues (bias, BN, ReLU, maxima) and barriers that the two
// consumers run in step; halving the weight bytes read from L2 changes
// nothing (tools/kernel_variants.py encoder).
//
// Design: persistent CTAs (one an SM) walk tiles of 128 rows holding
// 128 / M whole groups (M a multiple of 16 from 16 to 128; rows past the
// last whole group, and past the last group of the call, are zero points
// whose results no max reads). Three warpgroups:
//   * a producer (one thread, registers cut to 24) streams the weights in
//     the order the consumers use them, 16 KB tiles by TMA ([64 k][128 n] as
//     two 64-column boxes, or one [128 k][64 n] box of W3 for conv3;
//     128-byte swizzle) into a 5-stage mbarrier ring
//     (gemm_sm90.cuh's ring_produce), across tiles without a break, so one
//     tile's scalar stages overlap the next tile's loads;
//   * two consumers (registers raised to 240) own 64 rows each and run
//     every product on wgmma m64nNk16 (A K-major from shared memory, the
//     weight tile MN-major as stored), 128 rows a weight tile (6.8 GB of L2
//     reads a B64 call instead of 13.6):
//     1. conv1 (K = 3) on CUDA cores, + b1, BN1, ReLU -> h1, written in the
//        swizzled K-major layout that wgmma reads;
//     2. conv2 -> + b2 -> h2 (swizzled); g: each warp's 16 rows lie in one
//        group (M % 16 == 0), so a warp reduces its rows with shuffles, and
//        the groups' maxima are taken over those partials -> g [groups, C2]
//        as a padded 64-row A tile;
//     3. the g-product g @ W3[:C2] once a tile, on a padded m64 wgmma, the
//        512 columns split between the two consumers -> gterm [groups, C3]
//        fp32;
//     4. conv3 chained into conv4 by 64-column chunks of conv3's output:
//        the chunk's products over h2 (W3 in [128 k][64 n] boxes, wgmma
//        m64n64k16), then + gterm + b3, one rounding, BN2, ReLU -> an h3
//        chunk [rows, 64] (swizzled), at once the A operand of conv4's
//        partial product into conv4's fp32 accumulators (64 x NP a
//        consumer), so h3 [rows, C3] is never held whole. conv4's C4
//        columns are taken NP = 256 (or 128) at a time: a C4 past NP runs
//        steps 4 and 5 once a pass, conv3 again each time. (Issuing chunk
//        c + 1's conv3 products before chunk c's epilogue, with two sets of
//        conv3 accumulators, read 2.76 against 2.32 ms on an H100: at
//        C4 = 256 the accumulators in flight leave too few registers.)
//     5. conv4's per-warp column maxima as in 2, the groups' maxima, + b4
//        -> the pass's columns of out.
//   The consumers sync with each other only around the two group maxima
//   and the g-product; a consumer's own rows need only its own 128-thread
//   barrier (and fence.proxy.async between its writes and its wgmma).
// The epilogues add the bf16 biases as bf16 pairs (__hadd2) and take the
// bf16 maxima and ReLUs on pairs; the per-column vectors are staged in
// shared memory once a CTA. Shared memory: the ring 80 KB, h2 64 KB, h1 / g
// / the h3 chunk 32 KB (one region, each dead before the next is written),
// gterm 16 KB, the warps' maxima 8 KB, the vectors 10 KB: 211 KB, one CTA
// an SM.
//
// Requirements checked by the Python wrapper: bf16 nb [BG, M, 3] and W1..W4,
// fp32 biases and folded BN vectors, all contiguous and 16-byte aligned,
// M a multiple of 16 from 16 to 128, C1..C3 = 128, 256, 512 (the
// tokenizer's; compile-time here) and C4 a multiple of 128 (the tokenizer's
// encoder_dims).

#include <cuda_bf16.h>

#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sm90::named_sync;
using sm90::smem_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_m64n128k16;
using sm90::wgmma_m64n128k16_first;
using sm90::wgmma_wait;

constexpr int C1 = 128, C2 = 256, C3 = 512;
constexpr int ROWS = 128;              // rows (points) a tile
constexpr int MAX_M = 128;
constexpr int CONSUMERS = 2;           // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int NC3 = 64;                // conv3 columns a chained chunk
constexpr int NST = 5;                 // ring stages
constexpr int BOX_BYTES = 64 * 64 * 2;           // [64 k][64 n] bf16
constexpr int STAGE = 2 * BOX_BYTES;             // [64 k][128 n]
constexpr int H_ATOM = ROWS * 128;               // [128 rows][64 cols] bf16
constexpr int G_ATOM = 64 * 128;                 // [64 rows][64 cols] bf16
constexpr int MAX_GROUPS = ROWS / 16;
constexpr int WARPS = ROWS / 16;                 // consumer warps, 16 rows each
constexpr int OFF_H2 = NST * STAGE;
constexpr int OFF_R = OFF_H2 + (C2 / 64) * H_ATOM;
constexpr int R_BYTES = (C1 / 64) * H_ATOM;
constexpr int OFF_GT = OFF_R + R_BYTES;
constexpr int OFF_WMAX = OFF_GT + MAX_GROUPS * C3 * 4;
// The per-column vectors, staged once a CTA: BN1 (mean, inv, bias) and BN2
// with b3 in fp32; b1 and b2 rounded to bf16 (they are added in bf16).
constexpr int OFF_VEC = OFF_WMAX + WARPS * 256 * 4;
constexpr int VEC_BYTES = 4 * (3 * C1 + 4 * C3) + 2 * (C1 + C2);
constexpr int SMEM_BYTES = OFF_VEC + VEC_BYTES + 1024;  // + alignment
static_assert(R_BYTES >= (C2 / 64) * G_ATOM && R_BYTES >= (NC3 / 64) * H_ATOM,
              "h1, the g tile and the h3 chunk share one region");
static_assert(SMEM_BYTES <= 232448, "one CTA an SM");

__device__ __forceinline__ float to_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Eval BatchNorm of a bf16 value, each operation rounded, rounded to bf16.
__device__ __forceinline__ float bn_bf(float v, float mean, float inv,
                                       float bias) {
  return to_bf(__fadd_rn(__fmul_rn(__fsub_rn(v, mean), inv), bias));
}

// Byte offset of (row r, column c) of a K-major bf16 tile stored as atoms
// of [rows][64 columns], `atom` bytes each, under the 128-byte swizzle:
// 16-byte chunk j of row r sits at chunk j ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c, int atom) {
  return (c / 64) * atom + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) +
         (c % 8) * 2;
}

using bf162 = __nv_bfloat162;

// bf16(v) + b for a pair, the add in bf16 (a matmul output rounded once,
// then its bias added in bf16).
__device__ __forceinline__ bf162 bias_pair(float v0, float v1, bf162 b) {
  return __hadd2(__floats2bfloat162_rn(v0, v1), b);
}

// relu(bn_bf(v)) for a pair of fp32 values, packed.
__device__ __forceinline__ bf162 bn_relu_pair(float v0, float v1, float2 mean,
                                             float2 inv, float2 bias) {
  return __hmax2(__floats2bfloat162_rn(bn_bf(v0, mean.x, inv.x, bias.x),
                                       bn_bf(v1, mean.y, inv.y, bias.y)),
                 __float2bfloat162_rn(0.f));
}

// Max over the 16 rows of a warp's accumulator columns: (lo, hi) hold rows
// lane/4 and lane/4 + 8; lanes of one lane%4 end with the column's max.
__device__ __forceinline__ float warp_rows_max(float lo, float hi) {
  float m = fmaxf(lo, hi);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The same over a pair of bf16 columns.
__device__ __forceinline__ bf162 warp_rows_max2(bf162 lo, bf162 hi) {
  bf162 m = __hmax2(lo, hi);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    const unsigned u = __shfl_xor_sync(0xffffffffu, *reinterpret_cast<unsigned*>(&m), o);
    m = __hmax2(m, *reinterpret_cast<const bf162*>(&u));
  }
  return m;
}


// d[64 x 64] (+)= A[64 x 16] (K-major) * B[16 x 64] (MN-major): conv3's
// 64-column chunks. The _first form overwrites d (scale-d 0); its
// accumulators are outputs only.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_first(float* d, uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

struct Args {
  const bf16* nb;
  const bf16* w1;
  const float *b1, *m1, *i1, *s1, *b2, *b3, *m2, *i2, *s2, *b4;
  bf16* out;
  int BG, M, C4;
};

// NP: conv4's columns a pass (256, or 128 where C4 is an odd multiple).
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    point_encoder_kernel(const __grid_constant__ CUtensorMap map_w2,
                         const __grid_constant__ CUtensorMap map_w3,
                         const __grid_constant__ CUtensorMap map_w3k,
                         const __grid_constant__ CUtensorMap map_w4,
                         const Args a) {
  constexpr int NB3 = C3 / 128;  // n-blocks of the g-product
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int M = a.M, TG = ROWS / M, C4 = a.C4;
  const int tiles = (a.BG + TG - 1) / TG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // ---- producer: the weights, in consumption order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != 0) return;
    int it = 0;
    auto load = [&](const CUtensorMap* map, int krow, int ncol) {
      sm90::ring_produce<NST, STAGE>(full, empty, smem, it++, STAGE,
                                     [&](unsigned char* st, uint64_t* bar) {
                                       tma_load_2d(st, map, bar, ncol, krow);
                                       tma_load_2d(st + BOX_BYTES, map, bar,
                                                   ncol + 64, krow);
                                     });
    };
    auto load3 = [&](int krow, int ncol) {  // [128 k][64 n] of W3, one box
      sm90::ring_produce<NST, STAGE>(full, empty, smem, it++, STAGE,
                                     [&](unsigned char* st, uint64_t* bar) {
                                       tma_load_2d(st, &map_w3k, bar, ncol, krow);
                                     });
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kt = 0; kt < C1 / 64; ++kt)
        for (int nb = 0; nb < C2 / 128; ++nb) load(&map_w2, kt * 64, nb * 128);
      for (int kt = 0; kt < C2 / 64; ++kt)
        for (int q = 0; q < NB3; ++q)  // the two consumers' blocks in turn
          load(&map_w3, kt * 64, ((q % 2) * (NB3 / 2) + q / 2) * 128);
      // each pass, each chunk c: its conv3 (one [128 k][64 n] box a stage),
      // its conv4 over the pass's columns
      for (int p = 0; p < C4; p += NP)
        for (int c = 0; c < C3 / NC3; ++c) {
          for (int kh = 0; kh < C2 / 128; ++kh) load3(C2 + kh * 128, c * NC3);
          for (int nb = 0; nb < NP / 128; ++nb)
            load(&map_w4, c * NC3, p + nb * 128);
        }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int gw = wg * 4 + warp;  // the warp's 16 rows of the tile
  const int t2 = wg * 128 + tid;
  const uint32_t ring = smem_u32(smem);
  unsigned char* H2 = smem + OFF_H2;
  unsigned char* R = smem + OFF_R;
  const uint32_t h2_u = smem_u32(H2), r_u = smem_u32(R);
  float* GT = reinterpret_cast<float*>(smem + OFF_GT);
  float* WMAX = reinterpret_cast<float*>(smem + OFF_WMAX);
  float* M1 = reinterpret_cast<float*>(smem + OFF_VEC);
  float* I1 = M1 + C1;
  float* S1 = I1 + C1;
  float* B3 = S1 + C1;
  float* M2 = B3 + C3;
  float* I2 = M2 + C3;
  float* S2 = I2 + C3;
  bf16* B1 = reinterpret_cast<bf16*>(S2 + C3);
  bf16* B2 = B1 + C1;
  for (int c = t2; c < C3; c += 128 * CONSUMERS) {
    if (c < C1) {
      M1[c] = a.m1[c];
      I1[c] = a.i1[c];
      S1[c] = a.s1[c];
      B1[c] = __float2bfloat16(a.b1[c]);
    }
    if (c < C2) B2[c] = __float2bfloat16(a.b2[c]);
    B3[c] = a.b3[c];
    M2[c] = a.m2[c];
    I2[c] = a.i2[c];
    S2[c] = a.s2[c];
  }  // read after the first tile's barrier

  // The ring, consumer side: `it` counts this CTA's stage uses; a stage is
  // released once the wgmma group after it has been issued and waited to
  // one in flight (pend), or at once when this consumer skips it.
  int it = 0, pend = -1;
  auto consume = [&](auto&& mma) {
    const int s = it % NST;
    mbar_wait(&full[s], (it / NST) & 1);
    wgmma_fence();
    mma(ring + s * STAGE);
    wgmma_commit();
    wgmma_wait<1>();
    if (pend >= 0 && lane == 0) mbar_arrive(&empty[pend]);
    pend = s;
    ++it;
  };
  auto skip = [&]() {
    const int s = it % NST;
    mbar_wait(&full[s], (it / NST) & 1);
    if (lane == 0) mbar_arrive(&empty[s]);
    ++it;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    if (pend >= 0 && lane == 0) mbar_arrive(&empty[pend]);
    pend = -1;
  };
  // k-tile kt of a K-major A (atoms `atom` bytes apart, this consumer's rows
  // at `row_off`) against the stage's [64 k][128 n] weight tile, into d; a
  // product's first k-step overwrites d (accumulate is then a constant
  // false), so no accumulator stays alive from one product to the next.
  auto mma_tile = [&](float* d, uint32_t a_base, int atom, int row_off, int kt,
                      bool accumulate) {
    return [=](uint32_t stage) {
      const uint64_t da = smem_desc(a_base + kt * atom + row_off, 0, 1024);
      const uint64_t db = smem_desc(stage, BOX_BYTES, 1024);
      if (accumulate)
        wgmma_m64n128k16(d, da, db, 1);
      else
        wgmma_m64n128k16_first(d, da, db);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        wgmma_m64n128k16(d, da + ((kk * 32) >> 4), db + ((kk * 2048) >> 4), 1);
    };
  };

  // conv2's accumulators, then the g-product's, then conv4's (64 x NP a
  // consumer, across conv3's chunks).
  float d[128];
  float* d4 = d;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * TG;
    const int ng = min(TG, a.BG - g0);
    const int valid = ng * M;
    named_sync(1, 128 * CONSUMERS);  // the last tile's reads of WMAX are done

    // 1. conv1 + b1, BN1, ReLU -> h1 (this consumer's rows)
    for (int i = tid; i < 64 * (C1 / 8); i += 128) {
      const int r = wg * 64 + i / (C1 / 8), c = (i % (C1 / 8)) * 8;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f;
      if (r < valid) {
        const bf16* xp = a.nb + (static_cast<size_t>(g0) * M + r) * 3;
        x0 = __bfloat162float(xp[0]);
        x1 = __bfloat162float(xp[1]);
        x2 = __bfloat162float(xp[2]);
      }
      uint4 wv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wv[k] = __ldg(reinterpret_cast<const uint4*>(a.w1 + k * C1 + c));
      const bf16* w0 = reinterpret_cast<const bf16*>(&wv[0]);
      const bf16* w1 = reinterpret_cast<const bf16*>(&wv[1]);
      const bf16* w2 = reinterpret_cast<const bf16*>(&wv[2]);
      const uint4 bv = *reinterpret_cast<const uint4*>(B1 + c);
      const bf162* bp = reinterpret_cast<const bf162*>(&bv);
      uint4 o;
      bf162* op = reinterpret_cast<bf162*>(&o);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = x0 * __bfloat162float(w0[e + h]);
          v[h] = fmaf(x1, __bfloat162float(w1[e + h]), v[h]);
          v[h] = fmaf(x2, __bfloat162float(w2[e + h]), v[h]);
        }
        const float2 hb = __bfloat1622float2(bias_pair(v[0], v[1], bp[e / 2]));
        op[e / 2] = bn_relu_pair(hb.x, hb.y,
                                 *reinterpret_cast<const float2*>(M1 + c + e),
                                 *reinterpret_cast<const float2*>(I1 + c + e),
                                 *reinterpret_cast<const float2*>(S1 + c + e));
      }
      *reinterpret_cast<uint4*>(R + swz(r, c, H_ATOM)) = o;
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);

    // 2. conv2 + b2 -> h2; the warps' column maxima
#pragma unroll
    for (int kt = 0; kt < C1 / 64; ++kt)
#pragma unroll
      for (int nb = 0; nb < C2 / 128; ++nb)
        consume(mma_tile(d + 64 * nb, r_u, H_ATOM, wg * 8192, kt, kt > 0));
    drain();
#pragma unroll
    for (int nb = 0; nb < C2 / 128; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = nb * 128 + 8 * j + 2 * tq;
        const int r = wg * 64 + warp * 16 + gq;
        const bf162 b = *reinterpret_cast<const bf162*>(B2 + col);
        const float* acc = d + 64 * nb + 4 * j;
        const bf162 lo = bias_pair(acc[0], acc[1], b), hi = bias_pair(acc[2], acc[3], b);
        *reinterpret_cast<bf162*>(H2 + swz(r, col, H_ATOM)) = lo;
        *reinterpret_cast<bf162*>(H2 + swz(r + 8, col, H_ATOM)) = hi;
        const float2 m = __bfloat1622float2(warp_rows_max2(lo, hi));
        if (gq == 0) *reinterpret_cast<float2*>(WMAX + gw * 256 + col) = m;
      }
    fence_proxy_async();
    named_sync(1, 128 * CONSUMERS);

    // g = the groups' maxima -> rows 0..ng-1 of a [64, C2] A tile (the rows
    // past ng only feed gterm rows that are never read)
    const int wpg = M / 16;  // warps a group
    for (int i = t2; i < ng * (C2 / 8); i += 128 * CONSUMERS) {
      const int t = i / (C2 / 8), c = (i % (C2 / 8)) * 8;
      float m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = WMAX[t * wpg * 256 + c + e];
      for (int w = t * wpg + 1; w < (t + 1) * wpg; ++w)
#pragma unroll
        for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], WMAX[w * 256 + c + e]);
      uint4 o;
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16(m[e]);
      *reinterpret_cast<uint4*>(R + swz(t, c, G_ATOM)) = o;
    }
    fence_proxy_async();
    named_sync(1, 128 * CONSUMERS);

    // 3. gterm = g @ W3[:C2] -> GT [groups, C3] fp32
#pragma unroll
    for (int kt = 0; kt < C2 / 64; ++kt)
#pragma unroll
      for (int q = 0; q < NB3; ++q) {
        const int nb = (q % 2) * (NB3 / 2) + q / 2;
        if (nb / (NB3 / 2) == wg)
          consume(mma_tile(d + 64 * (nb % (NB3 / 2)), r_u, G_ATOM, 0, kt, kt > 0));
        else
          skip();
      }
    drain();
    if (warp == 0 && gq < ng)
#pragma unroll
      for (int h = 0; h < NB3 / 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = wg * (C3 / 2) + h * 128 + 8 * j + 2 * tq;
          GT[gq * C3 + col] = d[64 * h + 4 * j];
          GT[gq * C3 + col + 1] = d[64 * h + 4 * j + 1];
        }
    named_sync(1, 128 * CONSUMERS);  // GT complete; the g tile is read out

    // Steps 4 and 5 once a pass over conv4's columns [p, p + NP).
    for (int p = 0; p < C4; p += NP) {
      // 4. conv3 by chunks of NC3 = 64 columns, each chained into conv4
      float a3[NC3 / 2];
#pragma unroll
      for (int c = 0; c < C3 / NC3; ++c) {
#pragma unroll
        for (int kh = 0; kh < C2 / 128; ++kh)  // a [128 k][64 n] stage of W3[C2:]
          consume([=, &a3](uint32_t stage) {
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {  // k = 128 kh + 16 kk
              const uint64_t da = smem_desc(h2_u + (2 * kh + kk / 4) * H_ATOM +
                                            wg * 8192 + (kk % 4) * 32, 0, 1024);
              const uint64_t db = smem_desc(stage + kk * 2048, BOX_BYTES, 1024);
              if (kh == 0 && kk == 0)
                wgmma_m64n64k16_first(a3, da, db);
              else
                wgmma_m64n64k16(a3, da, db);
            }
          });
        drain();  // conv3(c) and conv4(c - 1) are done
#pragma unroll
        for (int j = 0; j < NC3 / 8; ++j) {
          const int cl = 8 * j + 2 * tq, col = c * NC3 + cl;
          const float2 b = *reinterpret_cast<const float2*>(B3 + col);
          const float2 mu = *reinterpret_cast<const float2*>(M2 + col);
          const float2 inv = *reinterpret_cast<const float2*>(I2 + col);
          const float2 sh = *reinterpret_cast<const float2*>(S2 + col);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wg * 64 + warp * 16 + gq + 8 * half;
            const float2 gt = *reinterpret_cast<const float2*>(
                GT + max(min(r / M, ng - 1), 0) * C3 + col);
            const float* acc = a3 + 4 * j + 2 * half;
            const float s0 = to_bf(__fadd_rn(__fadd_rn(acc[0], gt.x), b.x));
            const float s1 = to_bf(__fadd_rn(__fadd_rn(acc[1], gt.y), b.y));
            *reinterpret_cast<bf162*>(R + swz(r, cl, H_ATOM)) =
                bn_relu_pair(s0, s1, mu, inv, sh);
          }
        }
        fence_proxy_async();
        named_sync(2 + wg, 128);
#pragma unroll
        for (int nb = 0; nb < NP / 128; ++nb)  // a [64 k][128 n] stage of W4
          consume(mma_tile(d4 + 64 * nb, r_u, H_ATOM, wg * 8192, 0, c > 0));
      }
      drain();

      // 5. conv4's maxima over each group, + b4 -> out's columns [p, p + NP)
      if (p > 0) named_sync(1, 128 * CONSUMERS);  // the last pass's reads of WMAX
#pragma unroll
      for (int nb = 0; nb < NP / 128; ++nb)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = nb * 128 + 8 * j + 2 * tq;
          const float* acc = d4 + 64 * nb + 4 * j;
          const float m0 = warp_rows_max(acc[0], acc[2]);
          const float m1 = warp_rows_max(acc[1], acc[3]);
          if (gq == 0) {
            WMAX[gw * 256 + col] = m0;
            WMAX[gw * 256 + col + 1] = m1;
          }
        }
      named_sync(1, 128 * CONSUMERS);
      for (int i = t2; i < ng * (NP / 2); i += 128 * CONSUMERS) {
        const int t = i / (NP / 2), c = (i % (NP / 2)) * 2;
        float m0 = WMAX[t * wpg * 256 + c], m1 = WMAX[t * wpg * 256 + c + 1];
        for (int w = t * wpg + 1; w < (t + 1) * wpg; ++w) {
          m0 = fmaxf(m0, WMAX[w * 256 + c]);
          m1 = fmaxf(m1, WMAX[w * 256 + c + 1]);
        }
        const bf162 b = __floats2bfloat162_rn(a.b4[p + c], a.b4[p + c + 1]);
        *reinterpret_cast<bf162*>(a.out + static_cast<size_t>(g0 + t) * C4 + p +
                                  c) = bias_pair(m0, m1, b);
      }
    }
  }
}

// A [rows, cols] row-major bf16 weight as [k_box k][64 n] boxes.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols,
                int k_box = 64) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[2] = {1, static_cast<uint64_t>(cols)};
  const uint32_t box[2] = {64, static_cast<uint32_t>(k_box)};
  return encode_bf16_map(map, w, 2, dims, strides, box);
}

template <int NP>
cudaError_t launch(const Args& a, const void* w2, const void* w3, const void* w4,
                   cudaStream_t stream) {
  CUtensorMap map_w2, map_w3, map_w3k, map_w4;
  if (!weight_map(&map_w2, w2, C1, C2) || !weight_map(&map_w3, w3, 2 * C2, C3) ||
      !weight_map(&map_w3k, w3, 2 * C2, C3, 128) ||
      !weight_map(&map_w4, w4, C3, a.C4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(point_encoder_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int tg = ROWS / a.M, tiles = (a.BG + tg - 1) / tg;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  point_encoder_kernel<NP><<<grid, THREADS, SMEM_BYTES, stream>>>(
      map_w2, map_w3, map_w3k, map_w4, a);
  return cudaGetLastError();
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
    int c1, int c2, int c3, int c4, void* stream) {
  if (BG < 1 || M % 16 || M < 16 || M > MAX_M || c1 != C1 || c2 != C2 ||
      c3 != C3 || c4 < 128 || c4 % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(nb), static_cast<const bf16*>(w1),
               static_cast<const float*>(b1), static_cast<const float*>(m1),
               static_cast<const float*>(i1), static_cast<const float*>(s1),
               static_cast<const float*>(b2), static_cast<const float*>(b3),
               static_cast<const float*>(m2), static_cast<const float*>(i2),
               static_cast<const float*>(s2), static_cast<const float*>(b4),
               static_cast<bf16*>(out), BG, M, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(c4 % 256 ? launch<128>(a, w2, w3, w4, s)
                                   : launch<256>(a, w2, w3, w4, s));
}
