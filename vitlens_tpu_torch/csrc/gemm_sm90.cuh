// Hopper bf16 GEMM for the fused MLP (fused_mlp.cu), the fused LayerNorm
// + projection (fused_ln_proj.cu) and the chained-MLP prototypes
// (fused_mlp_chain.cu):
//
//     C[M, N] = epilogue(A[M, K] @ B[K, N])     (row-major bf16, fp32 sums)
//
// Its ring (the producer's and the consumers' step over a 4-stage mbarrier
// ring of 48 KB stages, `ring_produce` / `ring_consume`) is the shared core of
// the sm_90a GEMMs: int8_matmul.cu runs its s8 products on the same ring.
//
// What bounds it on an H100: the MLP's products (M = 49344, K/N = 1024/4096
// at the audio trunk) do ~200 FLOP per byte of their operands, far above the
// card's ridge of ~295 FLOP per byte of HBM for the whole call, so it is
// bound by the tensor cores. `wgmma` is the only instruction that reaches
// their full rate, and it wants its operands in shared memory in the
// layouts that TMA writes.
//
// Design: one CTA per 128 x 256 output tile, three warpgroups.
//   * A producer warpgroup (its registers cut to 40 with setmaxnreg): one
//     thread issues TMA loads (cp.async.bulk.tensor, 128-byte swizzle) of A
//     [128, 64] and B [64, 256] (four [64, 64] boxes) into a ring of 4 stages
//     of 48 KB, each guarded by a full and an empty mbarrier.
//   * Two consumer warpgroups (registers raised to 232) each own 64 rows and
//     issue wgmma.mma_async m64n256k16 (bf16 in, fp32 accumulators in 128
//     registers a thread) on every stage that has landed, keeping one
//     k-tile's group in flight, and release a stage (one arrival a warp)
//     when its products are done. A is K-major; B is the weight as stored, [K, N] with N
//     contiguous, read through wgmma's transposed-B (MN-major) descriptor,
//     so no transposed copy of a weight exists.
//   * Epilogue: the accumulators go to shared memory (reusing the ring,
//     which is idle once both consumers have waited out their products),
//     then each warp finishes whole rows in 8-column chunks: coalesced
//     16-byte loads of the residual and 16-byte stores of C (and C2), with
//     each epilogue's rounding points:
//       EPI_BIAS_ACT        C = bf16(act(acc + bias))            (fp32 act)
//       EPI_BIAS_ACT_PREACT as above, and C2 = bf16(acc + bias)
//       EPI_BIAS_RESIDUAL   C = bf16(resid + bias + acc), summed in that order
//       EPI_BIAS            C = bf16(acc + bias)
//       EPI_BIAS_RESIDUAL_F32  as EPI_BIAS_RESIDUAL with an fp32 resid32
//       EPI_ROW_F32         C32 = (resid + acc) + bias in fp32, no rounding
// Ragged edges: TMA zero-fills rows of A past M and columns of B past N; B
// boxes wholly past N are not loaded (their stale columns only reach masked
// outputs); stores past M or N are skipped. K must be a multiple of 64 and N
// of 8; bases and row strides 16-byte aligned (the wrapper checks).
//
// Each translation unit that includes this header gets its own copy (an
// anonymous namespace), so the objects link together.

#pragma once

#include <cuda_bf16.h>

#include "tma.cuh"

namespace {
namespace sm90 {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;             // 16 KB
constexpr int B_BOX = 64;                        // B columns per TMA box
constexpr int B_BOX_BYTES = BK * B_BOX * 2;      // 8 KB
constexpr int STAGE_BYTES = A_BYTES + (BN / B_BOX) * B_BOX_BYTES;  // 48 KB
constexpr int C_LD = BN + 8;                     // fp32 epilogue row (padded)
constexpr int C_WG_BYTES = 64 * C_LD * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
static_assert(CONSUMERS * C_WG_BYTES <= STAGES * STAGE_BYTES,
              "the epilogue tile reuses the ring");

enum Epilogue {
  EPI_BIAS_ACT = 0,         // C = act(acc + bias)
  EPI_BIAS_RESIDUAL = 1,    // C = resid + bias + acc
  EPI_BIAS_ACT_PREACT = 2,  // C = act(acc + bias), C2 = acc + bias
  EPI_BIAS = 3,             // C = acc + bias
  EPI_BIAS_RESIDUAL_F32 = 4,  // C = resid32 + bias + acc
  EPI_ROW_F32 = 5,          // C32 = resid + acc + bias (fp32 out)
};

struct Params {
  const float* bias;           // [N]
  const __nv_bfloat16* resid;  // [M, N] (EPI_BIAS_RESIDUAL, EPI_ROW_F32)
  __nv_bfloat16* C;            // [M, N]
  __nv_bfloat16* C2;           // [M, N] (EPI_BIAS_ACT_PREACT)
  int M, N, K, act;            // act: 0 exact GELU, 1 QuickGELU, 2 tanh GELU
  const float* resid32;        // [M, N] (EPI_BIAS_RESIDUAL_F32)
  float* C32;                  // [M, N] (EPI_ROW_F32)
};

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (act == 1) return v / (1.0f + __expf(-1.702f * v));
  return 0.5f * v *
         (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 at bit 62.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The ring shared by the sm_90a GEMMs, of NST stages of SB bytes. `it`
// counts k-tiles over the whole life of the CTA (across output tiles for a
// persistent one): k-tile `it` lives in stage it % NST, and full[s] /
// empty[s] complete once a use.
//
// Producer step (one thread): wait until the consumers released the
// stage's previous use, arm full[s] with the `bytes` TMA will bring, and
// issue them with load(stage pointer, &full[s]).
template <int NST = STAGES, int SB = STAGE_BYTES, class Load>
__device__ __forceinline__ void ring_produce(uint64_t* full, uint64_t* empty,
                                             unsigned char* smem, int it,
                                             uint32_t bytes, Load&& load) {
  const int s = it % NST;
  if (it >= NST) mbar_wait(&empty[s], ((it / NST) - 1) & 1);
  mbar_arrive_tx(&full[s], bytes);
  load(smem + s * SB, &full[s]);
}

// Consumer step (a whole warpgroup): wait for k-tile `it`, issue its wgmma
// group with mma(stage shared address), keep it in flight and wait out the
// group before it, whose stage a warp's lane 0 then releases (one arrival a
// warp) unless `it` is the output tile's first k-tile.
template <int NST = STAGES, int SB = STAGE_BYTES, class Mma>
__device__ __forceinline__ void ring_consume(uint64_t* full, uint64_t* empty,
                                             uint32_t ring, int it, bool release,
                                             Mma&& mma) {
  const int s = it % NST;
  mbar_wait(&full[s], (it / NST) & 1);
  wgmma_fence();
  mma(ring + s * SB);
  wgmma_commit();
  wgmma_wait<1>();  // the previous k-tile's products are done
  if (release && threadIdx.x % 32 == 0) mbar_arrive(&empty[(it - 1) % NST]);
}

// d[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major, transposed-B
// flag set). scale_d = 0 would overwrite d instead.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// As wgmma_m64n256k16, 128 columns wide (64 accumulators a thread).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// As wgmma_m64n128k16 with scale-d 0: d = A * B. Its accumulators are
// outputs only, so their old values are not kept alive up to the call.
__device__ __forceinline__ void wgmma_m64n128k16_first(float* d, uint64_t desc_a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_tma(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = p.K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      const int left = (p.N - col0 + B_BOX - 1) / B_BOX;
      const int boxes = left < BN / B_BOX ? left : BN / B_BOX;
      for (int kt = 0; kt < KT; ++kt)
        ring_produce(full, empty, smem, kt, A_BYTES + boxes * B_BOX_BYTES,
                     [&](unsigned char* a, uint64_t* bar) {
                       tma_load_2d(a, &map_a, bar, kt * BK, row0);
                       for (int j = 0; j < boxes; ++j)
                         tma_load_2d(a + A_BYTES + j * B_BOX_BYTES, &map_b, bar,
                                     col0 + j * B_BOX, kt * BK);
                     });
    }
  } else {  // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // No initialisation: the first product overwrites (scale-d 0), so no
    // other instruction defines the accumulators inside the wgmma pipeline.
    float d[128];
    const uint32_t ring = smem_u32(smem);
    for (int kt = 0; kt < KT; ++kt)
      ring_consume(full, empty, ring, kt, kt > 0, [&](uint32_t stage) {
        // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart; a k16 step
        // is 32 bytes along the swizzled row. B: [64 k][64 n] boxes 8 KB
        // apart along N (leading offset), 8-k groups 1024 bytes apart
        // (stride offset); a k16 step is 16 rows, 2048 bytes.
        const uint64_t da = smem_desc(stage + wg * 64 * 128, 0, 1024);
        const uint64_t db = smem_desc(stage + A_BYTES, B_BOX_BYTES, 1024);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16(d, da + ((kk * 32) >> 4), db + ((kk * 2048) >> 4),
                           kt > 0 || kk > 0);
      });
    wgmma_wait<0>();

    // Epilogue. Both consumers are past their last product, so the ring is
    // free: each warpgroup stages its [64, 256] fp32 tile (d[4j], d[4j+1]
    // are row g, cols 8j+2t, 8j+2t+1; d[4j+2], d[4j+3] row g+8), then
    // finishes whole rows in 16-byte chunks.
    named_sync(1, 128 * CONSUMERS);
    float* Cs = reinterpret_cast<float*>(smem + wg * C_WG_BYTES);
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + half * 8;
        *reinterpret_cast<float2*>(&Cs[r * C_LD + j * 8 + 2 * t]) =
            make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
      }
    named_sync(2 + wg, 128);
    constexpr int CHUNKS = BN / 8;
#pragma unroll 4
    for (int idx = tid; idx < 64 * CHUNKS; idx += 128) {
      const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
      const int gr = row0 + wg * 64 + r, gc = col0 + c;
      if (gr >= p.M || gc >= p.N) continue;
      const float4 p0 = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c]);
      const float4 p1 = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c + 4]);
      const float part[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const size_t off = static_cast<size_t>(gr) * p.N + gc;
      uint4 o;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
      if constexpr (EPI == EPI_ROW_F32) {  // (x + part) + bo, kept in fp32
        const uint4 xr = *reinterpret_cast<const uint4*>(p.resid + off);
        const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr);
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = __bfloat162float(xe[e]) + part[e] + p.bias[gc + e];
        *reinterpret_cast<float4*>(p.C32 + off) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<float4*>(p.C32 + off + 4) =
            make_float4(y[4], y[5], y[6], y[7]);
        continue;
      } else if constexpr (EPI == EPI_BIAS_RESIDUAL) {  // x + b2 + part, in order
        const uint4 xr = *reinterpret_cast<const uint4*>(p.resid + off);
        const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          oe[e] = __float2bfloat16(__bfloat162float(xe[e]) + p.bias[gc + e] +
                                   part[e]);
      } else if constexpr (EPI == EPI_BIAS_RESIDUAL_F32) {  // the same, fp32 rows
        const float4 r0 = *reinterpret_cast<const float4*>(p.resid32 + off);
        const float4 r1 = *reinterpret_cast<const float4*>(p.resid32 + off + 4);
        const float re[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          oe[e] = __float2bfloat16(re[e] + p.bias[gc + e] + part[e]);
      } else {
        uint4 o2;
        __nv_bfloat16* o2e = reinterpret_cast<__nv_bfloat16*>(&o2);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = part[e] + p.bias[gc + e];
          if constexpr (EPI == EPI_BIAS) {
            oe[e] = __float2bfloat16(a);
          } else {
            oe[e] = __float2bfloat16(act_fn(a, p.act));
            o2e[e] = __float2bfloat16(a);
          }
        }
        if constexpr (EPI == EPI_BIAS_ACT_PREACT)
          *reinterpret_cast<uint4*>(p.C2 + off) = o2;
      }
      *reinterpret_cast<uint4*>(p.C + off) = o;
    }
  }
}

// C = epilogue(A @ B) with A [M, K] and B [K, N] row-major bf16 on `stream`.
// Returns the launch's error (cudaErrorInvalidValue if a tensor map cannot
// be encoded).
template <int EPI>
cudaError_t launch_gemm(const __nv_bfloat16* A, const __nv_bfloat16* B,
                        const Params& p, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(p.K),
                              static_cast<uint64_t>(p.M)};
  const uint64_t a_strides[2] = {1, static_cast<uint64_t>(p.K)};
  const uint32_t a_box[2] = {BK, BM};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(p.N),
                              static_cast<uint64_t>(p.K)};
  const uint64_t b_strides[2] = {1, static_cast<uint64_t>(p.N)};
  const uint32_t b_box[2] = {B_BOX, BK};
  if (!encode_bf16_map(&map_a, A, 2, a_dims, a_strides, a_box) ||
      !encode_bf16_map(&map_b, B, 2, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tma<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_tma<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
