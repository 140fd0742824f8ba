// Unmasked softmax attention, forward only:
//
//     o = softmax(q @ k^T * scale) @ v      q [B, H, NQ, D], k/v [B, H, NK, D]
//
// Replaces vitlens_tpu/ops/flash_attention.py::_fused_attention_fwd_impl (body
// `_fused_attn_kernel`). Scores, the softmax (running max, exponentials and
// row sums) and the P @ V accumulation are fp32, and the output is rounded
// once to bf16. The probabilities enter the P @ V tensor-core product as bf16
// (fp32 accumulate), the usual flash-attention choice; the row sums use the
// fp32 probabilities.
//
// What bounds it on an H100: at the encode's lengths (NK <= 600, head dim 64)
// a head does 4 * NQ * NK * D FLOP on (2 NQ + 2 NK) * 2 D bytes, ~64 FLOP a
// byte at NQ = NK = 257, well under the card's ridge: reading q, k, v and
// writing o bounds it, and after that the exponentials (one MUFU op per
// score) and the latency of each warpgroup's serial S -> max -> exp -> P V
// chain. So the design reads every byte once from HBM, keeps the scores on
// chip, and puts as many independent warpgroups on an SM as fit.
//
// Head dims: D is any multiple of 8 from 8 to 128. The kernel is built for a
// padded width HDP of 64 (D <= 64) or 128 columns, each 64 columns one
// 128-byte swizzled sub-tile of a tile. The tensor maps keep the true D as
// their innermost extent, so TMA zero-fills the columns past it: the zeros
// add nothing to S, P V computes zero columns there, and only the true D
// columns are stored. Shared memory per CTA (K/V slot, Q buffer) doubles at HDP = 128
// and its accumulators take twice the registers, so that variant runs two
// CTAs an SM (112 KB each) where HDP = 64 runs three (74 KB).
//
// Design:
//   * A CTA is one consumer warpgroup of 64 q rows a pass and one producer
//     warp; three CTAs share an SM (74 KB of shared memory each), or two
//     with deeper rings where one pass a CTA would not fill the card.
//     S = Q K^T runs on wgmma m64nNk16 with Q as the register A operand and
//     K read from shared memory (K-major, 128-byte swizzle); O += P V on
//     wgmma m64n{HDP}k16 with P, rounded to bf16, as the register A operand
//     and V through the transposed-B (MN-major) descriptor.
//   * K/V come by TMA (cp.async.bulk.tensor, 4-D maps over the caller's
//     strides), 64 keys a chunk, each chunk completing its own mbarrier.
//     Where all chunks fit the CTA's share of the SM and the CTA runs more
//     than one pass, they stay resident and every pass reads them there
//     (K/V cross HBM once a CTA). Otherwise the same kernel streams them
//     through a ring of slots guarded by full/empty mbarriers, one pass a
//     CTA; the CTAs of one head are neighbours in the grid and meet its
//     K/V in L2. On the encode's shapes every CTA runs one pass: on the
//     card, three streaming CTAs an SM beat two that keep a head's K/V
//     resident for all of its passes (0.32 against 0.43 ms at the trunk).
//   * Ragged tails at the instruction's granularity: q at m64 (rows past NQ
//     are zero-filled by TMA and never stored); keys at n8 for S (the last
//     chunk's product is m64nNk16 with N = 8 * ceil(keys / 8)) and at k16
//     for P V; keys past NK are -inf before the max and their V rows are
//     zero-filled, so P = 0 meets finite V. Every chunk holds a key, so
//     the running max is finite after the first chunk, and the rescale of
//     a row whose max was -inf is by 0, never exp(-inf + inf).
//   * q, k and v are read where they lie: a batch, a head and a row stride
//     each (the packed qkv projection's views need no copy). The output is
//     written [B, NQ, H, D], each warp's 16 rows staged through shared
//     memory into coalesced 16-byte stores, so that the caller's
//     [B, NQ, H * D] is a view.

#include <cuda_bf16.h>
#include <math.h>

#include "ptx.cuh"
#include "tma.cuh"

namespace {

constexpr int KC = 64;                 // keys per chunk
constexpr int SUB_BYTES = 64 * 128;    // a [64 rows][64 columns] sub-tile, 8 KB
constexpr int WARP_BYTES = 16 * 128;   // a warp's 16 rows of a sub-tile
// An SM's 228 KB less the 1 KB the system keeps per CTA and the static
// barriers, split three or two ways.
constexpr int SMEM_3 = 74 * 1024;
constexpr int SMEM_2 = 112 * 1024;

// Shared-memory geometry of the kernel built for HDP padded columns.
template <int HDP>
struct Geo {
  static constexpr int SUBS = HDP / 64;                 // sub-tiles a tile
  static constexpr int SLOT_BYTES = 2 * SUBS * SUB_BYTES;  // K and V of a chunk
  static constexpr int Q_BYTES = SUBS * SUB_BYTES;      // a pass's 64 q rows
  static constexpr int MIN_CTAS = HDP == 64 ? 3 : 2;    // CTAs an SM holds
  static constexpr int smem_bytes(int slots, int qbufs) {
    return slots * SLOT_BYTES + qbufs * Q_BYTES + 1024;  // + alignment slack
  }
};
// Barriers for the most slots any variant uses (HDP = 64 at 112 KB).
constexpr int SLOT_CAP = (SMEM_2 - Geo<64>::smem_bytes(0, 1)) / Geo<64>::SLOT_BYTES;

// Byte offset of 16-byte chunk `c` of row `r` in a tile of 128-byte rows
// under the 128-byte swizzle (what TMA writes for a 1024-aligned tile).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ void wgmma_s8(float* d, const uint32_t* a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s16(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s24(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s32(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s40(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s48(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s56(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s64(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv128(float* d, const uint32_t* a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// O += P V over one k16 step, N = HDP columns.
template <int HDP>
__device__ __forceinline__ void wg_pv(float* d, const uint32_t* a, uint64_t desc_b,
                                      int scale_d) {
  if constexpr (HDP == 64)
    wgmma_pv(d, a, desc_b, scale_d);
  else
    wgmma_pv128(d, a, desc_b, scale_d);
}


// S[64 x n] = Q K^T for n = 8 * ceil(valid / 8) keys of a chunk, HDP / 16
// k16 steps (the first overwrites); step kk is 32 bytes along the swizzled
// rows of sub-tile kk / 4.
template <int HDP>
__device__ __forceinline__ void wg_scores(float (&d)[32],
                                          const uint32_t (&qf)[HDP / 16][4],
                                          uint64_t desc, int valid) {
  const int n8 = (valid + 7) / 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint64_t db = desc + (((kk / 4) * SUB_BYTES + (kk % 4) * 32) >> 4);
    switch (n8) {
      case 1: wgmma_s8(d, qf[kk], db, kk > 0); break;
      case 2: wgmma_s16(d, qf[kk], db, kk > 0); break;
      case 3: wgmma_s24(d, qf[kk], db, kk > 0); break;
      case 4: wgmma_s32(d, qf[kk], db, kk > 0); break;
      case 5: wgmma_s40(d, qf[kk], db, kk > 0); break;
      case 6: wgmma_s48(d, qf[kk], db, kk > 0); break;
      case 7: wgmma_s56(d, qf[kk], db, kk > 0); break;
      default: wgmma_s64(d, qf[kk], db, kk > 0); break;
    }
  }
}

// One consumer warpgroup of 64 q rows a pass and one producer warp.
// scale_log2 = scale * log2(e) > 0, so the row max of the raw scores is the
// max of the scaled ones.
template <int HDP>
__global__ void __launch_bounds__(160, Geo<HDP>::MIN_CTAS)
    flash_fwd(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, int H, int NQ, int NK, int D,
                 int passes_per_cta, int slots, float scale_log2) {
  using G = Geo<HDP>;
  constexpr int QROWS = 64, QBUF = G::Q_BYTES, WARPS = 4, SLOT_BYTES = G::SLOT_BYTES;
  constexpr int SUBS = G::SUBS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[SLOT_CAP], empty[SLOT_CAP];
  __shared__ __align__(8) uint64_t qfull[2], qempty[2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qbuf = smem + slots * SLOT_BYTES;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (NK + KC - 1) / KC;
  const bool streaming = chunks > slots;
  const int p0 = blockIdx.x * passes_per_cta;
  const int npass = min(passes_per_cta, (NQ + QROWS - 1) / QROWS - p0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == WARPS) {  // ---- producer ----
    if (lane == 0) {
      auto load_q = [&](int i) {
        const int qs = i & 1;
        if (i >= 2) mbar_wait(&qempty[qs], ((i >> 1) - 1) & 1);
        mbar_arrive_tx(&qfull[qs], QBUF);
        for (int j = 0; j < SUBS; ++j)
          tma_load_4d(qbuf + qs * QBUF + j * SUB_BYTES, &map_q, &qfull[qs], j * 64,
                      (p0 + i) * QROWS, h, b);
      };
      load_q(0);
      if (npass > 1) load_q(1);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % slots;
        if (c >= slots) mbar_wait(&empty[s], ((c / slots) - 1) & 1);
        unsigned char* kd = smem + s * SLOT_BYTES;
        mbar_arrive_tx(&full[s], SLOT_BYTES);
        for (int j = 0; j < SUBS; ++j) {
          tma_load_4d(kd + j * SUB_BYTES, &map_k, &full[s], j * 64, c * KC, h, b);
          tma_load_4d(kd + SLOT_BYTES / 2 + j * SUB_BYTES, &map_v, &full[s], j * 64,
                      c * KC, h, b);
        }
      }
      for (int i = 2; i < npass; ++i) load_q(i);
    }
    return;
  }

  // ---- consumers: warp w of warpgroup wg holds rows 16 w + g and + 8 ----
  const uint32_t ring = smem_u32(smem);
  const int g = lane / 4, t = lane % 4;
  auto release = [&](int c) {
    if (streaming && lane == 0) mbar_arrive(&empty[c % slots]);
  };
  for (int i = 0; i < npass; ++i) {
    const int qs = i & 1;
    // The warp's 16 rows of sub-tile j of this pass's Q buffer (later its O).
    unsigned char* stage = qbuf + qs * QBUF + warp * WARP_BYTES;
    const int row0 = (p0 + i) * QROWS + warp * 16;
    mbar_wait(&qfull[qs], (i >> 1) & 1);
    uint32_t qf[HDP / 16][4];  // Q as the register A operand of S
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      ldmatrix_x4(qf[kk], stage + (kk / 4) * SUB_BYTES +
                              swz(lane % 16, (kk % 4) * 2 + lane / 16));

    // O [64 x HDP]: od[4j], od[4j+1] row g, od[4j+2], od[4j+3] row g+8
    float od[HDP / 2];
    float sc[32];  // S of the chunk, then P
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const uint32_t slot = ring + (c % slots) * SLOT_BYTES;
      const int valid = min(KC, NK - c * KC);
      mbar_wait(&full[c % slots], (c / slots) & 1);
      wgmma_fence();
      wg_scores<HDP>(sc, qf, smem_desc(slot, 0, 1024), valid);
      wgmma_commit();
      wgmma_wait<0>();  // S, and the previous chunk's P V
      if (c > 0) release(c - 1);

      if (valid < KC) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * 8 + 2 * t + (e & 1) >= valid) sc[4 * j + e] = -INFINITY;
      }
      float tm0 = fmaxf(sc[0], sc[1]), tm1 = fmaxf(sc[2], sc[3]);
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        tm0 = fmaxf(tm0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        tm1 = fmaxf(tm1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
        tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
      }
      // The chunk holds a key, so the new max is finite, and a row whose
      // max was -inf is rescaled by 0, never by exp(-inf - -inf).
      const float nm0 = fmaxf(m0, tm0), nm1 = fmaxf(m1, tm1);
      const float a0 = m0 == -INFINITY ? 0.f : ex2((m0 - nm0) * scale_log2);
      const float a1 = m1 == -INFINITY ? 0.f : ex2((m1 - nm1) * scale_log2);
      m0 = nm0;
      m1 = nm1;
      const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -ms0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -ms0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -ms1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -ms1));
        r0 += sc[4 * j] + sc[4 * j + 1];
        r1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + r0;
      l1 = l1 * a1 + r1;
      if (c > 0) {
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          od[4 * j] *= a0;
          od[4 * j + 1] *= a0;
          od[4 * j + 2] *= a1;
          od[4 * j + 3] *= a1;
        }
      }
      // O += P V: P's accumulator layout is the register A operand (two n8
      // tiles make one k16 step); V through the transposed-B descriptor.
      uint32_t pa[KC / 16][4];
#pragma unroll
      for (int kt = 0; kt < KC / 16; ++kt) {
        pa[kt][0] = pack_bf16(sc[8 * kt], sc[8 * kt + 1]);
        pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
        pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
        pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
      }
      // V's 64-column sub-tiles are 8 KB apart (the leading offset).
      const uint64_t dv = smem_desc(slot + SLOT_BYTES / 2, SUB_BYTES, 1024);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < KC / 16; ++kt)
        if (kt * 16 < valid)
          wg_pv<HDP>(od, pa[kt], dv + ((kt * 2048) >> 4), c > 0 || kt > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    release(chunks - 1);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      unsigned char* sub = stage + (j / 8) * SUB_BYTES;
      *reinterpret_cast<uint32_t*>(sub + swz(g, j % 8) + 4 * t) =
          pack_bf16(od[4 * j] * inv0, od[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(sub + swz(g + 8, j % 8) + 4 * t) =
          pack_bf16(od[4 * j + 2] * inv1, od[4 * j + 3] * inv1);
    }
    __syncwarp();
    // The true D columns of each row: dch 16-byte chunks (a constant when D
    // is the padded width).
    auto store = [&](const int dch) {
#pragma unroll
      for (int idx = lane; idx < 16 * dch; idx += 32) {
        const int r = idx / dch, cc = idx - r * dch;
        if (row0 + r < NQ)
          *reinterpret_cast<uint4*>(
              o + ((static_cast<size_t>(b) * NQ + row0 + r) * H + h) * D + cc * 8) =
              *reinterpret_cast<const uint4*>(stage + (cc / 8) * SUB_BYTES +
                                              swz(r, cc % 8));
      }
    };
    if (D == HDP)
      store(HDP / 8);
    else
      store(D / 8);
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_arrive(&qempty[qs]);
  }
}

template <int HDP>
int launch(const CUtensorMap& map_q, const CUtensorMap& map_k,
           const CUtensorMap& map_v, void* o, int B, int H, int NQ, int NK,
           int D, float scale, cudaStream_t stream) {
  using G = Geo<HDP>;
  const int BH = B * H, sms = sm_count();
  const int chunks = (NK + KC - 1) / KC, passes = (NQ + 63) / 64;
  // Three CTAs an SM (two at HDP = 128: its registers and slots double), or
  // two with deeper rings where one pass a CTA would not fill the card.
  const bool small = static_cast<long long>(BH) * passes <= 2LL * sms;
  const int per_sm = small ? 2 : G::MIN_CTAS;
  const int budget = per_sm == 2 ? SMEM_2 : SMEM_3;
  // Resident K/V: all chunks fit beside two q buffers; a CTA then takes as
  // many of its head's passes as still leave per_sm CTAs for every SM.
  // Otherwise one pass a CTA, through a ring of the slots that fit beside
  // one q buffer.
  int per_cta = 1;
  if (chunks <= (budget - G::smem_bytes(0, 2)) / G::SLOT_BYTES) {
    const int want = (per_sm * sms + BH - 1) / BH;  // CTAs a head
    const int split = want < passes ? want : passes;
    per_cta = (passes + split - 1) / split;
  }
  const int ring = (budget - G::smem_bytes(0, 1)) / G::SLOT_BYTES;
  const int slots = per_cta > 1 || chunks < ring ? chunks : ring;
  const int smem = G::smem_bytes(slots, per_cta > 1 ? 2 : 1);
  static int smem_set[64] = {};  // the largest size granted, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  dim3 grid((passes + per_cta - 1) / per_cta, BH);
  flash_fwd<HDP><<<grid, 160, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), H, NQ, NK, D,
      per_cta, slots, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, NQ, D], k/v [B, H, NK, D] bf16 with element strides (batch, head,
// row) given for each, the last dim contiguous, every stride a multiple of 8
// elements and the bases 16-byte aligned; D a multiple of 8 from 8 to 128;
// o [B, NQ, H, D] contiguous; scale > 0. Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue if a tensor map cannot be
// encoded or D is not taken.
extern "C" int vitlens_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int NQ,
    int NK, int D, long long qsb, long long qsh, long long qsn, long long ksb,
    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
    float scale, void* stream) {
  if (D < 8 || D > 128 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v;
  // The true head dim is the innermost extent: TMA zero-fills the padded
  // columns of each 64-column box.
  const uint64_t q_dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(NQ),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t kv_dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(NK),
                               static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t q_strides[4] = {1, static_cast<uint64_t>(qsn),
                                 static_cast<uint64_t>(qsh),
                                 static_cast<uint64_t>(qsb)};
  const uint64_t k_strides[4] = {1, static_cast<uint64_t>(ksn),
                                 static_cast<uint64_t>(ksh),
                                 static_cast<uint64_t>(ksb)};
  const uint64_t v_strides[4] = {1, static_cast<uint64_t>(vsn),
                                 static_cast<uint64_t>(vsh),
                                 static_cast<uint64_t>(vsb)};
  const uint32_t q_box[4] = {64, 64, 1, 1};
  const uint32_t kv_box[4] = {64, KC, 1, 1};
  if (!encode_bf16_map(&map_q, q, 4, q_dims, q_strides, q_box) ||
      !encode_bf16_map(&map_k, k, 4, kv_dims, k_strides, kv_box) ||
      !encode_bf16_map(&map_v, v, 4, kv_dims, v_strides, kv_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(map_q, map_k, map_v, o, B, H, NQ, NK, D, scale, s)
                 : launch<128>(map_q, map_k, map_v, o, B, H, NQ, NK, D, scale, s);
}
