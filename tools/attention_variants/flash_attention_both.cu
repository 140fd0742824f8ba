// Both attention designs built and measured on the card, kept to reproduce
// their numbers (PERF.md, Findings) against the committed
// csrc/flash_attention.cu:
//
//   python3 tools/kernel_variants.py attn '{"mma_sync": {"@source":
//     "tools/attention_variants/flash_attention_both.cu",
//     "constexpr bool USE_WGMMA = true;": "constexpr bool USE_WGMMA = false;"}}'
//
// USE_WGMMA = false selects the mma.sync design: 8 or 9 consumer warps of 16
// q rows each, 32-key chunks, every operand by ldmatrix from swizzled shared
// memory, two CTAs an SM (CTA_SMEM). USE_WGMMA = true selects the wgmma
// design (WG_NWG warpgroups of 64 q rows a CTA) that the committed source
// grew from; with MIN_CTAS = 3 and CTA_SMEM = 74 KB it is the committed
// kernel's configuration. It builds against the headers in
// vitlens_tpu_torch/csrc/.

// Unmasked softmax attention, forward only:
//
//     o = softmax(q @ k^T * scale) @ v      q [B, H, NQ, 64], k/v [B, H, NK, 64]
//
// Replaces vitlens_tpu/ops/flash_attention.py::_fused_attention_fwd_impl (body
// `_fused_attn_kernel`). Scores, the softmax (running max, exponentials and
// row sums) and the P @ V accumulation are fp32, and the output is rounded
// once to bf16. The probabilities enter the P @ V tensor-core product as bf16
// (fp32 accumulate), the usual flash-attention choice; the row sums use the
// fp32 probabilities.
//
// What bounds it on an H100: at the encode's lengths (NK <= 600, head dim 64)
// a head does 4 * NQ * NK * 64 FLOP on (2 NQ + 2 NK) * 128 bytes, ~64 FLOP a
// byte at NQ = NK = 257, well under the card's ridge: reading q, k, v and
// writing o bounds it, and after that the exponentials (one MUFU op per
// score). So the design reads every byte once and keeps the scores on chip.
//
// Design:
//   * K/V resident. A CTA owns one (batch, head) and a range of its q
//     passes, and loads that head's K and V into shared memory once, in
//     32-key chunks, by TMA (cp.async.bulk.tensor, 4-D maps over the
//     caller's strides, 128-byte swizzle), each chunk completing its own
//     mbarrier, so the first pass starts on the first chunk. When the
//     chunks fit half an SM (NK <= 320 with 8 consumer warps: two CTAs an
//     SM, one's loads under the other's products), every q pass of the CTA
//     reads them there: K/V cross HBM once per head (once per CTA where a
//     small batch is split over more CTAs to fill the card). Past that, the
//     same kernel streams the chunks through a ring of slots guarded by
//     full/empty mbarriers, one q pass a CTA, with the online softmax it
//     uses anyway; the passes of one head share the chunks through L2.
//   * One producer warp (one thread) issues the TMA loads: K/V chunks and,
//     double-buffered, each pass's q rows. 8 or 9 consumer warps (whichever
//     idles fewer warps over NQ: 257 rows take 9 warps in two passes) each
//     own 16 q rows a pass.
//     S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate) with every operand fetched by ldmatrix from swizzled
//     shared memory (.trans for V); P stays in registers as the A operand of
//     the second product.
//   * The softmax spends few instructions a score, which is what bounds the
//     kernel after the bytes: the row max is taken on the raw scores (scale
//     > 0), 2^(s * scale * log2 e - m * scale * log2 e) is one FMA and one
//     ex2, and O is rescaled only when a row max of the warp moved.
//   * Ragged tails at the instruction's granularity: a warp whose 16 rows lie
//     past NQ skips its work; in the last chunk only the 16-key steps that
//     hold a key run (TMA zero-fills rows past NK, so P = 0 meets finite V),
//     and keys past NK are -inf before the max. Every chunk holds at least
//     one key, so the running max is finite after the first chunk, and the
//     rescale of a row whose max is still -inf is by 0, never exp(-inf + inf).
//   * q, k and v are read where they lie: a batch, a head and a row stride
//     each (the packed qkv projection's views need no copy). The output is
//     written [B, NQ, H, 64], each warp's 16 x 128-byte rows staged through
//     shared memory into coalesced 16-byte stores, so that the caller's
//     [B, NQ, H * 64] is a view.

#include <cuda_bf16.h>
#include <math.h>

#include "ptx.cuh"
#include "tma.cuh"

namespace {

constexpr int HD = 64;                    // head dim: 128-byte rows
constexpr int KC = 32;                    // keys per chunk
constexpr int MIN_CTAS = 2;               // CTAs an SM holds
constexpr int CHUNK_BYTES = KC * HD * 2;  // 4 KB of K (and of V)
constexpr int SLOT_BYTES = 2 * CHUNK_BYTES;
constexpr int WARP_BYTES = 16 * HD * 2;   // a warp's 16 q rows (and its O)
// Half of an SM's 228 KB less the 1 KB the system keeps per CTA and the
// static barriers holds two Q buffers, the alignment slack and the K/V slots.
constexpr int CTA_SMEM = 112 * 1024;

__host__ __device__ constexpr int max_slots(int cw) {
  return (CTA_SMEM - 2 * cw * WARP_BYTES - 1024) / SLOT_BYTES;
}
__host__ __device__ constexpr int smem_bytes(int cw, int slots) {
  return slots * SLOT_BYTES + 2 * cw * WARP_BYTES + 1024;  // + alignment slack
}
constexpr int SLOT_CAP = max_slots(8);    // the barrier arrays' size
constexpr bool USE_WGMMA = true;

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

// ldmatrix from a shared-memory address (plain and transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// CW consumer warps of 16 q rows each (a pass is 16 * CW rows) and one
// producer warp. scale_log2 = scale * log2(e) > 0, so the row max of the raw
// scores is the max of the scaled ones.
template <int CW>
__global__ void __launch_bounds__(32 * (CW + 1), MIN_CTAS)
    flash_fwd(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              __nv_bfloat16* __restrict__ o, int H, int NQ, int NK,
              int passes_per_cta, int slots, float scale_log2) {
  constexpr int QROWS = 16 * CW;
  constexpr int QBUF_BYTES = CW * WARP_BYTES;
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
      mbar_init(&empty[s], CW);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], CW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CW) {  // ---- producer: one thread issues every TMA load ----
    if (lane == 0) {
      // The q rows of pass i go to buffer i % 2 once its previous pass is
      // done; the first two passes' and all K/V chunks are issued at once
      // (or as the ring frees its slots).
      auto load_q = [&](int i) {
        const int qs = i & 1;
        if (i >= 2) mbar_wait(&qempty[qs], ((i >> 1) - 1) & 1);
        mbar_arrive_tx(&qfull[qs], QBUF_BYTES);
        tma_load_4d(qbuf + qs * QBUF_BYTES, &map_q, &qfull[qs], 0,
                    (p0 + i) * QROWS, h, b);
      };
      load_q(0);
      if (npass > 1) load_q(1);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % slots;
        if (c >= slots) mbar_wait(&empty[s], ((c / slots) - 1) & 1);
        unsigned char* kd = smem + s * SLOT_BYTES;
        mbar_arrive_tx(&full[s], SLOT_BYTES);
        tma_load_4d(kd, &map_k, &full[s], 0, c * KC, h, b);
        tma_load_4d(kd + CHUNK_BYTES, &map_v, &full[s], 0, c * KC, h, b);
      }
      for (int i = 2; i < npass; ++i) load_q(i);
    }
    return;
  }

  // ---- consumers ----
  const uint32_t ring = smem_u32(smem);
  const int g = lane / 4, t = lane % 4;
  // This lane's ldmatrix row offsets in a chunk. K (x4): matrices (keys
  // 0-7, k lo), (0-7, k hi), (8-15, lo), (8-15, hi) of a 16-key step; V
  // (x4.trans): (keys 0-7, d lo), (8-15, d lo), (0-7, d hi), (8-15, d hi).
  // Every row a lane names is lane % 8 mod 8, so the swizzle is per lane.
  uint32_t koff[HD / 16], voff[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    koff[j] = swz((lane / 16) * 8 + lane % 8, j * 2 + (lane / 8) % 2);
    voff[j] = CHUNK_BYTES + swz(((lane / 8) % 2) * 8 + lane % 8, j * 2 + lane / 16);
  }

  for (int i = 0; i < npass; ++i) {
    const int qs = i & 1;
    unsigned char* stage = qbuf + qs * QBUF_BYTES + warp * WARP_BYTES;
    const int row0 = (p0 + i) * QROWS + warp * 16;
    const bool active = row0 < NQ;
    mbar_wait(&qfull[qs], (i >> 1) & 1);
    // Q A-fragments: lanes 0-15 give rows 0-15 at k 0, lanes 16-31 at k 8.
    uint32_t qf[HD / 16][4];
    if (active) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], stage + swz(lane % 16, kk * 2 + lane / 16));
    }

    float oacc[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
    // Running max of the raw scores and this thread's share of the row
    // sums, rows g and g + 8.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // S = Q K^T of chunk c into sc, 16 keys (two n8 tiles) per
    // ldmatrix.x4 and k16 step, over the 16-key steps that hold a key.
    auto scores = [&](float (&sc)[KC / 8][4], int c) {
      mbar_wait(&full[c % slots], (c / slots) & 1);
      if (!active) return;
      const uint32_t base = ring + (c % slots) * SLOT_BYTES;
      const int valid = min(KC, NK - c * KC);
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        if (np * 16 < valid) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t r[4];
            ldsm_x4(r, base + koff[kk] + np * 16 * 128);
            mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);
            mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);
          }
        }
      }
    };

    // The online softmax of chunk c's scores and O += P V; then the chunk's
    // slot is released (streaming only).
    auto softmax_pv = [&](float (&sc)[KC / 8][4], int c) {
      if (active) {
        const uint32_t base = ring + (c % slots) * SLOT_BYTES;
        const int valid = min(KC, NK - c * KC);  // >= 1
        // Keys past NK (the last chunk only) to -inf; the chunk's row max.
        if (valid < KC) {
#pragma unroll
          for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (nt * 8 + 2 * t + (e & 1) >= valid) sc[nt][e] = -INFINITY;
        }
        float tm0 = fmaxf(sc[0][0], sc[0][1]), tm1 = fmaxf(sc[0][2], sc[0][3]);
#pragma unroll
        for (int nt = 1; nt < KC / 8; ++nt) {
          tm0 = fmaxf(tm0, fmaxf(sc[nt][0], sc[nt][1]));
          tm1 = fmaxf(tm1, fmaxf(sc[nt][2], sc[nt][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
          tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
        }
        // The chunk holds a key, so the new max is finite, and a row whose
        // max was -inf is rescaled by 0, never by exp(-inf - -inf). O and
        // the sums are rescaled only when a max of the warp moved.
        const float nm0 = fmaxf(m0, tm0), nm1 = fmaxf(m1, tm1);
        if (__any_sync(0xffffffffu, nm0 != m0 || nm1 != m1)) {
          const float a0 = m0 == -INFINITY ? 0.f : ex2((m0 - nm0) * scale_log2);
          const float a1 = m1 == -INFINITY ? 0.f : ex2((m1 - nm1) * scale_log2);
          l0 *= a0;
          l1 *= a1;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            oacc[d][0] *= a0;
            oacc[d][1] *= a0;
            oacc[d][2] *= a1;
            oacc[d][3] *= a1;
          }
          m0 = nm0;
          m1 = nm1;
        }
        const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;

        // P = 2^(s * scale_log2 - m * scale_log2), and O += P V over the
        // 16-key steps that hold a key. P's accumulator layout is the A
        // operand (two n8 tiles make one k16 step).
#pragma unroll
        for (int kt = 0; kt < KC / 16; ++kt) {
          if (kt * 16 < valid) {
            float* s0 = sc[2 * kt];
            float* s1 = sc[2 * kt + 1];
            s0[0] = ex2(fmaf(s0[0], scale_log2, -ms0));
            s0[1] = ex2(fmaf(s0[1], scale_log2, -ms0));
            s0[2] = ex2(fmaf(s0[2], scale_log2, -ms1));
            s0[3] = ex2(fmaf(s0[3], scale_log2, -ms1));
            s1[0] = ex2(fmaf(s1[0], scale_log2, -ms0));
            s1[1] = ex2(fmaf(s1[1], scale_log2, -ms0));
            s1[2] = ex2(fmaf(s1[2], scale_log2, -ms1));
            s1[3] = ex2(fmaf(s1[3], scale_log2, -ms1));
            l0 += (s0[0] + s0[1]) + (s1[0] + s1[1]);
            l1 += (s0[2] + s0[3]) + (s1[2] + s1[3]);
            uint32_t pa[4];
            pa[0] = pack_bf16(s0[0], s0[1]);
            pa[1] = pack_bf16(s0[2], s0[3]);
            pa[2] = pack_bf16(s1[0], s1[1]);
            pa[3] = pack_bf16(s1[2], s1[3]);
#pragma unroll
            for (int dp = 0; dp < HD / 16; ++dp) {
              uint32_t r[4];
              ldsm_x4_trans(r, base + voff[dp] + kt * 16 * 128);
              mma_bf16(oacc[2 * dp], pa, r[0], r[1]);
              mma_bf16(oacc[2 * dp + 1], pa, r[2], r[3]);
            }
          }
        }
      }
      if (streaming) {  // release the slot for the chunk `slots` ahead
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[c % slots]);
      }
    };

    float sc[KC / 8][4];
    for (int c = 0; c < chunks; ++c) {
      scores(sc, c);
      softmax_pv(sc, c);
    }

    if (active) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      // O rows g and g + 8 into this warp's staging tile (4 bytes at column
      // 8 dt + 2t), then 16-byte stores of whole 128-byte rows into
      // [B, NQ, H, 64].
      __syncwarp();
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(stage + swz(g, dt) + 4 * t) =
            pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
        *reinterpret_cast<uint32_t*>(stage + swz(g + 8, dt) + 4 * t) =
            pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = j * 32 + lane, r = idx / 8, cc = idx % 8;
        if (row0 + r < NQ)
          *reinterpret_cast<uint4*>(
              o + ((static_cast<size_t>(b) * NQ + row0 + r) * H + h) * HD + cc * 8) =
              *reinterpret_cast<const uint4*>(stage + swz(r, cc));
      }
    }
    // The buffer's next TMA write must follow these generic reads/writes.
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_arrive(&qempty[qs]);
  }
}

// sm_count() comes from tma.cuh.

template <int CW>
cudaError_t launch(const CUtensorMap& map_q, const CUtensorMap& map_k,
                   const CUtensorMap& map_v, __nv_bfloat16* o, int BH, int H,
                   int NQ, int NK, float scale_log2, cudaStream_t stream) {
  const int chunks = (NK + KC - 1) / KC;
  const int passes = (NQ + 16 * CW - 1) / (16 * CW);
  // Resident K/V (all chunks fit the CTA's share of the SM): a CTA takes
  // all of its head's passes, unless too few heads would leave SMs idle
  // (then the passes are split, each CTA loading K/V once). Streaming (past
  // max_slots chunks): one pass a CTA, the chunks through a ring.
  const bool resident = chunks <= max_slots(CW);
  int per_cta = 1;
  if (resident) {
    const int want = (MIN_CTAS * sm_count() + BH - 1) / BH;
    const int split = want < passes ? want : passes;
    per_cta = (passes + split - 1) / split;
  }
  const int slots = resident ? chunks : max_slots(CW);
  const int smem = smem_bytes(CW, slots);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((passes + per_cta - 1) / per_cta, BH);
  flash_fwd<CW><<<grid, 32 * (CW + 1), smem, stream>>>(
      map_q, map_k, map_v, o, H, NQ, NK, per_cta, slots, scale_log2);
  return cudaGetLastError();
}

// The consumer-warp count: 8 or 9, whichever leaves fewer warp-passes idle
// over the 16-row tiles of NQ (8 on a tie: 257 rows take 9 warps in two
// passes, 256 rows 8).
int pick_cw(int NQ) {
  const int tiles = (NQ + 15) / 16;
  const int w8 = (tiles + 7) / 8 * 8 - tiles, w9 = (tiles + 8) / 9 * 9 - tiles;
  return w9 < w8 ? 9 : 8;
}


// ---- the wgmma design --------------------------------------------------

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

constexpr int WG_KC = 64;                      // keys per chunk
constexpr int WG_SLOT = 2 * WG_KC * HD * 2;    // K and V of a chunk, 16 KB
constexpr int WG_Q = 64 * HD * 2;              // a warpgroup's 64 q rows, 8 KB
constexpr int WG_NWG = 1;                      // consumer warpgroups a CTA
__host__ __device__ constexpr int wg_max_slots() {
  return (CTA_SMEM - 2 * WG_NWG * WG_Q - 1024) / WG_SLOT;
}
__host__ __device__ constexpr int wg_smem(int slots) {
  return slots * WG_SLOT + 2 * WG_NWG * WG_Q + 1024;
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


// S[64 x n] = Q K^T for n = 8 * ceil(valid / 8) keys of a chunk, 4 k16 steps
// (the first overwrites).
__device__ __forceinline__ void wg_scores(float (&d)[32], const uint32_t (&qf)[4][4],
                                          uint64_t desc, int valid) {
  const int n8 = (valid + 7) / 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t db = desc + ((kk * 32) >> 4);
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

// NWG consumer warpgroups of 64 q rows each (a pass is 64 * NWG rows) and
// one producer warp.
template <int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, MIN_CTAS)
    flash_fwd_wg(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, int H, int NQ, int NK,
                 int passes_per_cta, int slots, float scale_log2) {
  constexpr int QROWS = 64 * NWG, QBUF = NWG * WG_Q, WARPS = 4 * NWG;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[SLOT_CAP], empty[SLOT_CAP];
  __shared__ __align__(8) uint64_t qfull[2], qempty[2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qbuf = smem + slots * WG_SLOT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (NK + WG_KC - 1) / WG_KC;
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
        tma_load_4d(qbuf + qs * QBUF, &map_q, &qfull[qs], 0, (p0 + i) * QROWS, h, b);
      };
      load_q(0);
      if (npass > 1) load_q(1);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % slots;
        if (c >= slots) mbar_wait(&empty[s], ((c / slots) - 1) & 1);
        unsigned char* kd = smem + s * WG_SLOT;
        mbar_arrive_tx(&full[s], WG_SLOT);
        tma_load_4d(kd, &map_k, &full[s], 0, c * WG_KC, h, b);
        tma_load_4d(kd + WG_SLOT / 2, &map_v, &full[s], 0, c * WG_KC, h, b);
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
    unsigned char* stage = qbuf + qs * QBUF + warp * WARP_BYTES;
    const int row0 = (p0 + i) * QROWS + warp * 16;
    mbar_wait(&qfull[qs], (i >> 1) & 1);
    uint32_t qf[HD / 16][4];  // Q as the register A operand of S
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qf[kk], stage + swz(lane % 16, kk * 2 + lane / 16));

    float od[32];  // O [64 x 64]: od[4j], od[4j+1] row g, od[4j+2], od[4j+3] row g+8
    float sc[32];  // S of the chunk, then P
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const uint32_t slot = ring + (c % slots) * WG_SLOT;
      const int valid = min(WG_KC, NK - c * WG_KC);
      mbar_wait(&full[c % slots], (c / slots) & 1);
      wgmma_fence();
      wg_scores(sc, qf, smem_desc(slot, 0, 1024), valid);
      wgmma_commit();
      wgmma_wait<0>();  // S, and the previous chunk's P V
      if (c > 0) release(c - 1);

      if (valid < WG_KC) {
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
        for (int j = 0; j < 8; ++j) {
          od[4 * j] *= a0;
          od[4 * j + 1] *= a0;
          od[4 * j + 2] *= a1;
          od[4 * j + 3] *= a1;
        }
      }
      // O += P V: P's accumulator layout is the register A operand (two n8
      // tiles make one k16 step); V through the transposed-B descriptor.
      uint32_t pa[WG_KC / 16][4];
#pragma unroll
      for (int kt = 0; kt < WG_KC / 16; ++kt) {
        pa[kt][0] = pack_bf16(sc[8 * kt], sc[8 * kt + 1]);
        pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
        pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
        pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
      }
      const uint64_t dv = smem_desc(slot + WG_SLOT / 2, 8192, 1024);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < WG_KC / 16; ++kt)
        if (kt * 16 < valid)
          wgmma_pv(od, pa[kt], dv + ((kt * 2048) >> 4), c > 0 || kt > 0);
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
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(stage + swz(g, j) + 4 * t) =
          pack_bf16(od[4 * j] * inv0, od[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(stage + swz(g + 8, j) + 4 * t) =
          pack_bf16(od[4 * j + 2] * inv1, od[4 * j + 3] * inv1);
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int idx = jj * 32 + lane, r = idx / 8, cc = idx % 8;
      if (row0 + r < NQ)
        *reinterpret_cast<uint4*>(
            o + ((static_cast<size_t>(b) * NQ + row0 + r) * H + h) * HD + cc * 8) =
            *reinterpret_cast<const uint4*>(stage + swz(r, cc));
    }
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_arrive(&qempty[qs]);
  }
}

cudaError_t launch_wg(const CUtensorMap& map_q, const CUtensorMap& map_k,
                      const CUtensorMap& map_v, __nv_bfloat16* o, int BH, int H,
                      int NQ, int NK, float scale_log2, cudaStream_t stream) {
  const int chunks = (NK + WG_KC - 1) / WG_KC;
  const int passes = (NQ + 64 * WG_NWG - 1) / (64 * WG_NWG);
  const bool resident = chunks <= wg_max_slots();
  int per_cta = 1;
  if (resident) {
    const int want = (MIN_CTAS * sm_count() + BH - 1) / BH;
    const int split = want < passes ? want : passes;
    per_cta = (passes + split - 1) / split;
  }
  const int slots = resident ? chunks : wg_max_slots();
  const int smem = wg_smem(slots);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wg<WG_NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((passes + per_cta - 1) / per_cta, BH);
  flash_fwd_wg<WG_NWG><<<grid, 128 * WG_NWG + 32, smem, stream>>>(
      map_q, map_k, map_v, o, H, NQ, NK, per_cta, slots, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, NQ, 64], k/v [B, H, NK, 64] bf16 with element strides
// (batch, head, row) given for each, the last dim contiguous, every stride a
// multiple of 8 elements and the bases 16-byte aligned; o [B, NQ, H, 64]
// contiguous; scale > 0; D (the head dim, taken for the committed entry
// point's signature) must be 64. Returns cudaGetLastError() after the launch
// (0 on success), cudaErrorInvalidValue if a tensor map cannot be encoded.
extern "C" int vitlens_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int NQ,
    int NK, int D, long long qsb, long long qsh, long long qsn, long long ksb,
    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
    float scale, void* stream) {
  if (D != HD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v;
  const uint64_t q_dims[4] = {HD, static_cast<uint64_t>(NQ),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t kv_dims[4] = {HD, static_cast<uint64_t>(NK),
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
  const int cw = pick_cw(NQ);
  const uint32_t q_box[4] = {
      HD, static_cast<uint32_t>(USE_WGMMA ? 64 * WG_NWG : 16 * cw), 1, 1};
  const uint32_t kv_box[4] = {HD, USE_WGMMA ? WG_KC : KC, 1, 1};
  if (!encode_bf16_map(&map_q, q, 4, q_dims, q_strides, q_box) ||
      !encode_bf16_map(&map_k, k, 4, kv_dims, k_strides, kv_box) ||
      !encode_bf16_map(&map_v, v, 4, kv_dims, v_strides, kv_box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* out = static_cast<__nv_bfloat16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  const float sl = scale * 1.4426950408889634f;  // log2(e)
  if (USE_WGMMA)
    return static_cast<int>(
        launch_wg(map_q, map_k, map_v, out, B * H, H, NQ, NK, sl, st));
  const cudaError_t err =
      cw == 9 ? launch<9>(map_q, map_k, map_v, out, B * H, H, NQ, NK, sl, st)
              : launch<8>(map_q, map_k, map_v, out, B * H, H, NQ, NK, sl, st);
  return static_cast<int>(err);
}
