// Unmasked softmax attention, forward only:
//
//     o = softmax(q @ k^T * scale) @ v      q [BH, NQ, 64], k/v [BH, NK, 64]
//
// Replaces vitlens_tpu/ops/flash_attention.py::_fused_attention_fwd_impl (body
// `_fused_attn_kernel`). Scores, the softmax (running max, exponentials and
// row sums) and the P @ V accumulation are fp32, and the output is rounded
// once to bf16. The probabilities enter the P @ V tensor-core product as bf16
// (fp32 accumulate), the usual flash-attention choice; the row sums use the
// fp32 probabilities.
//
// What bounds it on an H100: at the encode's lengths (NK <= 600, head dim 64)
// the products are small (2 * NQ * NK * 64 FLOP each per head); the kernel is
// bound by reading Q/K/V and by the softmax's exponentials and shuffles, not
// by tensor-core FLOPs. Its gain over the plain PyTorch path is that the
// [NQ, NK] scores and probabilities never reach HBM.
//
// Design: one CTA of 4 warps per (batch*head, 64-row q tile); each warp owns
// 16 q rows. K/V stream through shared memory in 64-row tiles; S = Q K^T and
// O += P V use mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the
// accumulators in registers, and an online softmax (running max and sum)
// rescales O between tiles. Ragged NQ and NK tails are zero-filled on load
// and masked (-inf scores, skipped stores) in the kernel: no padding copies.
// Head dim is fixed at 64; the Python wrapper checks it, bf16 and contiguity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;         // head dim
constexpr int TQ = 64;         // q rows per CTA
constexpr int TK = 64;         // keys per tile
constexpr int LD = HD + 8;     // padded smem row (bf16 elements)
constexpr int THREADS = 128;   // 4 warps x 16 q rows

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [r0, r0 + 64) of a [n, 64] bf16 matrix into smem, zero-filling
// rows >= n. 64 rows x 8 chunks of 16 bytes over 128 threads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int c = threadIdx.x + i * THREADS;
    int r = c / 8, cc = (c % 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * HD + cc);
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
    flash_fwd(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              int NQ, int NK, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[TQ * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[TK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[TK * LD];

  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group row / thread-in-group
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * NQ * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * NK * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * NK * HD;

  load_tile(Qs, qb, q0, NQ);
  __syncthreads();

  // Q fragments (A operand, row-major 16x16 per k-step), kept in registers.
  uint32_t qf[HD / 16][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[qr * LD + c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[(qr + 8) * LD + c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[qr * LD + c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&Qs[(qr + 8) * LD + c + 8]);
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int k0 = 0; k0 < NK; k0 += TK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kb, k0, NK);
    load_tile(Vs, vb, k0, NK);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const int key = nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[key * LD + c]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[key * LD + c + 8]);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    // Scale, mask keys past NK, and take the tile's row maxima.
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        float val = key < NK ? s[nt][e] * scale : -INFINITY;
        s[nt][e] = val;
        if (e < 2) tm0 = fmaxf(tm0, val);
        else tm1 = fmaxf(tm1, val);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    // Every tile holds at least one valid key, so the new maxima are finite.
    const float nm0 = fmaxf(m0, tm0), nm1 = fmaxf(m1, tm1);
    const float a0 = __expf(m0 - nm0), a1 = __expf(m1 - nm1);
    m0 = nm0;
    m1 = nm1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      oacc[i][0] *= a0;
      oacc[i][1] *= a0;
      oacc[i][2] *= a1;
      oacc[i][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m0);
      s[nt][1] = __expf(s[nt][1] - m0);
      s[nt][2] = __expf(s[nt][2] - m1);
      s[nt][3] = __expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O += P V: 4 k-steps of 16 keys; P's accumulator layout is reused as
    // the A operand (two adjacent 8-key n-tiles make one 16-key k-step).
#pragma unroll
    for (int kt = 0; kt < TK / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const int kr = kt * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int d = dt * 8 + g;
        uint32_t b0 = pack_raw(Vs[kr * LD + d], Vs[(kr + 1) * LD + d]);
        uint32_t b1 = pack_raw(Vs[(kr + 8) * LD + d], Vs[(kr + 9) * LD + d]);
        mma_bf16(oacc[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + qr, r1 = r0 + 8;
  __nv_bfloat16* ob = o + static_cast<size_t>(bh) * NQ * HD;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < NQ)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(r0) * HD + c]) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (r1 < NQ)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(r1) * HD + c]) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
}

}  // namespace

// q [BH, NQ, 64], k/v [BH, NK, 64], o [BH, NQ, 64], all bf16 and contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_flash_attention_fwd(const void* q, const void* k,
                                           const void* v, void* o, int BH,
                                           int NQ, int NK, float scale,
                                           void* stream) {
  dim3 grid((NQ + TQ - 1) / TQ, BH);
  flash_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), NQ,
      NK, scale);
  return static_cast<int>(cudaGetLastError());
}
