// A variant of csrc/fused_ln_proj.cu kept for tools/kernel_variants.py, not
// built into the library:
//
//     python3 tools/kernel_variants.py lnproj      # beside the committed kernel
//
// The design that keeps LN(x) out of HBM: ln_stats writes each row's mean
// and rstd (8 bytes a row, into the committed entry point's y scratch), then
// one GEMM on gemm_sm90.cuh's ring (TMA producer warpgroup, 4 x 48 KB
// stages, two consumer warpgroups on wgmma m64n256k16, W read through the
// MN-major descriptor) whose consumers normalise their own 64 rows of each
// A tile of x in shared memory once the stage has landed:
// y = bf16(((x - mean) * rstd) * w + b), each operation rounded. Under the
// 128-byte swizzle a thread's 16-byte chunk holds the same 8 columns in each
// of its 4 rows, so it reads 16 floats of the LN affine (through L1) a
// k-tile and its rows' statistics once. The writes are ordered before the
// wgmma by fence.proxy.async and a 128-thread barrier; no CTA-wide barrier.
// It reads the same numbers as the committed kernel and is slower on an
// H100 (0.9123 against 0.7600 ms at M = 49344, N = 3072, in one process):
// each of the N / 256 column tiles of a row block normalises its A tiles
// again, and that scalar work does not hide under the products.

#include "gemm_sm90.cuh"

namespace {
namespace sm90 {

struct LnParams {
  Params p;
  const float* mean;  // [M]
  const float* rstd;  // [M]
  const float* w;     // [K]
  const float* b;     // [K]
};

// mean[row], rstd[row] of x[row] in fp32. One warp per row.
__global__ void ln_stats(const __nv_bfloat16* __restrict__ x,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int M, int D,
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
  const float mean = sum / D;
  float sq = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rsqrtf(sq / D + eps);
  }
}

// One consumer warpgroup's 64 rows of a stage's A tile (`a`), k-tile kt:
// thread tid owns physical chunk tid % 8 of rows tid / 8 + 16 q, which is
// logical chunk (tid % 8) ^ ((tid / 8) % 8) of each.
__device__ __forceinline__ void ln_normalise(unsigned char* a, int tid, int kt,
                                             const float* mu, const float* rs,
                                             const LnParams& l) {
  const int k0 = kt * BK + (((tid % 8) ^ ((tid / 8) % 8)) * 8);
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(l.w + k0));
  const float4 w1 = __ldg(reinterpret_cast<const float4*>(l.w + k0 + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(l.b + k0));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(l.b + k0 + 4));
  const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4* chunk = reinterpret_cast<uint4*>(a + (tid / 8 + 16 * q) * 128 +
                                            (tid % 8) * 16);
    uint4 u = *chunk;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c = __fsub_rn(__bfloat162float(e[j]), mu[q]);
      e[j] = __float2bfloat16(__fadd_rn(__fmul_rn(__fmul_rn(c, rs[q]), w[j]), b[j]));
    }
    *chunk = u;
  }
  fence_proxy_async();  // the writes, before the async proxy's wgmma reads
}

__global__ void __launch_bounds__(THREADS, 1)
    gemm_ln(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const LnParams l) {
  const Params& p = l.p;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = p.K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // ---- producer, as gemm_tma's ----
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
    return;
  }
  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float d[128];
  const uint32_t ring = smem_u32(smem);
  float mu[4] = {0.f, 0.f, 0.f, 0.f}, rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // this thread's 4 rows; none past M
    const int r = row0 + wg * 64 + tid / 8 + 16 * q;
    if (r < p.M) {
      mu[q] = l.mean[r];
      rs[q] = l.rstd[r];
    }
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    ln_normalise(smem + s * STAGE_BYTES + wg * 64 * 128, tid, kt, mu, rs, l);
    named_sync(2 + wg, 128);
    wgmma_fence();
    const uint32_t stage = ring + s * STAGE_BYTES;
    const uint64_t da = smem_desc(stage + wg * 64 * 128, 0, 1024);
    const uint64_t db = smem_desc(stage + A_BYTES, B_BOX_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16(d, da + ((kk * 32) >> 4), db + ((kk * 2048) >> 4),
                       kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // Epilogue: as gemm_tma's, out = bf16(acc + bias).
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
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      oe[e] = __float2bfloat16(Cs[r * C_LD + c + e] + p.bias[gc + e]);
    *reinterpret_cast<uint4*>(p.C + static_cast<size_t>(gr) * p.N + gc) = o;
  }
}

}  // namespace sm90
}  // namespace

// The committed entry point's signature; y [M, D] bf16 scratch holds mean
// and rstd [M] fp32 here.
extern "C" int vitlens_fused_ln_proj_fwd(const void* x, const void* lnw,
                                         const void* lnb, const void* w,
                                         const void* b, void* y, void* out,
                                         int M, int D, int N, float eps,
                                         void* stream) {
  using namespace sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mean = static_cast<float*>(y);
  float* rstd = mean + M;
  ln_stats<<<(M + 7) / 8, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                      mean, rstd, M, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  LnParams l{};
  l.p.bias = static_cast<const float*>(b);
  l.p.C = static_cast<__nv_bfloat16*>(out);
  l.p.M = M;
  l.p.N = N;
  l.p.K = D;
  l.mean = mean;
  l.rstd = rstd;
  l.w = static_cast<const float*>(lnw);
  l.b = static_cast<const float*>(lnb);
  CUtensorMap map_a, map_b;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(M)};
  const uint64_t a_strides[2] = {1, static_cast<uint64_t>(D)};
  const uint32_t a_box[2] = {BK, BM};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(D)};
  const uint64_t b_strides[2] = {1, static_cast<uint64_t>(N)};
  const uint32_t b_box[2] = {B_BOX, BK};
  if (!encode_bf16_map(&map_a, x, 2, a_dims, a_strides, a_box) ||
      !encode_bf16_map(&map_b, w, 2, b_dims, b_strides, b_box))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(gemm_ln, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_ln<<<grid, THREADS, SMEM_BYTES, s>>>(map_a, map_b, l);
  return static_cast<int>(cudaGetLastError());
}
