// Farthest-point sampling indices, forward only:
//
//     idx[b, 0] = start[b]; dist[b, :] = 1e10
//     step i: dist = min(dist, |x - x[idx[b, i]]|^2); idx[b, i + 1] = argmax(dist)
//
// Replaces both TPU kernels of vitlens_tpu/ops/fps.py: the all-batch
// `_fps_indices_pallas_batched` (:120) and the per-row grid
// `_fps_indices_pallas` (:175), which compute the same function. Numerics
// follow `_fps_indices_xla` index for index: fp32 coordinates, the distance
// rounded after every operation in the order (dx*dx + dy*dy) + dz*dz (the
// __fmul_rn / __fadd_rn intrinsics keep nvcc from contracting it into FMAs,
// which would round differently and flip the argmax at near-ties), and the
// smallest index among the maxima. Any N >= 1, with no padding.
//
// What bounds it on an H100: at the pc encode's B64, N 8192, npoint 512 it
// does ~64*8192*511*10 ~ 2.7 GFLOP of fp32 work on 2.1 MB of input, ~0.04 ms
// at the card's 67 TFLOP/s fp32; but each of the 511 steps ends in an argmax
// over the whole row whose winner the next step needs, so the chain of 511
// row-wide reductions sets a latency floor (tools/kernel_variants.py fps
// measures it with the distance update cut out).
//
// Design: a thread-block cluster of C CTAs a row (C from the batch and the
// SM count, chosen by the Python wrapper: B64 takes C = 2, 128 SMs; one row
// takes C = 4, which measured faster than 8 or 16), 256 threads a CTA. CTA r of the cluster owns the contiguous
// points [r * P, r * P + P) of its row, P = ceil(N / C).
//   * Each thread keeps KR points (x, y, z and the running distance: 4
//     registers a point; KR in {1, 2, ..., 32}, the smallest that holds the
//     partition, a template parameter) in registers, point k * 256 + tid of
//     the partition, and a copy of their coordinates in shared memory, where
//     a warp looks up its winner's. A partition past 8192 points puts the
//     next 7680 in shared memory (float4 {x, y, z, dist}) and the rest in
//     global memory: coordinates read from xyz and distances from a scratch
//     row, each step (a slower path, not an error).
//   * The argmax: every distance is >= 0, so its bits as uint32 order like
//     the float. A warp takes the max of the bits (redux.sync) and the
//     smallest index among the lanes that hold it (a second redux.sync).
//   * Across the cluster, with no barrier inside the CTA: lane r of every
//     warp sends the warp's winner (bits, global index, x, y, z) into CTA
//     r's shared memory, into the slot (this CTA's rank, the warp) of the
//     step's parity, with st.async, whose bytes complete a transaction count
//     on CTA r's mbarrier of that parity (armed each step by its own thread
//     0). Each warp waits on its CTA's mbarrier, then reduces the C * 8
//     slots: the largest bits, the smallest global index among them, and
//     that slot's coordinates are the next center, so no CTA reads the rest
//     of the row. A warp sends into a slot of parity p again only two steps
//     later, after every warp of the cluster has sent its next winner, which
//     each does after reading that slot. (Plain stores followed by a cluster
//     barrier, or each by a remote mbarrier arrive, cost a release at
//     cluster scope a step and measured slower: tools/kernel_variants.py fps
//     builds both as regex variants of this source.)
//   Ties go to the smallest global index: every warp's winner is its
//   smallest index among its maxima, and so is the reduction of the slots.
//
// Requirements checked by the Python wrapper: xyz [B, N, 3] fp32 contiguous,
// start [B] int32 in [0, N), N >= 1, npoint >= 1, C in {1, 2, 4, 8, 16},
// work [B, N] fp32 scratch where a partition of ceil(N / C) points exceeds
// REG_POINTS + SMEM_POINTS, else null.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_KR = 32;                      // register points a thread
constexpr int REG_POINTS = MAX_KR * THREADS;    // 8192 a CTA
constexpr int SMEM_POINTS = 7680;  // 120 KB of float4 a CTA, beside 96 KB of xyz
// (ops/fps.py's ON_CHIP_POINTS is REG_POINTS + SMEM_POINTS: the wrapper grows
// the cluster until a partition fits them.)
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SLOTS = MAX_CLUSTER * WARPS;  // a winner a warp of the cluster
constexpr unsigned NO_INDEX = 0x7fffffffu;
constexpr unsigned FULL = 0xffffffffu;
// A warp's winner as the CTAs receive it: two 16-byte stores.
struct __align__(16) Winner {
  unsigned key, idx, pad0, pad1;  // distance bits; global index in the row
  float x, y, z, pad2;
};

__device__ __forceinline__ float sqdist(float x, float y, float z, float cx,
                                        float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this CTA) in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The winner into a peer's slot at `addr`; each of the two stores completes
// its 16 bytes on the peer's mbarrier at `bar`.
__device__ __forceinline__ void send_winner(uint32_t addr, uint32_t bar,
                                            unsigned key, unsigned idx, float x,
                                            float y, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%2, %3, %2, %2}, [%1];\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0+16], {%4, %5, %6, %2}, [%1];\n"
      ::"r"(addr), "r"(bar), "r"(key), "r"(idx), "r"(__float_as_uint(x)),
      "r"(__float_as_uint(y)), "r"(__float_as_uint(z))
      : "memory");
}

// Tells this CTA's mbarrier to expect `bytes` in its current phase, with
// its one arrival.
__device__ __forceinline__ void arm_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of this parity of a local mbarrier has completed
// (acquire at cluster scope: the peers' stores are visible after it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "FPS_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra FPS_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <int KR>
__global__ void __launch_bounds__(THREADS, 1)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ idx, float* __restrict__ work, int N,
               int npoint, int C, int s_cap) {
  // The shared tier {x, y, z, dist} [s_cap], then the register tier's xyz.
  extern __shared__ float4 sp[];
  __shared__ Winner cs[2][MAX_SLOTS];
  __shared__ __align__(8) uint64_t bar[2];  // one a parity
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x / C;
  const int P = (N + C - 1) / C;
  const int lo = static_cast<int>(rank) * P;
  const int cnt = max(0, min(P, N - lo));
  const int n_reg = min(cnt, KR * THREADS);
  const int n_smem = min(cnt - n_reg, s_cap);
  const int g0 = n_reg + n_smem;  // the global tier: [g0, cnt)
  const int slots = C * WARPS;
  const float* row = xyz + static_cast<size_t>(b) * N * 3;
  const float* part = row + static_cast<size_t>(lo) * 3;
  float* gdist = g0 < cnt ? work + static_cast<size_t>(b) * N + lo : nullptr;
  float* rxyz = reinterpret_cast<float*>(sp + s_cap);

  // Points outside the partition hold distance -1: min(-1, d) stays -1 and
  // never beats a real distance, so the loops need no bounds test.
  float px[KR], py[KR], pz[KR], pd[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int l = k * THREADS + tid;
    const bool in = l < n_reg;
    px[k] = in ? part[3 * l] : 0.f;
    py[k] = in ? part[3 * l + 1] : 0.f;
    pz[k] = in ? part[3 * l + 2] : 0.f;
    pd[k] = in ? 1e10f : -1.f;
    if (in) {
      rxyz[3 * l] = px[k];
      rxyz[3 * l + 1] = py[k];
      rxyz[3 * l + 2] = pz[k];
    }
  }
  for (int i = tid; i < n_smem; i += THREADS) {
    const int l = n_reg + i;
    sp[i] = make_float4(part[3 * l], part[3 * l + 1], part[3 * l + 2], 1e10f);
  }
  for (int l = g0 + tid; l < cnt; l += THREADS) gdist[l] = 1e10f;
  const int arrivals = 1;  // a phase completes on thread 0's arm and its bytes
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bar[i])),
                   "r"(arrivals));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every peer has started and set up its shared memory

  int far = min(max(start[b], 0), N - 1);
  const float* c0 = row + 3 * static_cast<size_t>(far);
  float cx = c0[0], cy = c0[1], cz = c0[2];
  int* out = idx + static_cast<size_t>(b) * npoint;

  float bv;
  int bl;
  // Lowers every distance of the partition and keeps the thread's
  // (largest, first local index): l rises within each tier and from tier to
  // tier, so a strict > keeps the smallest index among ties.
  auto lower = [&]() {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      pd[k] = fminf(pd[k], sqdist(px[k], py[k], pz[k], cx, cy, cz));
      if (pd[k] > bv) {
        bv = pd[k];
        bl = k * THREADS + tid;
      }
    }
    for (int i = tid; i < n_smem; i += THREADS) {
      float4 v = sp[i];
      v.w = fminf(v.w, sqdist(v.x, v.y, v.z, cx, cy, cz));
      sp[i].w = v.w;
      if (v.w > bv) {
        bv = v.w;
        bl = n_reg + i;
      }
    }
    for (int l = g0 + tid; l < cnt; l += THREADS) {
      const float* q = part + 3 * static_cast<size_t>(l);
      const float m =
          fminf(gdist[l], sqdist(__ldg(q), __ldg(q + 1), __ldg(q + 2), cx, cy, cz));
      gdist[l] = m;
      if (m > bv) {
        bv = m;
        bl = l;
      }
    }
  };

  for (int s = 0;; ++s) {
    if (rank == 0 && tid == 0) out[s] = far;
    if (s + 1 == npoint) break;
    const int p = s & 1;
    if (tid == 0) arm_tx(&bar[p], slots * static_cast<int>(sizeof(Winner)));
    bv = -1.f;
    bl = NO_INDEX;
    lower();

    // The warp's winner, sent by lane r to CTA r, with its coordinates
    // (lanes of this warp wrote them before the first cluster_sync).
    const unsigned key = __float_as_uint(fmaxf(bv, 0.f));
    const unsigned wkey = __reduce_max_sync(FULL, key);
    const unsigned widx =
        __reduce_min_sync(FULL, key == wkey ? static_cast<unsigned>(bl) : NO_INDEX);
    if (lane < C) {
      float x = 0.f, y = 0.f, z = 0.f;
      if (widx < static_cast<unsigned>(n_reg)) {
        x = rxyz[3 * widx];
        y = rxyz[3 * widx + 1];
        z = rxyz[3 * widx + 2];
      } else if (widx < static_cast<unsigned>(g0)) {
        const float4 v = sp[widx - n_reg];
        x = v.x;
        y = v.y;
        z = v.z;
      } else if (widx < static_cast<unsigned>(cnt)) {
        const float* q = part + 3 * static_cast<size_t>(widx);
        x = q[0];
        y = q[1];
        z = q[2];
      }
      const Winner* slot = &cs[p][static_cast<int>(rank) * WARPS + warp];
      send_winner(peer_addr(slot, lane), peer_addr(&bar[p], lane), wkey,
                  widx == NO_INDEX ? NO_INDEX : lo + widx, x, y, z);
    }
    mbar_wait(&bar[p], (s >> 1) & 1);

    // The row's winner, in every warp: the largest bits, the smallest
    // global index among them, and that slot's coordinates.
    unsigned bk = 0u, bi = NO_INDEX;
    int be = 0;
    for (int e = lane; e < slots; e += 32) {
      const uint2 ki = *reinterpret_cast<const uint2*>(&cs[p][e]);
      if (ki.x > bk || (ki.x == bk && ki.y < bi)) {
        bk = ki.x;
        bi = ki.y;
        be = e;
      }
    }
    const unsigned gkey = __reduce_max_sync(FULL, bk);
    const unsigned gidx = __reduce_min_sync(FULL, bk == gkey ? bi : NO_INDEX);
    const int src = __ffs(__ballot_sync(FULL, bk == gkey && bi == gidx)) - 1;
    const float4 c = *reinterpret_cast<const float4*>(&cs[p][__shfl_sync(FULL, be, src)].x);
    cx = c.x;
    cy = c.y;
    cz = c.z;
    far = min(max(static_cast<int>(gidx), 0), N - 1);  // in bounds even on NaN input
  }
  cluster_sync();  // no peer still writes to this CTA
}

template <int KR>
cudaError_t launch(const float* xyz, const int* start, int* idx, float* work,
                   int B, int N, int npoint, int C, int s_cap,
                   cudaStream_t stream) {
  auto kernel = fps_kernel<KR>;
  const int P = (N + C - 1) / C;
  const int smem = s_cap * static_cast<int>(sizeof(float4)) +
                   3 * static_cast<int>(sizeof(float)) * min(P, KR * THREADS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, start, idx, work, N, npoint, C,
                           s_cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The smallest register points a thread, KR, that hold a partition of P
// points (MAX_KR if none does).
template <int KR>
cudaError_t dispatch(int P, const float* xyz, const int* start, int* idx,
                     float* work, int B, int N, int npoint, int C, int s_cap,
                     cudaStream_t stream) {
  if constexpr (KR < MAX_KR)
    if (P > KR * THREADS)
      return dispatch<2 * KR>(P, xyz, start, idx, work, B, N, npoint, C, s_cap,
                              stream);
  return launch<KR>(xyz, start, idx, work, B, N, npoint, C, s_cap, stream);
}

}  // namespace

// xyz [B, N, 3] fp32; start [B] int32; idx [B, npoint] int32 (written);
// work [B, N] fp32 scratch, or null where every partition fits the on-chip
// tiers (it is read only past them); C CTAs a row, one cluster.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_fps_fwd(const void* xyz, const void* start, void* idx,
                               void* work, int B, int N, int npoint, int C,
                               void* stream) {
  if (N < 1 || npoint < 1 || B < 1 || C < 1 || C > MAX_CLUSTER || (C & (C - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = (N + C - 1) / C;
  const int s_cap = P > REG_POINTS ? min(P - REG_POINTS, SMEM_POINTS) : 0;
  if (P > REG_POINTS + SMEM_POINTS && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<1>(
      P, static_cast<const float*>(xyz), static_cast<const int*>(start),
      static_cast<int*>(idx), static_cast<float*>(work), B, N, npoint, C, s_cap,
      static_cast<cudaStream_t>(stream)));
}
