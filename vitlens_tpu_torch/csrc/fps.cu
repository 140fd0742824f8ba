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
// smallest index among the maxima. The TPU kernels pad N to a multiple of 128;
// this one takes any N up to 16384 with no padding.
//
// What bounds it on an H100: at the pc encode's B64, N 8192, npoint 512 it
// does ~64*8192*512*10 ~ 2.7 GFLOP of fp32 work on 6.3 MB of input, ~0.04 ms
// at the card's 67 TFLOP/s fp32; but each of the 512 steps ends in a
// block-wide argmax whose winner the next step needs, so the chain of 512
// reductions (two __syncthreads each) sets a latency floor well above that.
//
// Design (first, simple and correct): one 1024-thread block per batch row.
// The row's xyz sits in dynamic shared memory (12 B a point, 96 KB at
// N = 8192) so that the winner's coordinates are one read; each thread keeps
// the running distance of its strided share of the points (point j belongs to
// thread j % 1024) in registers. A step: every thread lowers its distances and
// keeps its own (max, first index); a __shfl_xor_sync butterfly reduces the
// (value, index) pairs in each warp; warp 0 reduces the 32 warp winners from
// shared memory and publishes the next point. B = 64 rows fill 64 of the 132
// SMs; spreading a row over a cluster with distributed shared memory is later
// work.
//
// Requirements checked by the Python wrapper: xyz [B, N, 3] fp32 contiguous,
// start [B] int32 in [0, N), 1 <= N <= 16384, npoint >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FPS_THREADS = 1024;
constexpr int FPS_WARPS = FPS_THREADS / 32;
constexpr int FPS_PER_THREAD = 16;  // N <= 16384
constexpr int NO_INDEX = 0x7fffffff;

// (v, i) beats (bv, bi): larger value, or the same value at a smaller index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(FPS_THREADS, 1)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ idx, int N, int npoint) {
  extern __shared__ float s_xyz[];  // xs [N], ys [N], zs [N]
  __shared__ float red_v[FPS_WARPS];
  __shared__ int red_i[FPS_WARPS];
  __shared__ int s_next;
  float* xs = s_xyz;
  float* ys = xs + N;
  float* zs = ys + N;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  const float* row = xyz + static_cast<size_t>(b) * N * 3;
  for (int e = tid; e < 3 * N; e += FPS_THREADS) {
    const int p = e / 3;
    s_xyz[(e - 3 * p) * N + p] = row[e];
  }
  float dist[FPS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < FPS_PER_THREAD; ++k) dist[k] = 1e10f;
  int far = min(max(start[b], 0), N - 1);
  int* out = idx + static_cast<size_t>(b) * npoint;
  __syncthreads();

  for (int s = 0; s < npoint; ++s) {
    if (tid == 0) out[s] = far;
    if (s + 1 == npoint) break;
    const float cx = xs[far], cy = ys[far], cz = zs[far];
    float bv = -1.0f;  // every distance is >= 0
    int bi = NO_INDEX;
#pragma unroll
    for (int k = 0; k < FPS_PER_THREAD; ++k) {
      const int j = k * FPS_THREADS + tid;
      if (k * FPS_THREADS < N && j < N) {
        const float dx = __fsub_rn(xs[j], cx);
        const float dy = __fsub_rn(ys[j], cy);
        const float dz = __fsub_rn(zs[j], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = fminf(dist[k], d);
        dist[k] = m;
        if (m > bv) {  // j rises with k: ties keep the smaller index
          bv = m;
          bi = j;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) s_next = bi;
    }
    __syncthreads();
    far = min(max(s_next, 0), N - 1);  // stays in bounds even on NaN input
  }
}

}  // namespace

// xyz [B, N, 3] fp32; start [B] int32; idx [B, npoint] int32 (written).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_fps_fwd(const void* xyz, const void* start, void* idx,
                               int B, int N, int npoint, void* stream) {
  if (N < 1 || N > FPS_THREADS * FPS_PER_THREAD || npoint < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<B, FPS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(start),
      static_cast<int*>(idx), N, npoint);
  return static_cast<int>(cudaGetLastError());
}
