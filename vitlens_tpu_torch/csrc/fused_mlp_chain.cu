// The residual MLP half of a transformer block in ONE kernel, optionally with
// the attention out-projection and its residual in front of it:
//
//   chunked MLP:   row32 = x
//   attn-out+MLP:  row32 = x + ctx @ Wo + bo          (fp32, never written)
//   out = bf16(row32 + b2 + act(LN(row32) @ W1 + b1) @ W2)
//
// Replaces scripts/fused_mlp_pallas.py::fused_mlp (body `fused_mlp_kernel`)
// and scripts/fused_attnout_mlp_pallas.py::fused (body `kernel`): two entry
// points over one kernel template. The hidden activation never leaves the
// chip: H is walked in chunks, each chunk's h = act(z @ W1[:, c] + b1[c]) is
// rounded to bf16 into shared memory and multiplied into an fp32 [rows, D]
// accumulator. Numerics follow the prototypes: LayerNorm in fp32 (mean, then
// the mean of squared deviations) rounded to bf16; both products accumulate in
// fp32; b1 and the activation in fp32 before the one rounding of h; the
// residual row and b2 join the accumulator in fp32 (in the attn-out variant
// the residual is the fp32 row, not its bf16 rounding); one rounding of out.
// The activation is a template parameter: 0 = exact (erf) GELU, which is what
// the resblock means, 1 = tanh GELU, which is what the TPU prototypes compute
// (Mosaic has no erf).
//
// What bounds it on an H100: the operations (4*M*D*H, plus 2*M*D*D with the
// out-projection: 0.28 and 0.31 ms at M = 16448, D = 1024, H = 4096 against
// ~0.1 GB of x/out/weights). What holds this design far above that bound: an
// fp32 [32, 1024] accumulator is 128 KB, half an SM's register file, so a CTA
// owns only 32 rows and streams all 16.8 MB of W1 and W2 from L2 for them:
// 514 CTAs x 16.8 MB = 8.6 GB of L2 traffic at M = 16448, against 0.4 GB of
// HBM traffic for the hidden tensor in the three-launch fused_mlp.cu.
//
// Design (first, simple and correct): a CTA of 8 warps owns TM = 32 rows; warp
// w owns all 32 rows x the D/8 columns [w*D/8, (w+1)*D/8) of the accumulator
// (128 registers a thread at D = 1024).
//   0. (attn-out only) ctx tile -> shared memory; acc = ctx @ Wo, Wo streamed
//      in [16, D] slabs through a 3-stage cp.async ring.
//   1. x tile -> shared memory; acc += x (+ bo). LayerNorm statistics from the
//      registers (quad shuffles, then across the warps through shared
//      memory), z = bf16(LN(acc)) -> shared memory, once (the TPU prototype
//      recomputes it per chunk); acc += b2.
//   2. One continuous stream of weight slabs through the ring: for each chunk
//      of TH = 128 hidden columns, D/64 slabs W1[64, 128] (h_acc += z @ slab;
//      warp w owns 16 of the chunk's columns), the b1 + act epilogue into the
//      h tile, then 8 slabs W2[16, D] (acc += h @ slab). One barrier a slab.
//   3. out tile -> shared memory -> coalesced 16-byte stores.
// The ragged M tail is zero-filled on load and not stored.
//
// Requirements checked by the Python wrapper: bf16 x/ctx/Wo/W1/W2, fp32 LN
// params and biases, everything contiguous and 16-byte aligned, D one of 256
// and 1024, H a multiple of 128.

#include "ptx.cuh"

namespace {

constexpr int TM = 32;        // rows a CTA owns
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TH = 128;       // hidden columns a chunk
constexpr int K1 = 64;        // rows of a W1 slab [K1, TH]
constexpr int K2 = 16;        // rows of a W2 or Wo slab [K2, D]
constexpr int STAGES = 3;
constexpr int H_LD = TH + 8;  // padded rows (bf16): ldmatrix rows hit 8 bank groups
constexpr int W1_LD = TH + 8;

template <int D>
struct Cfg {
  static constexpr int NT = D / 64;      // n8 tiles of the accumulator a warp
  static constexpr int Z_LD = D + 8;     // x / ctx / z / out tile row
  static constexpr int W2_LD = D + 8;
  static constexpr int STAGE_ELEMS =
      K1 * W1_LD > K2 * W2_LD ? K1 * W1_LD : K2 * W2_LD;
  static constexpr int SMEM_BYTES =
      2 * (TM * Z_LD + TM * H_LD + STAGES * STAGE_ELEMS) + 4 * WARPS * TM;
};

template <int ACT>
__device__ __forceinline__ float act_fn(float v) {
  if constexpr (ACT == 0)
    return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  else
    return 0.5f * v *
           (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// acc[2][NT] (+)= a[32, 16] @ b[16, NT*8]: a points at the k offset of a
// [32, a_ld] tile, b at (k row 0, the warp's first column) of a [16, b_ld]
// slab. ldmatrix addressing: A (x4) lanes 0-15 give rows 0-15 at k 0,
// lanes 16-31 rows 0-15 at k 8; B (x4.trans) lane%8 + 8*((lane/8)%2) is the
// k row, 8*(lane/16) the n offset.
template <int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[2][NT][4],
                                        const __nv_bfloat16* a, int a_ld,
                                        const __nv_bfloat16* b, int b_ld,
                                        int lane) {
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;
  uint32_t af[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    ldmatrix_x4(af[i], a + (i * 16 + a_row) * a_ld + a_col);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, b + b_row * b_ld + j * 8 + b_col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_bf16(acc[i][j], af[i], r[0], r[1]);
      mma_bf16(acc[i][j + 1], af[i], r[2], r[3]);
    }
  }
}

// The sum over each of the CTA's rows of v[i][half] (a thread's partial for
// rows i*16 + half*8 + g), returned to every thread for its own 4 rows.
__device__ __forceinline__ void row_sums(float (&v)[2][2], float* red,
                                         int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = v[i][half];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red[warp * TM + i * 16 + half * 8 + g] = s;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * TM + i * 16 + half * 8 + g];
      v[i][half] = s;
    }
  __syncthreads();  // red is free again
}

template <int D, int ACT, bool OUTPROJ>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_chain(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ ctx,
              const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
              const float* __restrict__ lnw, const float* __restrict__ lnb,
              const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
              const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
              __nv_bfloat16* __restrict__ out, int M, int H, float eps) {
  using C = Cfg<D>;
  constexpr int NT = C::NT, Z_LD = C::Z_LD, W2_LD = C::W2_LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = zs + TM * Z_LD;
  __nv_bfloat16* ring = hs + TM * H_LD;
  float* red = reinterpret_cast<float*>(ring + STAGES * C::STAGE_ELEMS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * TM;
  const int wcol = warp * (D / WARPS);  // the warp's first accumulator column
  constexpr int ROW_CHUNKS = D / 8;     // 16-byte chunks of a [*, D] row

  // [TM, D] rows of src -> zs; rows past M are zero.
  auto load_tile = [&](const __nv_bfloat16* src) {
    for (int c = tid; c < TM * ROW_CHUNKS; c += THREADS) {
      const int r = c / ROW_CHUNKS, kc = (c % ROW_CHUNKS) * 8;
      const bool ok = row0 + r < M;
      cp_async16(zs + r * Z_LD + kc,
                 src + static_cast<size_t>(ok ? row0 + r : 0) * D + kc, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  // Rows [k0, k0 + K2) of a [*, D] matrix -> a ring stage.
  auto load_rows_slab = [&](int stage, const __nv_bfloat16* mat, int k0) {
    __nv_bfloat16* dst = ring + stage * C::STAGE_ELEMS;
#pragma unroll
    for (int i = 0; i < K2 * ROW_CHUNKS / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / ROW_CHUNKS, nc = (c % ROW_CHUNKS) * 8;
      cp_async16(dst + r * W2_LD + nc,
                 mat + static_cast<size_t>(k0 + r) * D + nc, true);
    }
  };
  // W1[k0 : k0 + K1, h0 : h0 + TH] -> a ring stage.
  auto load_w1_slab = [&](int stage, int k0, int h0) {
    __nv_bfloat16* dst = ring + stage * C::STAGE_ELEMS;
    constexpr int CH = TH / 8;
#pragma unroll
    for (int i = 0; i < K1 * CH / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / CH, nc = (c % CH) * 8;
      cp_async16(dst + r * W1_LD + nc,
                 w1 + static_cast<size_t>(k0 + r) * H + h0 + nc, true);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // -- 0: acc = ctx @ Wo -----------------------------------------------------
  if constexpr (OUTPROJ) {
    load_tile(ctx);
    constexpr int S0 = D / K2;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      load_rows_slab(s, wo, s * K2);
      cp_async_commit();
    }
    for (int s = 0; s < S0; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = s + STAGES - 1;
      if (next < S0) load_rows_slab(next % STAGES, wo, next * K2);
      cp_async_commit();
      mma_k16<NT>(acc, zs + s * K2, Z_LD,
                  ring + (s % STAGES) * C::STAGE_ELEMS + wcol, W2_LD, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ctx tile and the ring
  }

  // -- 1: acc += x (+ bo); z = bf16(LN(acc)); acc += b2 ------------------------
  load_tile(x);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + half * 8 + g, c = wcol + j * 8 + 2 * t;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(zs + r * Z_LD + c));
        acc[i][j][2 * half] += xv.x;
        acc[i][j][2 * half + 1] += xv.y;
        if constexpr (OUTPROJ) {
          const float2 bv = *reinterpret_cast<const float2*>(bo + c);
          acc[i][j][2 * half] += bv.x;
          acc[i][j][2 * half + 1] += bv.y;
        }
      }
  float mean[2][2], rstd[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) s += acc[i][j][2 * half] + acc[i][j][2 * half + 1];
      mean[i][half] = s;
    }
  row_sums(mean, red, warp, lane);  // its barriers also retire the x tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mean[i][half] *= 1.0f / D;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float d0 = acc[i][j][2 * half] - mean[i][half];
        const float d1 = acc[i][j][2 * half + 1] - mean[i][half];
        s += d0 * d0 + d1 * d1;
      }
      rstd[i][half] = s;
    }
  row_sums(rstd, red, warp, lane);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      rstd[i][half] = rsqrtf(rstd[i][half] * (1.0f / D) + eps);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wcol + j * 8 + 2 * t;
      const float2 wv = *reinterpret_cast<const float2*>(lnw + c);
      const float2 bv = *reinterpret_cast<const float2*>(lnb + c);
      const float2 b2v = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + half * 8 + g;
        const float z0 =
            (acc[i][j][2 * half] - mean[i][half]) * rstd[i][half] * wv.x + bv.x;
        const float z1 =
            (acc[i][j][2 * half + 1] - mean[i][half]) * rstd[i][half] * wv.y + bv.y;
        *reinterpret_cast<__nv_bfloat162*>(zs + r * Z_LD + c) =
            __floats2bfloat162_rn(z0, z1);
        acc[i][j][2 * half] += b2v.x;
        acc[i][j][2 * half + 1] += b2v.y;
      }
    }
  // (the first barrier of the stream below publishes z)

  // -- 2: the slab stream -------------------------------------------------------
  constexpr int S1 = D / K1, S2 = TH / K2, S = S1 + S2;
  const int total = (H / TH) * S;
  auto issue = [&](int s) {
    if (s < total) {
      const int chunk = s / S, r = s % S;
      if (r < S1)
        load_w1_slab(s % STAGES, r * K1, chunk * TH);
      else
        load_rows_slab(s % STAGES, w2, chunk * TH + (r - S1) * K2);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float hacc[2][2][4];
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(s + STAGES - 1);
    const int chunk = s / S, r = s % S;
    const __nv_bfloat16* slab = ring + (s % STAGES) * C::STAGE_ELEMS;
    if (r < S1) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            hacc[i][j][0] = hacc[i][j][1] = hacc[i][j][2] = hacc[i][j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < K1; kk += 16)
        mma_k16<2>(hacc, zs + r * K1 + kk, Z_LD, slab + kk * W1_LD + warp * 16,
                   W1_LD, lane);
      if (r == S1 - 1) {  // h = bf16(act(h_acc + b1)) -> the h tile
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = warp * 16 + j * 8 + 2 * t;
            const float2 bv =
                *reinterpret_cast<const float2*>(b1 + chunk * TH + c);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = i * 16 + half * 8 + g;
              *reinterpret_cast<__nv_bfloat162*>(hs + row * H_LD + c) =
                  __floats2bfloat162_rn(
                      act_fn<ACT>(hacc[i][j][2 * half] + bv.x),
                      act_fn<ACT>(hacc[i][j][2 * half + 1] + bv.y));
            }
          }
      }
    } else {
      mma_k16<NT>(acc, hs + (r - S1) * K2, H_LD, slab + wcol, W2_LD, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with z

  // -- 3: out = bf16(acc), staged through the z tile ---------------------------
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + half * 8 + g, c = wcol + j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(zs + r * Z_LD + c) =
            __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
  __syncthreads();
  for (int c = tid; c < TM * ROW_CHUNKS; c += THREADS) {
    const int r = c / ROW_CHUNKS, kc = (c % ROW_CHUNKS) * 8;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * D + kc) =
          *reinterpret_cast<const uint4*>(zs + r * Z_LD + kc);
  }
}

template <int D, int ACT, bool OUTPROJ>
cudaError_t launch(const void* x, const void* ctx, const void* wo,
                   const void* bo, const void* lnw, const void* lnb,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int M, int H, float eps,
                   cudaStream_t stream) {
  constexpr int smem = Cfg<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_chain<D, ACT, OUTPROJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  mlp_chain<D, ACT, OUTPROJ><<<(M + TM - 1) / TM, THREADS, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(ctx),
      static_cast<const bf*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(lnw), static_cast<const float*>(lnb),
      static_cast<const bf*>(w1), static_cast<const float*>(b1),
      static_cast<const bf*>(w2), static_cast<const float*>(b2),
      static_cast<bf*>(out), M, H, eps);
  return cudaGetLastError();
}

template <bool OUTPROJ>
int dispatch(const void* x, const void* ctx, const void* wo, const void* bo,
             const void* lnw, const void* lnb, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, int M, int D, int H,
             int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define VITLENS_CHAIN_CASE(D_, ACT_)                                          \
  if (D == D_ && act == ACT_)                                                 \
    err = launch<D_, ACT_, OUTPROJ>(x, ctx, wo, bo, lnw, lnb, w1, b1, w2, b2, \
                                    out, M, H, eps, s);
  VITLENS_CHAIN_CASE(1024, 0)
  VITLENS_CHAIN_CASE(1024, 1)
  VITLENS_CHAIN_CASE(256, 0)
  VITLENS_CHAIN_CASE(256, 1)
#undef VITLENS_CHAIN_CASE
  return static_cast<int>(err);
}

}  // namespace

// x [M, D] bf16; lnw, lnb [D] fp32; w1 [D, H] bf16; b1 [H] fp32; w2 [H, D]
// bf16; b2 [D] fp32; out [M, D] bf16. act: 0 = exact GELU, 1 = tanh GELU.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_fused_mlp_chunked_fwd(
    const void* x, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, void* out, int M, int D,
    int H, int act, float eps, void* stream) {
  return dispatch<false>(x, nullptr, nullptr, nullptr, lnw, lnb, w1, b1, w2, b2,
                         out, M, D, H, act, eps, stream);
}

// As above with the out-projection in front: ctx [M, D] bf16, wo [D, D] bf16,
// bo [D] fp32.
extern "C" int vitlens_fused_attnout_mlp_fwd(
    const void* x, const void* ctx, const void* wo, const void* bo,
    const void* lnw, const void* lnb, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, int M, int D, int H, int act,
    float eps, void* stream) {
  return dispatch<true>(x, ctx, wo, bo, lnw, lnb, w1, b1, w2, b2, out, M, D, H,
                        act, eps, stream);
}
