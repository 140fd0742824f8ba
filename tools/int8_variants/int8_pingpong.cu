// A variant of csrc/int8_matmul.cu kept for
// tools/kernel_variants.py, not built into the library:
//
//     python3 tools/kernel_variants.py int8 '{"pingpong": {"@source": "tools/int8_variants/int8_pingpong.cu"}}'
//
// Its products run in a ping-pong schedule instead of the committed
// cooperative one: each consumer warpgroup owns a whole 128 x 128 tile (two
// m64n128k32 products a k-step) and takes every other tile of its CTA from
// the one in-order ring of 32 KB stages, and an mbarrier pair hands the
// tensor cores from one warpgroup to the other, so that one's epilogue runs
// under the other's products (and no warpgroup waits on a ring stage more
// than one use ahead). On an H100 it is faster where K is short (the
// epilogue is a large share of a tile) and slower at K = 4096, where the
// epilogue is a small share and a 128-column tile reads each byte of B for
// half as many rows as the committed 256-column one.
// The epilogues, the quantise kernel and the entry points are the
// committed file's.
//
// int8 x int8 products of the W8A8 serving mode, and the per-row activation
// quantisation that feeds them:
//
//     C[M, N] = A[M, K] @ B[K, N]                          (INT32: exact)
//     Y[M, N] = cast(((float(A @ B) * xs[m]) * ws[n]) + b[n])  (DEQUANT)
//     xs[m] = max(amax_k |x[m, k]| / 127, 1e-12),
//     A[m, k] = clamp(rint(x[m, k] / xs[m]), -127, 127)     (quantise)
//
// INT32 replaces scripts/bench_int8_native.py::pallas_int8_matmul (body
// `_mm_kernel`), the exact tiled product. DEQUANT is the same product with
// the tail of vitlens_tpu/quant.py::int8_matmul as its epilogue, and the
// quantise kernel its head: on the TPU XLA fuses both into the dot ("the
// f32 row-scale x col-scale dequant is elementwise and fuses with the
// bias/residual consumer"); here they are this file's kernels, so the
// quantized encode makes no other pass over its [M, K] and [M, N] tensors.
// Rounding points are the plain version's, each one explicit so that nvcc
// contracts nothing into an FMA: IEEE division (__fdiv_rn) for both scales'
// uses, rint (half to even, as torch.round and jnp.round), then
// __int2float_rn, __fmul_rn by the row scale, __fmul_rn by the column scale,
// __fadd_rn of the bias (only when there is one), one rounding to the output
// type.
//
// B is handed over TRANSPOSED, Bt [N, K] (K contiguous): wgmma takes 8-bit
// operands only K-major. A quantized module makes that copy once, when it is
// quantized or loaded.
//
// What bounds it on an H100: at the quantized audio encode's fc shape
// (M = 49344, K = 1024, N = 4096) the product does 2*M*K*N = 0.41 TOP
// (0.21 ms at 1979 TOP/s); INT32 writes 4*M*N = 808 MB (0.24 ms at
// 3.35 TB/s), so its output bytes bound it, while DEQUANT writes half that
// in bf16 and is bound by its operations. The quantise kernel moves bytes
// only (read M*K elements, write M*K int8 and M scales).
//
// Design of the quantise kernel: one warp a row, 16-byte loads, the amax
// reduced across the warp, then the row read again (from L1/L2) and written
// as int8, 8 or 4 bytes a lane. (Keeping the row in 16 registers a lane
// instead, to read it once, made the bf16 rows 2x to 4x slower on an H100.)
//
// Requirements checked by the Python wrappers: int8 A [M, K] and Bt [N, K],
// contiguous, 16-byte aligned, K a multiple of 32 and N of 128; fp32 scales
// and bias, contiguous; x bf16 or fp32, contiguous, K a multiple of 32.

#include "gemm_sm90.cuh"

namespace {

using sm90::BM;
using sm90::BN;
using sm90::STAGE_BYTES;
using sm90::THREADS;
using sm90::CONSUMERS;
using sm90::A_BYTES;

constexpr int BK = 128;  // int8 k a stage: one 128-byte swizzled row
static_assert(A_BYTES == BM * BK && STAGE_BYTES == A_BYTES + BN * BK,
              "an int8 stage is the bf16 stage's bytes");
constexpr int NST = 4;                 // ring stages
constexpr int TM = 128, TN = 128;      // a consumer warpgroup's tile
constexpr int TA_BYTES = TM * BK;      // 16 KB
constexpr int TSTAGE = TA_BYTES + TN * BK;  // 32 KB
constexpr int BOX_BYTES = 64 * 128;    // a [64 rows][128 bytes] store box
constexpr int EPI_BYTES = 4 * BOX_BYTES;  // a consumer warpgroup's staging
constexpr int WSB_BYTES = 2 * TN * 4;     // its tile's column scales and bias
constexpr int SMEM_BYTES =
    NST * TSTAGE + CONSUMERS * (EPI_BYTES + WSB_BYTES) + 1024;

// d[64 x 128] (+)= A[64 x 32] * B[32 x 128], s8 x s8 -> s32, both K-major.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t* d, uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

enum Int8Epilogue {
  I8_INT32 = 0,    // C = acc
  I8_DEQUANT = 1,  // Y = cast(((float(acc) * xs[m]) * ws[n]) + b[n])
};

struct Int8Params {  // the output goes by its tensor map
  const float* xs;   // [M] row scales (I8_DEQUANT)
  const float* ws;   // [N] column scales
  const float* bias; // [N], or null
  int M, N, K;
};

// Byte `b` of row `r` of a [64 rows][128 bytes] box under the 128-byte
// swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// Two neighbouring outputs into a staging box.
__device__ __forceinline__ void put2(unsigned char* p, int32_t a, int32_t b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

__device__ __forceinline__ void put2(unsigned char* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(unsigned char* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

__device__ __forceinline__ float from_float(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <int EPI, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_c, const Int8Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  // order[w]: the other warpgroup has issued its previous tile's products.
  // A warpgroup waits for it before its own products, so the two take the
  // tensor cores in turn (one's epilogue under the other's products), and
  // so that no warpgroup waits on a ring stage more than one use ahead.
  __shared__ __align__(8) uint64_t order[2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tiles_n = (p.N + TN - 1) / TN;
  const int tiles = ((p.M + TM - 1) / TM) * tiles_n;
  const int KT = (p.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consuming warpgroup's four warps
    }
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // ---- producer: every tile's k-tiles, in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (tile / tiles_n) * TM, col0 = (tile % tiles_n) * TN;
        for (int kt = 0; kt < KT; ++kt, ++it)
          sm90::ring_produce<NST, TSTAGE>(full, empty, smem, it, TSTAGE,
                                          [&](unsigned char* a, uint64_t* bar) {
                                            tma_load_2d(a, &map_a, bar, kt * BK, row0);
                                            tma_load_2d(a + TA_BYTES, &map_b, bar,
                                                        kt * BK, col0);
                                          });
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes every other tile of the CTA's ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  int32_t d0[64], d1[64];  // rows 0-63 and 64-127 of the tile
  const uint32_t ring = smem_u32(smem);
  unsigned char* out = smem + NST * TSTAGE + wg * EPI_BYTES;
  float* wsb = reinterpret_cast<float*>(smem + NST * TSTAGE +
                                        CONSUMERS * EPI_BYTES + wg * WSB_BYTES);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  constexpr int ESZ = sizeof(OutT);
  constexpr int BOX_COLS = 128 / ESZ;
  constexpr int PASS_COLS = EPI_BYTES / (TM * ESZ);  // 128 (bf16) or 64
  constexpr int NBC = PASS_COLS / BOX_COLS;          // boxes across a pass
  int waits = 0;
  for (int k = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;
       k += 2, tile += 2 * gridDim.x) {
    const int row0 = (tile / tiles_n) * TM, col0 = (tile % tiles_n) * TN;
    float w1 = 0.f, b1 = 0.f;  // this thread's column scale and bias
    if constexpr (EPI == I8_DEQUANT) {
      const int c = col0 + tid;
      if (c < p.N) {
        w1 = p.ws[c];
        if (p.bias != nullptr) b1 = p.bias[c];
      }
    }
    const int it0 = k * KT;
    if (k > 0) mbar_wait(&order[wg], (waits++) & 1);
    for (int kt = 0; kt < KT; ++kt)
      sm90::ring_consume<NST, TSTAGE>(full, empty, ring, it0 + kt, kt > 0,
                                      [&](uint32_t stage) {
        const uint64_t da0 = sm90::smem_desc(stage, 0, 1024);
        const uint64_t da1 = sm90::smem_desc(stage + 64 * 128, 0, 1024);
        const uint64_t db = sm90::smem_desc(stage + TA_BYTES, 0, 1024);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          wgmma_m64n128k32_s8(d0, da0 + ((kk * 32) >> 4), db + ((kk * 32) >> 4),
                              kt > 0 || kk > 0);
          wgmma_m64n128k32_s8(d1, da1 + ((kk * 32) >> 4), db + ((kk * 32) >> 4),
                              kt > 0 || kk > 0);
        }
      });
    if (tid == 0) mbar_arrive(&order[wg ^ 1]);
    sm90::wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it0 + KT - 1) % NST]);

    // d0/d1[4j], [4j+1] are row g, cols 8j+2t, 8j+2t+1; [4j+2], [4j+3] row g+8.
    float xs[4] = {0.f, 0.f, 0.f, 0.f};  // rows (m-half, g or g+8)
    if constexpr (EPI == I8_DEQUANT) {
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + (i / 2) * 64 + warp * 16 + g + 8 * (i % 2);
        if (r < p.M) xs[i] = p.xs[r];
      }
      wsb[tid] = w1;
      wsb[TN + tid] = b1;
    }
#pragma unroll
    for (int pass = 0; pass < TN / PASS_COLS; ++pass) {
      if (tid == 0) bulk_wait_read();
      sm90::named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < PASS_COLS / 8; ++jj) {
        const int j = pass * (PASS_COLS / 8) + jj;
        const int cp = 8 * jj + 2 * t;
        float2 w = make_float2(0.f, 0.f), bias = make_float2(0.f, 0.f);
        if constexpr (EPI == I8_DEQUANT) {
          w = *reinterpret_cast<const float2*>(wsb + 8 * j + 2 * t);
          bias = *reinterpret_cast<const float2*>(wsb + TN + 8 * j + 2 * t);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = i / 2, h = i % 2;
          unsigned char* dst = out + (m * NBC + cp / BOX_COLS) * BOX_BYTES +
                               swz128(warp * 16 + g + 8 * h, (cp % BOX_COLS) * ESZ);
          const int32_t a0 = m ? d1[4 * j + 2 * h] : d0[4 * j + 2 * h];
          const int32_t a1 = m ? d1[4 * j + 2 * h + 1] : d0[4 * j + 2 * h + 1];
          if constexpr (EPI == I8_INT32) {
            put2(dst, a0, a1);
          } else {
            float y0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), xs[i]), w.x);
            float y1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), xs[i]), w.y);
            if (p.bias != nullptr) {
              y0 = __fadd_rn(y0, bias.x);
              y1 = __fadd_rn(y1, bias.y);
            }
            put2(dst, from_float(y0, OutT()), from_float(y1, OutT()));
          }
        }
      }
      fence_proxy_async();
      sm90::named_sync(1 + wg, 128);
      if (tid == 0) {
        for (int b = 0; b < 2 * NBC; ++b)
          tma_store_2d(&map_c, out + b * BOX_BYTES,
                       col0 + pass * PASS_COLS + (b % NBC) * BOX_COLS,
                       row0 + (b / NBC) * 64);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait();
}

template <int EPI, typename OutT>
int launch_int8(const void* a, const void* bt, void* c, const Int8Params& p,
                void* stream) {
  CUtensorMap map_a, map_b, map_c;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(p.K), static_cast<uint64_t>(p.M)};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(p.K), static_cast<uint64_t>(p.N)};
  const uint64_t c_dims[2] = {static_cast<uint64_t>(p.N), static_cast<uint64_t>(p.M)};
  const uint64_t ab_strides[2] = {1, static_cast<uint64_t>(p.K)};
  const uint64_t c_strides[2] = {1, static_cast<uint64_t>(p.N)};
  const uint32_t a_box[2] = {BK, TM};
  const uint32_t b_box[2] = {BK, TN};
  const uint32_t c_box[2] = {128 / sizeof(OutT), 64};
  const CUtensorMapDataType c_type =
      sizeof(OutT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : EPI == I8_INT32 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode_i8_map(&map_a, a, 2, a_dims, ab_strides, a_box) ||
      !encode_i8_map(&map_b, bt, 2, b_dims, ab_strides, b_box) ||
      !encode_map(&map_c, c_type, sizeof(OutT), c, 2, c_dims, c_strides, c_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm<EPI, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((p.M + TM - 1) / TM) * ((p.N + TN - 1) / TN);
  const int ctas = (tiles + 1) / 2, sms = sm_count();  // two tiles a CTA at once
  int8_gemm<EPI, OutT><<<ctas < sms ? ctas : sms, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(map_a, map_b, map_c, p);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// xs[row] and xi[row, :] of one row of x [M, K] per warp; K % 32 == 0.
template <typename T>
__global__ void quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xi,
                              float* __restrict__ xs, int M, int K) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * K;
  float amax = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr + c));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(to_float(e[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  if (lane == 0) xs[row] = s;
  int8_t* qr = xi + static_cast<size_t>(row) * K;
  for (int c = lane * V; c < K; c += 32 * V) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr + c));
    const T* e = reinterpret_cast<const T*>(&u);
    uint32_t w[V / 4] = {};  // V int8 values, four a word
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(to_float(e[i]), s)), -127.f), 127.f);
      w[i / 4] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * (i % 4));
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(qr + c) = w[0];
  }
}

}  // namespace

// a [M, K] int8; bt [N, K] int8 (B transposed); c [M, N] int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_int8_matmul_fwd(const void* a, const void* bt, void* c,
                                       int M, int N, int K, void* stream) {
  const Int8Params p{nullptr, nullptr, nullptr, M, N, K};
  return launch_int8<I8_INT32, int32_t>(a, bt, c, p, stream);
}

// a [M, K] int8 (quantised rows); bt [N, K] int8; xs [M], ws [N] and bias
// [N] (or null) fp32; y [M, N] bf16 (out_bf16 = 1) or fp32 (0).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_int8_matmul_dequant_fwd(const void* a, const void* bt,
                                               const void* xs, const void* ws,
                                               const void* bias, void* y, int M,
                                               int N, int K, int out_bf16,
                                               void* stream) {
  const Int8Params p{static_cast<const float*>(xs), static_cast<const float*>(ws),
                     static_cast<const float*>(bias), M, N, K};
  return out_bf16 ? launch_int8<I8_DEQUANT, __nv_bfloat16>(a, bt, y, p, stream)
                  : launch_int8<I8_DEQUANT, float>(a, bt, y, p, stream);
}

// x [M, K] bf16 (in_bf16 = 1) or fp32 (0); xi [M, K] int8; xs [M] fp32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitlens_int8_quantize_fwd(const void* x, void* xi, void* xs,
                                         int M, int K, int in_bf16, void* stream) {
  constexpr int rows = 8;  // warps a block
  const dim3 grid((M + rows - 1) / rows), block(32 * rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    quantize_rows<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xi),
        static_cast<float*>(xs), M, K);
  else
    quantize_rows<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xi),
        static_cast<float*>(xs), M, K);
  return static_cast<int>(cudaGetLastError());
}
