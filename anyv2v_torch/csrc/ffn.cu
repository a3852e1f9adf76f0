// K3 ffn: out = h @ W2^T + b2 for x [N, C] bf16, in one of two forms:
//  - GEGLU: h = v * gelu(g), [v, g] = x @ W1^T + b1, W1 [2I, C], b1 [2I];
//  - GELU:  h = gelu(x @ W1^T + b1), W1 [I, C], b1 [I];
// W2 [C, I], b2 [C] (torch Linear layouts), exact-erf GELU, fp32
// accumulation, h rounded to bf16 before the second product, bf16 out.
//
// Replaces anyv2v_tpu/ops/pallas_ffn.py _ffn_kernel, both branches: GEGLU
// routed at C = 320 (L0), 640 (L1) and 512 (transformer_in), and at C = 32 on
// the tiny archs; GELU wherever a GELU-form FeedForward fits (C <= 768, C % 32
// == 0; no configuration of the repo has one).
//
// What bounds it on the H100: operations. At L0 of an inversion step (65536
// rows, C 320, I 1280) the two GEGLU products are 6 * 65536 * 320 * 1280 =
// 1.6e11 FLOP, 0.16 ms at 989 TFLOP/s (the GELU form 4 * N * C * I); x and out
// are 84 MB (0.025 ms at 3.35 TB/s).
// The Pallas kernel keeps the intermediate on chip because W1 and W2 stay
// resident in 16 MB of VMEM. A Hopper block cannot hold them (227 KB of
// shared memory), so a fused form streams them once per row tile: 24 * C^2 *
// N / BM bytes, with the row tile BM capped by the fp32 [BM, C] output
// accumulator in registers (256 KB per SM) at 128 rows for C 320 and 64 for
// C 640. The two-GEMM form instead writes h [N, I] in bf16 and reads it back:
// 16 * C * N bytes.
//
//   case          fused form, weight re-reads (L2)   two GEMMs, h round trip (HBM)
//   L0 (C 320)    1.26 GB at BM 128                  0.34 GB
//   L1 (C 640)    2.5 GB at BM 64                    0.17 GB
//
// So K3 is two GEMMs. The fp32 pre-activation, which the Pallas kernel
// exists to keep out of HBM, still never reaches it: h is the tensor that the
// Pallas body and the plain path round to bf16 at the same point.
//
// Design: both launches run hopper.cuh's warp-specialised main loop
// (gemm_main_loop): persistent blocks of 128-row tiles, a TMA producer
// filling a 4-stage ring of 128-byte-swizzled K-major tiles (64 deep: x or h
// [128, 64], and the weight rows), two consumer warpgroups of 64 rows issuing
// wgmma with both operands in shared memory and fp32 accumulators in
// registers.
//  - Launch 1, GEGLU: [v | g] = x @ W1^T + b1, each tile's 256 columns are
//    128 of v and the same 128 of g (two TMA boxes, W1 rows i0.. and I+i0..),
//    one m64n256k16 wgmma per 16 of C; the epilogue computes h = v * gelu(g).
//    GELU: each tile is 128 columns of x @ W1^T from one box of W1 rows i0..,
//    one m64n128k16 wgmma per 16 of C; the epilogue computes h = gelu(acc +
//    b1). Either epilogue runs in fp32 (gelu_erf: erf to 1.5e-7 on the
//    special-function units; erff made launch 1 13 % slower at L0 on an
//    H100), stages h as bf16 in shared memory and stores it by TMA (4-byte
//    stores from the accumulator layout made it another 20 % slower). At C
//    320 a tile has only 5 K steps, so the epilogue, which the consumers run
//    between tiles while the tensor cores wait, is what bounds launch 1.
//  - Launch 2, out = h @ W2^T + b2: tiles of 64..320 columns (C 320 in one
//    tile, so h is read once; 640 in two), the epilogue adds b2.
// The wrapper runs rows in chunks of at most 2^18, so h stays under 0.7 GB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64, RING = 4;   // rows, depth and stages of the ring
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGING_BYTES = BM * 128 * 2;   // launch 1: the tile's h, [128 rows, 128]

// What a GEMM's epilogue computes: launch 2's bias, or launch 1's activation.
enum Act : int { kBias = 0, kGeglu = 1, kGelu = 2 };

// GELU's exact-erf form, 0.5 g (1 + erf(g / sqrt 2)), with erf by Abramowitz
// and Stegun 7.1.26 (|error| <= 1.5e-7): 1 - erf(|x|) = poly(t) exp(-x^2),
// t = 1 / (1 + p |x|), on the special-function units (one reciprocal, one
// exp2) and without erff's branches. For x < 0 the factor 1 + erf(x) is
// poly(t) exp(-x^2) itself, so the negative tail keeps its relative accuracy.
__device__ __forceinline__ float gelu_erf(float g) {
  const float x = g * 0.70710678118654752f, ax = fabsf(x);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(t) : "f"(fmaf(0.3275911f, ax, 1.f)));
  float poly = fmaf(1.061405429f, t, -1.453152027f);
  poly = fmaf(poly, t, 1.421413741f);
  poly = fmaf(poly, t, -0.284496736f);
  poly = fmaf(poly, t, 0.254829592f);
  const float q = poly * t * hopper::ex2(-x * x * 1.4426950408889634f);
  return 0.5f * g * (x < 0.f ? q : 2.f - q);
}

// One GEMM of K3, rows of A [M, K] against rows of B (K-major), both by TMA.
// kGeglu: B is W1, a tile's BN = 256 columns are v and g of 128 h columns;
// kGelu: B is W1, a tile's BN = 128 columns are 128 h columns; both epilogues
// store h [M, cols = I]. kBias: B is W2, the epilogue adds the bias and
// stores out [M, cols = C].
template <int BN, int ACT>
struct FfnGemm {
  static constexpr bool STAGED = ACT != kBias;   // h staged and stored by TMA
  static constexpr int STAGES = RING;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int FULL_ARRIVALS = 1, PRODUCER_THREADS = 1;
  static constexpr int BOX_ROWS = STAGED ? 128 : 64;   // B rows per TMA box
  static constexpr int TILE_COLS = ACT == kGeglu ? BN / 2 : BN;   // output columns per tile

  const CUtensorMap* a_map;
  const CUtensorMap* b_map;
  const CUtensorMap* o_map;   // launch 1: h, boxes of [64 rows, 64]
  unsigned char* staging;     // launch 1: [2 warpgroups][2 boxes][64 rows][128 bytes]
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int M, K, cols, col_tiles;

  __device__ int tiles() const { return (M + BM - 1) / BM * col_tiles; }
  __device__ int ksteps() const { return (K + BK - 1) / BK; }
  __device__ void begin_produce(int, int) const {}

  __device__ void produce(int tile, int k, unsigned char* stage, uint64_t* full, int) const {
    const int m0 = tile / col_tiles * BM, n0 = tile % col_tiles * TILE_COLS;
    mbar_arrive_expect_tx(full, STAGE_BYTES);
    tma_load_2d(stage, a_map, full, k * BK, m0);
#pragma unroll
    for (int j = 0; j < BN / BOX_ROWS; ++j)   // GEGLU: v rows n0.., then g rows I + n0..
      tma_load_2d(stage + A_BYTES + j * BOX_ROWS * 128, b_map, full, k * BK,
                  ACT == kGeglu ? j * cols + n0 : n0 + j * BOX_ROWS);
  }

  // The thread that issued a warpgroup's h stores waits for them at the end.
  __device__ void consumers_done() const {
    if (STAGED && threadIdx.x % 128 == 0) bulk_wait();
  }

  struct Consumer {
    const FfnGemm& g;
    int m0, n0, wg;
    float acc[BN / 2];

    __device__ Consumer(const FfnGemm& g, int tile, int wg)
        : g(g), m0(tile / g.col_tiles * BM), n0(tile % g.col_tiles * TILE_COLS), wg(wg) {}

    __device__ void mma(int k, const unsigned char* stage) {
      const uint32_t a = smem_addr(stage) + wg * 64 * 128, b = smem_addr(stage) + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_width<BN>(acc, wgmma_desc_sw128(a + kk * 32, 16, 1024), b + kk * 32,
                           k > 0 || kk > 0);
      wgmma_commit();
    }

    // Accumulator layout: 4 registers per 8 columns, (row g, col 2t),
    // (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of the warp's 16 rows.
    __device__ void epilogue() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if constexpr (STAGED)
        act_epilogue();
      else
        bias_epilogue();
    }

    // out = acc + b2, stored from registers (rows past M, columns past C
    // store nothing).
    __device__ void bias_epilogue() {
      const int tw = threadIdx.x % 128, lane = tw % 32, t = lane % 4;
      const int r0 = m0 + wg * 64 + (tw / 32) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row < g.M)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (size_t)row * g.cols + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
        }
      }
    }

    // h = v * gelu(g) (kGeglu) or gelu(acc + b1) (kGelu) staged as bf16 in the
    // warpgroup's two 128-byte-swizzled boxes of [64 rows, 64 columns], then
    // stored by TMA (which clips rows past M and columns past I); the staging
    // is reused once the previous tile's stores have read it.
    __device__ void act_epilogue() {
      const int tw = threadIdx.x % 128, lane = tw % 32, t = lane % 4;
      unsigned char* st = g.staging + wg * (STAGING_BYTES / 2);
      if (tw == 0) bulk_wait_read();
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < TILE_COLS / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
        float2 b1 = b0;
        if constexpr (ACT == kGeglu)
          b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + g.cols + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (tw / 32) * 16 + lane / 4 + 8 * h;
          const float* v = acc + 4 * j + 2 * h;
          float y0, y1;
          if constexpr (ACT == kGeglu) {
            const float* gt = acc + 4 * (j + TILE_COLS / 8) + 2 * h;
            y0 = (v[0] + b0.x) * gelu_erf(gt[0] + b1.x);
            y1 = (v[1] + b0.y) * gelu_erf(gt[1] + b1.y);
          } else {
            y0 = gelu_erf(v[0] + b0.x);
            y1 = gelu_erf(v[1] + b0.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(st + (j / 8) * 8192 + r * 128 +
                                             (((j % 8) ^ (r % 8)) * 16) + 4 * t) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tw == 0) {
        tma_store_2d(g.o_map, st, n0, m0 + wg * 64);
        tma_store_2d(g.o_map, st + 8192, n0 + 64, m0 + wg * 64);
        bulk_commit();
      }
    }
  };
};

struct Maps {
  CUtensorMap a, b, o;
};

template <int BN, int ACT>
__global__ void __launch_bounds__(GEMM_THREADS, 1) ffn_kernel(
    const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int M, int K, int cols, int col_tiles) {
  using Body = FfnGemm<BN, ACT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = smem + RING * Body::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + (Body::STAGED ? STAGING_BYTES : 0));
  uint64_t* empty = full + RING;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], Body::FULL_ARRIVALS);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Body body{&maps.a, &maps.b, &maps.o, staging, bias, out, M, K, cols, col_tiles};
  gemm_main_loop(body, smem, full, empty);
}

// A 2-D map over a bf16 [rows, width] tensor, 128-byte-swizzled boxes of
// [box_rows, 64].
bool make_map(CUtensorMap* map, const void* ptr, int rows, int width, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  return make_bf16_map(map, ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// One launch: a [M, K] against b [n_rows, K]; the plan's grid and shared
// bytes, refused unless they match this body.
template <int BN, int ACT>
cudaError_t launch(const void* a, const void* b, int n_rows, const void* bias, void* out, int M,
                   int K, int cols, int grid, int smem, cudaStream_t stream) {
  using Body = FfnGemm<BN, ACT>;
  const int col_tiles = (cols + Body::TILE_COLS - 1) / Body::TILE_COLS;
  const long long tiles = (long long)(M + BM - 1) / BM * col_tiles;
  if (smem != gemm_smem_bytes(Body::STAGE_BYTES, RING, Body::STAGED ? STAGING_BYTES : 0) ||
      grid < 1 ||
      grid > tiles)
    return cudaErrorInvalidValue;
  Maps maps;
  if (!make_map(&maps.a, a, M, K, BM) || !make_map(&maps.b, b, n_rows, K, Body::BOX_ROWS) ||
      (Body::STAGED && !make_map(&maps.o, out, M, cols, 64)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<BN, ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ffn_kernel<BN, ACT><<<grid, GEMM_THREADS, smem, stream>>>(
      maps, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, M, K, cols, col_tiles);
  return cudaGetLastError();
}

// Both launches over N rows, launch 1 in the given form: h [N, I] is the
// caller's scratch. The plan (ops/ffn.py ffn_plan) gives launch 2's width
// `bn` (64..320 by 64) and each launch's grid and shared bytes. Pointers
// 16-byte aligned, C % 8 == 0.
cudaError_t ffn(bool gelu, const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* h, void* out, int N, int C, int I, int bn, int grid1,
                int smem1, int grid2, int smem2, cudaStream_t s) {
  if (N <= 0 || C <= 0 || C > 768 || C % 8 != 0 || I <= 0 || I % 64 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = gelu ? launch<128, kGelu>(x, w1, I, b1, h, N, C, I, grid1, smem1, s)
                         : launch<256, kGeglu>(x, w1, 2 * I, b1, h, N, C, I, grid1, smem1, s);
  if (err != cudaSuccess) return err;
  switch (bn) {
#define ANYV2V_CASE(W) \
  case W: return launch<W, kBias>(h, w2, C, b2, out, N, I, C, grid2, smem2, s);
    ANYV2V_CASE(64) ANYV2V_CASE(128) ANYV2V_CASE(192) ANYV2V_CASE(256) ANYV2V_CASE(320)
#undef ANYV2V_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The GEGLU form: w1 [2I, C], b1 [2I].
extern "C" int anyv2v_ffn_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* h, void* out, int N, int C, int I, int bn,
                                int grid1, int smem1, int grid2, int smem2, void* stream) {
  return (int)ffn(false, x, w1, b1, w2, b2, h, out, N, C, I, bn, grid1, smem1, grid2, smem2,
                  (cudaStream_t)stream);
}

// The GELU form: w1 [I, C], b1 [I].
extern "C" int anyv2v_ffn_gelu(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* h, void* out, int N, int C, int I, int bn,
                               int grid1, int smem1, int grid2, int smem2, void* stream) {
  return (int)ffn(true, x, w1, b1, w2, b2, h, out, N, C, I, bn, grid1, smem1, grid2, smem2,
                  (cudaStream_t)stream);
}
