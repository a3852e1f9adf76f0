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
// (gemm_main_loop), TMA feeding a ring of 128-byte-swizzled K-major stages 64
// deep, wgmma with both operands in shared memory and fp32 accumulators in
// registers, the bias read from shared memory (copied there once per block).
//  - Launch 1, x @ W1^T + b1 and the activation, on the loop's ping-pong
//    schedule. The loop before it ran launch 1 on 128 x 256 tiles shared by
//    both consumer warpgroups; measured (scripts/torch_gemm_stamps.py, H100, 700 W), its
//    consumers spent 49 % of their cycles at L0 in the GEGLU epilogue, which
//    at C 320 follows only 5 K steps and which both warpgroups ran at once
//    while the tensor cores waited (0.2826 ms; 0.130 with the epilogue
//    skipped). Now each consumer warpgroup owns whole tiles of 128 rows by
//    128 rows of W1 (GEGLU: 64 of v and the same 64 of g, two TMA boxes; GELU:
//    128 of them), two m64n128k16 wgmma per 16 of C into two accumulators,
//    and runs its tile's epilogue while the other warpgroup's products run
//    (launch 1 at L0: 0.238-0.245 ms against 0.283 cooperative, one call).
//    What bounds it now: a warpgroup's GEGLU of its 128 x 64 outputs takes
//    longer than the other's 5 K steps of products (the launch with the
//    GELU skipped: 0.185 ms). Stamped (scripts/torch_gemm_stamps.py on this
//    loop, an instrumented copy): the epilogue 52 % of the consumers' cycles
//    at L0 and 37 % at L1, the turn barrier 0.1-0.2 % and full-barrier
//    waits 5-6 %: the epilogues set the pace, not the loads. A launch of no
//    more tiles than SMs (the tiny archs) runs them on the cooperative
//    schedule instead: both warpgroups on each tile, 64 rows each, so that
//    no tile waits for a turn.
//    The epilogue computes h = v * gelu(g) or gelu(acc + b1) in fp32
//    (gelu_erf: erf to 1.5e-7 on the special-function units; erff made
//    launch 1 13 % slower at L0), stages h as bf16 in the warpgroup's own
//    128-byte-swizzled boxes of [128 rows, 64 columns] and stores it by TMA.
//    Tried and slower: the epilogue as a loop over column groups (0.316 ms
//    against 0.239: its accumulators picked by a switch), its gelu 8 values
//    at a time (equal), stages 32 deep with the 64-byte swizzle, 10 of them
//    (0.276).
//  - Launch 2, out = h @ W2^T + b2, on the cooperative schedule (its 20 K
//    steps a tile at I 1280 hide a bias epilogue): tiles of 128 rows by
//    64..320 columns (C 320 in one tile, so h is read once; 640 in two), the
//    output stored from registers (a 128 x 320 tile in shared memory would
//    take 80 KB of the ring that streams h). 0.114 ms at L0, against 0.127
//    with the bias read from global memory; an 8-stage ring of 32-deep
//    stages was slower (0.131). Stamped: issuing wgmma 61-67 % of the
//    consumers' cycles, full-barrier waits 13-15 %, the epilogue 9-17 %.
// The wrapper runs rows in chunks of at most 2^18, so h stays under 0.7 GB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64;           // rows and depth of a stage
constexpr int A_BYTES = BM * BK * 2;

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

// Launch 1: h = act(x @ W1^T + b1) over tiles of 128 rows by 128 rows of W1
// (GEGLU: v rows n0.., then g rows I + n0..; GELU: rows n0..). PP (ping-pong):
// each tile owned by one consumer warpgroup, 128 rows in two accumulators;
// else (a launch of no more tiles than SMs) both warpgroups on each tile, 64
// rows each. h [M, I] is stored by TMA.
template <int ACT, bool PP>
struct ActGemm {
  static constexpr bool PINGPONG = PP;
  static constexpr int BN = 128;                           // W1 rows per tile
  static constexpr int HCOLS = ACT == kGeglu ? 64 : 128;   // h columns per tile
  static constexpr int ROWS = PP ? BM : BM / 2;            // a warpgroup's rows of a tile
  static constexpr int STAGES = (ACT == kGeglu ? 5 : 4) + (PP ? 0 : 1);
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int STAGING_BYTES = ROWS * HCOLS * 2;   // one warpgroup's h
  static constexpr int EXTRA_BYTES = 2 * STAGING_BYTES;
  static constexpr int PRODUCER_THREADS = 1;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

  const CUtensorMap* a_map;   // x, boxes of [128 rows, 64]
  const CUtensorMap* b_map;   // W1, boxes of [64 rows, 64] (GEGLU) or [128 rows, 64]
  const CUtensorMap* o_map;   // h, boxes of [ROWS, 64]
  unsigned char* staging;     // [2 warpgroups][STAGING_BYTES]
  const __nv_bfloat16* bias;  // b1 in shared memory
  __nv_bfloat16* out;
  int M, K, I, col_tiles;

  __device__ int tiles() const { return (M + BM - 1) / BM * col_tiles; }
  __device__ int ksteps() const { return (K + BK - 1) / BK; }

  struct Loader {
    const ActGemm& g;
    int m0 = 0, n0 = 0;
    __device__ Loader(const ActGemm& g, int) : g(g) {}
    __device__ void begin(int tile) {
      m0 = tile / g.col_tiles * BM;
      n0 = tile % g.col_tiles * HCOLS;
    }
    __device__ void load(int k, unsigned char* stage, uint64_t* full) const {
      mbar_arrive_expect_tx(full, STAGE_BYTES);
      tma_load_2d(stage, g.a_map, full, k * BK, m0);
      tma_load_2d(stage + A_BYTES, g.b_map, full, k * BK, n0);
      if constexpr (ACT == kGeglu)
        tma_load_2d(stage + A_BYTES + 64 * 128, g.b_map, full, k * BK, g.I + n0);
    }
  };

  // The thread that issued a warpgroup's h stores waits for them at the end.
  __device__ void consumers_done() const {
    if (threadIdx.x % 128 == 0) bulk_wait();
  }

  struct Consumer {
    static constexpr int HALVES = ROWS / 64;   // m64n128 accumulators
    const ActGemm& g;
    int m0, n0, wg, r0;   // r0: the warpgroup's first row in the tile
    float acc[64 * HALVES];

    __device__ Consumer(const ActGemm& g, int tile, int wg)
        : g(g), m0(tile / g.col_tiles * BM), n0(tile % g.col_tiles * HCOLS), wg(wg),
          r0(PP ? 0 : wg * 64) {}

    __device__ void mma(int k, const unsigned char* stage) {
      const uint32_t a = smem_addr(stage) + r0 * 128, b = smem_addr(stage) + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int m = 0; m < HALVES; ++m)
          wgmma_ss_n128(acc + 64 * m, wgmma_desc_sw128(a + m * 64 * 128 + kk * 32, 16, 1024),
                        wgmma_desc_sw128(b + kk * 32, 16, 1024), k > 0 || kk > 0);
      wgmma_commit();
    }

    // Accumulator layout: 4 registers per 8 columns, (row g, col 2t),
    // (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of the warp's 16 rows of each half.
    // h = v * gelu(g + b1) (kGeglu) or gelu(acc + b1) (kGelu) is staged as
    // bf16 in the warpgroup's 128-byte-swizzled boxes of [ROWS, 64 columns],
    // then stored by TMA (which clips rows past M and columns past I); the
    // staging is reused once the previous tile's stores have read it.
    __device__ void epilogue() {
#pragma unroll
      for (int i = 0; i < 64 * HALVES; ++i) fence_operand(acc[i]);
      const int tw = threadIdx.x % 128, lane = tw % 32, t = lane % 4;
      unsigned char* st = g.staging + wg * STAGING_BYTES;
      const __nv_bfloat162* b1 = reinterpret_cast<const __nv_bfloat162*>(g.bias);
      if (tw == 0) bulk_wait_read();
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < HCOLS / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.I) continue;
        const float2 bv = __bfloat1622float2(b1[col / 2]);
        float2 bg = bv;
        if constexpr (ACT == kGeglu) bg = __bfloat1622float2(b1[(g.I + col) / 2]);
#pragma unroll
        for (int m = 0; m < HALVES; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m * 64 + (tw / 32) * 16 + lane / 4 + 8 * h;
            const float* v = acc + 64 * m + 4 * j + 2 * h;
            float y0, y1;
            if constexpr (ACT == kGeglu) {
              const float* gt = v + 32;   // the same columns of g: 64 columns on
              y0 = (v[0] + bv.x) * gelu_erf(gt[0] + bg.x);
              y1 = (v[1] + bv.y) * gelu_erf(gt[1] + bg.y);
            } else {
              y0 = gelu_erf(v[0] + bv.x);
              y1 = gelu_erf(v[1] + bv.y);
            }
            *reinterpret_cast<__nv_bfloat162*>(st + (j / 8) * (ROWS * 128) + r * 128 +
                                               (((j % 8) ^ (r % 8)) * 16) + 4 * t) =
                __floats2bfloat162_rn(y0, y1);
          }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tw == 0) {
#pragma unroll
        for (int box = 0; box < HCOLS / 64; ++box)
          tma_store_2d(g.o_map, st + box * (ROWS * 128), n0 + 64 * box, m0 + r0);
        bulk_commit();
      }
    }
  };
};

// Launch 2: out = h @ W2^T + b2 over tiles of 128 rows by BN columns, both
// consumer warpgroups on each tile (64 rows each), stored from registers.
template <int BN>
struct BiasGemm {
  static constexpr bool PINGPONG = false;
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int EXTRA_BYTES = 0;
  static constexpr int PRODUCER_THREADS = 1;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

  const CUtensorMap* a_map;   // h, boxes of [128 rows, 64]
  const CUtensorMap* b_map;   // W2, boxes of [64 rows, 64]
  const CUtensorMap* o_map;   // unused
  unsigned char* staging;     // unused
  const __nv_bfloat16* bias;  // b2 in shared memory
  __nv_bfloat16* out;
  int M, K, cols, col_tiles;

  __device__ int tiles() const { return (M + BM - 1) / BM * col_tiles; }
  __device__ int ksteps() const { return (K + BK - 1) / BK; }
  __device__ void consumers_done() const {}

  struct Loader {
    const BiasGemm& g;
    int m0 = 0, n0 = 0;
    __device__ Loader(const BiasGemm& g, int) : g(g) {}
    __device__ void begin(int tile) {
      m0 = tile / g.col_tiles * BM;
      n0 = tile % g.col_tiles * BN;
    }
    __device__ void load(int k, unsigned char* stage, uint64_t* full) const {
      mbar_arrive_expect_tx(full, STAGE_BYTES);
      tma_load_2d(stage, g.a_map, full, k * BK, m0);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load_2d(stage + A_BYTES + j * 64 * 128, g.b_map, full, k * BK, n0 + 64 * j);
    }
  };

  struct Consumer {
    const BiasGemm& g;
    int m0, n0, wg;
    float acc[BN / 2];

    __device__ Consumer(const BiasGemm& g, int tile, int wg)
        : g(g), m0(tile / g.col_tiles * BM), n0(tile % g.col_tiles * BN), wg(wg) {}

    __device__ void mma(int k, const unsigned char* stage) {
      const uint32_t a = smem_addr(stage) + wg * 64 * 128, b = smem_addr(stage) + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_width<BN>(acc, wgmma_desc_sw128(a + kk * 32, 16, 1024), b + kk * 32,
                           k > 0 || kk > 0);
      wgmma_commit();
    }

    // out = acc + b2 (rows past M, columns past C store nothing).
    __device__ void epilogue() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      const int tw = threadIdx.x % 128, lane = tw % 32, t = lane % 4;
      const int r0 = m0 + wg * 64 + (tw / 32) * 16 + lane / 4;
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(g.bias);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b = __bfloat1622float2(b2[col / 2]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row < g.M)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (size_t)row * g.cols + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
        }
      }
    }
  };
};

template <int BN, int ACT, bool PP>
using Gemm = std::conditional_t<ACT == kBias, BiasGemm<BN>, ActGemm<ACT, PP>>;

// The bias's shared bytes: `n` bf16, n % 8 == 0.
__host__ __device__ constexpr int bias_bytes(int n) { return n * 2; }

struct Maps {
  CUtensorMap a, b, o;
};

template <int BN, int ACT, bool PP>
__global__ void __launch_bounds__(GEMM_THREADS, 1) ffn_kernel(
    const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ bias, int bias_n,
    __nv_bfloat16* __restrict__ out, int M, int K, int cols, int col_tiles) {
  using Body = Gemm<BN, ACT, PP>;
  constexpr int S = Body::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = smem + S * Body::STAGE_BYTES;
  __nv_bfloat16* bias_s = reinterpret_cast<__nv_bfloat16*>(staging + Body::EXTRA_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(bias_s) + bias_bytes(bias_n));
  uint64_t* empty = full + S;
  for (int i = threadIdx.x; i < bias_bytes(bias_n) / 16; i += GEMM_THREADS)
    reinterpret_cast<uint4*>(bias_s)[i] = reinterpret_cast<const uint4*>(bias)[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Body::PINGPONG ? 4 : 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Body body{&maps.a, &maps.b, &maps.o, staging, bias_s, out, M, K, cols, col_tiles};
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

// One launch: a [M, K] against b [n_rows, K] into `cols` output columns; the
// plan's schedule (PP: ping-pong), grid and shared bytes, refused unless they
// match this body (a grid of at most one block per unit; launch 1 on the
// ping-pong schedule exactly where its tiles outnumber the grid).
template <int BN, int ACT, bool PP = false>
cudaError_t launch(const void* a, const void* b, int n_rows, const void* bias, int bias_n,
                   void* out, int M, int K, int cols, int grid, int smem, cudaStream_t stream) {
  using Body = Gemm<BN, ACT, PP>;
  constexpr int tile_cols = ACT == kBias ? BN : ActGemm<ACT, PP>::HCOLS;
  const int col_tiles = (cols + tile_cols - 1) / tile_cols;
  const long long tiles = (long long)(M + BM - 1) / BM * col_tiles;
  if (ACT != kBias && PP != (tiles > grid)) return cudaErrorInvalidValue;
  const long long units = PP ? (tiles + 1) / 2 : tiles;
  if (smem != gemm_smem_bytes(Body::STAGE_BYTES, Body::STAGES,
                              Body::EXTRA_BYTES + bias_bytes(bias_n)) ||
      grid < 1 || grid > units)
    return cudaErrorInvalidValue;
  Maps maps;
  const int box_rows = ACT == kGeglu ? 64 : ACT == kGelu ? 128 : 64;
  if (!make_map(&maps.a, a, M, K, BM) || !make_map(&maps.b, b, n_rows, K, box_rows) ||
      (ACT != kBias && !make_map(&maps.o, out, M, cols, PP ? BM : BM / 2)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<BN, ACT, PP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ffn_kernel<BN, ACT, PP><<<grid, GEMM_THREADS, smem, stream>>>(
      maps, (const __nv_bfloat16*)bias, bias_n, (__nv_bfloat16*)out, M, K, cols, col_tiles);
  return cudaGetLastError();
}

// Both launches over N rows, launch 1 in the given form: h [N, I] is the
// caller's scratch. The plan (ops/ffn.py ffn_plan) gives launch 1's schedule
// (`pingpong1`), launch 2's width `bn` (64..320 by 64) and each launch's
// grid and shared bytes. Pointers 16-byte aligned, C % 8 == 0.
cudaError_t ffn(bool gelu, const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* h, void* out, int N, int C, int I, int pingpong1, int bn,
                int grid1, int smem1, int grid2, int smem2, cudaStream_t s) {
  if (N <= 0 || C <= 0 || C > 768 || C % 8 != 0 || I <= 0 || I % 64 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (gelu)
    err = pingpong1 ? launch<128, kGelu, true>(x, w1, I, b1, I, h, N, C, I, grid1, smem1, s)
                    : launch<128, kGelu>(x, w1, I, b1, I, h, N, C, I, grid1, smem1, s);
  else
    err = pingpong1
              ? launch<128, kGeglu, true>(x, w1, 2 * I, b1, 2 * I, h, N, C, I, grid1, smem1, s)
              : launch<128, kGeglu>(x, w1, 2 * I, b1, 2 * I, h, N, C, I, grid1, smem1, s);
  if (err != cudaSuccess) return err;
  switch (bn) {
#define ANYV2V_CASE(W) \
  case W: return launch<W, kBias>(h, w2, C, b2, C, out, N, I, C, grid2, smem2, s);
    ANYV2V_CASE(64) ANYV2V_CASE(128) ANYV2V_CASE(192) ANYV2V_CASE(256) ANYV2V_CASE(320)
#undef ANYV2V_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The GEGLU form: w1 [2I, C], b1 [2I].
extern "C" int anyv2v_ffn_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* h, void* out, int N, int C, int I,
                                int pingpong1, int bn, int grid1, int smem1, int grid2,
                                int smem2, void* stream) {
  return (int)ffn(false, x, w1, b1, w2, b2, h, out, N, C, I, pingpong1, bn, grid1, smem1, grid2,
                  smem2, (cudaStream_t)stream);
}

// The GELU form: w1 [I, C], b1 [I].
extern "C" int anyv2v_ffn_gelu(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* h, void* out, int N, int C, int I,
                               int pingpong1, int bn, int grid1, int smem1, int grid2,
                               int smem2, void* stream) {
  return (int)ffn(true, x, w1, b1, w2, b2, h, out, N, C, I, pingpong1, bn, grid1, smem1, grid2,
                  smem2, (cudaStream_t)stream);
}
