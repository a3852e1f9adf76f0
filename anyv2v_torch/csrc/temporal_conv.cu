// K4 temporal_conv: out[b,f,p,:] = bias + sum_{d=0..2} h[b,f+d-1,p,:] @ W[d]
// with h = silu(x * s[b] + t[b]) rounded to bf16 (the groupnorm apply and
// SiLU as a prologue; skipped when s is null) and h = 0 outside [0, F).
// x [B, F, P, C] bf16, s/t [B, C] fp32, W [3, C, C'] bf16, bias [C'] bf16,
// fp32 accumulation; C and C' multiples of 8.
//
// Replaces anyv2v_tpu/ops/pallas_temporal_conv.py _tconv_kernel, which every
// TemporalConvLayer runs four times: C in {320, 640, 1280}, P in
// {4096, 1024, 256, 64}, F = 16 (128 on the long-video path); and 16/32 on
// the tiny archs, where P reaches 1, 4 and 16.
//
// What bounds it on the H100: it is one GEMM of [B*F*P, 3C] x [3C, C'],
// operations-bound (L2 at batch 3: 12288 rows, 2 * 12288 * 3840 * 1280 = 1.2e11
// FLOP, 0.122 ms at 989 TFLOP/s). Its prologue is not free: each x element
// feeds every output column tile of each of the three taps, so a kernel that
// applies it while staging A evaluates it 3 * ceil(C' / BN) times, each an
// evaluation of silu on the special-function units (16 a clock per SM).
//
// Design: hopper.cuh's warp-specialised main loop (gemm_main_loop) on its
// cooperative schedule: persistent blocks of 128-row tiles of 64..320 output
// columns (C' 320 in one tile, 640 in two, 1280 in four; 256 where that
// fills more of the card: the mid block's 120 tiles for 96), a 4-stage ring,
// two consumer warpgroups of 64 rows. The K loop runs over the three taps and
// C in slices of 64.
//  - B, a [64, BN] slice of W[d], comes by TMA in 128-byte-swizzled column
//    atoms of 64 (MN-major: W is C'-contiguous). The output is stored from
//    registers: at 320 columns the ring takes all but 2 KB of the block's
//    shared memory.
//  - A, the tap's x slice [128 rows, 64 channels] in the 128-byte swizzle,
//    comes by TMA from a 4-D map [B, F, P, C] where P % 128 == 0 (a tile is
//    then 128 pixels of one frame, and a frame outside [0, F) is a
//    coordinate outside the map, zero-filled); elsewhere (P < 128: the mid
//    block, the per-rank shapes, the tiny archs) the producer warpgroup
//    gathers it with cp.async, 16 bytes at a time (frames outside [0, F) and
//    rows past the end zero-filled), signalled on the same full barrier as
//    B's bytes (cp.async.mbarrier.arrive).
//  - The prologue runs as a kernel of its own before the GEMM
//    (temporal_conv_kernel_prologue): h = silu(x*s + t) in fp32, rounded to
//    bf16 (silu(v) = v/2 + v/2 * tanh(v/2): one tanh.approx an element),
//    once per x element, written to the caller's scratch; the GEMM's wgmma
//    then reads A (h) from shared memory.
// What bounds it, measured (scripts/torch_gemm_stamps.py and
// scripts/torch_attention_probe.py, H100, 700 W): fused, the prologue took
// 41-47 % of the consumers' cycles on the cooperative-only loop before this
// one, between a stage's arrival and the wgmma issue, with the tensor cores
// waiting, and ran 3 * ceil(C' / BN) times per x element (3 at C' 320, 6 at
// 640, 12 at 1280). Taken off that path inside
// the GEMM, it lost at this ring (4 stages of 56 KB): a producer-side
// transform rewriting each landed stage in place was 8 % slower than the
// register prologue at L1 batch 3 (0.425 against 0.393 ms), and as warps
// of their own 3x slower: a stage landed, one being rewritten and two in
// the consumers' wgmma leave the loads one stage in flight where the
// latency from L2 or HBM needs two or three. On its own the prologue costs
// h's round trip through HBM (4 bytes an element: 0.04 ms at L1 batch 3)
// and a launch, and is evaluated once: L1 batch 3 0.268 ms, L2 0.212 (0.393
// and 0.376 fused on this loop, 0.414 and 0.405 on the loop before). The
// GEMM itself is then K4's prologue-free form, 16-28 % faster than on the
// loop before (TMA A where P % 128 == 0, a producer with registers enough
// not to spill), and the mid block on 256-column tiles. Stamped on this
// loop (an instrumented copy): at L0 and L1 issuing wgmma takes 54-62 % of
// the consumers' cycles, the register stores of the epilogue 15-26 %,
// full-barrier waits 13-14 %; at the mid block (P 64, A gathered) full
// waits take 67 % and the producer issues its gathers 64 % of its cycles:
// there the cp.async gathers set the pace.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64, RING = 4;   // rows, depth and stages of the ring
constexpr int A_BYTES = BM * BK * 2;
constexpr int ROWS = BM / 16;                // tile rows per producer thread
constexpr int NO_FRAME = -(1 << 20);        // a row past the end: no tap reads it

// silu(x * s + t) of a bf16 pair in fp32, rounded to bf16: with v = (x*s +
// t) / 2, silu = v + v * tanh(v) (one tanh.approx an element).
__device__ __forceinline__ uint32_t silu2(uint32_t x, float s0, float s1, float t0, float t1) {
  const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float h0 = 0.5f * fmaf(x2.x, s0, t0), h1 = 0.5f * fmaf(x2.y, s1, t1);
  return pack_bf16(fmaf(h0, tanh_approx(h0), h0), fmaf(h1, tanh_approx(h1), h1));
}

struct Maps {
  CUtensorMap w, x;   // x: only where P % 128 == 0
};

// wgmma reads A (x, or h after the prologue kernel) from shared memory.
template <int BN>
struct TconvGemm {
  static constexpr bool PINGPONG = false;
  static constexpr int STAGES = RING;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int PRODUCER_THREADS = 128;
  // the gathering producer warpgroup spilled at 40 registers (the mid block
  // 0.0939 ms against 0.0736 at 96, where ptxas spills nothing)
  static constexpr int PRODUCER_REGS = 96, CONSUMER_REGS = 200;

  const CUtensorMap* w_map;
  const CUtensorMap* x_map;   // null: A is gathered
  const __nv_bfloat16* x;
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int F, P, C, Cout, M, col_tiles, kslices;

  __device__ int tiles() const { return (M + BM - 1) / BM * col_tiles; }
  __device__ int ksteps() const { return 3 * kslices; }

  // The producer warpgroup: thread 0 issues the TMA loads; where A is
  // gathered, thread tw gathers chunk tw % 8 (channels 8c..8c+7 of a slice)
  // of the tile rows tw / 8 + 16 i.
  struct Loader {
    const TconvGemm& g;
    const int tw;
    int m0 = 0, n0 = 0;
    int frame[ROWS];   // each gathered row's frame, NO_FRAME past the end

    __device__ Loader(const TconvGemm& g, int tw) : g(g), tw(tw) {}

    // The frames of this thread's rows: where P >= 16, stepping 16 rows at a
    // time from the first (two divisions a tile: a launch of one tile waits
    // on them), else a division each.
    __device__ void begin(int tile) {
      m0 = tile / g.col_tiles * BM;
      n0 = tile % g.col_tiles * BN;
      const int row0 = m0 + tw / 8;
      int p = row0 % g.P, f = row0 / g.P % g.F;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = row0 + 16 * i;
        if (g.P < 16) f = row / g.P % g.F;
        frame[i] = row < g.M ? f : NO_FRAME;
        if (g.P >= 16 && (p += 16) >= g.P) {
          p -= g.P;
          f = f + 1 == g.F ? 0 : f + 1;
        }
      }
    }

    // Step k is tap k / kslices, channels 64 * (k % kslices)... . The A tile
    // is [128 rows][64 channels], 128-byte rows with 16-byte chunk c of row r
    // at chunk c ^ (r % 8), as TMA's 128-byte swizzle writes it.
    __device__ void load(int k, unsigned char* stage, uint64_t* full) const {
      const int d = k / g.kslices, k0 = k % g.kslices * BK;
      if (tw == 0) {
        if (g.x_map != nullptr) {   // the tile is 128 pixels of one frame
          mbar_arrive_expect_tx(full, STAGE_BYTES);
          tma_load_4d(stage, g.x_map, full, k0, m0 % g.P, m0 / g.P % g.F + d - 1,
                      m0 / (g.F * g.P));
        } else {
          mbar_arrive_expect_tx(full, B_BYTES);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(stage + A_BYTES + j * BK * 128, g.w_map, full, n0 + 64 * j, k0, d);
      }
      if (g.x_map != nullptr) return;
      const int c = tw % 8, ch = k0 + 8 * c;
      const uint32_t a = smem_addr(stage);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = tw / 8 + 16 * i;
        const bool valid = (unsigned)(frame[i] + d - 1) < (unsigned)g.F && ch < g.C;
        const long long src = (long long)(m0 + r) + (long long)(d - 1) * g.P;
        cp_async16(a + r * 128 + ((c ^ (r % 8)) * 16), valid ? g.x + src * g.C + ch : g.x, valid);
      }
      cp_async_mbar_arrive(full);
    }
  };

  __device__ void consumers_done() const {}

  struct Consumer {
    const TconvGemm& g;
    int m0, n0, wg;
    float acc[BN / 2];

    __device__ Consumer(const TconvGemm& g, int tile, int wg)
        : g(g), m0(tile / g.col_tiles * BM), n0(tile % g.col_tiles * BN), wg(wg) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    }

    // wgmma reads this warpgroup's 64 rows of A and the stage's B slice from
    // shared memory.
    __device__ void mma(int k, const unsigned char* stage) {
      const uint32_t sa = smem_addr(stage), b = sa + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_t_width<BN>(acc, wgmma_desc_sw128(sa + wg * 64 * 128 + kk * 32, 16, 1024),
                             b + kk * 16 * 128, BK * 128, k > 0 || kk > 0);
      wgmma_commit();
    }

    __device__ void epilogue() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      const int tw = threadIdx.x % 128, lane = tw % 32, t = lane % 4;
      const int r0 = m0 + wg * 64 + (tw / 32) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.Cout) continue;
        const float2 b2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row < g.M)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (size_t)row * g.Cout + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] + b2.x, acc[4 * j + 2 * h + 1] + b2.y);
        }
      }
    }
  };
};

// The prologue on its own: h = silu(x * s[b] + t[b]) in fp32, rounded to
// bf16, 8 channels a thread, over all n8 = B * F * P * C / 8 chunks of x;
// the GEMM then reads h.
__global__ void __launch_bounds__(256) temporal_conv_kernel_prologue(
    const uint4* __restrict__ x, const float* __restrict__ s, const float* __restrict__ t,
    uint4* __restrict__ h, long long n8, int c8, int fp) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const long long row = i / c8;
  const int o = (int)(row / fp) * c8 * 8 + (int)(i - row * c8) * 8;
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + o));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + o + 4));
  const float4 t0 = __ldg(reinterpret_cast<const float4*>(t + o));
  const float4 t1 = __ldg(reinterpret_cast<const float4*>(t + o + 4));
  const uint4 v = x[i];
  h[i] = make_uint4(silu2(v.x, s0.x, s0.y, t0.x, t0.y), silu2(v.y, s0.z, s0.w, t0.z, t0.w),
                    silu2(v.z, s1.x, s1.y, t1.x, t1.y), silu2(v.w, s1.z, s1.w, t1.z, t1.w));
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1) temporal_conv_kernel(
    const __grid_constant__ Maps maps, bool tma_a, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int F, int P, int C,
    int Cout, int M, int col_tiles) {
  using Body = TconvGemm<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * Body::STAGE_BYTES);
  uint64_t* empty = full + RING;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      // TMA: the expect_tx arrival; gathers: 128 cp.async arrivals besides it
      mbar_init(&full[i], tma_a ? 1 : 1 + Body::PRODUCER_THREADS);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Body body{&maps.w, tma_a ? &maps.x : nullptr, x, bias, out, F, P, C, Cout, M,
                  col_tiles, (C + BK - 1) / BK};
  gemm_main_loop(body, smem, full, empty);
}

// The GEMM of a (x, or h after the prologue) [B, F, P, C] with W.
template <int BN>
cudaError_t launch(const void* a, const void* w, const void* bias, void* out, int B, int F,
                   int P, int C, int Cout, int M, int grid, int smem, cudaStream_t stream) {
  using Body = TconvGemm<BN>;
  const int col_tiles = (Cout + BN - 1) / BN;
  const long long tiles = (long long)(M + BM - 1) / BM * col_tiles;
  if (smem != gemm_smem_bytes(Body::STAGE_BYTES, RING, 0) || grid < 1 || grid > tiles)
    return cudaErrorInvalidValue;
  Maps maps;
  // W [3, C, C'] as a 3-D map, 128-byte-swizzled boxes of 64 rows of C by 64
  // columns of C'; rows past C and columns past C' read as zeros
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, 3};
  const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  if (!make_bf16_map(&maps.w, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // a [B, F, P, C] as a 4-D map, boxes of 128 pixels of one frame by 64
  // channels; channels past C and frames outside [0, F) read as zeros
  const bool tma_a = P % BM == 0;
  if (tma_a) {
    const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)F, (cuuint64_t)B};
    const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)P * C * 2,
                                    (cuuint64_t)F * P * C * 2};
    const cuuint32_t xbox[4] = {BK, BM, 1, 1};
    if (!make_bf16_map(&maps.x, a, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(temporal_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  temporal_conv_kernel<BN><<<grid, GEMM_THREADS, smem, stream>>>(
      maps, tma_a, (const __nv_bfloat16*)a, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, F,
      P, C, Cout, M, col_tiles);
  return cudaGetLastError();
}

}  // namespace

// The plan (ops/temporal_conv.py tconv_plan) gives the tile width `bn`
// (64..320 by 64), the grid and the shared bytes. Pointers 16-byte aligned;
// s, t and h all null (no prologue), or s and t [B, C] fp32 and h the
// caller's scratch of x's shape, which the prologue kernel fills for the
// GEMM to read.
extern "C" int anyv2v_temporal_conv(const void* x, const void* s, const void* t, void* h,
                                    const void* w, const void* bias, void* out, int B, int F,
                                    int P, int C, int Cout, int bn, int grid, int smem,
                                    void* stream) {
  const long long M = (long long)B * F * P;
  if (B <= 0 || F <= 0 || P <= 0 || C <= 0 || Cout <= 0 || C % 8 != 0 || Cout % 8 != 0 ||
      M > 0x7fffffffLL - 2 * BM || (s == nullptr) != (t == nullptr) ||
      (s == nullptr) != (h == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 64: case 128: case 192: case 256: case 320: break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (s != nullptr) {
    const long long n8 = M * C / 8;
    temporal_conv_kernel_prologue<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
        (const uint4*)x, (const float*)s, (const float*)t, (uint4*)h, n8, C / 8, F * P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    x = h;
  }
  switch (bn) {
#define ANYV2V_CASE(W) \
  case W: return (int)launch<W>(x, w, bias, out, B, F, P, C, Cout, (int)M, grid, smem, st);
    ANYV2V_CASE(64) ANYV2V_CASE(128) ANYV2V_CASE(192) ANYV2V_CASE(256) ANYV2V_CASE(320)
#undef ANYV2V_CASE
  }
  return (int)cudaErrorInvalidValue;
}
