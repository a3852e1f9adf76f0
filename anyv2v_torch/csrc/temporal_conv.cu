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
// applies it while staging A evaluates it 3 * ceil(C' / BN) times. The
// tensor cores spend 6 * C' operations on an x element, about 6 * C' / 4270
// clocks of one SM; an evaluation of silu with an exponential and a
// reciprocal is two special-function ops at 16 per clock per SM. At BN 64
// the prologue took about 4.2x the tensor-core time at every width.
//
// Design: hopper.cuh's warp-specialised main loop (gemm_main_loop):
// persistent blocks of 128-row tiles of up to BN = 320 output columns (C'
// 320 in one tile, 640 in two, 1280 in four), a 4-stage ring, two consumer
// warpgroups of 64 rows. The K loop runs over the three taps and C in slices
// of 64.
//  - B, a [64, BN] slice of W[d], comes by TMA in 128-byte-swizzled column
//    atoms of 64 (MN-major: W is C'-contiguous).
//  - A is gathered by the producer warpgroup with cp.async, 16 bytes at a
//    time, from per-row source offsets computed once per tile (the frame
//    shift is (d-1)*P rows; frames outside [0, F) and rows past the end are
//    zero-filled), and signalled on the same full barrier as B's bytes
//    (cp.async.mbarrier.arrive). A gather and not a TMA box: P can be smaller
//    than a tile (64 at the mid block, 1 on the tiny archs), so a tile spans
//    frames.
//  - The consumers ldmatrix the raw x slice, apply silu(x*s + t) in fp32 in
//    registers (silu(h) = h/2 + h/2 * tanh(h/2): one tanh.approx per element),
//    round to bf16, and feed the fragments to wgmma as its register A
//    operand; one 16-deep step's A serves the n256 and n64 products of all
//    320 columns. Rows whose source frame is outside [0, F) take s = t = 0,
//    so their zero-filled x stays 0 after the prologue (silu(0*s + t) != 0).
//    The next step's prologue runs while this step's products are in flight
//    (two register buffers).
// So each x element is evaluated 3 * ceil(C' / 320) times (3 at C' 320, 6 at
// 640, 12 at 1280; 15, 30 and 60 before), with one special-function op each.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64, RING = 4;   // rows, depth and stages of the ring
constexpr int A_BYTES = BM * BK * 2;
constexpr int ROW_SRC_BYTES = 3 * BM * 4;    // per tap and tile row: its source row, or -1

template <int BN>
struct TconvGemm {
  static constexpr int STAGES = RING;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 128 gathering threads' cp.async arrivals and the TMA thread's expect_tx
  static constexpr int FULL_ARRIVALS = 129, PRODUCER_THREADS = 128;

  const CUtensorMap* w_map;
  const __nv_bfloat16* x;
  const float* s;   // null: no prologue
  const float* t;
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int* row_src;     // shared [3][BM]
  int F, P, C, Cout, M, col_tiles, kslices;

  __device__ int tiles() const { return (M + BM - 1) / BM * col_tiles; }
  __device__ int ksteps() const { return 3 * kslices; }

  // Each producer thread writes its tile row's source row for every tap,
  // between two barriers of the producer warpgroup (the previous tile's
  // gathers have all been issued before the first).
  __device__ void begin_produce(int tile, int tw) const {
    named_barrier(1, 128);
    const int row = tile / col_tiles * BM + tw;
    const int bf = row / P, f = bf % F;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int fs = f + d - 1;
      row_src[d * BM + tw] = row < M && fs >= 0 && fs < F ? row + (d - 1) * P : -1;
    }
    named_barrier(1, 128);
  }

  // Step k is tap k / kslices, channels 64 * (k % kslices)... . The A tile is
  // [128 rows][64 channels], 128-byte rows with 16-byte chunk c of row r at
  // chunk c ^ (r % 8) (no bank conflicts for ldmatrix); thread tw gathers
  // chunk tw % 8 of rows tw / 8 + 16 i.
  __device__ void produce(int tile, int k, unsigned char* stage, uint64_t* full, int tw) const {
    const int d = k / kslices, k0 = k % kslices * BK;
    if (tw == 0) {
      const int n0 = tile % col_tiles * BN;
      mbar_arrive_expect_tx(full, B_BYTES);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load_3d(stage + A_BYTES + j * BK * 128, w_map, full, n0 + 64 * j, k0, d);
    }
    const int c = tw % 8, ch = k0 + 8 * c;
    const uint32_t a = smem_addr(stage);
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int r = tw / 8 + 16 * i;
      const int src = row_src[d * BM + r];
      const bool valid = src >= 0 && ch < C;
      cp_async16(a + r * 128 + ((c ^ (r % 8)) * 16),
                 valid ? x + (size_t)src * C + ch : x, valid);
    }
    cp_async_mbar_arrive(full);
  }

  __device__ void consumers_done() const {}

  struct Consumer {
    const TconvGemm& g;
    int m0, n0, wg;
    // this thread's two rows (g and g + 8 of its warp's 16): the offset of
    // their batch's s/t row, and per tap whether the source frame exists
    int st[2];
    unsigned valid[2];
    float acc[BN / 2];
    uint32_t a[2][BK / 16][4];   // two steps' A fragments

    __device__ Consumer(const TconvGemm& g, int tile, int wg)
        : g(g), m0(tile / g.col_tiles * BM), n0(tile % g.col_tiles * BN), wg(wg) {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * 64 + (threadIdx.x % 128 / 32) * 16 + lane / 4 + 8 * h;
        const int bf = row / g.P, f = bf % g.F;
        st[h] = bf / g.F * g.C;
        valid[h] = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (row < g.M && f + d - 1 >= 0 && f + d - 1 < g.F) valid[h] |= 1u << d;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    }

    // silu(x * s + t) of one bf16 pair of row h, channels ch and ch + 1.
    __device__ uint32_t prologue(uint32_t raw, int h, int d, int ch) const {
      float2 s2 = make_float2(0.f, 0.f), t2 = s2;
      if (((valid[h] >> d) & 1) && ch < g.C) {
        s2 = __ldg(reinterpret_cast<const float2*>(g.s + st[h] + ch));
        t2 = __ldg(reinterpret_cast<const float2*>(g.t + st[h] + ch));
      }
      const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
      const float h0 = 0.5f * fmaf(x2.x, s2.x, t2.x), h1 = 0.5f * fmaf(x2.y, s2.y, t2.y);
      return pack_bf16(fmaf(h0, tanh_approx(h0), h0), fmaf(h1, tanh_approx(h1), h1));
    }

    template <int BUF>
    __device__ void step(int k, const unsigned char* stage) {
      const int d = k / g.kslices, k0 = k % g.kslices * BK;
      const int lane = threadIdx.x % 32, t = lane % 4;
      const int rbase = wg * 64 + (threadIdx.x % 128 / 32) * 16;
      const uint32_t sa = smem_addr(stage);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // matrices: rows 0-7 / 8-15 of the warp's 16, channels 0-7 / 8-15 of the step
        const int q = lane / 8, r = rbase + (q & 1) * 8 + lane % 8, c = 2 * kk + (q >> 1);
        ldmatrix_x4(a[BUF][kk], sa + r * 128 + ((c ^ (r % 8)) * 16));
      }
      if (g.s != nullptr) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)   // (row g, ch 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
            a[BUF][kk][e] = prologue(a[BUF][kk][e], e & 1, d, k0 + kk * 16 + 2 * t + (e >> 1) * 8);
      }
      const uint32_t b = sa + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_width<BN>(acc, a[BUF][kk], b + kk * 16 * 128, BK * 128);
      wgmma_commit();
    }

    // The registers of step k's A stay untouched until its wgmmas are done:
    // the main loop waits for step k - 1's before step k + 1 is prepared.
    __device__ void mma(int k, const unsigned char* stage) {
      if (k & 1)
        step<1>(k, stage);
      else
        step<0>(k, stage);
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

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1) temporal_conv_kernel(
    const __grid_constant__ CUtensorMap w_map, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ s, const float* __restrict__ t,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int F, int P, int C,
    int Cout, int M, int col_tiles) {
  using Body = TconvGemm<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* row_src = reinterpret_cast<int*>(smem + RING * Body::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * Body::STAGE_BYTES + ROW_SRC_BYTES);
  uint64_t* empty = full + RING;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], Body::FULL_ARRIVALS);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Body body{&w_map, x, s, t, bias, out, row_src, F, P, C, Cout, M, col_tiles,
                  (C + BK - 1) / BK};
  gemm_main_loop(body, smem, full, empty);
}

template <int BN>
cudaError_t launch(const void* x, const void* s, const void* t, const void* w, const void* bias,
                   void* out, int F, int P, int C, int Cout, int M, int grid, int smem,
                   cudaStream_t stream) {
  using Body = TconvGemm<BN>;
  const int col_tiles = (Cout + BN - 1) / BN;
  const long long tiles = (long long)(M + BM - 1) / BM * col_tiles;
  if (smem != gemm_smem_bytes(Body::STAGE_BYTES, RING, ROW_SRC_BYTES) || grid < 1 ||
      grid > tiles)
    return cudaErrorInvalidValue;
  // W [3, C, C'] as a 3-D map, 128-byte-swizzled boxes of 64 rows of C by 64
  // columns of C'; rows past C and columns past C' read as zeros
  CUtensorMap w_map;
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, 3};
  const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  if (!make_bf16_map(&w_map, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(temporal_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  temporal_conv_kernel<BN><<<grid, GEMM_THREADS, smem, stream>>>(
      w_map, (const __nv_bfloat16*)x, (const float*)s, (const float*)t,
      (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, F, P, C, Cout, M, col_tiles);
  return cudaGetLastError();
}

}  // namespace

// The plan (ops/temporal_conv.py tconv_plan) gives the tile width `bn`
// (64..320 by 64), the grid and the shared bytes. Pointers 16-byte aligned;
// s and t both null (no prologue) or both [B, C] fp32.
extern "C" int anyv2v_temporal_conv(const void* x, const void* s, const void* t, const void* w,
                                    const void* bias, void* out, int B, int F, int P, int C,
                                    int Cout, int bn, int grid, int smem, void* stream) {
  const long long M = (long long)B * F * P;
  if (B <= 0 || F <= 0 || P <= 0 || C <= 0 || Cout <= 0 || C % 8 != 0 || Cout % 8 != 0 ||
      M > 0x7fffffffLL - 2 * BM || (s == nullptr) != (t == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
#define ANYV2V_CASE(W) \
  case W: return (int)launch<W>(x, s, t, w, bias, out, F, P, C, Cout, (int)M, grid, smem, st);
    ANYV2V_CASE(64) ANYV2V_CASE(128) ANYV2V_CASE(192) ANYV2V_CASE(256) ANYV2V_CASE(320)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
