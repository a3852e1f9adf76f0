// K5 flash_attention: softmax(q k^T * scale + bias) v with an fp32 online
// softmax, heads folded into the channel dim: q [B, Sq, H*DH], k/v
// [B, Sk, H*DH], bf16 in and out. Optional score bias (fp32, [H, Sq, Sk]
// shared by the batch, or [B, H, Sq, Sk]), added after the scale. Optional
// split-KV (never with a bias): a second K/V source kc/vc
// [B / frames, Sk2, H*DH] that query row b reads at b / frames, under the
// same softmax as the row's own keys.
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_attention.py       _flash_kernel         (split-head flash, with
//                                                    its additive bias; here
//                                                    the temporal transformer's
//                                                    cross-attention, Sq 17*HW,
//                                                    SEINE's spatial self-
//                                                    attention, and any biased
//                                                    attention outside the
//                                                    frame kernels' class)
//   pallas_attention.py       _flash_splitkv_kernel (ConsistI2V first-frame
//                                                    concat self-attention)
//   pallas_cross_attention.py _cross_kernel         (long queries over short
//                                                    K/V, Sk <= 512: one source
//                                                    body, Sk masked per tile)
// The TPU versions transposed [B,S,H,D] -> [B*H,S,D] in device memory before
// each call (pallas_attention.py:300-308). Here TMA reads the folded layout in
// place, and the split-KV context is indexed by row, so the repeated
// first-frame keys are never built.
//
// What bounds it on the H100: operations. The L0 split-KV call of an edit
// step is 51 rows x 5 heads x 4096 queries x 8192 keys x 64 x 4 = 2.2e12
// FLOP (2.2 ms at 989 TFLOP/s) against 0.55 GB of operands (0.16 ms at
// 3.35 TB/s), and 8.6e9 exponentials (2.1 ms at the special-function units'
// 16 per clock per SM): at head width 64 the softmax costs as much as the
// products. The full tensor-core rate is wgmma's, fed from shared memory by
// TMA without register traffic; 128 query rows per block halve the K/V
// rereads of 64-row blocks (17.1 GB from L2 at L0 split-KV).
//
// Design (every head width that is a multiple of 8 up to 128, and 160, takes
// this one body; the odd multiples of 8 run it with the score depth padded to
// 16): a block of three warpgroups owns 128 query rows of one (batch row,
// head).
//  - Producer (warpgroup 2, one thread): TMA loads of Q once and of 128-key
//    K/V tiles into a ring of 3 stages (2 at dh 160) guarded by mbarriers
//    (full: bytes landed; empty: all 8 consumer warps done), first the row's
//    own keys and then, in split-KV mode, the context row b / frames. Its
//    registers go to the consumers (setmaxnreg 40 / 232).
//  - Consumers (warpgroups 0 and 1, 64 query rows each, so each K/V tile is
//    read once per 128 rows): S = Q.K^T by wgmma m64n128k16 with Q and K in
//    shared memory; the online softmax in registers in the exp2 domain, keys
//    past each source's end at -inf; P packed to bf16 as the register A
//    operand of a second wgmma against V in shared memory (transposed B, N =
//    DH split into 128/64/32/16/8-wide instructions).
//  - Layout: no swizzle. Each tile is stored as 8-channel column chunks of
//    16-byte rows ([chunk][row][8]), so every 8x8 core matrix is 128
//    contiguous bytes; one TMA box of [rows, 8 channels] per chunk, from a
//    3-D tensor map over [B, S, C] whose row bound zero-fills past a batch
//    row's end without reading the next row. A box never spans more than its
//    own head's channels: at dh 8, 24, 40, ... the score depth's pad chunk is
//    zero in Q and K, written once before the pipeline starts.
//  - Output: normalised, staged as bf16 in the warpgroup's own Q rows, then
//    stored with 16-byte stores; query rows past Sq store nothing.
//  - Bias (a template flag, so the unbiased instances compile as before):
//    each consumer thread reads its own accumulator fragment's bias values
//    (2 rows x 64 keys of a tile) straight from global memory after the
//    score wgmma, and the softmax runs on s * scale * log2e + bias * log2e
//    (the row maxima can no longer be taken on the raw scores). Nothing is
//    staged, so shared memory is as without a bias (a 128x128 fp32 tile
//    would not fit beside dh 160's ring). Rows past Sq read row Sq - 1 (their
//    outputs are never stored), keys past Sk are never read. Bytes: the bias
//    is read once per block, so a bias shared by the batch is read B times
//    from HBM (the grid's batch index is its slowest): at SEINE's L0 self
//    shape, 48 rows x 8 heads x 4096^2 x 4 bytes = 25.8 GB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;        // keys per K/V tile
constexpr int THREADS = 384;   // consumers 0-255, producer 256-383
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // 128*40 + 256*232 <= 65536

// Shared tiles are stored as 8-channel column chunks of 16-byte rows,
// [chunk][row][8]: every 8x8 core matrix of wgmma's no-swizzle layout is 128
// contiguous bytes, and each chunk is one TMA box of [rows, 8 channels].
template <int DH>
struct Cfg {
  static constexpr int DP = (DH + 15) / 16 * 16;   // Q.K^T depth, padded to 16
  static constexpr int QCH = DP / 8;               // chunks of Q and K
  static constexpr int VCH = DH / 8;               // of V, and loaded of each
  static constexpr int STAGES = DH > 80 ? 2 : 3;
  static constexpr int Q_BYTES = QCH * BQ * 16;
  static constexpr int K_BYTES = QCH * BK * 16;
  static constexpr int V_BYTES = VCH * BK * 16;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 128;   // + alignment slack
  static constexpr int TX = 2 * VCH * BK * 16;                        // bytes per K/V stage
};

// O[64 x DH] += P[64 x 16] . V[16 x DH] for one 16-key step of a V tile at
// `vaddr` (MN-major: 8-key groups 128 bytes apart, channel chunks BK*16),
// DH split greedily into instructions of width 128/64/32/16/8 from column C0
// on (40 = 32 + 8, 80 = 64 + 16, 160 = 128 + 32); each piece's accumulators
// follow the previous piece's, 4 registers per 8 columns.
template <int DH, int C0 = 0>
__device__ __forceinline__ void pv_step(float* o, const uint32_t (&a)[4], uint32_t vaddr) {
  using namespace hopper;
  static_assert(DH % 8 == 0 && DH <= 160, "head widths: multiples of 8 up to 160");
  constexpr int R = DH - C0;
  if constexpr (R > 0) {
    constexpr int N = R >= 128 ? 128 : R >= 64 ? 64 : R >= 32 ? 32 : R >= 16 ? 16 : 8;
    const uint64_t d = wgmma_desc(vaddr + (C0 / 8) * BK * 16, 128, BK * 16);
    if constexpr (N == 128) {
      wgmma_rs_n128(o + C0 / 2, a, d);
    } else if constexpr (N == 64) {
      wgmma_rs_n64(o + C0 / 2, a, d);
    } else if constexpr (N == 32) {
      wgmma_rs_n32(o + C0 / 2, a, d);
    } else if constexpr (N == 16) {
      wgmma_rs_n16(o + C0 / 2, a, d);
    } else {
      wgmma_rs_n8(o + C0 / 2, a, d);
    }
    pv_step<DH, C0 + N>(o, a, vaddr);
  }
}

// The online softmax of one score tile of a warpgroup (64 rows x 128 keys;
// this thread's rows g and g+8 of its warp's 16, keys 2t, 2t+1 of each 8):
// keys >= n masked, the row maxima taken on the raw scores (scale > 0) and
// kept in raw units, s overwritten by the fp32 numerators exp2((s - m) *
// scale_log2), the sums updated; c0, c1 are the factors by which the rows'
// earlier sums and output shrink.
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int n, float scale_log2,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& c0, float& c1) {
  using hopper::ex2;
  const int t = threadIdx.x % 4;
  if (n < BK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if ((i / 4) * 8 + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
  }
  float mx0 = fmaxf(m0, hopper::tile_max(s, 0)), mx1 = fmaxf(m1, hopper::tile_max(s, 2));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds at least one key, so the new maxima are finite
  c0 = ex2((m0 - mx0) * scale_log2);
  c1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float o0 = -mx0 * scale_log2, o1 = -mx1 * scale_log2;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt * 4 + 0] = ex2(fmaf(s[nt * 4 + 0], scale_log2, o0));
    s[nt * 4 + 1] = ex2(fmaf(s[nt * 4 + 1], scale_log2, o0));
    s[nt * 4 + 2] = ex2(fmaf(s[nt * 4 + 2], scale_log2, o1));
    s[nt * 4 + 3] = ex2(fmaf(s[nt * 4 + 3], scale_log2, o1));
    r0 += s[nt * 4 + 0] + s[nt * 4 + 1];
    r1 += s[nt * 4 + 2] + s[nt * 4 + 3];
  }
  l0 = l0 * c0 + r0;
  l1 = l1 * c1 + r1;
}

// The score tile in the exp2 domain with its bias: s * scale_log2 + bias *
// log2e for this thread's rows (ba, bb: the bias rows of g and g+8) and keys
// below n; keys >= n are left for softmax_tile to mask.
__device__ __forceinline__ void add_bias(float (&s)[BK / 2], const float* __restrict__ ba,
                                         const float* __restrict__ bb, int n, float scale_log2) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int key = (i / 4) * 8 + 2 * t + (i & 1);
    if (key < n) s[i] = fmaf(s[i], scale_log2, LOG2E * __ldg((i & 2 ? bb : ba) + key));
  }
}

// The numerators as bf16 A fragments: a 16-key step pairs two 8-key tiles.
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    pa[nt / 2][(nt % 2) * 2 + 0] = hopper::pack_bf16(s[nt * 4 + 0], s[nt * 4 + 1]);
    pa[nt / 2][(nt % 2) * 2 + 1] = hopper::pack_bf16(s[nt * 4 + 2], s[nt * 4 + 3]);
  }
}

// The TMA maps of q, k, v, kc, vc.
struct Maps {
  CUtensorMap q, k, v, kc, vc;
};

// bias: [H, Sq, Sk] per batch row, `bias_stride` floats apart (0: shared by
// the batch); read only by the BIAS instances.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(
    const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o,
    const float* __restrict__ bias, long long bias_stride, int Sq, int Sk, int Sk2,
    int frames, int C, float scale_log2) {
  using namespace hopper;
  using F = Cfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  unsigned char* qs = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
  uint64_t* empty = full + F::STAGES;
  uint64_t* qbar = empty + F::STAGES;

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BQ;
  const int tiles1 = (Sk + BK - 1) / BK;
  const int tiles = tiles1 + (Sk2 + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  if constexpr (F::QCH > F::VCH) {   // the zero pad chunk of the score depth (dh 8, 24, 40, ...)
    for (int e = threadIdx.x; e < BQ + F::STAGES * BK; e += THREADS) {
      unsigned char* dst = e < BQ ? qs + F::VCH * BQ * 16 + e * 16
                                  : smem + F::K_OFF + ((e - BQ) / BK) * F::K_BYTES +
                                        F::VCH * BK * 16 + ((e - BQ) % BK) * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // the warpgroup index, warp-uniform to the compiler (setmaxnreg needs
  // branches it can tell apart)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 2) {
    // ---- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int c0 = h * DH;
      mbar_arrive_expect_tx(qbar, F::VCH * BQ * 16);
      for (int c = 0; c < F::VCH; ++c)
        tma_load_3d(qs + c * BQ * 16, &maps.q, qbar, c0 + c * 8, r0, b);
      for (int tile = 0; tile < tiles; ++tile) {
        const int stage = tile % F::STAGES, round = tile / F::STAGES;
        if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
        const bool own = tile < tiles1;
        const int k0 = (own ? tile : tile - tiles1) * BK, bb = own ? b : b / frames;
        const CUtensorMap* mk = own ? &maps.k : &maps.kc;
        const CUtensorMap* mv = own ? &maps.v : &maps.vc;
        unsigned char* ks = smem + F::K_OFF + stage * F::K_BYTES;
        unsigned char* vs = smem + F::V_OFF + stage * F::V_BYTES;
        mbar_arrive_expect_tx(&full[stage], F::TX);
        for (int c = 0; c < F::VCH; ++c) {
          tma_load_3d(ks + c * BK * 16, mk, &full[stage], c0 + c * 8, k0, bb);
          tma_load_3d(vs + c * BK * 16, mv, &full[stage], c0 + c * 8, k0, bb);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tw = threadIdx.x % 128, lane = tw % 32;
    const uint32_t q_addr = smem_addr(qs) + role * 64 * 16;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // this thread's bias rows g and g+8 (rows past Sq read row Sq - 1)
    const float *bias_a = nullptr, *bias_b = nullptr;
    if constexpr (BIAS) {
      const int ra = r0 + role * 64 + (tw / 32) * 16 + lane / 4;
      const float* bh = bias + b * bias_stride + (size_t)h * Sq * Sk;
      bias_a = bh + (size_t)min(ra, Sq - 1) * Sk;
      bias_b = bh + (size_t)min(ra + 8, Sq - 1) * Sk;
    }

    mbar_wait(qbar, 0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int stage = tile % F::STAGES;
      const int n = tile < tiles1 ? min(BK, Sk - tile * BK) : min(BK, Sk2 - (tile - tiles1) * BK);
      const uint32_t k_addr = smem_addr(smem + F::K_OFF + stage * F::K_BYTES);
      const uint32_t v_addr = smem_addr(smem + F::V_OFF + stage * F::V_BYTES);
      mbar_wait(&full[stage], (tile / F::STAGES) & 1);

      // S = Q K^T: 64 rows x 128 keys per warpgroup (K-major: 8-row groups
      // 128 bytes apart, channel chunks BQ*16 or BK*16)
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::DP / 16; ++kk)
        wgmma_ss_n128(s, wgmma_desc(q_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                      wgmma_desc(k_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(s[i]);

      float c0, c1;
      if constexpr (BIAS) {   // one key source: the tile's keys start at tile * BK
        add_bias(s, bias_a + tile * BK, bias_b + tile * BK, n, scale_log2);
        softmax_tile(s, n, 1.f, m0, m1, l0, l1, c0, c1);
      } else {
        softmax_tile(s, n, scale_log2, m0, m1, l0, l1, c0, c1);
      }
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        acc[i + 0] *= c0;
        acc[i + 1] *= c0;
        acc[i + 2] *= c1;
        acc[i + 3] *= c1;
      }
      uint32_t pa[BK / 16][4];
      pack_p(s, pa);

      // O += P V
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        if (kk * 16 < n) pv_step<DH>(acc, pa[kk], v_addr + kk * 16 * 16);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    // stage the bf16 output in this warpgroup's own Q rows ([chunk][row][8]),
    // then store whole rows with 16-byte stores; rows past Sq store nothing
    const int g = lane / 4, t = lane % 4, ra = role * 64 + (tw / 32) * 16 + g;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      unsigned char* dst = qs + n * BQ * 16 + ra * 16 + 4 * t;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[n * 4 + 0] * i0, acc[n * 4 + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * 16) =
          __floats2bfloat162_rn(acc[n * 4 + 2] * i1, acc[n * 4 + 3] * i1);
    }
    named_barrier(1 + role, 128);
    __nv_bfloat16* ob = o + (size_t)b * Sq * C + h * DH;
    for (int e = tw; e < 64 * F::VCH; e += 128) {
      const int row = e / F::VCH, c = e % F::VCH, grow = r0 + role * 64 + row;
      if (grow < Sq)
        *reinterpret_cast<uint4*>(ob + (size_t)grow * C + c * 8) =
            *reinterpret_cast<const uint4*>(qs + c * BQ * 16 + (role * 64 + row) * 16);
    }
  }
}

// A 3-D map over a bf16 [B, S, C] tensor, boxes of [rows, 8 channels];
// rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int C, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)S * C * 2};
  const cuuint32_t box[3] = {8, (cuuint32_t)rows, 1};
  return hopper::make_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DH, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kc,
                   const void* vc, void* o, const float* bias, long long bias_stride, int B,
                   int Sq, int Sk, int Sk2, int frames, int H, float scale, cudaStream_t stream) {
  const int C = H * DH;
  Maps maps;
  if (!make_map(&maps.q, q, B, Sq, C, BQ) || !make_map(&maps.k, k, B, Sk, C, BK) ||
      !make_map(&maps.v, v, B, Sk, C, BK))
    return cudaErrorInvalidValue;
  if (Sk2 > 0) {
    if (!make_map(&maps.kc, kc, B / frames, Sk2, C, BK) ||
        !make_map(&maps.vc, vc, B / frames, Sk2, C, BK))
      return cudaErrorInvalidValue;
  } else {   // never read: no context tiles
    maps.kc = maps.k;
    maps.vc = maps.v;
  }
  const int smem = Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DH, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<DH, BIAS><<<grid, THREADS, smem, stream>>>(
      maps, (__nv_bfloat16*)o, bias, bias_stride, Sq, Sk, Sk2, frames, C,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// kc/vc may be null with Sk2 == 0; bias null, or contiguous fp32 [H, Sq, Sk]
// (bias_per_batch 0) or [B, H, Sq, Sk] (1), never with Sk2 > 0. Every
// pointer 16-byte aligned, rows contiguous with stride H*DH; scale > 0.
// smem_bytes is ops/flash_attention.py's plan, refused unless it matches this
// file's layout.
extern "C" int anyv2v_flash_attention(const void* q, const void* k, const void* v,
                                      const void* kc, const void* vc, void* o,
                                      const void* bias, int bias_per_batch,
                                      int B, int Sq, int Sk, int Sk2, int frames,
                                      int H, int DH, float scale, int smem_bytes,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Sk2 < 0 || H <= 0 ||
      H > 65535 || frames <= 0 || B % frames != 0 || !(scale > 0.f) ||
      (Sk2 > 0 && (kc == nullptr || vc == nullptr)) || (bias != nullptr && Sk2 > 0))
    return (int)cudaErrorInvalidValue;
  const float* bf = (const float*)bias;
  const long long stride = bias_per_batch ? (long long)H * Sq * Sk : 0;
  switch (DH) {
#define ANYV2V_CASE(D)                                                                         \
  case D:                                                                                      \
    if (smem_bytes != Cfg<D>::SMEM) return (int)cudaErrorInvalidValue;                         \
    return bf ? (int)launch<D, true>(q, k, v, kc, vc, o, bf, stride, B, Sq, Sk, Sk2, frames, H, \
                                     scale, s)                                                 \
              : (int)launch<D, false>(q, k, v, kc, vc, o, bf, 0, B, Sq, Sk, Sk2, frames, H,     \
                                      scale, s);
    ANYV2V_CASE(8) ANYV2V_CASE(16) ANYV2V_CASE(24) ANYV2V_CASE(32) ANYV2V_CASE(40)
    ANYV2V_CASE(48) ANYV2V_CASE(56) ANYV2V_CASE(64) ANYV2V_CASE(72) ANYV2V_CASE(80)
    ANYV2V_CASE(88) ANYV2V_CASE(96) ANYV2V_CASE(104) ANYV2V_CASE(112) ANYV2V_CASE(120)
    ANYV2V_CASE(128) ANYV2V_CASE(160)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
