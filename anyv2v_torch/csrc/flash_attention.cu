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
//                                                    SEINE's and the editors'
//                                                    self-attention, and any
//                                                    biased attention outside
//                                                    the frame kernels' class)
//   pallas_attention.py       _flash_splitkv_kernel (ConsistI2V first-frame
//                                                    concat self-attention)
//   pallas_cross_attention.py _cross_kernel         (long queries over short
//                                                    K/V: every cross-attention
//                                                    over 77 text tokens, the
//                                                    IP adapter's 4 keys)
// The TPU versions transposed [B,S,H,D] -> [B*H,S,D] in device memory before
// each call (pallas_attention.py:300-308). Here TMA reads the folded layout in
// place, and the split-KV context is indexed by row, so the repeated
// first-frame keys are never built.
//
// What bounds it on the H100 (80GB HBM3, 700 W; scripts/torch_flash_stamps.py
// sums clock64 cycles by phase in an instrumented copy, --loads stamps each
// K/V copy, --short the one-key-tile body; PERF.md section 6), by class:
//  - long self-attention and split-KV (the tiles body below): the softmax and
//    the K/V stream. The operations bound is 2.2 ms at ConsistI2V's L0
//    split-KV (51 rows x 5 heads x 4096 queries x 8192 keys x 64 x 4 FLOP),
//    the exponentials' 2.0 ms (16 per clock per SM); at head width 40 (SEINE)
//    the exponentials' 1.54 ms is the larger. Each consumer warpgroup spends
//    45-51 % of its cycles in the softmax of its 64 x 128 tile (one warp per
//    SM sub-partition: latency-bound) and about 14 % of a step (about 420 of
//    2,900 cycles) waiting for K, in the steady state: a copy takes about 2.9
//    steps from issue to landing and is issued about 2.75 ahead. Issuing K
//    and V each as far ahead as its own ring allows, or a fifth stage, did
//    not shorten the waits (the copies then took longer: the blocks stream
//    K/V from L2 at 32 KB a 128 x 128 step, about 2.8 TB/s over 132 SMs);
//    three consumer warpgroups on 192-row items (a third fewer bytes a
//    score) lost to ptxas's register handling of the wgmma pipeline.
//  - the one-key-tile class without a bias (the short body, below the tiles
//    body): bytes, Q read and O written once (0.08 ms at ConsistI2V's L0
//    spatial and temporal cross-attention), against each head's chain of a
//    score product, one softmax, P.V and the stores: the softmax takes
//    25-29 % of the consumers' cycles and the stores 16-26 %, the Q chunk
//    waits 6-14 % (the producer waits for free Q slots 44-77 % of its time).
//  - a call whose items leave the card under one wave (the editors' small
//    calls): the launch and the first loads; 64-row items double the blocks.
//  - a score bias: its bytes (4 per score, 25.8 GB read by the blocks at
//    SEINE's L0 self with a bias shared by the batch, from L2 once HBM has
//    given it once); the softmax with the bias's loads is 70-72 % of the
//    consumers' cycles.
//
// Design of the tiles body (every head width that is a multiple of 8 up to
// 128, and 160, takes it; the odd multiples of 8 run it with the score depth padded to
// 16; everything below the head width and the bias flag is a run-time field
// of the launch plan, ops/flash_attention.py flash_plan, which the entry
// checks against this file's layout):
//  - Persistent blocks: a grid of at most one block per SM walks work items
//    (a tile of 64 or 128 query rows, a head, a batch row). Barrier set-up
//    and the score-depth pad are done once per block. The walk is strided
//    (block x takes items x, x + grid, ...), so the blocks in flight read
//    neighbouring items' K/V from L2, with the query tile fastest, or the
//    batch row fastest where a bias is shared by the batch (the blocks in
//    flight then read the same bias rows, which come from HBM about once).
//  - Warp specialisation: a producer warp (one thread issuing TMA) runs
//    ahead across items, filling a ring of Q tiles and a ring of 128-key K
//    and V tiles with separate full/empty mbarriers for K and V, so that K's
//    slot is free once the score product has read it. One consumer
//    warpgroup per 64 query rows: two for 128-row items, one for 64-row
//    items (taken where 128-row items would leave the card under one wave,
//    or where they do not fit beside two K/V stages). The consumers poll
//    the full barriers (test_wait) rather than sleep on them (try_wait).
//  - TMA: at head widths 64 and 128, Q, K and V are 128-byte-swizzled
//    tiles ([64-channel chunk][row][128 bytes]), one 3-D box a chunk, read
//    by swizzled wgmma descriptors; at the other widths one 4-D box per tile
//    ([chunks, rows, 8] over the folded [B, S, C] seen as [B, C / 8, S, 8])
//    lands as the unswizzled [chunk][row][8] tile below.
//  - The softmax overlapped with the products: a consumer issues tile j's
//    score wgmma and tile j-1's P.V wgmma together, waits for the scores
//    only, and runs tile j's softmax (fp32, exp2 domain) while P.V runs; P
//    is packed to bf16 as the register A operand of the next P.V (up to head
//    width 88 and without a bias: P's 32 registers held through the softmax
//    fit the 168 a thread has only there; elsewhere P.V is waited for first).
//    P.V covers the whole tile: a conditional wgmma would be a commit group
//    of its own to ptxas and turn the wait for the scores into a wait for
//    everything. The two consumer warpgroups of a 128-row item take turns to
//    issue their products (ping-pong on named barriers).
//  - K/V resident for a one-tile key axis (Sk <= 128, no context): the walk
//    is then a contiguous run of items per block, query tile fastest, and a
//    (batch row, head)'s K/V tile is loaded once for all of the run's items
//    that share it; Q tiles stream through a ring of up to 4.
//  - Output: normalised, staged as bf16 in the warpgroup's own staging
//    buffer and written by a TMA store (rows past Sq are clipped), which
//    runs while the next item computes.
//  - Bias (a template flag, so the unbiased instances carry none of it):
//    each consumer thread reads its accumulator fragment's values (2 rows x
//    64 keys of a tile) from global memory after the score wait, as float2
//    where Sk is even, and the softmax runs on s * scale * log2e + bias *
//    log2e. Rows past Sq read row Sq - 1 (their outputs are never stored),
//    keys past Sk are never read.
//  - Layout without swizzle (and of the output's staging at every width):
//    8-channel column chunks of 16-byte rows ([chunk][row][8]), so every 8x8
//    core matrix is 128 contiguous bytes. Rows past a batch row's end read
//    as zeros, without reading the next row. At dh 8, 24, 40, ... the score
//    depth's pad chunk is zero in Q and K, written once per block.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 128;            // keys per K/V tile
// two consumer warpgroups and a producer warp. ptxas compiles a kernel to
// 65536 / threads registers a thread (168 here); setmaxnreg would give the
// consumers more (hopper.cuh), but a producer warpgroup at 40 / 232, or
// three consumer warpgroups at 24 / 160 up to head width 64, measured
// 1.1-1.8x slower (PERF.md section 6): ptxas still serialised the wgmmas for
// "insufficient register resources" (C7512) and spilled, now at 135-219
// registers. So the consumers' tiles are sized for 168.
constexpr int MAX_THREADS = 288;
constexpr int MAX_STAGES = 4;      // of the Q ring and of the K/V ring
constexpr int BARRIER_BYTES = 256, ALIGN_SLACK = 1024;   // the swizzle atom
constexpr int SMEM_LIMIT = 232448;

// Unswizzled tiles are stored as 8-channel column chunks of 16-byte rows,
// [chunk][row][8]: every 8x8 core matrix of wgmma's no-swizzle layout is 128
// contiguous bytes.
template <int DH>
struct Cfg {
  static constexpr int DP = (DH + 15) / 16 * 16;   // Q.K^T depth, padded to 16
  static constexpr int QCH = DP / 8;               // chunks of Q and K
  static constexpr int VCH = DH / 8;               // of V, and loaded of each
  // at the multiples of 64 (64, 128) Q, K and V are 128-byte-swizzled tiles
  // instead, [64-channel chunk][row][128 bytes], one TMA box a chunk: a
  // copy then reads whole 128-byte row pieces, not 16-byte ones
  static constexpr bool SW = DH % 64 == 0;
  // a tile's softmax runs while the previous tile's P.V does: P's registers
  // stay held through the softmax, which 168 registers a thread allow up to
  // head width 88 and not with the bias's 64 more
  template <bool BIAS>
  static constexpr bool OVERLAP = !BIAS && DH <= 88;
};

// The shared memory of one launch, in bytes from the 128-aligned base: the Q
// ring, the K ring, the V ring, the output staging (64 rows per consumer
// warpgroup), the barriers. ops/flash_attention.py flash_layout_bytes is the
// same formula.
struct Layout {
  int q_bytes, k_bytes, v_bytes, q_off, k_off, v_off, o_off, bar_off, total;
};

inline Layout make_layout(int dh, int tile_rows, int q_stages, int kv_stages) {
  const int dp = (dh + 15) / 16 * 16;
  Layout l;
  l.q_bytes = tile_rows * dp * 2;
  l.k_bytes = BK * dp * 2;
  l.v_bytes = BK * dh * 2;
  l.q_off = 0;
  l.k_off = q_stages * l.q_bytes;
  l.v_off = l.k_off + kv_stages * l.k_bytes;
  l.o_off = l.v_off + kv_stages * l.v_bytes;
  l.bar_off = l.o_off + tile_rows * dh * 2;
  l.total = l.bar_off + BARRIER_BYTES + ALIGN_SLACK;
  return l;
}

// The TMA maps of q, k, v, kc, vc (loads) and o (stores), the shapes, and the
// launch plan's fields.
struct Params {
  CUtensorMap q, k, v, kc, vc, o;
  const float* bias;
  long long bias_stride;   // floats between batch rows' biases; 0: shared
  int B, H, Sq, Sk, Sk2, frames;
  float scale_log2;
  int tile_rows;       // 64 or 128: one consumer warpgroup per 64
  int q_stages, kv_stages;
  int resident;        // one K/V tile per (batch row, head), kept for a run of items
  int batch_fastest;   // item order: batch row fastest (else query tile fastest)
  int qtiles, items;
  Layout lay;
};

struct Item {
  int b, h, r0;
};

__device__ __forceinline__ Item item_of(const Params& p, int it) {
  int b, h, qt;
  if (p.batch_fastest) {
    b = it % p.B;
    const int r = it / p.B;
    qt = r % p.qtiles;
    h = r / p.qtiles;
  } else {
    qt = it % p.qtiles;
    const int r = it / p.qtiles;
    h = r % p.H;
    b = r / p.H;
  }
  return {b, h, qt * p.tile_rows};
}

// A block's items: a contiguous run in resident mode (consecutive items
// share their K/V), else every gridDim.x-th from blockIdx.x.
struct Walk {
  int begin, end, step;
};

__device__ __forceinline__ Walk walk_of(const Params& p) {
  if (p.resident)
    return {(int)((long long)blockIdx.x * p.items / gridDim.x),
            (int)((long long)(blockIdx.x + 1) * p.items / gridDim.x), 1};
  return {(int)blockIdx.x, p.items, (int)gridDim.x};
}

// S = Q K^T: 64 rows x 128 keys of a warpgroup, K-major, channel chunks
// `q_chunk` (Q) or a K tile's chunk apart; no swizzle: 8-channel chunks,
// 8-row groups 128 bytes apart; swizzled: 64-channel chunks, 8-row atoms
// 1024 bytes apart, 16 channels 32 bytes on. Issued, not waited.
template <int DH>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint32_t q_addr, int q_chunk,
                                             uint32_t k_addr) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < Cfg<DH>::DP / 16; ++kk) {
    if constexpr (Cfg<DH>::SW) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss_n128(s, wgmma_desc_sw128(q_addr + c * q_chunk + off, 16, 1024),
                    wgmma_desc_sw128(k_addr + c * BK * 128 + off, 16, 1024), kk > 0);
    } else {
      wgmma_ss_n128(s, wgmma_desc(q_addr + kk * 2 * q_chunk, q_chunk, 128),
                    wgmma_desc(k_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
    }
  }
  wgmma_commit();
}

// O += P V over the whole tile (past the tile's keys P is 0 and V's rows
// are TMA's zero fill); issued, not waited. No step is conditional: ptxas
// makes each conditional wgmma a group of its own, and then a wait for all
// but the newest group waits for the P.V that should run on.
// Swizzled V (MN-major): a 16-key step is 16 rows of 128 bytes on, the
// 64-channel chunks a tile's chunk apart.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_addr) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (Cfg<DH>::SW) {
      const uint64_t d = wgmma_desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
      if constexpr (DH == 128) {
        wgmma_rs_n128(acc, pa[kk], d);
      } else {
        wgmma_rs_n64(acc, pa[kk], d);
      }
    } else {
      pv_step<DH>(acc, pa[kk], v_addr + kk * 16 * 16, BK * 16);
    }
  }
  wgmma_commit();
}

// The online softmax of one score tile of a warpgroup (64 rows x 128 keys;
// this thread's rows g and g+8 of its warp's 16, keys 2t, 2t+1 of each 8):
// keys >= n masked, the row maxima taken on the raw scores (scale > 0) and
// kept in raw units, s overwritten by the fp32 numerators exp2((s - m) *
// scale_log2), the sums updated; c0, c1 are the factors by which the rows'
// earlier sums and output shrink. 8-key groups wholly past n take no
// exponential.
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int n, float scale_log2,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& c0, float& c1) {
  using hopper::ex2;
  if (n < BK) hopper::mask_keys(s, n);
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
  if (n == BK) {   // a whole tile: no branch between the exponentials
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt * 4 + 0] = ex2(fmaf(s[nt * 4 + 0], scale_log2, o0));
      s[nt * 4 + 1] = ex2(fmaf(s[nt * 4 + 1], scale_log2, o0));
      s[nt * 4 + 2] = ex2(fmaf(s[nt * 4 + 2], scale_log2, o1));
      s[nt * 4 + 3] = ex2(fmaf(s[nt * 4 + 3], scale_log2, o1));
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      if (nt * 8 < n) {
        s[nt * 4 + 0] = ex2(fmaf(s[nt * 4 + 0], scale_log2, o0));
        s[nt * 4 + 1] = ex2(fmaf(s[nt * 4 + 1], scale_log2, o0));
        s[nt * 4 + 2] = ex2(fmaf(s[nt * 4 + 2], scale_log2, o1));
        s[nt * 4 + 3] = ex2(fmaf(s[nt * 4 + 3], scale_log2, o1));
      } else {
        s[nt * 4 + 0] = s[nt * 4 + 1] = s[nt * 4 + 2] = s[nt * 4 + 3] = 0.f;
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    r0 += s[nt * 4 + 0] + s[nt * 4 + 1];
    r1 += s[nt * 4 + 2] + s[nt * 4 + 3];
  }
  l0 = l0 * c0 + r0;
  l1 = l1 * c1 + r1;
}

// This thread's bias values of one tile into `bv` (the accumulator
// fragment's order): rows `ra` and `rb` (pointers to the tile's first key),
// keys below n; the rest are left 0 for softmax_tile to mask. `pairs`: Sk is
// even, so keys 2t and 2t+1 are one aligned float2.
__device__ __forceinline__ void load_bias(float (&bv)[BK / 2], const float* __restrict__ ra,
                                          const float* __restrict__ rb, int n, bool pairs) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    const int key = nt * 8 + 2 * t;
    float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if (pairs) {
      if (key < n) {
        a = __ldg(reinterpret_cast<const float2*>(ra + key));
        b = __ldg(reinterpret_cast<const float2*>(rb + key));
      }
    } else {
      if (key < n) {
        a.x = __ldg(ra + key);
        b.x = __ldg(rb + key);
      }
      if (key + 1 < n) {
        a.y = __ldg(ra + key + 1);
        b.y = __ldg(rb + key + 1);
      }
    }
    bv[nt * 4 + 0] = a.x;
    bv[nt * 4 + 1] = a.y;
    bv[nt * 4 + 2] = b.x;
    bv[nt * 4 + 3] = b.y;
  }
}

// The score tile in the exp2 domain with its bias: s * scale_log2 + bias *
// log2e for keys below n; keys >= n are left for softmax_tile to mask.
__device__ __forceinline__ void add_bias(float (&s)[BK / 2], const float (&bv)[BK / 2], int n,
                                         float scale_log2) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int key = (i / 4) * 8 + 2 * t + (i & 1);
    if (key < n) s[i] = fmaf(s[i], scale_log2, LOG2E * bv[i]);
  }
}

// Pins the accumulators and P's fragments before a wgmma fence, so that
// their writes (the rescale, the packing) stay ahead of it.
template <int DH>
__device__ __forceinline__ void fence_pv_operands(float (&acc)[DH / 2],
                                                  uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) hopper::fence_operand(acc[i]);
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) hopper::fence_operand(pa[i][r]);
}

template <int DH, bool BIAS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    flash_attention_kernel(const __grid_constant__ Params p) {
  using namespace hopper;
  using F = Cfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout& L = p.lay;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t *qfull = bars, *qempty = bars + MAX_STAGES;
  uint64_t *kfull = bars + 2 * MAX_STAGES, *kempty = bars + 3 * MAX_STAGES;
  uint64_t *vfull = bars + 4 * MAX_STAGES, *vempty = bars + 5 * MAX_STAGES;
  const int TR = p.tile_rows, QS = p.q_stages, KS = p.kv_stages;
  const int nc = TR / 64;   // consumer warpgroups

  if (threadIdx.x == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 4 * nc);   // one arrival per consumer warp
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4 * nc);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4 * nc);
    }
    mbar_fence_init();
  }
  if constexpr (F::QCH > F::VCH) {   // the zero pad chunk of the score depth (dh 8, 24, 40, ...)
    const int qrows = QS * TR, rows = qrows + KS * BK;
    for (int e = threadIdx.x; e < rows; e += blockDim.x) {
      unsigned char* dst =
          e < qrows ? smem + L.q_off + (e / TR) * L.q_bytes + F::VCH * TR * 16 + (e % TR) * 16
                    : smem + L.k_off + ((e - qrows) / BK) * L.k_bytes + F::VCH * BK * 16 +
                          ((e - qrows) % BK) * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  const Walk w = walk_of(p);
  const int tiles1 = (p.Sk + BK - 1) / BK;
  const int tiles = tiles1 + (p.Sk2 + BK - 1) / BK;
  // the warpgroup index (the producer warp's is nc), warp-uniform
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == nc) {
    // ---- producer ----
    if (threadIdx.x != nc * 128) return;
    int qi = 0, kv = 0, prev = -1;
    // K/V tile `tile` of item x into ring position n: K then V, each into
    // its slot once the consumers have released it
    auto load_kv = [&](int n, const Item& x, int tile) {
      const int stage = n % KS, round = n / KS, c0 = x.h * F::VCH;
      const bool own = tile < tiles1;
      const int k0 = (own ? tile : tile - tiles1) * BK, bb = own ? x.b : x.b / p.frames;
      unsigned char* ks = smem + L.k_off + stage * L.k_bytes;
      unsigned char* vs = smem + L.v_off + stage * L.v_bytes;
      if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);
      mbar_arrive_expect_tx(&kfull[stage], F::VCH * BK * 16);
      if constexpr (F::SW) {
        for (int c = 0; c < DH / 64; ++c)
          tma_load_3d(ks + c * BK * 128, own ? &p.k : &p.kc, &kfull[stage], x.h * DH + c * 64,
                      k0, bb);
      } else {
        tma_load_4d(ks, own ? &p.k : &p.kc, &kfull[stage], 0, k0, c0, bb);
      }
      if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);
      mbar_arrive_expect_tx(&vfull[stage], F::VCH * BK * 16);
      if constexpr (F::SW) {
        for (int c = 0; c < DH / 64; ++c)
          tma_load_3d(vs + c * BK * 128, own ? &p.v : &p.vc, &vfull[stage], x.h * DH + c * 64,
                      k0, bb);
      } else {
        tma_load_4d(vs, own ? &p.v : &p.vc, &vfull[stage], 0, k0, c0, bb);
      }
    };
    for (int it = w.begin; it < w.end; it += w.step, ++qi) {
      const Item x = item_of(p, it);
      const int slot = qi % QS;
      if (qi >= QS) mbar_wait(&qempty[slot], ((qi / QS) - 1) & 1);
      unsigned char* qs = smem + L.q_off + slot * L.q_bytes;
      mbar_arrive_expect_tx(&qfull[slot], F::VCH * TR * 16);
      if constexpr (F::SW) {
        for (int c = 0; c < DH / 64; ++c)
          tma_load_3d(qs + c * TR * 128, &p.q, &qfull[slot], x.h * DH + c * 64, x.r0, x.b);
      } else {
        tma_load_4d(qs, &p.q, &qfull[slot], 0, x.r0, x.h * F::VCH, x.b);
      }
      if (p.resident) {
        const int bh = x.b * p.H + x.h;
        if (bh != prev) load_kv(kv++, x, 0);
        prev = bh;
      } else {
        for (int tile = 0; tile < tiles; ++tile) load_kv(kv++, x, tile);
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = role, tw = threadIdx.x % 128, lane = tw % 32, g = lane / 4, t = lane % 4;
  const bool lead = lane == 0;
  const int row_a = wg * 64 + (tw / 32) * 16 + g;   // this thread's rows in the item: a, a + 8
  unsigned char* ostage = smem + L.o_off + wg * 64 * DH * 2;
  const bool pairs = p.Sk % 2 == 0;
  // this thread's bias rows of an item (rows past Sq read row Sq - 1)
  auto bias_row = [&](const Item& x, int r) {
    return p.bias + x.b * p.bias_stride + ((size_t)x.h * p.Sq + min(x.r0 + r, p.Sq - 1)) * p.Sk;
  };
  auto keys_in = [&](int tile) {   // keys of a tile of the walk's items
    return tile < tiles1 ? min(BK, p.Sk - tile * BK) : min(BK, p.Sk2 - (tile - tiles1) * BK);
  };

  // two consumer warpgroups take turns to issue their products (named
  // barriers 3 and 4), so that one's softmax runs while the other's wgmmas
  // do; warpgroup 0 goes first, and warpgroup 1 skips the very last arrival
  // (both take the same number of turns)
  const bool pingpong = nc == 2;
  auto turn_begin = [&] {
    if (pingpong) named_barrier(3 + wg, 256);
  };
  auto turn_end = [&](bool final_turn) {
    if (pingpong && !(wg == 1 && final_turn)) named_barrier_arrive(4 - wg, 256);
  };
  if (pingpong && wg == 1) named_barrier_arrive(3, 256);

  int qi = 0, kv = 0;
  for (int it = w.begin; it < w.end; it += w.step, ++qi) {
    const Item x = item_of(p, it);
    const int slot = qi % QS;
    constexpr int ROW = F::SW ? 128 : 16;   // bytes of a row in a chunk
    const uint32_t q_addr = smem_addr(smem + L.q_off + slot * L.q_bytes) + wg * 64 * ROW;
    const int q_chunk = TR * ROW;
    // in resident mode the item's K/V stays in its slot until the run ends
    bool release = true;
    if (p.resident && it + w.step < w.end) {
      const Item nx = item_of(p, it + w.step);
      release = nx.b != x.b || nx.h != x.h;
    }
    const int T = p.resident ? 1 : tiles;
    auto k_addr = [&](int j) { return smem_addr(smem + L.k_off + ((kv + j) % KS) * L.k_bytes); };
    auto v_addr = [&](int j) { return smem_addr(smem + L.v_off + ((kv + j) % KS) * L.v_bytes); };
    auto phase = [&](int j) { return (uint32_t)(((kv + j) / KS) & 1); };

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0, c1;
    float s[BK / 2];
    uint32_t pa[BK / 16][4];

    // the softmax of tile j's scores, in the exp2 domain with the bias
    auto scores_done = [&](int j) {
      const int n = keys_in(j);
      if constexpr (BIAS) {
        float bv[BK / 2];
        load_bias(bv, bias_row(x, row_a) + j * BK, bias_row(x, row_a + 8) + j * BK, n, pairs);
        add_bias(s, bv, n, p.scale_log2);
        softmax_tile(s, n, 1.f, m0, m1, l0, l1, c0, c1);
      } else {
        softmax_tile(s, n, p.scale_log2, m0, m1, l0, l1, c0, c1);
      }
    };

    mbar_spin(&qfull[slot], (qi / QS) & 1);
    // tile 0: its scores alone
    mbar_spin(&kfull[kv % KS], phase(0));
    turn_begin();
    wgmma_fence();
    issue_scores<DH>(s, q_addr, q_chunk, k_addr(0));
    turn_end(false);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) fence_operand(s[i]);
    if (lead && release) mbar_arrive(&kempty[kv % KS]);
    if (lead && T == 1) mbar_arrive(&qempty[slot]);
    scores_done(0);
    pack_frag(s, pa);
    // tile j's scores and tile j-1's P.V together; tile j's softmax while
    // P.V runs
    for (int j = 1; j < T; ++j) {
      mbar_spin(&kfull[(kv + j) % KS], phase(j));
      mbar_spin(&vfull[(kv + j - 1) % KS], phase(j - 1));
      fence_pv_operands<DH>(acc, pa);
      turn_begin();
      wgmma_fence();
      issue_scores<DH>(s, q_addr, q_chunk, k_addr(j));
      issue_pv<DH>(acc, pa, v_addr(j - 1));
      turn_end(false);
      if constexpr (F::template OVERLAP<BIAS>) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(s[i]);
      if (lead) mbar_arrive(&kempty[(kv + j) % KS]);
      if (lead && j == T - 1) mbar_arrive(&qempty[slot]);
      scores_done(j);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) fence_operand(acc[i]);
      if (lead) mbar_arrive(&vempty[(kv + j - 1) % KS]);
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        acc[i + 0] *= c0;
        acc[i + 1] *= c0;
        acc[i + 2] *= c1;
        acc[i + 3] *= c1;
      }
      pack_frag(s, pa);
    }
    // the last tile's P.V
    mbar_spin(&vfull[(kv + T - 1) % KS], phase(T - 1));
    fence_pv_operands<DH>(acc, pa);
    turn_begin();
    wgmma_fence();
    issue_pv<DH>(acc, pa, v_addr(T - 1));
    turn_end(it + w.step >= w.end);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) fence_operand(acc[i]);
    if (lead && release) mbar_arrive(&vempty[(kv + T - 1) % KS]);
    kv += p.resident ? (release ? 1 : 0) : T;

    // normalise, stage as bf16 ([chunk][row][8], 64 rows a warpgroup) once
    // the previous item's store has read the staging buffer, and store by TMA
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    if (tw == 0) bulk_wait_read();
    named_barrier(1 + wg, 128);
    const int r = row_a - wg * 64;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      unsigned char* dst = ostage + c * 64 * 16 + r * 16 + 4 * t;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[c * 4 + 0] * i0, acc[c * 4 + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * 16) =
          __floats2bfloat162_rn(acc[c * 4 + 2] * i1, acc[c * 4 + 3] * i1);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tw == 0 && x.r0 + wg * 64 < p.Sq) {
      tma_store_4d(&p.o, ostage, 0, x.r0 + wg * 64, x.h * F::VCH, x.b);
      bulk_commit();
    }
  }
  if (tw == 0) bulk_wait();
}

// ---- the one-key-tile class: a body of its own ----
//
// Unbiased calls with 0 < Sk <= 128 and no context, at the models' head
// widths (40, 64, 80, 160): every cross-attention over 77 text tokens and the
// IP adapter's 4 image tokens. An item is 64 query rows of one batch row and
// a group of heads whose channels are whole 64-channel chunks (8 heads of 40,
// 5 of 64, 4 of 80, 2 of 160: 320 channels; fewer for a call of few items),
// one consumer warpgroup an item, three consumer warpgroups a block:
//  - Q arrives as 128-byte-swizzled chunks of 64 rows x 64 channels through a
//    ring of chunk slots that runs on across items; a warpgroup waits for the
//    chunks a head reads and frees each chunk once its last head has read it,
//    so the next items' chunks stream in under the current one.
//  - K and V of the group stay resident per (batch row, group), NK keys deep:
//    Sk rounded up to 16, the score product's N and P.V's depth (the
//    template's NK), not 128. K is a swizzled tile like Q's where every head
//    starts on a 16-channel step (64, 80, 160), V where heads are whole
//    64-channel chunks (64), both by TMA; elsewhere each is the unswizzled
//    [chunk][key][8] tile, which the producer warpgroup fills by cp.async
//    (TMA moves such a tile one 16-byte piece at a time: about 7 us for a
//    group's K and V at head width 40).
//  - Heads of 40 start half of them on an 8-channel step, which no wgmma
//    descriptor of a swizzled tile can express, so their Q is the register A
//    operand, taken by ldmatrix at its swizzled 16-byte pieces (the score
//    depth's pad, channels 40-47, as zero registers; K's pad chunk is the
//    next head's, or a zero chunk after the group's).
//  - Per head: the score product, one exact softmax (the key axis is one
//    tile; the row sums of P as bf16, as P.V takes it), P.V, and the output
//    written from the accumulators by 16-byte stores after a quad transpose
//    (no staging, no barrier): the barrier handshake and the Q waits are
//    paid once a group. The heads of an item run one after another; the
//    other warpgroups' heads fill the SM in between.
//  - A producer warpgroup gives up registers (setmaxnreg 24) so that the
//    consumers hold 160 (a head at width 160 and 80 keys used 158).
constexpr int SHORT_ROWS = 64;                 // query rows of an item
constexpr int SHORT_MAX_KEYS = 80;             // past it, the tiles body measured faster
constexpr int SHORT_SLOTS = 15;                // at most, Q chunk slots
constexpr int SHORT_CHUNK = SHORT_ROWS * 128;  // bytes of one swizzled Q chunk
constexpr int SHORT_WGS = 3;                   // consumer warpgroups, each its own items
constexpr int SHORT_THREADS = 128 * (SHORT_WGS + 1);   // and a producer warpgroup
static_assert(SHORT_THREADS == 512, "the setmaxnreg counts below fit 512 threads");

template <int DH>
struct ShortCfg {
  static constexpr bool RS = DH % 16 != 0;    // Q as the register A operand
  static constexpr bool KSW = !RS;            // K swizzled
  static constexpr bool VSW = DH % 64 == 0;   // V swizzled
  static constexpr int DP = (DH + 15) / 16 * 16;
  static constexpr int VCH = DH / 8;
};

// The shared memory of a launch of the short body, in bytes from the
// 1024-aligned base: the Q chunk slots; K, key_tile rows of an item's
// 64-channel chunks and 16 bytes more (a swizzled tile, or the unswizzled
// 8-channel chunks and one zero chunk); V from the next 1024-byte boundary,
// the same without the 16 bytes; the barriers. ops/flash_attention.py
// flash_short_bytes is the same formula.
struct ShortLayout {
  int k_off, v_off, bar_off, total;
};

inline ShortLayout make_short_layout(int key_tile, int qchunks, int slots) {
  ShortLayout l;
  const int row = qchunks * 128;   // bytes of a key's 64-channel chunks
  l.k_off = slots * SHORT_CHUNK;
  l.v_off = l.k_off + ((row + 16) * key_tile + 1023) / 1024 * 1024;
  l.bar_off = l.v_off + row * key_tile;
  l.total = l.bar_off + BARRIER_BYTES + ALIGN_SLACK;
  return l;
}

struct ShortParams {
  CUtensorMap q, k, v;           // k, v: the swizzled maps (KSW, VSW)
  const __nv_bfloat16 *kg, *vg;  // k, v in global memory (the unswizzled tiles)
  __nv_bfloat16* o;
  int B, H, Sq, Sk, C;
  float scale_log2;
  int group, groups, qchunks, slots, qtiles, items;
  ShortLayout lay;
};

// Thread `tw` of the producer warpgroup's share of one unswizzled K or V tile
// of a (batch row, group): 8-channel chunk c of key j from global memory
// into [chunk][key][8], by cp.async (TMA moves a tile of 16-byte pieces one
// piece at a time); keys past Sk and channels past C are zeros. Consecutive
// threads take consecutive keys of a chunk, so that the shared writes are
// contiguous.
template <int NK>
__device__ __forceinline__ void load_chunks(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                            const ShortParams& p, int b, int c0, int chunks,
                                            int tw) {
  for (int e = tw; e < chunks * NK; e += 128) {
    const int c = e / NK, j = e % NK;
    const bool ok = j < p.Sk && (c0 + c) * 8 < p.C;
    const size_t off = ((size_t)b * p.Sk + min(j, p.Sk - 1)) * p.C + min(c0 + c, p.C / 8 - 1) * 8;
    hopper::cp_async16(dst + e * 16, src + off, ok);
  }
}

// 16 bytes a thread of a row's output: the quad's four threads hold 2
// channels of each 8-channel group (the wgmma fragment); four groups at a
// time are transposed across the quad (two rounds of shuffles), so that
// thread t holds group g0 + t whole, and stores it with one 16-byte store.
template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* o, const uint32_t (&r)[N], int groups,
                                          bool ok) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int g0 = 0; g0 < N; g0 += 4) {
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = g0 + j < N ? r[g0 + j] : 0u;
#pragma unroll
    for (int p = 0; p < 2; ++p) {   // 2x2 blocks across threads t, t ^ 2
      const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 2) ? x[p] : x[2 + p], 2);
      if (t & 2) x[p] = got; else x[2 + p] = got;
    }
#pragma unroll
    for (int q = 0; q < 4; q += 2) {   // within each block, across t, t ^ 1
      const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 1) ? x[q] : x[q + 1], 1);
      if (t & 1) x[q] = got; else x[q + 1] = got;
    }
    if (ok && g0 + t < groups)
      *reinterpret_cast<uint4*>(o + (g0 + t) * 8) = make_uint4(x[0], x[1], x[2], x[3]);
  }
}

// One kernel symbol for both bodies (an overload on the parameters), so that
// a profile sums K5's device time under one name.
template <int DH, int NK>
__global__ void __launch_bounds__(SHORT_THREADS, 1)
    flash_attention_kernel(const __grid_constant__ ShortParams p) {
  using namespace hopper;
  using F = ShortCfg<DH>;
  constexpr int KCHUNK = NK * 16;    // bytes of one unswizzled 8-channel chunk of K or V
  constexpr int SWCHUNK = NK * 128;  // bytes of one swizzled 64-channel chunk of K or V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.lay.bar_off);
  uint64_t *qfull = bars, *qempty = bars + SHORT_SLOTS;
  uint64_t *kvfull = bars + 2 * SHORT_SLOTS, *kvempty = kvfull + 1;
  const int G = p.group, NS = p.slots, NCH = p.qchunks, kch = G * F::VCH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 4);   // the item's warpgroup
    }
    // the producer warpgroup's cp.async arrivals, and its TMA thread's
    mbar_init(kvfull, (F::KSW && F::VSW ? 0 : 128) + (F::KSW || F::VSW ? 1 : 0));
    mbar_init(kvempty, 4 * SHORT_WGS);   // every consumer warpgroup
    mbar_fence_init();
  }
  if constexpr (F::RS) {   // the zero chunk after K
    for (int e = threadIdx.x; e < NK; e += blockDim.x)
      *reinterpret_cast<uint4*>(smem + p.lay.k_off + kch * KCHUNK + e * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  __syncthreads();

  // a contiguous run of items per block, query tile fastest, then the group,
  // then the batch row: consecutive items share their K/V
  const int begin = (int)((long long)blockIdx.x * p.items / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * p.items / gridDim.x);
  auto item_of = [&](int it, int& b, int& g, int& r0) {
    r0 = (it % p.qtiles) * SHORT_ROWS;
    const int r = it / p.qtiles;
    g = r % p.groups;
    b = r / p.groups;
  };
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == SHORT_WGS) {
    // ---- producer: K/V once per (batch row, group), Q chunk by chunk ----
    setmaxnreg_dec<24>();
    const int tw = threadIdx.x - 128 * SHORT_WGS;
    const bool tma = tw == 0;
    int seg = -1, pb = -1, pg = -1;
    for (int it = begin, i = 0; it < end; ++it, ++i) {
      int b, g, r0;
      item_of(it, b, g, r0);
      if (b != pb || g != pg) {
        ++seg;
        pb = b;
        pg = g;
        if (seg > 0) mbar_wait(kvempty, (seg - 1) & 1);
        unsigned char *ks = smem + p.lay.k_off, *vs = smem + p.lay.v_off;
        if (tma && (F::KSW || F::VSW)) {
          mbar_arrive_expect_tx(kvfull, ((F::KSW ? 1 : 0) + (F::VSW ? 1 : 0)) * NCH * SWCHUNK);
          for (int c = 0; c < NCH; ++c) {
            if constexpr (F::KSW) tma_load_3d(ks + c * SWCHUNK, &p.k, kvfull, g * G * DH + c * 64, 0, b);
            if constexpr (F::VSW) tma_load_3d(vs + c * SWCHUNK, &p.v, kvfull, g * G * DH + c * 64, 0, b);
          }
        }
        if constexpr (!F::KSW) load_chunks<NK>(smem_addr(ks), p.kg, p, b, g * kch, kch, tw);
        if constexpr (!F::VSW) load_chunks<NK>(smem_addr(vs), p.vg, p, b, g * kch, kch, tw);
        if constexpr (!F::KSW || !F::VSW) cp_async_mbar_arrive(kvfull);
      }
      if (!tma) continue;
      for (int c = 0; c < NCH; ++c) {
        const int q = i * NCH + c, slot = q % NS;
        if (q >= NS) mbar_wait(&qempty[slot], ((q / NS) - 1) & 1);
        mbar_arrive_expect_tx(&qfull[slot], SHORT_CHUNK);
        tma_load_3d(smem + slot * SHORT_CHUNK, &p.q, &qfull[slot], g * G * DH + c * 64, r0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup `role` takes the run's items role, role + SHORT_WGS, ... ----
  setmaxnreg_inc<160>();
  const int wg = role, tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const bool lead = lane == 0;
  const uint32_t kbase = smem_addr(smem + p.lay.k_off), vbase = smem_addr(smem + p.lay.v_off);
  float s[NK / 2];
  uint32_t pa[NK / 16][4];
  uint32_t qa[F::DP / 16][4];
  float acc[DH / 2];
  int seg = -1, pb = -1, pg = -1;
  for (int it = begin, i = 0; it < end; ++it, ++i) {
    int b, g, r0;
    item_of(it, b, g, r0);
    if (b != pb || g != pg) {   // every warpgroup passes every K/V segment
      if (seg >= 0 && lead) mbar_arrive(kvempty);
      ++seg;
      pb = b;
      pg = g;
      mbar_spin(kvfull, seg & 1);
    }
    if (i % SHORT_WGS != wg) continue;
    const int qbase = i * NCH;
    int waited = 0, released = 0;
    auto chunk_addr = [&](int c) { return smem_addr(smem + ((qbase + c) % NS) * SHORT_CHUNK); };
    auto wait_chunks = [&](int last) {
      for (; waited <= last; ++waited)
        mbar_spin(&qfull[(qbase + waited) % NS], ((qbase + waited) / NS) & 1);
    };
    auto release_chunks = [&](int below) {
      for (; released < below; ++released)
        if (lead) mbar_arrive(&qempty[(qbase + released) % NS]);
    };
    // head h's score product, issued and committed (a ragged group's heads
    // past H read zeros and are never stored)
    auto issue_scores = [&](int h) {
      const int c0 = h * DH;   // the head's first channel in the group
      wait_chunks(min((c0 + DH - 1) / 64, NCH - 1));
      if constexpr (F::RS) {
        // lane l: row (l % 8) + 8 * ((l / 8) % 2) of the warp's 16, the
        // 8-channel piece (l / 16) of the 16-channel step
        const int r = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int kk = 0; kk < F::DP / 16; ++kk) {
          const int q = c0 / 8 + 2 * kk + lane / 16;   // the piece's 8-channel index
          const uint32_t a = chunk_addr(q / 8) + r * 128 + (((q % 8) ^ (r % 8)) * 16);
          if (kk * 16 + 8 < DH) {
            ldmatrix_x4(qa[kk], a);
          } else {   // the pad: channels DH .. DP
            ldmatrix_x2(qa[kk][0], qa[kk][1], a);
            qa[kk][2] = qa[kk][3] = 0u;
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::DP / 16; ++kk) {
        const int c = c0 + 16 * kk;
        if constexpr (F::RS) {
          wgmma_rs_keys<NK>(s, qa[kk], wgmma_desc(kbase + (c / 8) * KCHUNK, KCHUNK, 128),
                            kk > 0);
        } else {
          wgmma_ss_keys<NK>(s, wgmma_desc_sw128(chunk_addr(c / 64) + (c % 64) * 2, 16, 1024),
                            wgmma_desc_sw128(kbase + (c / 64) * SWCHUNK + (c % 64) * 2, 16, 1024),
                            kk > 0);
        }
      }
      wgmma_commit();
    };
    // the exact softmax of head h's one key tile (keys >= Sk masked) into
    // `ph`, its row sums into l0, l1; then the head's Q chunks are free
    auto softmax = [&](int h, uint32_t (&ph)[NK / 16][4], float& l0, float& l1) {
      fence_frag(s);
      if (h + 1 == G) wait_chunks(NCH - 1);   // chunks no head reads landed too
      release_chunks(h + 1 < G ? min(((h + 1) * DH) / 64, NCH) : NCH);
      if (p.Sk < NK) mask_keys(s, p.Sk);
      float m0, m1;
      quad_row_max(s, m0, m1);
      exp2_frag(s, p.scale_log2, -m0 * p.scale_log2, -m1 * p.scale_log2, (p.Sk + 7) / 8);
      pack_frag(s, ph);
      // the row sums of P as P.V takes it (bf16): numerator and denominator
      // round alike, which matters where a few keys carry the row
      l0 = 0.f;
      l1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; r += 2) {
          l0 += __uint_as_float(ph[kk][r] << 16) + __uint_as_float(ph[kk][r] & 0xffff0000u);
          l1 += __uint_as_float(ph[kk][r + 1] << 16) +
                __uint_as_float(ph[kk][r + 1] & 0xffff0000u);
        }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    };
    // head h's P.V into acc (overwritten), issued and committed
    auto issue_pv = [&](int h, const uint32_t (&ph)[NK / 16][4]) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        if constexpr (F::VSW) {
          wgmma_rs_n64(acc, ph[kk],
                       wgmma_desc_sw128(vbase + h * SWCHUNK + kk * 16 * 128, SWCHUNK, 1024),
                       kk > 0);
        } else {
          pv_step<DH>(acc, ph[kk], vbase + h * F::VCH * KCHUNK + kk * 16 * 16, KCHUNK, kk > 0);
        }
      }
      wgmma_commit();
    };
    const int row = r0 + warp * 16 + lane / 4;   // this thread's rows: row, row + 8
    __nv_bfloat16* orow = p.o + ((size_t)b * p.Sq + row) * p.C + g * G * DH;
    // head h's output, normalised by its row sums (heads past H and rows past
    // Sq are not stored)
    auto store = [&](int h, float l0, float l1) {
      fence_frag(acc);
      const float i0 = 1.f / l0, i1 = 1.f / l1;
      uint32_t r[DH / 8];
      const bool head = g * G + h < p.H;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) r[nt] = pack_bf16(acc[nt * 4 + 0] * i0, acc[nt * 4 + 1] * i0);
      store_row(orow + h * DH, r, DH / 8, head && row < p.Sq);
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) r[nt] = pack_bf16(acc[nt * 4 + 2] * i1, acc[nt * 4 + 3] * i1);
      store_row(orow + (size_t)8 * p.C + h * DH, r, DH / 8, head && row + 8 < p.Sq);
    };

    // one head after another: with a product in flight beside the softmax
    // or the stores (the next head's scores, or the last head's P.V), ptxas
    // serialises the wgmmas for register resources (C7511) and the head
    // took longer (PERF.md section 6); the other warpgroup's head fills in
    for (int h = 0; h < G; ++h) {
      float l0, l1;
      issue_scores(h);
      wgmma_wait<0>();
      softmax(h, pa, l0, l1);
      issue_pv(h, pa);
      wgmma_wait<0>();
      store(h, l0, l1);
    }
  }
}

// A 4-D map over a bf16 [B, S, C] tensor seen as [B, C / 8, S, 8]: one box
// of [chunks, rows, 8] lands in shared memory as the [chunk][row][8] tile
// (one TMA instruction per tile, not one per 8 channels); rows past S read
// as zeros (and are not written by a store).
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int C, int rows, int chunks) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)C / 8, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, 16, (cuuint64_t)S * C * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1};
  return hopper::make_bf16_map(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A 3-D map over a bf16 [B, S, C] tensor, 128-byte-swizzled boxes of [rows,
// 64 channels] (Cfg::SW); rows past S read as zeros.
bool make_map_sw(CUtensorMap* map, const void* ptr, int B, int S, int C, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)S * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return hopper::make_bf16_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The load map of Q, K, V, kc or vc: swizzled at the multiples of 64.
template <int DH>
bool make_load_map(CUtensorMap* map, const void* ptr, int B, int S, int C, int rows) {
  return Cfg<DH>::SW ? make_map_sw(map, ptr, B, S, C, rows)
                     : make_map(map, ptr, B, S, C, rows, Cfg<DH>::VCH);
}

template <int DH, bool BIAS>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v, const void* kc,
                   const void* vc, void* o, int grid, cudaStream_t stream) {
  const int C = p.H * DH;
  if (!make_load_map<DH>(&p.q, q, p.B, p.Sq, C, p.tile_rows) ||
      !make_load_map<DH>(&p.k, k, p.B, p.Sk, C, BK) ||
      !make_load_map<DH>(&p.v, v, p.B, p.Sk, C, BK) ||
      !make_map(&p.o, o, p.B, p.Sq, C, 64, Cfg<DH>::VCH))
    return cudaErrorInvalidValue;
  if (p.Sk2 > 0) {
    if (!make_load_map<DH>(&p.kc, kc, p.B / p.frames, p.Sk2, C, BK) ||
        !make_load_map<DH>(&p.vc, vc, p.B / p.frames, p.Sk2, C, BK))
      return cudaErrorInvalidValue;
  } else {   // never read: no context tiles
    p.kc = p.k;
    p.vc = p.v;
  }
  void (*kernel)(Params) = flash_attention_kernel<DH, BIAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128 * (p.tile_rows / 64) + 32, p.lay.total, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, int NK>
cudaError_t launch_short(ShortParams& p, const void* q, const void* k, const void* v, int grid,
                         cudaStream_t stream) {
  using F = ShortCfg<DH>;
  if (!make_map_sw(&p.q, q, p.B, p.Sq, p.C, SHORT_ROWS) ||
      (F::KSW && !make_map_sw(&p.k, k, p.B, p.Sk, p.C, NK)) ||
      (F::VSW && !make_map_sw(&p.v, v, p.B, p.Sk, p.C, NK)))
    return cudaErrorInvalidValue;
  void (*kernel)(ShortParams) = flash_attention_kernel<DH, NK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SHORT_THREADS, p.lay.total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// kc/vc may be null with Sk2 == 0; bias null, or contiguous fp32 [H, Sq, Sk]
// (bias_per_batch 0) or [B, H, Sq, Sk] (1), never with Sk2 > 0. Every
// pointer 16-byte aligned, rows contiguous with stride H*DH; scale > 0.
// The launch plan (ops/flash_attention.py flash_plan): tile_rows 64 or 128,
// the Q and K/V ring depths, resident (only with one key tile and no
// context; its walk has the query tile fastest), batch_fastest, the
// persistent grid (1..items) and smem_bytes, refused unless the bytes are
// this file's layout of those fields and one block can hold them.
extern "C" int anyv2v_flash_attention(const void* q, const void* k, const void* v,
                                      const void* kc, const void* vc, void* o,
                                      const void* bias, int bias_per_batch,
                                      int B, int Sq, int Sk, int Sk2, int frames,
                                      int H, int DH, float scale, int tile_rows, int q_stages,
                                      int kv_stages, int resident, int batch_fastest, int grid,
                                      int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Sk2 < 0 || H <= 0 || frames <= 0 || B % frames != 0 ||
      !(scale > 0.f) || (Sk2 > 0 && (kc == nullptr || vc == nullptr)) ||
      (bias != nullptr && Sk2 > 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.bias = (const float*)bias;
  p.bias_stride = bias_per_batch ? (long long)H * Sq * Sk : 0;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Sk2 = Sk2;
  p.frames = frames;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.tile_rows = tile_rows;
  p.q_stages = q_stages;
  p.kv_stages = kv_stages;
  p.resident = resident;
  p.batch_fastest = batch_fastest;
  if ((tile_rows != 64 && tile_rows != 128) || q_stages < 1 || q_stages > MAX_STAGES ||
      kv_stages < 1 || kv_stages > MAX_STAGES || (resident != 0 && resident != 1) ||
      (batch_fastest != 0 && batch_fastest != 1) ||
      (resident && (Sk > BK || Sk2 > 0 || batch_fastest)))
    return (int)cudaErrorInvalidValue;
  p.qtiles = (Sq + tile_rows - 1) / tile_rows;
  const long long items = (long long)p.qtiles * H * B;
  if (items > 0x7fffffffLL || grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.lay = make_layout(DH, tile_rows, q_stages, kv_stages);
  if (smem_bytes != p.lay.total || p.lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  switch (DH) {
#define ANYV2V_CASE(D)                                                            \
  case D:                                                                         \
    return p.bias ? (int)launch<D, true>(p, q, k, v, kc, vc, o, grid, s)          \
                  : (int)launch<D, false>(p, q, k, v, kc, vc, o, grid, s);
    ANYV2V_CASE(8) ANYV2V_CASE(16) ANYV2V_CASE(24) ANYV2V_CASE(32) ANYV2V_CASE(40)
    ANYV2V_CASE(48) ANYV2V_CASE(56) ANYV2V_CASE(64) ANYV2V_CASE(72) ANYV2V_CASE(80)
    ANYV2V_CASE(88) ANYV2V_CASE(96) ANYV2V_CASE(104) ANYV2V_CASE(112) ANYV2V_CASE(120)
    ANYV2V_CASE(128) ANYV2V_CASE(160)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The one-key-tile body (no bias, no context; ops/flash_attention.py
// flash_plan's body "short"): DH 40, 64, 80 or 160, Sk <= 80, key_tile Sk
// rounded up to 16, head_group heads an item (whole 64-channel chunks, or
// every head; at most 320 channels), q_slots Q chunk slots (at least one
// item's 64-channel chunks for each consumer warpgroup), the
// persistent grid (1..items) and smem_bytes, refused unless the bytes are
// this file's layout of those fields and one block can hold them.
extern "C" int anyv2v_flash_attention_short(const void* q, const void* k, const void* v, void* o,
                                            int B, int Sq, int Sk, int H, int DH, float scale,
                                            int key_tile, int head_group, int q_slots, int grid,
                                            int smem_bytes, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Sk > SHORT_MAX_KEYS || H <= 0 || !(scale > 0.f) ||
      key_tile != (Sk + 15) / 16 * 16 || head_group < 1 || head_group > H ||
      ((head_group * DH) % 64 != 0 && head_group != H) || head_group * DH > 320)
    return (int)cudaErrorInvalidValue;
  ShortParams p;
  p.kg = (const __nv_bfloat16*)k;
  p.vg = (const __nv_bfloat16*)v;
  p.o = (__nv_bfloat16*)o;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.C = H * DH;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.group = head_group;
  p.groups = (H + head_group - 1) / head_group;
  p.qchunks = (head_group * DH + 63) / 64;
  p.slots = q_slots;
  p.qtiles = (Sq + SHORT_ROWS - 1) / SHORT_ROWS;
  const long long items = (long long)p.qtiles * p.groups * B;
  if (q_slots < SHORT_WGS * p.qchunks || q_slots > SHORT_SLOTS ||
      items > 0x7fffffffLL || grid < 1 || grid > items)
    return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.lay = make_short_layout(key_tile, p.qchunks, q_slots);
  if (smem_bytes != p.lay.total || p.lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ANYV2V_KEYS(D)                                                                  \
  switch (key_tile) {                                                                   \
    case 16: return (int)launch_short<D, 16>(p, q, k, v, grid, s);                      \
    case 32: return (int)launch_short<D, 32>(p, q, k, v, grid, s);                      \
    case 48: return (int)launch_short<D, 48>(p, q, k, v, grid, s);                      \
    case 64: return (int)launch_short<D, 64>(p, q, k, v, grid, s);                      \
    default: return (int)launch_short<D, 80>(p, q, k, v, grid, s);                      \
  }
  switch (DH) {
    case 40: ANYV2V_KEYS(40)
    case 64: ANYV2V_KEYS(64)
    case 80: ANYV2V_KEYS(80)
    case 160: ANYV2V_KEYS(160)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ANYV2V_KEYS
}
