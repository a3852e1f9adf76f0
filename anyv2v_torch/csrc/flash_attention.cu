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
// sums clock64 cycles by phase in an instrumented copy), by case class:
//  - long self-attention and split-KV (Sk in the thousands): the softmax, not
//    the products or the bytes. The operations bound is 2.2 ms at ConsistI2V's
//    L0 split-KV (51 rows x 5 heads x 4096 queries x 8192 keys x 64 x 4 FLOP)
//    and the exponentials' 2.0 ms (16 per clock per SM); at head width 40
//    (SEINE) the exponentials' 1.54 ms is the larger. Each consumer
//    warpgroup spends 45-51 % of its cycles in the softmax of its 64 x 128
//    tile (one warp per SM sub-partition: the exponentials, maxima and sums
//    of one warp are latency-bound), and 18-21 % waiting for K/V tiles that
//    the producer, blocked 71 % of its time on slots not yet freed, issued
//    three tiles ahead. At head width 64 the copies themselves took a share
//    while they moved 16-byte row pieces (a copy of an eighth of the bytes
//    was 9-12 % faster); 128-byte-swizzled tiles took it back.
//  - cross-attention over one key tile (Sk <= 128): bytes, Q read and O
//    written once (0.08 ms at ConsistI2V's L0 spatial cross), reached only
//    if the copies stay in flight; per item the consumers' softmax of a
//    partly masked tile (20-31 %), the epilogue (16-44 %, the staging
//    barriers and TMA store) and the Q waits (9-14 %) leave it at 2.4-5.5x.
//  - the editors' small calls (48 or 24 items of 128 rows): less than one
//    wave of blocks on 132 SMs; 64-row items double the blocks.
//  - a score bias: its bytes (4 per score, 25.8 GB read by the blocks at
//    SEINE's L0 self with a bias shared by the batch, from L2 once HBM has
//    given it once); the softmax with the bias's loads is 70-72 % of the
//    consumers' cycles.
//
// Design (every head width that is a multiple of 8 up to 128, and 160, takes
// this one body; the odd multiples of 8 run it with the score depth padded to
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
// two consumer warpgroups and a producer warp. ptxas gives every thread of
// such a block at most 168 registers (65536 / threads, rounded down to 8: as
// it does a block of three warpgroups, setmaxnreg or not; the highest
// register in the SASS, scripts/torch_attention_probe.py --sass, stays under
// it, and past it ptxas spills), so the consumers' tiles are sized for 168.
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
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DH, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.lay.total);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<DH, BIAS>
      <<<grid, 128 * (p.tile_rows / 64) + 32, p.lay.total, stream>>>(p);
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
