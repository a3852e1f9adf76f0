// K2 frame_attention: self-attention over the frame axis S of temporal tokens
// x [B, S, HW, C] (C = heads * DH), for every (batch, pixel, head), bf16.
//
// Keys k/v [B, Sk, HW, C] may carry up to 16 frames past S (ConsistI2V's
// augmented first-frame window, appended on the frame axis).
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_temporal_ew.py     _ew_kernel      (L0 temporal, HW 4096, dh 8)
//   pallas_short_attention.py _strided_kernel (L1/L2/mid temporal and
//                                              transformer_in, dh 16/32/64;
//                                              ConsistI2V, Sk = 25, dh 40/80/160;
//                                              SEINE, bias, dh 40/80/160)
//   pallas_short_attention.py _short_kernel   (as short_attention_frames
//                                              calls it past 32 frames: the
//                                              128-frame long-video path)
// The first two read the native [B, S, HW, C] layout so the temporal
// transformer never transposes its tokens; past 32 frames the JAX package
// transposes to [B*HW, S, C] for _short_kernel. This kernel reads the native
// layout at every S <= 128 and computes S x Sk scores per (batch, pixel,
// head), both rounded up to 16.
//
// Optional bias: an fp32 [H, S, Sk] table shared by every batch row and pixel
// (SEINE's T5 relative-position bias: 8 KB at 8 heads x 16 x 16, 590 KB at
// 8 heads x 128 x 144), added to the scaled scores. The body works in the
// exp2 domain, so each score gains bias * log2(e) before the row maximum, as
// _ew_kernel adds it. The table is read through __ldg (a 16-frame table stays
// in L1, a 128-frame one in L2); a null pointer means no bias, and that
// instantiation is the bias-free code unchanged. Keys past Sk stay -inf. The
// bias must be finite.
//
// What bounds it on the H100 (80GB HBM3, 700 W), up to 32 frames: bytes, q,
// k and v read once and the output written once (2 x B*(S+Sk)*HW*C*2 bytes,
// 400 MB for an i2vgen-xl L0 edit call at 16 frames, 0.66 GB for
// ConsistI2V's); the S*Sk*DH multiply-adds per head are few by comparison.
// At 128 frames the multiply-adds grow 64-fold (4.1e11 operations against
// 6.4 GB at L0 batch 3, 64 per byte, under the card's ~295) and so do the
// exponentials (1.3e10, 3.1 ms at the special-function units' 16 per clock
// per SM): at dh 8 the exponentials bound the long route, at transformer_in
// (dh 64) its bytes. scripts/torch_attention_stamps.py found the mma.sync body on
// the long route spending its warps' cycles at transformer_in 36 % issuing
// cp.async copies and 9 % waiting for them (one pixel a block, its copies in
// flight only under the other block's math), at L0 15 % and 5 %, with the
// exponentials 23 % and P.V 19 %.
//
// Two bodies, two kernel symbols (so that a profile tells the routes apart):
//
// frame_attention_kernel, 1 <= S <= 32 (K2): the mma.sync tensor-core body. It
// replaces two CUDA-core bodies that served S <= 32 in fp32 (4-9x their
// byte bound). Each (b, pixel, head) is a whole [S] x [Sk] attention
// problem, so the body is built around pixels:
//  - A block owns P pixels (consecutive in b*HW + pixel) and a group of whole
//    heads, at most 128 channels (one head of 160): Q [S, G], K and V [Sk, G]
//    of each pixel come into shared memory by cp.async, 16 bytes a thread,
//    rows past S or Sk zero-filled, Q and K in one group and V in a second,
//    so the first items' scores overlap V's flight. At 16 frames one pixel
//    is 13 KB, so P grows until a block moves about 16 KB, with two blocks'
//    shared memory still on one SM, so one block's copies overlap the
//    other's math (on an H100, 8 KB blocks summed to the same time over the
//    K2 cases within 2 %; 24, 32, 64 and 128 KB were slower). Rows are
//    padded to an odd number of 16-byte units, so ldmatrix is free of bank
//    conflicts. ops/frame_attention.py's frame_plan sizes the block; the
//    entry refuses a plan that differs.
//  - A warp takes 16 query frames of one head of one pixel (an item) at a
//    time. Scores: Q and K by ldmatrix, mma.sync m16n8k16 steps over the
//    head width and an m16n8k8 step for its last 8 channels (dh 8, 40), bf16
//    in, fp32 out; all Sk keys of a row are held at once (KT tiles of 8 keys:
//    2, 4 or 6), so the softmax is exact in one pass: the row maximum, then
//    exp2 by ex2.approx of one fma (scale folded, as the true head width
//    gives it; a bias adds bias * log2(e) first; keys >= Sk are -inf).
//  - P goes to bf16 A fragments; P.V runs on the tensor cores with V by
//    ldmatrix.trans, in chunks of 64 output channels, and the row sums come
//    from the same bf16 P against a column of ones (one more mma per 16
//    keys). The normalised bf16 output overwrites the item's own Q tile, and
//    the block stores whole 16-byte rows at the end; query rows >= S are not
//    stored.
//
// frame_attention_long_kernel, 32 < S <= 128 (K2 long, the long-video
// route), the Hopper body:
//  - Persistent blocks (one per SM) walk items of (pixel, head group), head
//    group fastest. A producer warp (one thread) loads each item's Q [S, G],
//    K and V [Sk, G] as TMA boxes of the native layout onto a ring of two
//    item stages with full and empty mbarriers, so the next pixel's bytes
//    are in flight under this pixel's math. Where the group is whole
//    64-channel slabs of heads 8 to 64 wide (every main-path call), each
//    box is a slab: a 4-D map over [B, S, HW, C], boxes of (64 channels,
//    rows, 1, 1), 128-byte swizzled, so that every row is one 128-byte
//    piece. Elsewhere (dh 40 / 80 / 160, groups under 64 channels) a 5-D
//    map over (8 channels, frames, C/8 chunks, pixels, batch) lands
//    [chunk][row][8] tiles in 16-byte pieces. On the H100 those pieces cost
//    the route most of its time: with frames 4 MB apart each piece is a
//    row of its own, and transformer_in took 9.9 ms (against 2.2 with
//    slabs, PERF.md section 6). Rows past S or Sk read as zeros.
//    ops/frame_attention.py's frame_long_plan sizes it.
//  - Two consumer warpgroups split each item's units (64 query frames, one
//    head): with S > 64 each takes its 64 frames of every head, else every
//    other head; they take turns to issue their products. A unit's scores
//    are one wgmma of N = 128 or 144 keys per 16 channels, all Sk keys at
//    once, so the softmax is exact in one pass: SS on the slabs (a head's
//    channels at its offset in the 128-byte rows), at dh 8 with A from
//    registers holding the head's 8 channels and zeros, unswizzled with the
//    last 8 channels of dh 40 paired with a zero chunk. P goes to bf16
//    register fragments for an RS wgmma P.V, and the row sums come from the
//    same P against a chunk of ones; up to dh 64 a unit's P.V runs under
//    the next unit's softmax.
//  - The normalised output overwrites the unit's own Q rows in shared
//    memory; a TMA store writes it (each warpgroup its own 64 rows of the
//    slabs, else one store once both are done; rows past S clipped) and
//    releases the stage when it has read it.
// What bounds it: at transformer_in the bytes (2.22 ms against a byte
// bound of 1.92 at batch 3); at dh 8 (L0) the exponentials and the
// latency around them, two warps a sub-partition each waiting on its own
// unit's scores and P.V (three warpgroups measured slower: ptxas then
// allows 128 registers a thread, and spills). Its softmax is one pass over
// all keys, so K1's lazy row maxima have nothing to skip here, and a quarter
// or an eighth of the exponentials on the FMA pipe (2^x by a polynomial)
// measured no faster at L0 (6.49-6.54 ms against 6.46-6.47 at batch 3,
// PERF.md section 6): the chain, not the special-function unit, paces it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---- the tensor-core body (see the header) ----

constexpr int MAX_WARPS = 8;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

// Row stride (bf16) of a block's shared tiles for a group of G channels:
// 16-byte rows whose stride is an odd number of 16-byte units, so that the
// eight row addresses of an ldmatrix fall in eight different bank groups.
__host__ __device__ constexpr int row_stride(int G) { return G + 8 + 8 * ((G / 8) % 2); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Scores of one item (16 query frames of one head) against the Sk <= KT*8
// keys on the tensor cores, then the exact softmax numerators as bf16 A
// fragments of the P.V product. s[nt] is the m16n8 accumulator of keys
// nt*8..nt*8+7: rows g and g+8, keys 2t and 2t+1. Without a bias the row
// maximum is taken on the raw scores and the scale folds into one fma before
// ex2 (scale > 0); with one, the scaled score plus bias * log2(e) comes first.
// Every one of the KT/2 16-key tiles is computed, without a branch: a tile
// past the last one of Sk (only where KT*8 exceeds Sk rounded to 16, off the
// model paths) reads the last tile's rows again, and its keys are -inf. A
// guard per tile let the compiler turn the later tiles into branches, each
// waiting on its own ldmatrix, where without guards it issues the loads of
// several tiles ahead of their mma (PERF.md, K2 long at 128 frames).
template <int DH, int KT, bool BIAS>
__device__ __forceinline__ void item_scores(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                            int LD, int qt, int hc, int h, int S, int Sk,
                                            const float* __restrict__ bias, float scale_log2,
                                            uint32_t (&pa)[KT / 2][4]) {
  using namespace hopper;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float s[KT * 4];
#pragma unroll
  for (int i = 0; i < KT * 4; ++i) s[i] = 0.f;
  const __nv_bfloat16* qrow = qs + (qt * 16 + (lane & 15)) * LD + hc;
  const int klast = round16(Sk) - 16;   // first row of the last tile in shared memory
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(qrow + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < KT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(ks + (min(np * 16, klast) + (lane & 7) + (lane >> 4) * 8) * LD +
                               hc + kk * 16 + ((lane >> 3) & 1) * 8));
      mma_m16n8k16(s + 4 * (2 * np), a, b[0], b[1]);
      mma_m16n8k16(s + 4 * (2 * np + 1), a, b[2], b[3]);
    }
  }
  if constexpr (DH % 16 == 8) {   // the last 8 channels (dh 8, 40): m16n8k8
    constexpr int kb = DH / 16 * 16;
    uint32_t a0, a1;
    ldmatrix_x2(a0, a1, smem_addr(qrow + kb));
#pragma unroll
    for (int np = 0; np < KT / 2; ++np) {
      uint32_t b0, b1;
      ldmatrix_x2(b0, b1, smem_addr(ks + (min(np * 16, klast) + (lane & 15)) * LD + hc + kb));
      mma_m16n8k8(s + 4 * (2 * np), a0, a1, b0);
      mma_m16n8k8(s + 4 * (2 * np + 1), a0, a1, b1);
    }
  }
  const int r0 = qt * 16 + g;
  if (BIAS) {
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = nt * 8 + 2 * t + (i & 1), row = r0 + (i >> 1) * 8;
        float x = s[nt * 4 + i] * scale_log2;
        if (key < Sk && row < S)
          x = fmaf(__ldg(bias + ((long long)h * S + row) * Sk + key), kLog2e, x);
        s[nt * 4 + i] = x;
      }
  }
  if (Sk < KT * 8) {   // keys past Sk (a ragged last tile, or tiles past it)
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (nt * 8 + 2 * t + (i & 1) >= Sk) s[nt * 4 + i] = -INFINITY;
  }
  float m0 = tile_max(s, 0), m1 = tile_max(s, 2);
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  // key 0 exists, so both maxima are finite
  const float k = BIAS ? 1.f : scale_log2;
  const float o0 = -m0 * k, o1 = -m1 * k;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(ex2(fmaf(s[nt * 4 + 0], k, o0)), ex2(fmaf(s[nt * 4 + 1], k, o0)));
    pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ex2(fmaf(s[nt * 4 + 2], k, o1)), ex2(fmaf(s[nt * 4 + 3], k, o1)));
  }
}

// O = P.V / l for one item on the tensor cores, V by ldmatrix.trans, in
// chunks of up to 64 output channels; the row sums l come from the same
// bf16 P against a column of ones. The bf16 result overwrites the item's
// own Q tile in shared memory (no other item reads it). As in item_scores,
// every tile is computed; past the last one P is 0 and V's last tile is
// read again.
template <int DH, int KT>
__device__ __forceinline__ void item_pv(__nv_bfloat16* qs, const __nv_bfloat16* vs, int LD,
                                        int qt, int hc, int Sk, const uint32_t (&pa)[KT / 2][4]) {
  using namespace hopper;
  constexpr int NT = DH / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int klast = round16(Sk) - 16;
  float i0 = 0.f, i1 = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += 8) {
    constexpr int CN = 8;
    float acc[CN][4], lsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < CN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      const int kr = min(kk * 16, klast);
      if (c0 == 0) mma_m16n8k16(lsum, pa[kk], BF16_ONES, BF16_ONES);
      const __nv_bfloat16* vrow = vs + (kr + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + hc;
#pragma unroll
      for (int n = 0; n < CN; n += 2) {
        if (c0 + n + 1 < NT) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vrow + (c0 + n) * 8 + (lane >> 4) * 8));
          mma_m16n8k16(acc[n], pa[kk], b[0], b[1]);
          mma_m16n8k16(acc[n + 1], pa[kk], b[2], b[3]);
        } else if (c0 + n < NT) {   // an odd last tile (dh 8, 40)
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, smem_addr(vs + (kr + (lane & 15)) * LD + hc + (c0 + n) * 8));
          mma_m16n8k16(acc[n], pa[kk], b0, b1);
        }
      }
    }
    if (c0 == 0) {
      i0 = 1.f / lsum[0];
      i1 = 1.f / lsum[2];
    }
#pragma unroll
    for (int n = 0; n < CN; ++n) {
      if (c0 + n < NT) {
        __nv_bfloat16* dst = qs + (qt * 16 + g) * LD + hc + (c0 + n) * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[n][0] * i0, acc[n][1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * LD) =
            __floats2bfloat162_rn(acc[n][2] * i1, acc[n][3] * i1);
      }
    }
  }
}

// P pixels (consecutive in b*HW + pixel, the last block's ragged) and a
// group of HB heads per block: Q [S, G], K and V [Sk, G] of each pixel in
// shared memory (G = HB*DH channels, rows padded to 16 and zero-filled),
// every (pixel, head, 16 query frames) item on the tensor cores, the output
// staged back in Q's place and stored in whole rows.
template <int DH, int KT, bool BIAS>
__device__ __forceinline__ void frame_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int Sk, int HW, int H, int HB, int npix_total, int P,
    float scale_log2) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = HB * DH, LD = row_stride(G), CH = G / 8;
  const int rows_q = round16(S), rows_k = round16(Sk);
  const int pix_elems = (rows_q + 2 * rows_k) * LD;
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bp0 = blockIdx.x * P;
  const int npix = min(P, npix_total - bp0);
  const int C = H * DH, c0 = blockIdx.y * G;
  const long long fstride = (long long)HW * C;
  const int nthreads = blockDim.x, tid = threadIdx.x;

  // Q and K first, V second: the first items' scores overlap V's flight.
  // Rows past S or Sk are zero-filled (their source address clamped).
  for (int x = 0; x < npix; ++x) {
    const long long b = (bp0 + x) / HW;
    const int p = (bp0 + x) % HW;
    __nv_bfloat16* qs = base + x * pix_elems;
    __nv_bfloat16* ks = qs + rows_q * LD;
    const __nv_bfloat16* qg = q + (b * S * HW + p) * C + c0;
    const __nv_bfloat16* kg = k + (b * Sk * HW + p) * C + c0;
    for (int e = tid; e < rows_q * CH; e += nthreads) {
      const int r = e / CH, c = e % CH;
      cp_async16(smem_addr(qs + r * LD + c * 8), qg + min(r, S - 1) * fstride + c * 8, r < S);
    }
    for (int e = tid; e < rows_k * CH; e += nthreads) {
      const int r = e / CH, c = e % CH;
      cp_async16(smem_addr(ks + r * LD + c * 8), kg + min(r, Sk - 1) * fstride + c * 8, r < Sk);
    }
  }
  cp_async_commit();
  for (int x = 0; x < npix; ++x) {
    const long long b = (bp0 + x) / HW;
    const int p = (bp0 + x) % HW;
    __nv_bfloat16* vs = base + x * pix_elems + (rows_q + rows_k) * LD;
    const __nv_bfloat16* vg = v + (b * Sk * HW + p) * C + c0;
    for (int e = tid; e < rows_k * CH; e += nthreads) {
      const int r = e / CH, c = e % CH;
      cp_async16(smem_addr(vs + r * LD + c * 8), vg + min(r, Sk - 1) * fstride + c * 8, r < Sk);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid / 32, nwarps = nthreads / 32;
  const int qtiles = rows_q / 16, per_pix = HB * qtiles, items = npix * per_pix;
  for (int it = warp, first = 1;; it += nwarps, first = 0) {
    const bool has = it < items;
    const int x = !has ? 0 : it / per_pix, rest = !has ? 0 : it % per_pix;
    const int hh = rest / qtiles, qt = rest % qtiles;
    __nv_bfloat16* qs = base + x * pix_elems;
    const __nv_bfloat16* ks = qs + rows_q * LD;
    uint32_t pa[KT / 2][4];
    if (has)
      item_scores<DH, KT, BIAS>(qs, ks, LD, qt, hh * DH, blockIdx.y * HB + hh, S, Sk, bias,
                                scale_log2, pa);
    if (first) {   // every warp passes here once: V has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!has) break;
    item_pv<DH, KT>(qs, ks + rows_k * LD, LD, qt, hh * DH, Sk, pa);
  }
  __syncthreads();
  for (int x = 0; x < npix; ++x) {
    const long long b = (bp0 + x) / HW;
    const int p = (bp0 + x) % HW;
    const __nv_bfloat16* qs = base + x * pix_elems;
    __nv_bfloat16* og = o + (b * S * HW + p) * C + c0;
    for (int e = tid; e < S * CH; e += nthreads) {
      const int r = e / CH, c = e % CH;
      *reinterpret_cast<uint4*>(og + r * fstride + c * 8) =
          *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);
    }
  }
}

// S <= 32 (K2)
template <int DH, int KT, bool BIAS>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) frame_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int Sk, int HW, int H, int HB, int npix_total, int P,
    float scale_log2) {
  frame_body<DH, KT, BIAS>(q, k, v, bias, o, S, Sk, HW, H, HB, npix_total, P, scale_log2);
}

// Score tiles of 8 keys held per item: Sk rounded to 16 (2, 4 or 6 tiles).
template <int DH, int KT>
cudaError_t launch_kt(const void* q, const void* k, const void* v, const float* bias, void* o,
                      int B, int S, int Sk, int HW, int H, int HB, int P, int threads, int smem,
                      float scale_log2, cudaStream_t stream) {
  auto kernel = bias ? frame_attention_kernel<DH, KT, true> : frame_attention_kernel<DH, KT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int npix = B * HW;
  dim3 grid((unsigned)((npix + P - 1) / P), (unsigned)(H / HB));
  kernel<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
      (__nv_bfloat16*)o, S, Sk, HW, H, HB, npix, P, scale_log2);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o,
                   int B, int S, int Sk, int HW, int H, int HB, int P, int threads, int smem,
                   float scale_log2, cudaStream_t stream) {
  const int G = HB * DH;
  if (H % HB != 0 || G % 8 != 0 || P < 1 || S > 32 ||
      smem != P * (round16(S) + 2 * round16(Sk)) * row_stride(G) * 2 || threads % 32 != 0 ||
      threads < 32 || threads > MAX_WARPS * 32 || (long long)B * HW > 0x7fffffffLL ||
      H / HB > 65535 || !(scale_log2 > 0.f))
    return cudaErrorInvalidValue;
  const int kt = round16(Sk) / 8;
#define ANYV2V_KT(N)                                                                         \
  launch_kt<DH, N>(q, k, v, bias, o, B, S, Sk, HW, H, HB, P, threads, smem, scale_log2, stream)
  return kt == 2 ? ANYV2V_KT(2) : kt == 4 ? ANYV2V_KT(4) : ANYV2V_KT(6);
#undef ANYV2V_KT
}

// ---- the long route (32 < S <= 128): the Hopper body (see the header) ----

namespace long_body {

// consumer warpgroups (three measured slower: at 128 registers a thread
// they spill, and setmaxnreg would not lift that while the consumers' TMA
// stores keep their bulk-group waits, hopper.cuh); and a producer warp
constexpr int NWG = 2;
constexpr int THREADS = 128 * NWG + 32;
constexpr int MAX_STAGES = 2;      // item stages of the ring
constexpr int BARRIER_BYTES = 64, ALIGN = 1024;   // the swizzle atom
constexpr uint32_t ONES2 = 0x3F803F80u;   // two bf16 1.0

// The shared memory of one launch, in bytes from the 1024-aligned base: the
// item stages (Q [rows, G], K and V [key_rows, G], each [chunk][row][8]),
// the zero chunk and the ones chunk (key_rows rows of 16 bytes each), the
// barriers. ops/frame_attention.py frame_long_layout_bytes is the same
// formula.
struct Layout {
  int q_bytes, k_bytes, stage_bytes, zero_off, ones_off, bar_off, total;
};

inline Layout make_layout(int g, int tile_rows, int key_rows, int stages) {
  Layout l;
  l.q_bytes = tile_rows * g * 2;
  l.k_bytes = key_rows * g * 2;
  l.stage_bytes = l.q_bytes + 2 * l.k_bytes;
  l.zero_off = stages * l.stage_bytes;
  l.ones_off = l.zero_off + key_rows * 16;
  l.bar_off = l.ones_off + key_rows * 16;
  l.total = l.bar_off + BARRIER_BYTES + ALIGN;
  return l;
}

struct Params {
  CUtensorMap q, k, v, o;
  const float* bias;   // fp32 [H, S, Sk], or null
  int S, Sk, HW, hb, ng, qt, units, items, stages;
  float scale_log2;
  Layout lay;
};

__device__ __forceinline__ void tma_load_5d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(hopper::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const void* map, const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(hopper::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// The same with V in a 128-byte-swizzled tile (TMA's CU_TENSOR_MAP_SWIZZLE_128B:
// rows of 128 bytes, 64 channels; DH 8 to 64 within one such tile, at
// `vaddr`'s offset in the row): one MN-major product of DH columns, and the
// row sums against an unswizzled chunk of ones.
template <int DH>
__device__ __forceinline__ void pv_sums_step_sw(float* o, const uint32_t (&a)[4], uint32_t vaddr,
                                                uint32_t ones) {
  static_assert(DH == 8 || DH == 16 || DH == 32 || DH == 64, "one swizzled row");
  const uint64_t d = hopper::wgmma_desc_sw128(vaddr, 16, 1024);
  if constexpr (DH == 64) {
    hopper::wgmma_rs_n64(o, a, d);
  } else if constexpr (DH == 32) {
    hopper::wgmma_rs_n32(o, a, d);
  } else if constexpr (DH == 16) {
    hopper::wgmma_rs_n16(o, a, d);
  } else {
    hopper::wgmma_rs_n8(o, a, d);
  }
  hopper::wgmma_rs_n8(o + DH / 2, a, hopper::wgmma_desc(ones, 128, 128));
}

// Byte offset of 16-byte chunk c (0-7) of row r in a 128-byte-swizzled tile:
// TMA stores chunk c of row r at c ^ (r % 8) (tiles 1024-byte aligned).
__device__ __forceinline__ int sw128_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The m16n8k16 A fragment of one 8-channel head at channel o (a multiple of
// 8, under 64) of a 128-byte-swizzled tile, this thread's rows r0 + g and
// r0 + g + 8: the 16-channel window from o & ~15 with the other head's 8
// channels zero, so that a K-major product over that window of K sees only
// this head.
__device__ __forceinline__ void head8_frag(const unsigned char* tile, int r0, int o,
                                           uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, c = o / 8;
  const uint32_t x0 = *reinterpret_cast<const uint32_t*>(tile + sw128_offset(r0 + g, c) + 4 * t);
  const uint32_t x1 =
      *reinterpret_cast<const uint32_t*>(tile + sw128_offset(r0 + g + 8, c) + 4 * t);
  const bool hi = c & 1;
  a[0] = hi ? 0u : x0;
  a[1] = hi ? 0u : x1;
  a[2] = hi ? x0 : 0u;
  a[3] = hi ? x1 : 0u;
}

// KT: 8-key groups of the score tile, 16 (Sk <= 128) or 18 (Sk <= 144). SW:
// the tiles are 128-byte-swizzled slabs of 64 channels ([slab][row][128
// bytes], one TMA box a slab) where a head group is a multiple of 64 channels
// of heads 8 to 64 wide; else 8-channel chunks ([chunk][row][8]).
template <int DH, int KT, bool BIAS, bool SW>
__global__ void __launch_bounds__(THREADS, 1)
    frame_attention_long_kernel(const __grid_constant__ Params p) {
  using namespace hopper;
  constexpr int DC = DH / 8;                 // 8-channel chunks of a head
  constexpr int NK = KT * 8;                 // key rows of the K and V tiles
  constexpr int DP = (DH + 15) / 16 * 16;    // Q.K^T depth, padded to 16
  constexpr int NACC = DH / 2 + 4;           // a unit's output and row-sum registers
  // P.V under the next unit's softmax: P, the scores and the output held
  // together fit ptxas's 168 registers up to head width 64
  constexpr bool OVERLAP = DH <= 64;
  static_assert(!SW || 64 % DH == 0, "swizzled slabs hold whole heads of 8 to 64");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + (ALIGN - 1)) & ~uintptr_t(ALIGN - 1));
  const Layout& L = p.lay;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + MAX_STAGES;
  const int ST = p.stages, TR = p.qt * 64, G = p.hb * DH, c0 = G / 8;

  // SW with two query tiles: each warpgroup stores its own 64 rows (its
  // units are every head of its tile) and releases its half of the stage
  const bool split = SW && p.qt == NWG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], split ? 2 : 1);   // the threads that store the item's output
    }
    mbar_fence_init();
  }
  for (int e = threadIdx.x; e < 2 * NK; e += blockDim.x)
    *reinterpret_cast<uint4*>(smem + L.zero_off + e * 16) =
        e < NK ? make_uint4(0u, 0u, 0u, 0u) : make_uint4(ONES2, ONES2, ONES2, ONES2);
  fence_proxy_async();
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == NWG) {
    // ---- producer ----
    if (threadIdx.x != 128 * NWG) return;
    int n = 0;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
      const int hg = it % p.ng, px = it / p.ng, b = px / p.HW, pix = px % p.HW;
      const int stage = n % ST, round = n / ST;
      if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
      unsigned char* base = smem + stage * L.stage_bytes;
      mbar_arrive_expect_tx(&full[stage], L.stage_bytes);
      if constexpr (SW) {
        for (int j = 0; j < G / 64; ++j) {
          const int c = hg * G + 64 * j;
          tma_load_4d(base + j * TR * 128, &p.q, &full[stage], c, 0, pix, b);
          tma_load_4d(base + L.q_bytes + j * NK * 128, &p.k, &full[stage], c, 0, pix, b);
          tma_load_4d(base + L.q_bytes + L.k_bytes + j * NK * 128, &p.v, &full[stage], c, 0,
                      pix, b);
        }
      } else {
        tma_load_5d(base, &p.q, &full[stage], 0, 0, hg * c0, pix, b);
        tma_load_5d(base + L.q_bytes, &p.k, &full[stage], 0, 0, hg * c0, pix, b);
        tma_load_5d(base + L.q_bytes + L.k_bytes, &p.v, &full[stage], 0, 0, hg * c0, pix, b);
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = role, tw = threadIdx.x % 128, lane = tw % 32, g = lane / 4, t4 = lane % 4;
  const uint32_t sbase = smem_addr(smem);
  const uint32_t zero = sbase + L.zero_off, ones = sbase + L.ones_off;
  const float sl = p.scale_log2, kf = BIAS ? 1.f : sl;
  const int r = (tw / 32) * 16 + g;   // this thread's rows of a unit: r, r + 8
  float s[NK / 2], acc[NACC];
  uint32_t pa[NK / 16][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NK / 16; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0u;
  auto fence_pa = [&] {
#pragma unroll
    for (int j = 0; j < NK / 16; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) fence_operand(pa[j][x]);
  };
  // the consumer warpgroups take turns to issue their products, in a ring of
  // named barriers (NWG + 1 ...), where they take the same number of units,
  // so that one's softmax runs while the next waits for its scores;
  // warpgroup 0 goes first, and the last skips the very last arrival
  const bool pingpong = p.units % NWG == 0;
  auto turn_begin = [&] {
    if (pingpong) named_barrier(NWG + 1 + wg, 256);
  };
  auto turn_end = [&](bool final_turn) {
    if (pingpong && !(wg == NWG - 1 && final_turn))
      named_barrier_arrive(NWG + 1 + (wg + 1) % NWG, 256);
  };
  if (pingpong && wg == NWG - 1) named_barrier_arrive(NWG + 1, 256);
  // unit u: query tile u % 2 of head u / 2 with two tiles an item, else head u
  auto qt_of = [&](int u) { return p.qt == 2 ? u & 1 : 0; };
  auto hl_of = [&](int u) { return p.qt == 2 ? u >> 1 : u; };
  int n = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
    const int hg = it % p.ng, px = it / p.ng, b = px / p.HW, pix = px % p.HW;
    const int stage = n % ST;
    const bool last_item = it + (int)gridDim.x >= p.items;
    const int qoff = stage * L.stage_bytes, koff = qoff + L.q_bytes, voff = koff + L.k_bytes;
    mbar_spin(&full[stage], (n / ST) & 1);
    // a unit's Q rows and V columns (byte offsets in smem): a slab and a
    // channel offset o in its rows, or the head's first chunk
    auto slab_of = [&](int u) { return SW ? hl_of(u) * DH / 64 : 0; };
    auto o_of = [&](int u) { return SW ? hl_of(u) * DH % 64 : 0; };
    auto qa_of = [&](int u) {
      return SW ? qoff + slab_of(u) * TR * 128 + qt_of(u) * 64 * 128
                : qoff + (hl_of(u) * DC * TR + qt_of(u) * 64) * 16;
    };
    auto va_of = [&](int u) {
      return SW ? voff + slab_of(u) * NK * 128 + 2 * o_of(u) : voff + hl_of(u) * DC * NK * 16;
    };
    auto issue_pv = [&](int va) {
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        if constexpr (SW) {
          pv_sums_step_sw<DH>(acc, pa[kk], sbase + va + kk * 16 * 128, ones + kk * 16 * 16);
        } else {
          pv_sums_step<DH>(acc, pa[kk], sbase + va + kk * 16 * 16, NK * 16, ones + kk * 16 * 16);
        }
      }
      wgmma_commit();
    };
    // the normalised bf16 output of unit u over its own Q rows
    auto store_unit = [&](int u) {
      const int qa = qa_of(u), o = o_of(u);
      const float i0 = 1.f / acc[DH / 2], i1 = 1.f / acc[DH / 2 + 2];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        unsigned char* d0 = SW ? smem + qa + sw128_offset(r, o / 8 + c) + 4 * t4
                               : smem + qa + (c * TR + r) * 16 + 4 * t4;
        unsigned char* d1 = SW ? smem + qa + sw128_offset(r + 8, o / 8 + c) + 4 * t4
                               : d0 + 8 * 16;
        *reinterpret_cast<__nv_bfloat162*>(d0) =
            __floats2bfloat162_rn(acc[c * 4 + 0] * i0, acc[c * 4 + 1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(d1) =
            __floats2bfloat162_rn(acc[c * 4 + 2] * i1, acc[c * 4 + 3] * i1);
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    };
    // OVERLAP: a unit's Q.K^T and the previous unit's P.V are issued together
    // (the first unit's P.V a dummy with P 0), and that P.V runs under this
    // unit's softmax; no product is in flight from one unit to the next.
    // this warpgroup's units u = wg + NWG i
    int prev = -1;   // the unit whose P is in pa
    for (int u = wg; u < p.units; u += NWG) {
      const int hl = hl_of(u), qt = qt_of(u), o = o_of(u), qa = qa_of(u);
      const int ka = SW ? koff + slab_of(u) * NK * 128 : koff + hl * DC * NK * 16;
      fence_frag(s);
      fence_frag(acc);
      fence_pa();
      turn_begin();
      wgmma_fence();
      if constexpr (SW && DH == 8) {   // A from registers, the other head's channels zero
        uint32_t a[4];
        head8_frag(smem + qa, (tw / 32) * 16, o, a);
        const uint64_t db = wgmma_desc_sw128(sbase + ka + 2 * (o & ~15), 16, 1024);
        if constexpr (KT == 18) {
          wgmma_rs_k_n144(s, a, db, 0);
        } else {
          wgmma_rs_k_n128(s, a, db, 0);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint64_t da, db;
          if constexpr (SW) {
            da = wgmma_desc_sw128(sbase + qa + 2 * o + 32 * kk, 16, 1024);
            db = wgmma_desc_sw128(sbase + ka + 2 * o + 32 * kk, 16, 1024);
          } else {
            const uint32_t a = sbase + qa + 2 * kk * TR * 16, bk = sbase + ka + 2 * kk * NK * 16;
            const bool pad = 2 * kk + 1 >= DC;   // the step's second 8 channels: the zero chunk
            da = wgmma_desc(a, pad ? zero - a : TR * 16, 128);
            db = wgmma_desc(bk, pad ? zero - bk : NK * 16, 128);
          }
          if constexpr (KT == 18) {
            wgmma_ss_n144(s, da, db, kk > 0);
          } else {
            wgmma_ss_n128(s, da, db, kk > 0);
          }
        }
      }
      wgmma_commit();
      if constexpr (OVERLAP) issue_pv(prev >= 0 ? va_of(prev) : va_of(u));
      turn_end(!OVERLAP && last_item && u + NWG >= p.units);
      if constexpr (OVERLAP) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_frag(s);
      if constexpr (BIAS) {   // s * scale * log2e + bias * log2e on the real rows and keys
        const float* bh = p.bias + (size_t)(hg * p.hb + hl) * p.S * p.Sk;
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) {
          const int key = (i / 4) * 8 + 2 * t4 + (i & 1), row = qt * 64 + r + ((i >> 1) & 1) * 8;
          float x = s[i] * sl;
          if (key < p.Sk && row < p.S)
            x = fmaf(__ldg(bh + (size_t)row * p.Sk + key), 1.4426950408889634f, x);
          s[i] = x;
        }
      }
      if (p.Sk < NK) mask_keys(s, p.Sk);
      float m0, m1;
      quad_row_max(s, m0, m1);   // key 0 exists, so both maxima are finite
      exp2_frag(s, kf, -m0 * kf, -m1 * kf, (p.Sk + 7) / 8);
      if constexpr (OVERLAP) {
        wgmma_wait<0>();
        fence_frag(acc);
        fence_pa();
        if (prev >= 0) {
          store_unit(prev);
        } else {   // the dummy P.V read a P that is not this item's
#pragma unroll
          for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
        }
        pack_frag(s, pa);
        prev = u;
      } else {
        pack_frag(s, pa);
        fence_frag(acc);
        fence_pa();
        wgmma_fence();
        issue_pv(va_of(u));
        wgmma_wait<0>();
        fence_frag(acc);
        store_unit(u);
      }
    }
    if (OVERLAP && prev >= 0) {   // the last unit's P.V
      fence_frag(acc);
      fence_pa();
      turn_begin();
      wgmma_fence();
      issue_pv(va_of(prev));
      turn_end(last_item);
      wgmma_wait<0>();
      fence_frag(acc);
      store_unit(prev);
    }
    fence_proxy_async();
    if (split) {
      named_barrier(1 + wg, 128);   // this warpgroup's rows are staged
      if (tw == 0) {
        for (int j = 0; j < G / 64; ++j)
          tma_store_4d(&p.o, smem + qoff + j * TR * 128 + wg * 64 * 128, hg * G + 64 * j,
                       wg * 64, pix, b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(&empty[stage]);
      }
    } else {
      named_barrier(1, 128 * NWG);   // every warpgroup's outputs are staged
      if (threadIdx.x == 0) {
        if constexpr (SW) {
          for (int j = 0; j < G / 64; ++j)
            tma_store_4d(&p.o, smem + qoff + j * TR * 128, hg * G + 64 * j, 0, pix, b);
        } else {
          tma_store_5d(&p.o, smem + qoff, 0, 0, hg * c0, pix, b);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(&empty[stage]);
      }
    }
  }
  if (tw == 0) bulk_wait();
}

// A 5-D map over a bf16 [B, S, HW, C] tensor seen as (8 channels, S frames,
// C / 8 chunks, HW pixels, B): one box of (8, rows, chunks, 1, 1) lands in
// shared memory as the [chunk][row][8] tile of one pixel; rows past S read
// as zeros (and are not written by a store).
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int HW, int C, int rows,
              int chunks) {
  const cuuint64_t dims[5] = {8, (cuuint64_t)S, (cuuint64_t)C / 8, (cuuint64_t)HW,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)HW * C * 2, 16, (cuuint64_t)C * 2,
                                 (cuuint64_t)S * HW * C * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1, 1};
  return hopper::make_bf16_map(map, ptr, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A 4-D map over a bf16 [B, S, HW, C] tensor, 128-byte-swizzled boxes of
// (64 channels, rows, 1 pixel, 1): a pixel's slab of 64 channels, each row
// one 128-byte piece; rows past S read as zeros.
bool make_map_sw(CUtensorMap* map, const void* ptr, int B, int S, int HW, int C, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)HW, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HW * C * 2, (cuuint64_t)C * 2,
                                 (cuuint64_t)S * HW * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return hopper::make_bf16_map(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DH, int KT, bool SW>
cudaError_t launch(Params& p, int B, int C, const void* q, const void* k, const void* v, void* o,
                   int grid, cudaStream_t stream) {
  const int chunks = p.hb * DH / 8, rows = p.qt * 64;
  const bool ok = SW ? make_map_sw(&p.q, q, B, p.S, p.HW, C, rows) &&
                           make_map_sw(&p.k, k, B, p.Sk, p.HW, C, KT * 8) &&
                           make_map_sw(&p.v, v, B, p.Sk, p.HW, C, KT * 8) &&
                           make_map_sw(&p.o, o, B, p.S, p.HW, C, p.qt == 2 ? 64 : rows)
                     : make_map(&p.q, q, B, p.S, p.HW, C, rows, chunks) &&
                           make_map(&p.k, k, B, p.Sk, p.HW, C, KT * 8, chunks) &&
                           make_map(&p.v, v, B, p.Sk, p.HW, C, KT * 8, chunks) &&
                           make_map(&p.o, o, B, p.S, p.HW, C, rows, chunks);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = p.bias ? frame_attention_long_kernel<DH, KT, true, SW>
                       : frame_attention_long_kernel<DH, KT, false, SW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.lay.total);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, p.lay.total, stream>>>(p);
  return cudaGetLastError();
}

// The swizzled instances exist at the widths a 64-channel slab holds whole.
template <int DH, int KT>
cudaError_t launch_sw(Params& p, bool sw, int B, int C, const void* q, const void* k,
                      const void* v, void* o, int grid, cudaStream_t stream) {
  if constexpr (64 % DH == 0) {
    if (sw) return launch<DH, KT, true>(p, B, C, q, k, v, o, grid, stream);
  } else {
    if (sw) return cudaErrorInvalidValue;
  }
  return launch<DH, KT, false>(p, B, C, q, k, v, o, grid, stream);
}

}  // namespace long_body

}  // namespace

// 1 <= S <= 32, S <= Sk <= S + 16, DH 8/16/32/40/64/80/160, scale > 0;
// pointers 16-byte aligned. bias: fp32 [C / DH, S, Sk], or null. The launch
// plan (heads per block, pixels per block, threads, dynamic shared bytes)
// comes from ops/frame_attention.py::frame_plan; a plan that does not match
// the shape is refused.
extern "C" int anyv2v_frame_attention(const void* q, const void* k, const void* v,
                                      const float* bias, void* o, int B, int S, int Sk, int HW,
                                      int C, int DH, float scale, int heads_per_block,
                                      int pixels_per_block, int threads, int smem_bytes,
                                      void* stream) {
  if (B <= 0 || S <= 0 || S > 32 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
      C % DH != 0 || heads_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int H = C / DH;
  const float sl = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
#define ANYV2V_CASE(D)                                                                       \
  case D:                                                                                    \
    return (int)launch<D>(q, k, v, bias, o, B, S, Sk, HW, H, heads_per_block, pixels_per_block, \
                          threads, smem_bytes, sl, s);
    ANYV2V_CASE(8)
    ANYV2V_CASE(16)
    ANYV2V_CASE(32)
    ANYV2V_CASE(40)
    ANYV2V_CASE(64)
    ANYV2V_CASE(80)
    ANYV2V_CASE(160)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2 long: 32 < S <= 128, S <= Sk <= S + 16, DH 8/16/32/40/64/80/160, scale >
// 0; pointers 16-byte aligned; bias fp32 [C / DH, S, Sk] or null. The launch
// plan (ops/frame_attention.py frame_long_plan): heads a group, 64-row query
// tiles an item (2 where S > 64), the swizzled layout (where the group is
// whole 64-channel slabs of heads 8 to 64 wide), item stages, the persistent grid and
// smem_bytes, refused unless they match the shape and this file's layout.
extern "C" int anyv2v_frame_attention_long(const void* q, const void* k, const void* v,
                                           const float* bias, void* o, int B, int S, int Sk,
                                           int HW, int C, int DH, float scale,
                                           int heads_per_block, int q_tiles, int swizzle,
                                           int stages, int grid, int smem_bytes,
                                           void* stream) {
  using namespace long_body;
  if (B <= 0 || S <= 32 || S > 128 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
      C % DH != 0 || heads_per_block <= 0 || (C / DH) % heads_per_block != 0 ||
      (heads_per_block > 1 && heads_per_block * DH > 128) || q_tiles != (S > 64 ? 2 : 1) ||
      stages < 1 || stages > MAX_STAGES || !(scale > 0.f) ||
      swizzle != (64 % DH == 0 && heads_per_block * DH % 64 == 0 ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.bias = bias;
  p.S = S;
  p.Sk = Sk;
  p.HW = HW;
  p.hb = heads_per_block;
  p.ng = C / DH / heads_per_block;
  p.qt = q_tiles;
  p.units = q_tiles * heads_per_block;
  p.stages = stages;
  p.scale_log2 = scale * kLog2e;
  const long long items = (long long)B * HW * p.ng;
  if (items > 0x7fffffffLL || grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  const int kt = Sk <= 128 ? 16 : 18;
  p.lay = make_layout(heads_per_block * DH, 64 * q_tiles, kt * 8, stages);
  if (smem_bytes != p.lay.total || p.lay.total > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
#define ANYV2V_CASE(D)                                                                  \
  case D:                                                                               \
    return kt == 16 ? (int)launch_sw<D, 16>(p, swizzle, B, C, q, k, v, o, grid, s)      \
                    : (int)launch_sw<D, 18>(p, swizzle, B, C, q, k, v, o, grid, s);
    ANYV2V_CASE(8)
    ANYV2V_CASE(16)
    ANYV2V_CASE(32)
    ANYV2V_CASE(40)
    ANYV2V_CASE(64)
    ANYV2V_CASE(80)
    ANYV2V_CASE(160)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
