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
// What bounds it on the H100, up to 32 frames: bytes, q, k and v read once
// and the output written once (2 x B*(S+Sk)*HW*C*2 bytes, 400 MB for an
// i2vgen-xl L0 edit call at 16 frames, 0.66 GB for ConsistI2V's); the
// S*Sk*DH multiply-adds per head are few by comparison. At 128 frames the
// multiply-adds grow 64-fold (4.1e11 operations against 6.4 GB at L0 batch 3,
// 64 per byte, under the card's ~295) and so do the exponentials (1.3e10,
// 3.1 ms at the special-function units' 16 per clock per SM): on the tensor
// cores the products are cheap, and the softmax's exp2 count and the
// instructions around it bound the long route, not its bytes.
//
// One body, on the tensor cores, for 1 <= S <= 128. It replaces two CUDA-core
// bodies that served S <= 32 in fp32 (one thread per channel pair with the
// per-head sums as shuffle butterflies; R lanes per query row with keys in
// chunks of 8), which ran 4-9x their byte bound. Each (b, pixel, head) is a
// whole [S] x [Sk] attention problem, so the body is built around pixels:
//  - A block owns P pixels (consecutive in b*HW + pixel) and a group of whole
//    heads, at most 128 channels (one head of 160): Q [S, G], K and V [Sk, G]
//    of each pixel come into shared memory by cp.async, 16 bytes a thread,
//    rows past S or Sk zero-filled, Q and K in one group and V in a second,
//    so the first items' scores overlap V's flight. Past 32 frames P = 1
//    (one pixel is about 100 KB at 128), compiled as a constant; at 16
//    frames one pixel is 13 KB, so P grows until a block moves about 16 KB,
//    with two blocks' shared memory still on one SM, so one block's copies
//    overlap the other's math (on an H100,
//    8 KB blocks summed to the same time over the K2 cases within 2 %; 24,
//    32, 64 and 128 KB were slower). Rows are padded to an odd number of
//    16-byte units, so ldmatrix is free of bank conflicts.
//    ops/frame_attention.py's frame_plan sizes the block; the entry refuses
//    a plan that differs.
//  - A warp takes 16 query frames of one head of one pixel (an item) at a
//    time. Scores: Q and K by ldmatrix, mma.sync m16n8k16 steps over the
//    head width and an m16n8k8 step for its last 8 channels (dh 8, 40), bf16
//    in, fp32 out; all Sk keys of a row are held at once (KT tiles of 8 keys:
//    2, 4 or 6 up to 48 keys, 16 or 18 past 32 frames), so the softmax is
//    exact in one pass: the row maximum, then exp2 by ex2.approx of one fma
//    (scale folded, as the true head width gives it; a bias adds bias *
//    log2(e) first; keys >= Sk are -inf).
//  - P goes to bf16 A fragments; P.V runs on the tensor cores with V by
//    ldmatrix.trans, in chunks of 64 output channels, and the row sums come
//    from the same bf16 P against a column of ones (one more mma per 16
//    keys). The normalised bf16 output overwrites the item's own Q tile, and
//    the block stores whole 16-byte rows at the end; query rows >= S are not
//    stored.
// Two kernel symbols share the body, so that a profile tells the routes
// apart: frame_attention_kernel (S <= 32) and frame_attention_long_kernel
// (32 < S <= 128, the long-video route, one pixel per block).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
// staged back in Q's place and stored in whole rows. ONE: one pixel per
// block (P = 1, the long route), known at compile time, so that no pixel
// index is computed per item.
template <int DH, int KT, bool BIAS, bool ONE>
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
  const int npix = ONE ? 1 : min(P, npix_total - bp0);
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
    const int x = ONE || !has ? 0 : it / per_pix, rest = !has ? 0 : ONE ? it : it % per_pix;
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

#define ANYV2V_FRAME_PARAMS                                                                    \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k,                   \
      const __nv_bfloat16 *__restrict__ v, const float *__restrict__ bias,                    \
      __nv_bfloat16 *__restrict__ o, int S, int Sk, int HW, int H, int HB, int npix_total, int P, \
      float scale_log2

// S <= 32 (K2)
template <int DH, int KT, bool BIAS>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) frame_attention_kernel(ANYV2V_FRAME_PARAMS) {
  frame_body<DH, KT, BIAS, false>(q, k, v, bias, o, S, Sk, HW, H, HB, npix_total, P,
                                  scale_log2);
}

// 32 < S <= 128 (K2 long): one pixel per block
template <int DH, int KT, bool BIAS>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) frame_attention_long_kernel(
    ANYV2V_FRAME_PARAMS) {
  frame_body<DH, KT, BIAS, true>(q, k, v, bias, o, S, Sk, HW, H, HB, npix_total, 1, scale_log2);
}
#undef ANYV2V_FRAME_PARAMS

// LONG_ROUTE: the K2 long symbol (S > 32, KT 16 or 18), else K2's (KT 2, 4 or 6);
// each symbol is instantiated only at the tile counts it is launched with.
template <int DH, int KT, bool LONG_ROUTE>
cudaError_t launch_kt(const void* q, const void* k, const void* v, const float* bias, void* o,
                      int B, int S, int Sk, int HW, int H, int HB, int P, int threads, int smem,
                      float scale_log2, cudaStream_t stream) {
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*, const float*,
                 __nv_bfloat16*, int, int, int, int, int, int, int, float);
  if constexpr (LONG_ROUTE)
    kernel = bias ? frame_attention_long_kernel<DH, KT, true>
                  : frame_attention_long_kernel<DH, KT, false>;
  else
    kernel = bias ? frame_attention_kernel<DH, KT, true> : frame_attention_kernel<DH, KT, false>;
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

// Score tiles of 8 keys held per item: Sk rounded to 16 up to 48 keys (S <=
// 32), else 16 (up to 128 keys) or 18 (144).
template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o,
                   int B, int S, int Sk, int HW, int H, int HB, int P, int threads, int smem,
                   float scale_log2, cudaStream_t stream) {
  const int G = HB * DH;
  if (H % HB != 0 || G % 8 != 0 || P < 1 || (S > 32 && P != 1) ||
      smem != P * (round16(S) + 2 * round16(Sk)) * row_stride(G) * 2 || threads % 32 != 0 ||
      threads < 32 || threads > MAX_WARPS * 32 || (long long)B * HW > 0x7fffffffLL ||
      H / HB > 65535 || !(scale_log2 > 0.f))
    return cudaErrorInvalidValue;
#define ANYV2V_KT(N, ROUTE)                                                                \
  launch_kt<DH, N, ROUTE>(q, k, v, bias, o, B, S, Sk, HW, H, HB, P, threads, smem, scale_log2, \
                         stream)
  if (S <= 32) {
    const int kt = round16(Sk) / 8;
    return kt == 2 ? ANYV2V_KT(2, false) : kt == 4 ? ANYV2V_KT(4, false) : ANYV2V_KT(6, false);
  }
  return Sk <= 128 ? ANYV2V_KT(16, true) : ANYV2V_KT(18, true);
#undef ANYV2V_KT
}

}  // namespace

// 1 <= S <= 128, S <= Sk <= S + 16, DH 8/16/32/40/64/80/160, scale > 0;
// pointers 16-byte aligned. bias: fp32 [C / DH, S, Sk], or null. The launch
// plan (heads per block, pixels per block, threads, dynamic shared bytes)
// comes from ops/frame_attention.py::frame_plan; a plan that does not match
// the shape is refused.
extern "C" int anyv2v_frame_attention(const void* q, const void* k, const void* v,
                                      const float* bias, void* o, int B, int S, int Sk, int HW,
                                      int C, int DH, float scale, int heads_per_block,
                                      int pixels_per_block, int threads, int smem_bytes,
                                      void* stream) {
  if (B <= 0 || S <= 0 || S > 128 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
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
