// K2 frame_attention: self-attention over the frame axis S of temporal tokens
// x [B, S, HW, C] (C = heads * DH), for every (batch, pixel, head), bf16.
//
// Keys k/v [B, Sk, HW, C] may carry extra frames past S (ConsistI2V's
// augmented first-frame window, appended on the frame axis).
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_temporal_ew.py     _ew_kernel      (L0 temporal, HW 4096, dh 8)
//   pallas_short_attention.py _strided_kernel (L1/L2/mid temporal and
//                                              transformer_in, dh 16/32/64;
//                                              ConsistI2V, Sk = 25, dh 40/80;
//                                              SEINE, bias, dh 40/80/160)
//   pallas_short_attention.py _short_kernel   (as short_attention_frames
//                                              calls it past 32 frames: the
//                                              128-frame long-video path)
// The first two read the native [B, S, HW, C] layout so the temporal
// transformer never transposes its tokens; past 32 frames the JAX package
// transposes to [B*HW, S, C] for _short_kernel. These kernels read the native
// layout at every S and compute S x Sk scores per (batch, pixel, head), as
// _ew_kernel did (K2 long rounds both up to 16).
//
// Optional bias: an fp32 [H, S, Sk] table shared by every batch row and pixel
// (SEINE's T5 relative-position bias: 8 KB at 8 heads x 16 x 16, 590 KB at
// 8 heads x 128 x 144), added to the scaled scores. Every body works in the
// exp2 domain, so each score gains bias * log2(e) before the running max, as
// _ew_kernel adds it. The table is read through __ldg (a 16-frame table stays
// in L1, a 128-frame one in L2); a null pointer means no bias, and that
// instantiation is the bias-free code unchanged. Keys past Sk stay -inf. The
// bias must be finite.
//
// What bounds it on the H100, up to 32 frames: bytes, q, k and v read once
// and the output written once (2 x B*(S+Sk)*HW*C*2 bytes, 400 MB for an
// i2vgen-xl L0 edit call at 16 frames, 0.66 GB for ConsistI2V's); the
// S*Sk*DH multiply-adds per head are few by comparison. At 128 frames (K2
// long) the multiply-adds grow 64-fold (4.1e11 operations against 6.4 GB at
// L0 batch 3, 64 per byte, under the card's ~295) and so do the exponentials
// (1.3e10, 3.1 ms at the special-function units' 16 per clock per SM):
// on the tensor cores the products are cheap, and the softmax's exp2 count
// and the instructions around it bound the long route, not its bytes.
//
// Three kernels, three bodies:
//
// frame_attention_kernel (Sk == S <= 32, DH a power of two <= 64: i2vgen-xl's
// temporal layers). One thread per (batch, pixel, channel pair); neighbouring
// threads hold neighbouring channels, so each warp reads 128 contiguous bytes
// per frame (coalesced bf16x2 loads). A head spans DH/2 consecutive lanes, and
// the per-head q.k sum over DH is a butterfly of warp shuffles inside that
// lane group. Each thread keeps its two channels of k and v for all S frames
// in registers and loops over query frames: S scores, fp32 softmax with
// exp2f, then p.v for its two channels. It cannot go past 32 frames: at 128
// that is 512 registers of keys and values per thread.
//
// frame_attention_rows_kernel (S <= 32, S <= Sk <= S + 16, DH
// 8/16/40/80/160: ConsistI2V's temporal layers, 8 heads of 40/80/160 over 17
// frames plus 8 augmented first-frame keys; SEINE's with its bias): rows_body.
// DH/2 lanes is no power of two at DH 40, and 48 keys of two channels would
// not fit in registers, so the work is cut the other way: R lanes own one
// query row (b, pixel, head, frame), each holding CW = DH/R channels of q and
// of the fp32 accumulator (CW <= 40). Keys stream in chunks of 8 with one
// online-softmax rescale per chunk, on CUDA cores in fp32.
//
// frame_attention_long_kernel (K2 long: 32 < S <= 128, S <= Sk <= S + 16, DH
// 8/16/32/40/64/80/160: i2vgen-xl at 128 frames with 64 heads of 8/16/32,
// transformer_in's 8 of 64, SEINE's widths with the bias). Replaces
// _short_kernel past 32 frames on the native layout. Each (b, pixel, head)
// is a whole [S <= 128] x [Sk <= 144] attention problem, so the body is
// built around one pixel at a time, on the tensor cores:
//  - A block owns one (b, pixel) and a group of whole heads, at most 128
//    channels (one head of 160): Q [S, G], K and V [Sk, G] come into shared
//    memory by cp.async, 16 bytes a thread, rows past S or Sk zero-filled,
//    Q and K in one group and V in a second, so the first items' scores
//    overlap V's flight; two blocks share an SM, so one block's copies
//    overlap the other's math. Rows are padded to an odd number of 16-byte
//    units, so ldmatrix is free of bank conflicts. ops/frame_attention.py's
//    long_plan sizes the block; the entry refuses a plan that differs.
//  - A warp takes 16 query frames of one head (an item) at a time. Scores:
//    Q and K by ldmatrix, mma.sync m16n8k16 steps over the head width and an
//    m16n8k8 step for its last 8 channels (dh 8, 40), bf16 in, fp32 out; all
//    Sk keys of a row are held at once (16 or 18 tiles of 8 keys), so the
//    softmax is exact in one pass: the row maximum, then exp2 by ex2.approx
//    of one fma (scale folded, as the true head width gives it; a bias adds
//    bias * log2(e) first; keys >= Sk are -inf).
//  - P goes to bf16 A fragments; P.V runs on the tensor cores with V by
//    ldmatrix.trans, in chunks of 64 output channels, and the row sums come
//    from the same bf16 P against a column of ones (one more mma per 16
//    keys). The normalised bf16 output overwrites the item's own Q tile, and
//    the block stores whole 16-byte rows at the end; query rows >= S are not
//    stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

template <int SMAX, int LANES, bool BIAS>
__global__ void __launch_bounds__(256) frame_attention_kernel(
    const __nv_bfloat162* __restrict__ q, const __nv_bfloat162* __restrict__ k,
    const __nv_bfloat162* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat162* __restrict__ o, int S, int HW, int half, long long total,
    float scale_log2) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = gid < total;
  // threads past the end form whole lane groups of their own (total is a
  // multiple of LANES): they load a valid address and never store
  const long long g = valid ? gid : total - 1;
  const int c2 = (int)(g % half);
  const long long bp = g / half;
  const int p = (int)(bp % HW);
  const long long b = bp / HW;
  const long long frame_stride = (long long)HW * half;
  const long long base = (b * S * HW + p) * half + c2;
  // this channel pair's head: its [S, S] bias block
  const float* hb = BIAS ? bias + (long long)(c2 / LANES) * S * S : nullptr;

  float2 kr[SMAX], vr[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < S) {
      kr[j] = __bfloat1622float2(k[base + j * frame_stride]);
      vr[j] = __bfloat1622float2(v[base + j * frame_stride]);
    } else {
      kr[j] = make_float2(0.f, 0.f);
      vr[j] = make_float2(0.f, 0.f);
    }
  }

  for (int i = 0; i < S; ++i) {
    float2 qv = __bfloat1622float2(q[base + i * frame_stride]);
    qv.x *= scale_log2;
    qv.y *= scale_log2;
    float sc[SMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        float part = fmaf(qv.x, kr[j].x, qv.y * kr[j].y);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (BIAS) part = fmaf(__ldg(hb + i * S + j), kLog2e, part);
        sc[j] = part;
        mx = fmaxf(mx, part);
      } else {
        sc[j] = -INFINITY;
      }
    }
    float sum = 0.f;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        const float pj = exp2f(sc[j] - mx);
        sum += pj;
        acc.x = fmaf(pj, vr[j].x, acc.x);
        acc.y = fmaf(pj, vr[j].y, acc.y);
      }
    }
    if (valid) {
      const float inv = 1.f / sum;
      o[base + i * frame_stride] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    }
  }
}

template <int SMAX>
cudaError_t launch_s(const void* q, const void* k, const void* v,
                     const float* bias, void* o, int B, int S, int HW, int C,
                     int DH, float scale_log2, cudaStream_t stream) {
  const int half = C / 2;
  const long long total = (long long)B * HW * half;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto q2 = (const __nv_bfloat162*)q;
  auto k2 = (const __nv_bfloat162*)k;
  auto v2 = (const __nv_bfloat162*)v;
  auto o2 = (__nv_bfloat162*)o;
  switch (DH / 2) {
#define ANYV2V_CASE(L)                                                        \
  case L:                                                                     \
    if (bias)                                                                 \
      frame_attention_kernel<SMAX, L, true>                                   \
          <<<(unsigned)blocks, threads, 0, stream>>>(q2, k2, v2, bias, o2, S, \
                                                     HW, half, total,         \
                                                     scale_log2);             \
    else                                                                      \
      frame_attention_kernel<SMAX, L, false>                                  \
          <<<(unsigned)blocks, threads, 0, stream>>>(q2, k2, v2, nullptr, o2, \
                                                     S, HW, half, total,      \
                                                     scale_log2);             \
    break;
    ANYV2V_CASE(1)
    ANYV2V_CASE(2)
    ANYV2V_CASE(4)
    ANYV2V_CASE(8)
    ANYV2V_CASE(16)
    ANYV2V_CASE(32)
#undef ANYV2V_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One query row (b, pixel, head, frame) per R lanes; see the header.
template <int CW, int R, bool BIAS>
__device__ __forceinline__ void rows_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int Sk, int HW, int H, long long total,
    float scale_log2) {
  constexpr int KCH = 8;
  constexpr int V8 = CW / 8;   // 16-byte loads per lane and frame
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = gid < total;
  // threads past the end work on the last row and store nothing, so every
  // lane of a row group joins the shuffles
  const long long g = valid ? gid : total - 1;
  const int r = (int)(g % R);
  long long rest = g / R;
  const int i = (int)(rest % S);
  rest /= S;
  const int h = (int)(rest % H);
  rest /= H;
  const int p = (int)(rest % HW);
  const long long b = rest / HW;
  const int C = H * CW * R;
  const int c0 = h * CW * R + r * CW;
  const long long fstride = (long long)HW * C;

  float qr[CW], acc[CW];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(q + ((b * S + i) * HW + p) * C + c0);
#pragma unroll
    for (int u = 0; u < V8; ++u) {
      const uint4 w = qp[u];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 f = __bfloat1622float2(e[x]);
        qr[u * 8 + 2 * x] = f.x * scale_log2;
        qr[u * 8 + 2 * x + 1] = f.y * scale_log2;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  const __nv_bfloat16* kb = k + (b * Sk * HW + p) * C + c0;
  const __nv_bfloat16* vb = v + (b * Sk * HW + p) * C + c0;
  // this row's bias: bias[h, i, :]
  const float* rb = BIAS ? bias + ((long long)h * S + i) * Sk : nullptr;

  for (int j0 = 0; j0 < Sk; j0 += KCH) {
    float s[KCH];
    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
      float dot = 0.f;
      if (j0 + jj < Sk) {
        const uint4* kp = reinterpret_cast<const uint4*>(kb + (j0 + jj) * fstride);
#pragma unroll
        for (int u = 0; u < V8; ++u) {
          const uint4 w = kp[u];
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float2 f = __bfloat1622float2(e[x]);
            dot = fmaf(qr[u * 8 + 2 * x], f.x, dot);
            dot = fmaf(qr[u * 8 + 2 * x + 1], f.y, dot);
          }
        }
      }
#pragma unroll
      for (int off = R / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float sv = -INFINITY;
      if (j0 + jj < Sk) sv = BIAS ? fmaf(__ldg(rb + j0 + jj), kLog2e, dot) : dot;
      s[jj] = sv;
      cmax = fmaxf(cmax, s[jj]);
    }
    // j0 < Sk: the chunk holds a real key, so cmax is finite
    const float m_new = fmaxf(m, cmax);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] *= corr;
#pragma unroll
    for (int jj = 0; jj < KCH; ++jj) {
      if (j0 + jj < Sk) {
        const float pj = exp2f(s[jj] - m_new);
        l += pj;
        const uint4* vp = reinterpret_cast<const uint4*>(vb + (j0 + jj) * fstride);
#pragma unroll
        for (int u = 0; u < V8; ++u) {
          const uint4 w = vp[u];
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float2 f = __bfloat1622float2(e[x]);
            acc[u * 8 + 2 * x] = fmaf(pj, f.x, acc[u * 8 + 2 * x]);
            acc[u * 8 + 2 * x + 1] = fmaf(pj, f.y, acc[u * 8 + 2 * x + 1]);
          }
        }
      }
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / l;
    uint4* op = reinterpret_cast<uint4*>(o + ((b * S + i) * HW + p) * C + c0);
#pragma unroll
    for (int u = 0; u < V8; ++u) {
      uint4 w;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        e[x] = __floats2bfloat162_rn(acc[u * 8 + 2 * x] * inv, acc[u * 8 + 2 * x + 1] * inv);
      op[u] = w;
    }
  }
}

// S <= 32 (K2's row body)
template <int CW, int R, bool BIAS>
__global__ void __launch_bounds__(128) frame_attention_rows_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int Sk, int HW, int H, long long total,
    float scale_log2) {
  rows_body<CW, R, BIAS>(q, k, v, bias, o, S, Sk, HW, H, total, scale_log2);
}

template <int CW, int R>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const float* bias, void* o, int B, int S, int Sk, int HW,
                        int H, float scale_log2, cudaStream_t stream) {
  const long long total = (long long)B * HW * H * S * R;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto qb = (const __nv_bfloat16*)q;
  auto kb = (const __nv_bfloat16*)k;
  auto vb = (const __nv_bfloat16*)v;
  auto ob = (__nv_bfloat16*)o;
  const unsigned grid = (unsigned)blocks;
  if (bias)
    frame_attention_rows_kernel<CW, R, true><<<grid, threads, 0, stream>>>(
        qb, kb, vb, bias, ob, S, Sk, HW, H, total, scale_log2);
  else
    frame_attention_rows_kernel<CW, R, false><<<grid, threads, 0, stream>>>(
        qb, kb, vb, nullptr, ob, S, Sk, HW, H, total, scale_log2);
  return cudaGetLastError();
}

// ---- K2 long: the tensor-core body (see the header) ----

constexpr int LONG_MAX_WARPS = 8;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

// Row stride (bf16) of a block's shared tiles for a group of G channels:
// 16-byte rows whose stride is an odd number of 16-byte units, so that the
// eight row addresses of an ldmatrix fall in eight different bank groups.
__host__ __device__ constexpr int long_row_stride(int G) { return G + 8 + 8 * ((G / 8) % 2); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Scores of one item (16 query frames of one head) against the Sk <= KT*8
// keys on the tensor cores, then the exact softmax numerators as bf16 A
// fragments of the P.V product. s[nt] is the m16n8 accumulator of keys
// nt*8..nt*8+7: rows g and g+8, keys 2t and 2t+1. Without a bias the row
// maximum is taken on the raw scores and the scale folds into one fma before
// ex2 (scale > 0); with one, the scaled score plus bias * log2(e) comes first.
template <int DH, int KT, bool BIAS>
__device__ __forceinline__ void long_scores(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                            int LD, int qt, int hc, int h, int S, int Sk,
                                            const float* __restrict__ bias, float scale_log2,
                                            uint32_t (&pa)[KT / 2][4]) {
  using namespace hopper;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float s[KT * 4];
#pragma unroll
  for (int i = 0; i < KT * 4; ++i) s[i] = 0.f;
  const __nv_bfloat16* qrow = qs + (qt * 16 + (lane & 15)) * LD + hc;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(qrow + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < KT / 2; ++np) {
      if (np * 16 < Sk) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + hc +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_m16n8k16(s + 4 * (2 * np), a, b[0], b[1]);
        mma_m16n8k16(s + 4 * (2 * np + 1), a, b[2], b[3]);
      }
    }
  }
  if constexpr (DH % 16 == 8) {   // the last 8 channels (dh 8, 40): m16n8k8
    constexpr int kb = DH / 16 * 16;
    uint32_t a0, a1;
    ldmatrix_x2(a0, a1, smem_addr(qrow + kb));
#pragma unroll
    for (int np = 0; np < KT / 2; ++np) {
      if (np * 16 < Sk) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, smem_addr(ks + (np * 16 + (lane & 15)) * LD + hc + kb));
        mma_m16n8k8(s + 4 * (2 * np), a0, a1, b0);
        mma_m16n8k8(s + 4 * (2 * np + 1), a0, a1, b1);
      }
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
  if (Sk < KT * 8) {   // keys past Sk (a ragged last tile, or Sk <= (KT-2)*8)
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
// own Q tile in shared memory (no other item reads it).
template <int DH, int KT>
__device__ __forceinline__ void long_pv(__nv_bfloat16* qs, const __nv_bfloat16* vs, int LD,
                                        int qt, int hc, int Sk, const uint32_t (&pa)[KT / 2][4]) {
  using namespace hopper;
  constexpr int NT = DH / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float i0 = 0.f, i1 = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += 8) {
    constexpr int CN = 8;
    float acc[CN][4], lsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < CN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      if (kk * 16 < Sk) {
        if (c0 == 0) mma_m16n8k16(lsum, pa[kk], BF16_ONES, BF16_ONES);
        const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + hc;
#pragma unroll
        for (int n = 0; n < CN; n += 2) {
          if (c0 + n + 1 < NT) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, smem_addr(vrow + (c0 + n) * 8 + (lane >> 4) * 8));
            mma_m16n8k16(acc[n], pa[kk], b[0], b[1]);
            mma_m16n8k16(acc[n + 1], pa[kk], b[2], b[3]);
          } else if (c0 + n < NT) {   // an odd last tile (dh 8, 40)
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, smem_addr(vs + (kk * 16 + (lane & 15)) * LD + hc +
                                                (c0 + n) * 8));
            mma_m16n8k16(acc[n], pa[kk], b0, b1);
          }
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

// One block per (batch row, pixel, group of HB heads): Q [S, G], K and V
// [Sk, G] of that pixel in shared memory (G = HB*DH channels, rows padded to
// 16 and zero-filled), every (head, 16 query frames) item on the tensor
// cores, the output staged back in Q's place and stored in whole rows.
template <int DH, int KT, bool BIAS>
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 2) frame_attention_long_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int Sk, int HW, int H, int HB, float scale_log2) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = HB * DH, LD = long_row_stride(G), CH = G / 8;
  const int rows_q = round16(S), rows_k = round16(Sk);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + rows_q * LD;
  __nv_bfloat16* vs = ks + rows_k * LD;

  const long long b = blockIdx.x / HW;
  const int p = blockIdx.x % HW;
  const int C = H * DH, c0 = blockIdx.y * G;
  const long long fstride = (long long)HW * C;
  const __nv_bfloat16* qg = q + (b * S * HW + p) * C + c0;
  const __nv_bfloat16* kg = k + (b * Sk * HW + p) * C + c0;
  const __nv_bfloat16* vg = v + (b * Sk * HW + p) * C + c0;
  const int nthreads = blockDim.x, tid = threadIdx.x;

  // Q and K first, V second: the first items' scores overlap V's flight.
  // Rows past S or Sk are zero-filled (their source address clamped).
  for (int e = tid; e < rows_q * CH; e += nthreads) {
    const int r = e / CH, c = e % CH;
    cp_async16(smem_addr(qs + r * LD + c * 8), qg + min(r, S - 1) * fstride + c * 8, r < S);
  }
  for (int e = tid; e < rows_k * CH; e += nthreads) {
    const int r = e / CH, c = e % CH;
    cp_async16(smem_addr(ks + r * LD + c * 8), kg + min(r, Sk - 1) * fstride + c * 8, r < Sk);
  }
  cp_async_commit();
  for (int e = tid; e < rows_k * CH; e += nthreads) {
    const int r = e / CH, c = e % CH;
    cp_async16(smem_addr(vs + r * LD + c * 8), vg + min(r, Sk - 1) * fstride + c * 8, r < Sk);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid / 32, nwarps = nthreads / 32;
  const int qtiles = rows_q / 16, items = HB * qtiles;
  for (int it = warp, first = 1;; it += nwarps, first = 0) {
    const bool has = it < items;
    const int hh = has ? it / qtiles : 0, qt = has ? it % qtiles : 0;
    uint32_t pa[KT / 2][4];
    if (has)
      long_scores<DH, KT, BIAS>(qs, ks, LD, qt, hh * DH, blockIdx.y * HB + hh, S, Sk, bias,
                                scale_log2, pa);
    if (first) {   // every warp passes here once: V has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!has) break;
    long_pv<DH, KT>(qs, vs, LD, qt, hh * DH, Sk, pa);
  }
  __syncthreads();
  __nv_bfloat16* og = o + (b * S * HW + p) * C + c0;
  for (int e = tid; e < S * CH; e += nthreads) {
    const int r = e / CH, c = e % CH;
    *reinterpret_cast<uint4*>(og + r * fstride + c * 8) =
        *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);
  }
}

template <int DH, int KT>
cudaError_t launch_long_kt(const void* q, const void* k, const void* v, const float* bias,
                           void* o, int B, int S, int Sk, int HW, int H, int HB, int threads,
                           int smem, float scale_log2, cudaStream_t stream) {
  auto kernel = bias ? frame_attention_long_kernel<DH, KT, true>
                     : frame_attention_long_kernel<DH, KT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(B * HW), (unsigned)(H / HB));
  kernel<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
      (__nv_bfloat16*)o, S, Sk, HW, H, HB, scale_log2);
  return cudaGetLastError();
}

// Score tiles of 8 keys held per item: 16 (up to 128 keys) or 18 (144).
template <int DH>
cudaError_t launch_long(const void* q, const void* k, const void* v, const float* bias,
                        void* o, int B, int S, int Sk, int HW, int H, int HB, int threads,
                        int smem, float scale_log2, cudaStream_t stream) {
  const int G = HB * DH;
  if (H % HB != 0 || G % 8 != 0 ||
      smem != (round16(S) + 2 * round16(Sk)) * long_row_stride(G) * 2 || threads % 32 != 0 ||
      threads < 32 || threads > LONG_MAX_WARPS * 32 || (long long)B * HW > 0x7fffffffLL ||
      H / HB > 65535 || !(scale_log2 > 0.f))
    return cudaErrorInvalidValue;
  if (Sk <= 128)
    return launch_long_kt<DH, 16>(q, k, v, bias, o, B, S, Sk, HW, H, HB, threads, smem,
                                  scale_log2, stream);
  return launch_long_kt<DH, 18>(q, k, v, bias, o, B, S, Sk, HW, H, HB, threads, smem,
                                scale_log2, stream);
}

int launch_rows_dh(const void* q, const void* k, const void* v, const float* bias, void* o,
                   int B, int S, int Sk, int HW, int C, int DH, float scale, cudaStream_t s) {
  const int H = C / DH;
  const float sl = scale * kLog2e;
  switch (DH) {
    case 8: return (int)launch_rows<8, 1>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 16: return (int)launch_rows<16, 1>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 40: return (int)launch_rows<40, 1>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 80: return (int)launch_rows<40, 2>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 160: return (int)launch_rows<40, 4>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// S <= 32, S <= Sk <= S + 16, DH 8/16/40/80/160; pointers 16-byte aligned.
// bias: fp32 [C / DH, S, Sk], or null.
extern "C" int anyv2v_frame_attention_rows(const void* q, const void* k,
                                           const void* v, const float* bias,
                                           void* o, int B, int S, int Sk, int HW,
                                           int C, int DH, float scale,
                                           void* stream) {
  if (B <= 0 || S <= 0 || S > 32 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
      C % DH != 0)
    return (int)cudaErrorInvalidValue;
  return launch_rows_dh(q, k, v, bias, o, B, S, Sk, HW, C, DH, scale, (cudaStream_t)stream);
}

// K2 long: 32 < S <= 128, S <= Sk <= S + 16, DH 8/16/32/40/64/80/160,
// scale > 0; pointers 16-byte aligned. bias: fp32 [C / DH, S, Sk], or null. The launch
// plan (heads per block, threads, dynamic shared bytes) comes from
// ops/frame_attention.py::long_plan; a plan that does not match the shape
// is refused.
extern "C" int anyv2v_frame_attention_long(const void* q, const void* k,
                                           const void* v, const float* bias,
                                           void* o, int B, int S, int Sk, int HW,
                                           int C, int DH, float scale, int heads_per_block,
                                           int threads, int smem_bytes, void* stream) {
  if (B <= 0 || S <= 32 || S > 128 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
      C % DH != 0 || heads_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int H = C / DH;
  const float sl = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (DH) {
#define ANYV2V_CASE(D)                                                                  \
  case D:                                                                               \
    return (int)launch_long<D>(q, k, v, bias, o, B, S, Sk, HW, H, heads_per_block, threads, \
                               smem_bytes, sl, s);
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

// Sk == S <= 32, DH a power of two 2..64. bias: fp32 [C / DH, S, S], or null.
extern "C" int anyv2v_frame_attention(const void* q, const void* k,
                                      const void* v, const float* bias, void* o,
                                      int B, int S, int HW, int C, int DH,
                                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || S > 32 || HW <= 0 || DH < 2 || C % DH != 0)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (S <= 16)
    return (int)launch_s<16>(q, k, v, bias, o, B, S, HW, C, DH, scale_log2, s);
  return (int)launch_s<32>(q, k, v, bias, o, B, S, HW, C, DH, scale_log2, s);
}
