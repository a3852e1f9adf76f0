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
// layout at every S and compute no wasted scores: S x Sk per (batch, pixel,
// head), as _ew_kernel did.
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
// What bounds it on the H100: bytes up to 32 frames, q, k and v read once and
// the output written once (2 x B*(S+Sk)*HW*C*2 bytes, 400 MB for an
// i2vgen-xl L0 edit call at 16 frames, 0.66 GB for ConsistI2V's); the
// S*Sk*DH multiply-adds per head are few by comparison. At 128 frames the
// multiply-adds grow 64-fold (2.1e11 for an L0 edit call, 3.2 GB of bytes):
// on CUDA cores in fp32 the long route is bound by its operations, and
// tensor-core mma is the way to the byte bound (a later change).
//
// Three kernels, two bodies:
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
// frames plus 8 augmented first-frame keys) and frame_attention_long_kernel
// (K2 long: 32 < S <= 128, the same Sk range, DH 8/16/32/40/64/80/160:
// i2vgen-xl at 128 frames, transformer_in's 64, the row body's 40/80/160)
// share one body, rows_body; two kernel names keep the routes apart in a
// profile. DH/2 lanes is no power of two at DH 40, and 48 keys of two channels
// would not fit in registers, so the work is cut the other way: R lanes own
// one query row (b, pixel, head, frame), each holding CW = DH/R channels of q
// and of the fp32 accumulator (CW <= 40). Neighbouring row groups are the S
// query frames of one (pixel, head): at S = 128 and R = 1 a warp is 32 query
// frames of one (pixel, head) and a 128-thread block all 128 of them, so a
// key or value load is one address broadcast to the warp, the block's four
// warps share it through L1, and device memory is read once.
// Keys stream in chunks of 8 with one online-softmax rescale per chunk, so
// nothing in the body grows with S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// 32 < S <= 128 (K2 long): the same body, a kernel of its own so that a
// profile tells the two routes apart
template <int CW, int R, bool BIAS>
__global__ void __launch_bounds__(128) frame_attention_long_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int Sk, int HW, int H, long long total,
    float scale_log2) {
  rows_body<CW, R, BIAS>(q, k, v, bias, o, S, Sk, HW, H, total, scale_log2);
}

template <int CW, int R, bool LONG>
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
  if constexpr (LONG) {
    if (bias)
      frame_attention_long_kernel<CW, R, true><<<grid, threads, 0, stream>>>(
          qb, kb, vb, bias, ob, S, Sk, HW, H, total, scale_log2);
    else
      frame_attention_long_kernel<CW, R, false><<<grid, threads, 0, stream>>>(
          qb, kb, vb, nullptr, ob, S, Sk, HW, H, total, scale_log2);
  } else {
    if (bias)
      frame_attention_rows_kernel<CW, R, true><<<grid, threads, 0, stream>>>(
          qb, kb, vb, bias, ob, S, Sk, HW, H, total, scale_log2);
    else
      frame_attention_rows_kernel<CW, R, false><<<grid, threads, 0, stream>>>(
          qb, kb, vb, nullptr, ob, S, Sk, HW, H, total, scale_log2);
  }
  return cudaGetLastError();
}

template <bool LONG>
int launch_rows_dh(const void* q, const void* k, const void* v, const float* bias,
                   void* o, int B, int S, int Sk, int HW, int C, int DH, float scale,
                   cudaStream_t s) {
  const int H = C / DH;
  const float sl = scale * kLog2e;
  switch (DH) {
    case 8: return (int)launch_rows<8, 1, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 16: return (int)launch_rows<16, 1, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 32: return (int)launch_rows<32, 1, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 40: return (int)launch_rows<40, 1, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 64: return (int)launch_rows<32, 2, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 80: return (int)launch_rows<40, 2, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    case 160: return (int)launch_rows<40, 4, LONG>(q, k, v, bias, o, B, S, Sk, HW, H, sl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// S <= 32, S <= Sk <= S + 16, DH 8/16/32/40/64/80/160; pointers 16-byte
// aligned. bias: fp32 [C / DH, S, Sk], or null.
extern "C" int anyv2v_frame_attention_rows(const void* q, const void* k,
                                           const void* v, const float* bias,
                                           void* o, int B, int S, int Sk, int HW,
                                           int C, int DH, float scale,
                                           void* stream) {
  if (B <= 0 || S <= 0 || S > 32 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
      C % DH != 0)
    return (int)cudaErrorInvalidValue;
  return launch_rows_dh<false>(q, k, v, bias, o, B, S, Sk, HW, C, DH, scale,
                               (cudaStream_t)stream);
}

// K2 long: 32 < S <= 128, S <= Sk <= S + 16, DH 8/16/32/40/64/80/160;
// pointers 16-byte aligned. bias: fp32 [C / DH, S, Sk], or null.
extern "C" int anyv2v_frame_attention_long(const void* q, const void* k,
                                           const void* v, const float* bias,
                                           void* o, int B, int S, int Sk, int HW,
                                           int C, int DH, float scale,
                                           void* stream) {
  if (B <= 0 || S <= 32 || S > 128 || Sk < S || Sk > S + 16 || HW <= 0 || DH <= 0 ||
      C % DH != 0)
    return (int)cudaErrorInvalidValue;
  return launch_rows_dh<true>(q, k, v, bias, o, B, S, Sk, HW, C, DH, scale,
                              (cudaStream_t)stream);
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
