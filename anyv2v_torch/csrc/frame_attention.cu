// K2 frame_attention: self-attention over the frame axis S of temporal tokens
// x [B, S, HW, C] (C = heads * DH), for every (batch, pixel, head), bf16.
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_temporal_ew.py     _ew_kernel      (L0 temporal, HW 4096, dh 8)
//   pallas_short_attention.py _strided_kernel (L1/L2/mid temporal and
//                                              transformer_in, dh 16/32/64)
// Both read the native [B, S, HW, C] layout so the temporal transformer never
// transposes its tokens. This kernel does the same and computes no wasted
// scores: S x S per (batch, pixel, head), as _ew_kernel did.
//
// What bounds it on the H100: bytes. q, k and v are read once and the output
// written once (4 x B*S*HW*C*2 bytes, 400 MB for an L0 edit call); the
// S*S*DH multiply-adds per head are few by comparison.
//
// Design: one thread per (batch, pixel, channel pair); neighbouring threads
// hold neighbouring channels, so each warp reads 128 contiguous bytes per
// frame (coalesced bf16x2 loads). A head spans DH/2 consecutive lanes, and
// the per-head q.k sum over DH is a butterfly of warp shuffles inside that
// lane group. Each thread keeps its two channels of k and v for all S frames
// in registers and loops over query frames: S scores, fp32 softmax with
// exp2f, then p.v for its two channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int SMAX, int LANES>
__global__ void __launch_bounds__(256) frame_attention_kernel(
    const __nv_bfloat162* __restrict__ q, const __nv_bfloat162* __restrict__ k,
    const __nv_bfloat162* __restrict__ v, __nv_bfloat162* __restrict__ o,
    int S, int HW, int half, long long total, float scale_log2) {
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
cudaError_t launch_s(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int HW, int C, int DH, float scale_log2,
                     cudaStream_t stream) {
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
#define ANYV2V_CASE(L)                                                       \
  case L:                                                                    \
    frame_attention_kernel<SMAX, L><<<(unsigned)blocks, threads, 0, stream>>>( \
        q2, k2, v2, o2, S, HW, half, total, scale_log2);                     \
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

}  // namespace

extern "C" int anyv2v_frame_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int HW, int C, int DH, float scale,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || S > 32 || HW <= 0 || DH < 2 || C % DH != 0)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (S <= 16)
    return (int)launch_s<16>(q, k, v, o, B, S, HW, C, DH, scale_log2, s);
  return (int)launch_s<32>(q, k, v, o, B, S, HW, C, DH, scale_log2, s);
}
