// K1 folded_attention: softmax(q k^T * scale) v on heads folded into the
// channel dim, q [B, Sq, H*DH], k/v [B, Sk, H*DH], bf16 in and out.
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_packed_flash.py  _packed_whole_pipe_kernel (L0 spatial self),
//                           _wide_kv_kernel (L1/L2 self, L2 cross),
//                           _wide_t_kernel (L0/L1 cross, sk = 157)
//   pallas_short_attention.py _short_kernel (mid-block self, S = 64; the
//                           image-latent temporal encoder, S = 16)
// The TPU needed four bodies to fit 64 narrow heads (dh 5/10/20 padded to
// 8/16/32) into 128-lane MXU tiles. Here one body covers every case: the head
// width DH is a template parameter and each thread owns one query row.
//
// What bounds it on the H100: at DH = 8 the L0 self-attention of an edit
// step is 48 rows x 64 heads x 4096 x 4096 = 5.2e10 scores. Each score costs
// DH FMAs for q.k, one exp2 and DH FMAs for p.v on the CUDA cores, so the
// SFU exp rate and the fp32 FMA rate bound this kernel, not HBM (q, k, v and
// the output are read or written once per query tile).
//
// Design: grid (q-tile x batch, head). A block of BQ threads holds BQ query
// rows (pre-scaled by scale*log2 e) and an fp32 accumulator in registers.
// K/V stream through shared memory in tiles of BK keys, converted to fp32
// once; every thread reads the same key at once (a broadcast, no bank
// conflicts). Online softmax in fp32 with exp2f, rescaling once per chunk of
// KCH keys. Keys past Sk are masked to -inf. Using tensor-core mma with DH
// padded to 16 is left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BK = 64;
constexpr int KCH = 16;

template <int DH, int BQ>
__global__ void __launch_bounds__(BQ) folded_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int H, int n_qtiles, float scale_log2) {
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];
  const int C = H * DH;
  const int b = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int h = blockIdx.y;
  const int qi = qt * BQ + threadIdx.x;
  const bool valid = qi < Sq;

  float qr[DH], acc[DH];
  if (valid) {
    const __nv_bfloat16* qp = q + ((size_t)b * Sq + qi) * C + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = __bfloat162float(qp[d]) * scale_log2;
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * DH; e += BQ) {
      const int j = e / DH, d = e % DH;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const size_t off = ((size_t)b * Sk + kj) * C + h * DH + d;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    const int nk = min(BK, Sk - k0);
    for (int j0 = 0; j0 < nk; j0 += KCH) {
      float s[KCH];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < KCH; ++jj) {
        float x = -INFINITY;
        if (j0 + jj < nk) {
          x = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) x = fmaf(qr[d], ks[j0 + jj][d], x);
        }
        s[jj] = x;
        cmax = fmaxf(cmax, x);
      }
      // j0 < nk, so the chunk holds at least one real key and cmax is finite
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < KCH; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j0 + jj][d], acc[d]);
      }
      m = m_new;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
    __nv_bfloat16* op = o + ((size_t)b * Sq + qi) * C + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = __float2bfloat16(acc[d] * inv);
  }
}

template <int DH, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  dim3 grid((unsigned)(n_qtiles * B), (unsigned)H);
  folded_attention_kernel<DH, BQ><<<grid, BQ, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Sk, H, n_qtiles,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, float scale,
                      cudaStream_t stream) {
  if (Sq <= 32) return launch<DH, 32>(q, k, v, o, B, Sq, Sk, H, scale, stream);
  if (Sq <= 64) return launch<DH, 64>(q, k, v, o, B, Sq, Sk, H, scale, stream);
  return launch<DH, 128>(q, k, v, o, B, Sq, Sk, H, scale, stream);
}

}  // namespace

extern "C" int anyv2v_folded_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int Sq,
                                       int Sk, int H, int DH, float scale,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (DH) {
    case 8: return (int)launch_dh<8>(q, k, v, o, B, Sq, Sk, H, scale, s);
    case 16: return (int)launch_dh<16>(q, k, v, o, B, Sq, Sk, H, scale, s);
    case 32: return (int)launch_dh<32>(q, k, v, o, B, Sq, Sk, H, scale, s);
    case 64: return (int)launch_dh<64>(q, k, v, o, B, Sq, Sk, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* anyv2v_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
