// K4 temporal_conv: out[b,f,p,:] = bias + sum_{d=0..2} h[b,f+d-1,p,:] @ W[d]
// with h = silu(x * s[b] + t[b]) rounded to bf16 (the groupnorm apply and
// SiLU as a prologue; skipped when s is null) and h = 0 outside [0, F).
// x [B, F, P, C] bf16, s/t [B, C] fp32, W [3, C, C'] bf16, bias [C'] bf16.
//
// Replaces anyv2v_tpu/ops/pallas_temporal_conv.py _tconv_kernel, which every
// TemporalConvLayer runs four times: C in {320, 640, 1280}, P in
// {4096, 1024, 256, 64}, F = 16.
//
// What bounds it on the H100: it is a GEMM of [B*F*P, 3C] x [3C, C'] (2.4
// TFLOP-scale work per edit step at L0) and should be tensor-core bound; the
// unfused version also writes the normalised activation to HBM and reads it
// three times. This kernel reads x and writes the output once per output
// column tile and never materialises h or the three frame-shifted copies.
//
// Design: a 64x64 output tile per block of 4 warps, each warp a 32x32 tile of
// nvcuda::wmma fragments (bf16 in, fp32 accumulate). The K loop runs over the
// three taps and C in steps of 32. The A tile is gathered row by row: each
// block computes once where every one of its rows reads for each tap (the
// frame shift is an offset of (d-1)*P rows; frames outside [0, F) read as
// zero), then stages 8 channels per 16-byte load, applying the prologue in
// fp32. Edges of C, C' and the row count are masked (scalar loads where a row
// is not 8-channel aligned), so any shape is taken. The prologue is
// recomputed for each output column tile, and loads are not overlapped with
// the MMAs; wgmma with a TMA-fed pipeline is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int A_LD = BK + 8, B_LD = BN + 8, C_LD = BN + 4;

__global__ void __launch_bounds__(THREADS) temporal_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ t, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int F, int P, int C, int Cout, long long M) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  // per tile row: the element offset of its source row for each tap (-1:
  // outside [0, F), reads as zero) and the offset of its batch's s/t row
  __shared__ long long row_src[3][BM];
  __shared__ long long row_st[BM];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // 16-byte vector loads need 8-channel alignment of every row
  const bool vec_a = (C % 8) == 0, vec_b = (Cout % 8) == 0;

  for (int r = tid; r < BM; r += THREADS) {
    const long long row = m0 + r;
    long long st = 0;
    for (int d = 0; d < 3; ++d) row_src[d][r] = -1;
    if (row < M) {
      const long long bf = row / P;          // b * F + f
      const int p = (int)(row % P);
      const int f = (int)(bf % F);
      st = (bf / F) * C;
      for (int d = 0; d < 3; ++d) {
        const int fs = f + d - 1;
        if (fs >= 0 && fs < F) row_src[d][r] = ((bf + (d - 1)) * P + p) * C;
      }
    }
    row_st[r] = st;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  for (int d = 0; d < 3; ++d) {
    for (int k0 = 0; k0 < C; k0 += BK) {
      // A tile [BM, BK]: 8 channels per step, prologue applied in fp32
      for (int e = tid; e < BM * (BK / 8); e += THREADS) {
        const int r = e / (BK / 8), c8 = (e % (BK / 8)) * 8;
        const int ch = k0 + c8;
        const long long off = row_src[d][r];
        float v[8];
        if (off >= 0 && vec_a && ch + 8 <= C) {
          const uint4 raw = *reinterpret_cast<const uint4*>(x + off + ch);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f2 = __bfloat1622float2(h2[i]);
            v[2 * i] = f2.x;
            v[2 * i + 1] = f2.y;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = (off >= 0 && ch + i < C) ? __bfloat162float(x[off + ch + i]) : 0.f;
        }
        if (s != nullptr && off >= 0) {
          const long long so = row_st[r] + ch;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (ch + i < C) {
              float h = fmaf(v[i], s[so + i], t[so + i]);
              h = h / (1.f + expf(-h));
              v[i] = h;
            }
          }
        }
        // rounding to bf16 here is the unfused path's store of h
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) packed[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        *reinterpret_cast<uint4*>(As + r * A_LD + c8) = *reinterpret_cast<const uint4*>(packed);
      }
      // B tile [BK, BN] of W[d]
      for (int e = tid; e < BK * (BN / 8); e += THREADS) {
        const int kr = e / (BN / 8), n8 = (e % (BN / 8)) * 8;
        const int ch = k0 + kr, n = n0 + n8;
        const __nv_bfloat16* src = w + ((size_t)d * C + ch) * Cout + n;
        uint4 raw;
        if (ch < C && vec_b && n + 8 <= Cout) {
          raw = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            tmp[i] = (ch < C && n + i < Cout) ? src[i] : __float2bfloat16(0.f);
          raw = *reinterpret_cast<const uint4*>(tmp);
        }
        *reinterpret_cast<uint4*>(Bs + kr * B_LD + n8) = raw;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, nc = e % BN;
    const long long row = m0 + r;
    const int n = n0 + nc;
    if (row < M && n < Cout)
      out[row * Cout + n] =
          __float2bfloat16(Cs[r * C_LD + nc] + __bfloat162float(bias[n]));
  }
}

}  // namespace

extern "C" int anyv2v_temporal_conv(const void* x, const void* s, const void* t,
                                    const void* w, const void* bias, void* out,
                                    int B, int F, int P, int C, int Cout,
                                    void* stream) {
  if (B <= 0 || F <= 0 || P <= 0 || C <= 0 || Cout <= 0 ||
      (s == nullptr) != (t == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * F * P;
  const long long mtiles = (M + BM - 1) / BM;
  const int ntiles = (Cout + BN - 1) / BN;
  if (mtiles > 0x7fffffffLL || ntiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mtiles, (unsigned)ntiles);
  temporal_conv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)s, (const float*)t,
      (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)out, F, P, C, Cout, M);
  return (int)cudaGetLastError();
}
