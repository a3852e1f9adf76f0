// K3 ffn_geglu: out = (v * gelu(g)) @ W2^T + b2, [v, g] = x @ W1^T + b1,
// for x [N, C] bf16, W1 [2I, C], b1 [2I], W2 [C, I], b2 [C] (torch Linear
// layouts), fp32 accumulation, bf16 out.
//
// Replaces anyv2v_tpu/ops/pallas_ffn.py _ffn_kernel (GEGLU branch), routed at
// C = 320 (L0), 640 (L1) and 512 (transformer_in).
//
// What bounds it on the H100: unfused, the [N, 2I] pre-activation goes to HBM
// and back (at L0 of an edit step, 196608 x 2560 bf16 = 1 GB each way). This
// kernel keeps it on chip. The TPU kept W1 and W2 resident in 16 MB of VMEM;
// an SM has at most 227 KB of shared memory, so here the weights stream from
// L2 (50 MB holds them many times over) once per row tile, and the fp32
// output accumulator of a row tile, held in registers, bounds the tile at
// 32 rows. What limits this simple form is the latency of the weight loads
// (wmma fragments loaded from L2 that nothing overlaps), not the bandwidth
// of the re-reads: a 64-row tile on 16 warps, which halves them, was no
// faster on an H100 (3.50 vs 3.40 ms at C = 320, 65536 rows). Staging the
// weights through shared memory with cp.async/TMA and wgmma is later work.
//
// Design: one block of 8 warps per 32-row tile. The x tile sits in shared
// memory. The inner dimension streams in chunks of 64: each warp computes one
// 16x16 tile of v and of g with nvcuda::wmma (bf16 in, fp32 accumulate),
// the block applies bias + exact-erf GELU in fp32 and rounds h to bf16 (as
// the Pallas body does), then every warp accumulates h @ W2^T into its share
// of the [32, C] fp32 output tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 32;
constexpr int IC = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SV_LD = IC + 4;   // fp32, multiple of 4
constexpr int HS_LD = IC + 8;   // bf16, multiple of 8

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline size_t smem_bytes(int C) {
  size_t off = align128((size_t)BM * (C + 8) * 2);     // xs
  off += align128((size_t)2 * BM * SV_LD * 4);          // sv, sg
  off += align128((size_t)BM * HS_LD * 2);              // hs
  off += (size_t)WARPS * 256 * 4;                       // epilogue scratch
  return off;
}

template <int NT>
__global__ void __launch_bounds__(THREADS) ffn_geglu_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
    int N, int C, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int XS_LD = C + 8;
  __nv_bfloat16* xs = (__nv_bfloat16*)smem;
  size_t off = align128((size_t)BM * XS_LD * 2);
  float* sv = (float*)(smem + off);
  float* sg = sv + BM * SV_LD;
  off += align128((size_t)2 * BM * SV_LD * 4);
  __nv_bfloat16* hs = (__nv_bfloat16*)(smem + off);
  off += align128((size_t)BM * HS_LD * 2);
  float* scratch = (float*)(smem + off);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * BM;

  for (int e = tid; e < BM * C; e += THREADS) {
    const int r = e / C, c = e % C;
    const int row = row0 + r;
    xs[r * XS_LD + c] = row < N ? x[(size_t)row * C + c] : __float2bfloat16(0.f);
  }

  const int ctiles = C / 16;
  const int ntiles = 2 * ctiles;   // [32, C] output in 16x16 tiles
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) wmma::fill_fragment(acc[u], 0.f);
  __syncthreads();

  const int rb1 = warp / 4, cb1 = warp % 4;   // this warp's v/g tile
  for (int i0 = 0; i0 < I; i0 += IC) {
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fv, fg;
      wmma::fill_fragment(fv, 0.f);
      wmma::fill_fragment(fg, 0.f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bv, bg;
      const __nv_bfloat16* wv = w1 + (size_t)(i0 + cb1 * 16) * C;
      const __nv_bfloat16* wg = w1 + (size_t)(I + i0 + cb1 * 16) * C;
      for (int kk = 0; kk < C; kk += 16) {
        wmma::load_matrix_sync(a, xs + rb1 * 16 * XS_LD + kk, XS_LD);
        wmma::load_matrix_sync(bv, wv + kk, C);
        wmma::load_matrix_sync(bg, wg + kk, C);
        wmma::mma_sync(fv, a, bv, fv);
        wmma::mma_sync(fg, a, bg, fg);
      }
      wmma::store_matrix_sync(sv + rb1 * 16 * SV_LD + cb1 * 16, fv, SV_LD, wmma::mem_row_major);
      wmma::store_matrix_sync(sg + rb1 * 16 * SV_LD + cb1 * 16, fg, SV_LD, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < BM * IC; e += THREADS) {
      const int r = e / IC, c = e % IC;
      const float vv = sv[r * SV_LD + c] + __bfloat162float(b1[i0 + c]);
      const float gg = sg[r * SV_LD + c] + __bfloat162float(b1[I + i0 + c]);
      const float gelu = 0.5f * gg * (1.f + erff(gg * 0.70710678118654752f));
      hs[r * HS_LD + c] = __float2bfloat16(vv * gelu);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int t = warp + WARPS * u;
      if (t < ntiles) {
        const int rb = t / ctiles, cb = t % ctiles;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
#pragma unroll
        for (int kk = 0; kk < IC; kk += 16) {
          wmma::load_matrix_sync(a, hs + rb * 16 * HS_LD + kk, HS_LD);
          wmma::load_matrix_sync(b, w2 + (size_t)(cb * 16) * I + i0 + kk, I);
          wmma::mma_sync(acc[u], a, b, acc[u]);
        }
      }
    }
    __syncthreads();
  }

  float* my = scratch + warp * 256;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int t = warp + WARPS * u;
    if (t < ntiles) {
      const int rb = t / ctiles, cb = t % ctiles;
      wmma::store_matrix_sync(my, acc[u], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const int row = row0 + rb * 16 + r, col = cb * 16 + c;
        if (row < N)
          out[(size_t)row * C + col] =
              __float2bfloat16(my[e] + __bfloat162float(b2[col]));
      }
      __syncwarp();
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int N, int C,
                   int I, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_geglu_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + BM - 1) / BM);
  ffn_geglu_kernel<NT><<<blocks, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2,
      (const __nv_bfloat16*)b2, (__nv_bfloat16*)out, N, C, I);
  return cudaGetLastError();
}

}  // namespace

extern "C" int anyv2v_ffn_geglu(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int N, int C, int I, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || C <= 0 || C > 768 || C % 32 != 0 || I <= 0 || I % IC != 0)
    return (int)cudaErrorInvalidValue;
  const int nt = (2 * (C / 16) + WARPS - 1) / WARPS;
  switch (nt) {
#define ANYV2V_CASE(K) \
  case K: return (int)launch<K>(x, w1, b1, w2, b2, out, N, C, I, s);
    ANYV2V_CASE(1) ANYV2V_CASE(2) ANYV2V_CASE(3) ANYV2V_CASE(4)
    ANYV2V_CASE(5) ANYV2V_CASE(6) ANYV2V_CASE(7) ANYV2V_CASE(8)
    ANYV2V_CASE(9) ANYV2V_CASE(10) ANYV2V_CASE(11) ANYV2V_CASE(12)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
