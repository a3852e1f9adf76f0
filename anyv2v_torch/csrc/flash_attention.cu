// K5 flash_attention: softmax(q k^T * scale) v with an fp32 online softmax,
// heads folded into the channel dim: q [B, Sq, H*DH], k/v [B, Sk, H*DH],
// bf16 in and out. Optional split-KV: a second K/V source kc/vc
// [B / frames, Sk2, H*DH] that query row b reads at b / frames, under the
// same softmax as the row's own keys.
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_attention.py       _flash_kernel         (split-head flash; here
//                                                    the temporal transformer's
//                                                    cross-attention, Sq 17*HW)
//   pallas_attention.py       _flash_splitkv_kernel (ConsistI2V first-frame
//                                                    concat self-attention)
//   pallas_cross_attention.py _cross_kernel         (long queries over short
//                                                    K/V, Sk <= 512: one source
//                                                    body, Sk masked per tile)
// The TPU versions transposed [B,S,H,D] -> [B*H,S,D] in device memory before
// each call (pallas_attention.py:300-308). Here the kernel reads the folded
// layout in place with strided row loads, and the split-KV context is indexed
// by row, so the repeated first-frame keys are never built.
//
// What bounds it on the H100: operations. The L0 split-KV call of an edit
// step is 51 rows x 5 heads x 4096 queries x 8192 keys x 64 x 4 = 2.2e12
// FLOP (2.2 ms at 989 TFLOP/s) against 0.55 GB of operands (0.16 ms at
// 3.35 TB/s). So both products run on the tensor cores: mma.sync m16n8k16
// bf16 with fp32 accumulation (warp-level mma, not wgmma; a later change can
// move to wgmma with TMA-fed tiles).
//
// Design: a block of 4 warps owns 64 query rows of one (batch row, head); each
// warp owns 16 rows and keeps their Q fragments, fp32 O accumulator and
// softmax state in registers. K/V stream through shared memory in tiles of
// 64 keys (16-byte loads, zero-filled past the source's end and in the pad
// columns), first the row's own keys and then the shared context. Head widths
// that are not multiples of 16 (40) are padded to the MMA depth in shared
// memory and in the Q fragments only, never in device memory. Keys past a
// source's end score -inf; query rows past Sq load zeros and store nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr int BK = 64;           // keys per K/V tile
constexpr int NKT = BK / 8;      // 8-key score tiles per K/V tile

template <int DH>
struct Shape {
  static constexpr int DP = (DH + 15) / 16 * 16;  // QK^T depth, MMA-padded
  static constexpr int KSTEPS = DP / 16;
  static constexpr int NT = DH / 8;               // 8-wide output tiles
  static constexpr int LD = DP + 8;               // smem row stride (bf16):
                                                  // 16-byte rows, no bank clash
  static constexpr int CHUNKS = DP / 8;           // 16-byte chunks per row
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One K/V tile (rows [k0, k0 + BK) of a source with n keys) into shared memory.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ ks,
                                          __nv_bfloat16* __restrict__ vs,
                                          const __nv_bfloat16* __restrict__ kg,
                                          const __nv_bfloat16* __restrict__ vg,
                                          int k0, int n, int C) {
  using S = Shape<DH>;
  for (int e = threadIdx.x; e < BK * S::CHUNKS; e += WARPS * 32) {
    const int j = e / S::CHUNKS, c8 = (e % S::CHUNKS) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (k0 + j < n && c8 < DH) {
      const size_t off = (size_t)(k0 + j) * C + c8;
      kv = *reinterpret_cast<const uint4*>(kg + off);
      vv = *reinterpret_cast<const uint4*>(vg + off);
    }
    *reinterpret_cast<uint4*>(ks + j * S::LD + c8) = kv;
    *reinterpret_cast<uint4*>(vs + j * S::LD + c8) = vv;
  }
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int Sk2, int frames, int C, float scale_log2) {
  using S = Shape<DH>;
  __shared__ __align__(16) __nv_bfloat16 ks[BK * S::LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * S::LD];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment row group / column pair
  const int r0 = blockIdx.x * BQ + warp * 16;
  const int hc = h * DH;

  // Q fragments (A operand, row-major 16 x DP), zero past Sq and past DH
  uint32_t qa[S::KSTEPS][4];
  {
    const __nv_bfloat16* qb = q + (size_t)b * Sq * C + hc;
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + (i & 1) * 8;
        const int col = kk * 16 + (i >> 1) * 8 + 2 * t;
        qa[kk][i] = (row < Sq && col < DH)
                        ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * C + col)
                        : 0u;
      }
    }
  }

  float acc[S::NT][4];
#pragma unroll
  for (int n = 0; n < S::NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int tiles1 = (Sk + BK - 1) / BK;
  const int tiles = tiles1 + (Sk2 + BK - 1) / BK;
  const unsigned short* vsu = reinterpret_cast<const unsigned short*>(vs);
  for (int tile = 0; tile < tiles; ++tile) {
    const bool own = tile < tiles1;
    const int k0 = (own ? tile : tile - tiles1) * BK;
    const int n = own ? Sk : Sk2;
    __syncthreads();   // the previous tile is no longer read
    if (own)
      load_tile<DH>(ks, vs, k + (size_t)b * Sk * C + hc, v + (size_t)b * Sk * C + hc,
                    k0, n, C);
    else
      load_tile<DH>(ks, vs, kc + (size_t)(b / frames) * Sk2 * C + hc,
                    vc + (size_t)(b / frames) * Sk2 * C + hc, k0, n, C);
    __syncthreads();
    const int valid = min(BK, n - k0);

    // scores: 16 rows x 64 keys per warp
    float s[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        const uint32_t* kp =
            reinterpret_cast<const uint32_t*>(ks + (nt * 8 + g) * S::LD + kk * 16 + 2 * t);
        mma_bf16(s[nt], qa[kk], kp[0], kp[4]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = nt * 8 + 2 * t + (i & 1);
        s[nt][i] = key < valid ? s[nt][i] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nn = 0; nn < S::NT; ++nn) {
      acc[nn][0] *= c0;
      acc[nn][1] *= c0;
      acc[nn][2] *= c1;
      acc[nn][3] *= c1;
    }
    // P as bf16 A fragments: 16-key steps pair two 8-key score tiles
    uint32_t pa[NKT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
      const float p0 = exp2f(s[nt][0] - mn0), p1 = exp2f(s[nt][1] - mn0);
      const float p2 = exp2f(s[nt][2] - mn1), p3 = exp2f(s[nt][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V: V's B fragments gathered as bf16 pairs down the key axis
#pragma unroll
    for (int kc2 = 0; kc2 < NKT / 2; ++kc2) {
      const int kr = kc2 * 16 + 2 * t;
#pragma unroll
      for (int nn = 0; nn < S::NT; ++nn) {
        const int col = nn * 8 + g;
        const uint32_t b0 = (uint32_t)vsu[kr * S::LD + col] |
                            ((uint32_t)vsu[(kr + 1) * S::LD + col] << 16);
        const uint32_t b1 = (uint32_t)vsu[(kr + 8) * S::LD + col] |
                            ((uint32_t)vsu[(kr + 9) * S::LD + col] << 16);
        mma_bf16(acc[nn], pa[kc2], b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  __nv_bfloat16* ob = o + (size_t)b * Sq * C + hc;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int nn = 0; nn < S::NT; ++nn) {
    const int col = nn * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * C + col) =
          __floats2bfloat162_rn(acc[nn][0] * i0, acc[nn][1] * i0);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * C + col) =
          __floats2bfloat162_rn(acc[nn][2] * i1, acc[nn][3] * i1);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kc,
                   const void* vc, void* o, int B, int Sq, int Sk, int Sk2,
                   int frames, int H, float scale, cudaStream_t stream) {
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<DH><<<grid, WARPS * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)kc, (const __nv_bfloat16*)vc, (__nv_bfloat16*)o, Sq,
      Sk, Sk2, frames, H * DH, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// kc/vc may be null with Sk2 == 0. Every pointer 16-byte aligned, rows
// contiguous with stride H*DH.
extern "C" int anyv2v_flash_attention(const void* q, const void* k, const void* v,
                                      const void* kc, const void* vc, void* o,
                                      int B, int Sq, int Sk, int Sk2, int frames,
                                      int H, int DH, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Sk2 < 0 || H <= 0 ||
      H > 65535 || frames <= 0 || (Sk2 > 0 && (kc == nullptr || vc == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (DH) {
#define ANYV2V_CASE(D) \
  case D:              \
    return (int)launch<D>(q, k, v, kc, vc, o, B, Sq, Sk, Sk2, frames, H, scale, s);
    ANYV2V_CASE(8)
    ANYV2V_CASE(16)
    ANYV2V_CASE(40)
    ANYV2V_CASE(64)
    ANYV2V_CASE(80)
    ANYV2V_CASE(160)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
