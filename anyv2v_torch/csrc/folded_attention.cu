// K1 folded_attention: softmax(q k^T * scale) v on heads folded into the
// channel dim, q [B, Sq, H*DH], k/v [B, Sk, H*DH], bf16 in and out.
//
// Replaces (anyv2v_tpu/ops/):
//   pallas_packed_flash.py  _packed_whole_pipe_kernel (L0 spatial self),
//                           _wide_kv_kernel (L1/L2 self, L2 cross),
//                           _wide_t_kernel (L0/L1 cross, sk = 157),
//                           _packed_whole_kernel, _packed_kernel (Sk past 4096)
//   pallas_short_attention.py _short_kernel (mid-block self, S = 64; the
//                           image-latent temporal encoder, S = 16 or 128;
//                           ConsistI2V mid cross, 20 heads of 64)
// The TPU needed five bodies to fit 64 narrow heads (dh 5/10/20 padded to
// 8/16/32) into 128-lane MXU tiles. Here one body covers every case, with the
// head width DH a template parameter. It replaces a CUDA-core body in which
// one thread owned one query row and did every q.k and p.v product in fp32
// (2.2x SDPA at i2vgen-xl's L0 self, 3.0x at L1 self on an H100).
//
// What bounds it on the H100: at DH = 8 the softmax's exponentials, not bytes
// or products. L0 self of one edit step is 48 rows x 64 heads x 4096 x 4096 =
// 5.2e10 scores, one exp2 each, at the special-function units' 16 per clock
// per SM; the products of both matmuls on the tensor cores take a tenth of
// that, and q, k, v and the output are read or written once per query tile.
// So the design keeps the instructions around each exp2 few: the row maximum
// as a tree, the scale folded into one fma before ex2.approx, and the bf16
// pack that feeds the P.V product; the row sums cost no adds (below). A share
// of the exponentials as a polynomial on the FMA pipe was measured slower.
//
// Design:
//  - A block owns a tile of 16*QT queries of one batch row and a group of HB
//    whole heads spanning at most 128 channels (16 heads at dh 8, 8 at 16, 4
//    at 32, 2 at 64), so each K/V row of a tile is one contiguous read of up
//    to 256 bytes. Where the whole row is narrower than 128 channels (the
//    image-latent encoder, the tiny archs) the block packs R batch rows side
//    by side as R*HB "virtual" heads of one 128-channel tile.
//  - K and V come in tiles of 64 keys (Sk rounded to 16 where it is
//    shorter) through a ring of two stages in shared memory by cp.async, 16
//    bytes a thread, the next tile in flight while one is computed; Q once.
//    Two blocks share an SM (at most 128 registers a thread: one block per
//    SM without that cap was measured slower). Rows are strided by
//    an odd number of 16-byte units (ldmatrix is free of bank conflicts), and
//    rows past Sq or Sk, or of batch rows past B, are zero-filled.
//  - A warp owns up to 64/DH items, an item being (head, 16 queries), and
//    keeps each item's running max, row sum and fp32 output in registers
//    across the key loop. Scores by mma.sync: m16n8k8 at dh 8 (no padding),
//    m16n8k16 steps at 16/32/64; keys >= Sk are -inf and wholly empty
//    16-key chunks are skipped. Online softmax in the exp2 domain, one
//    rescale per 64 keys. Each 16-key chunk of P is packed to a bf16 A
//    fragment and fed at once to P.V on the tensor cores (V by
//    ldmatrix.trans) and to a product with a column of ones, which gives
//    the row sums of the same bf16 P.
//  - The normalised bf16 output overwrites the item's own Q tile, and the
//    block stores whole 16-byte pieces of its rows at the end.
//  - ops/folded_attention.py's folded_plan sizes the block (HB, R, QT,
//    warps, shared bytes); the C entry refuses a plan that does not
//    match the shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int KB = 64;          // keys per stage of the ring
constexpr int STAGES = 2;       // ring stages: two blocks share an SM
constexpr int GROUP = 128;      // channels of one block's tile, at most
constexpr int MAX_WARPS = 8;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

// Row stride (bf16) of a tile W channels wide: an odd number of 16-byte units.
__host__ __device__ constexpr int row_stride(int w) { return w + 8 + 8 * ((w / 8) % 2); }

__host__ __device__ constexpr int items_per_warp(int dh) { return 64 / dh; }

template <int DH>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) folded_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int B, int Sq, int Sk,
    int H, int HB, int R, int QT, int KS, int n_qblocks, float scale_log2) {
  using namespace hopper;
  constexpr int IPW = items_per_warp(DH);
  constexpr int NT = DH / 8;   // 8-channel output tiles of one head
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = HB * DH, VW = R * G, VH = R * HB, LD = row_stride(VW), CH = VW / 8;
  const int BQ = 16 * QT, C = H * DH;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + BQ * LD;   // stage s: K at ring + s*2*KS*LD, V after it

  const int b0 = (blockIdx.x / n_qblocks) * R;
  const int q0 = (blockIdx.x % n_qblocks) * BQ;
  const int c0 = blockIdx.y * G;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // Each thread copies one 16-byte column chunk of every row it visits.
  const int rpp = nthreads / CH;   // rows per pass
  const bool copier = tid < rpp * CH;
  const int col = tid % CH, row0 = tid / CH;
  const int rr = col * 8 / G;                 // packed batch row of this chunk
  const int brow = min(b0 + rr, B - 1);
  const bool col_ok = b0 + rr < B;
  const int ch = c0 + (col * 8) % G;
  const __nv_bfloat16* qcol = q + (size_t)brow * Sq * C + ch;
  const __nv_bfloat16* kcol = k + (size_t)brow * Sk * C + ch;
  const __nv_bfloat16* vcol = v + (size_t)brow * Sk * C + ch;

  auto load_kv = [&](int t, int s) {
    if (!copier) return;
    __nv_bfloat16* ks = ring + s * 2 * KS * LD;
    __nv_bfloat16* vs = ks + KS * LD;
    for (int j = row0; j < KS; j += rpp) {
      const int key = t * KB + j;
      const bool ok = col_ok && key < Sk;
      const size_t off = (size_t)min(key, Sk - 1) * C;
      cp_async16(smem_addr(ks + j * LD + col * 8), kcol + off, ok);
      cp_async16(smem_addr(vs + j * LD + col * 8), vcol + off, ok);
    }
  };

  const int ntiles = (Sk + KB - 1) / KB;
  if (copier)
    for (int r = row0; r < BQ; r += rpp) {
      const int qi = q0 + r;
      cp_async16(smem_addr(qs + r * LD + col * 8), qcol + (size_t)min(qi, Sq - 1) * C,
                 col_ok && qi < Sq);
    }
  load_kv(0, 0);   // group 0: Q and tile 0
  cp_async_commit();

  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  const int g = lane / 4, tq = lane % 4;
  const int items = VH * QT;
  float acc[IPW][NT][4], m[IPW][2], l[IPW][2];
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with tile t-1's stage
    if (t + 1 < ntiles) {   // tile t+1 flies while tile t is computed
      load_kv(t + 1, (t + 1) % STAGES);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (t % STAGES) * 2 * KS * LD;
    const __nv_bfloat16* vs = ks + KS * LD;
    const int nk = min(KB, Sk - t * KB);   // real keys in this tile (>= 1)

#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      const int it = warp + i * nwarps;
      if (it >= items) break;
      const int hc = (it / QT) * DH, qt = it % QT;
      float s[KB / 2];   // 8 tiles of 8 keys, m16n8 accumulators
#pragma unroll
      for (int x = 0; x < KB / 2; ++x) s[x] = 0.f;
      const __nv_bfloat16* qrow = qs + (qt * 16 + (lane & 15)) * LD + hc;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(qrow + kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          if (np * 16 < nk) {
            uint32_t b[4];
            ldmatrix_x4(b, smem_addr(ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + hc +
                                     kk * 16 + ((lane >> 3) & 1) * 8));
            mma_m16n8k16(s + 4 * (2 * np), a, b[0], b[1]);
            mma_m16n8k16(s + 4 * (2 * np + 1), a, b[2], b[3]);
          }
        }
      }
      if constexpr (DH % 16 == 8) {   // dh 8: one m16n8k8 step
        constexpr int kb = DH / 16 * 16;
        uint32_t a0, a1;
        ldmatrix_x2(a0, a1, smem_addr(qrow + kb));
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          if (np * 16 < nk) {
            uint32_t b0, b1;
            ldmatrix_x2(b0, b1, smem_addr(ks + (np * 16 + (lane & 15)) * LD + hc + kb));
            mma_m16n8k8(s + 4 * (2 * np), a0, a1, b0);
            mma_m16n8k8(s + 4 * (2 * np + 1), a0, a1, b1);
          }
        }
      }
      if (nk < KB) {   // the ragged last tile: keys past Sk
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (nt * 8 + 2 * tq + (x & 1) >= nk) s[nt * 4 + x] = -INFINITY;
      }
      float mx0 = tile_max(s, 0), mx1 = tile_max(s, 2);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // key 0 of the tile exists, so both maxima are finite; the first
      // tile's correction is ex2(-inf) = 0 on zero state
      const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
      const float corr0 = ex2((m[i][0] - mn0) * scale_log2);
      const float corr1 = ex2((m[i][1] - mn1) * scale_log2);
      m[i][0] = mn0;
      m[i][1] = mn1;
      const float o0 = -mn0 * scale_log2, o1 = -mn1 * scale_log2;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[i][n][0] *= corr0;
        acc[i][n][1] *= corr0;
        acc[i][n][2] *= corr1;
        acc[i][n][3] *= corr1;
      }
      // Each 16-key chunk: its exponentials, packed to a bf16 A fragment
      // and fed to P.V and to the row sums at once, so that only one
      // chunk's P is live. lt: this tile's row sums (rows g, g+8 in [0], [2]).
      float lt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int np = 0; np < KB / 16; ++np) {
        if (np * 16 < nk) {
          float p[8];
#pragma unroll
          for (int x = 0; x < 8; ++x)
            p[x] = ex2(fmaf(s[np * 8 + x], scale_log2, (x & 2) ? o1 : o0));
          const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                  pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
          mma_m16n8k16(lt, pa, BF16_ONES, BF16_ONES);
          const __nv_bfloat16* vrow =
              vs + (np * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + hc;
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            if (n + 1 < NT) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, smem_addr(vrow + n * 8 + (lane >> 4) * 8));
              mma_m16n8k16(acc[i][n], pa, b[0], b[1]);
              mma_m16n8k16(acc[i][n + 1], pa, b[2], b[3]);
            } else {   // dh 8: one 8-channel tile
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1,
                                smem_addr(vs + (np * 16 + (lane & 15)) * LD + hc + n * 8));
              mma_m16n8k16(acc[i][n], pa, b0, b1);
            }
          }
        }
      }
      l[i][0] = fmaf(l[i][0], corr0, lt[0]);
      l[i][1] = fmaf(l[i][1], corr1, lt[2]);
    }
  }

  // Normalise each item into its own Q tile, then store whole rows.
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int it = warp + i * nwarps;
    if (it >= items) break;
    const int hc = (it / QT) * DH, qt = it % QT;
    const float l0 = l[i][0], l1 = l[i][1];
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      __nv_bfloat16* dst = qs + (qt * 16 + g) * LD + hc + n * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[i][n][0] * i0, acc[i][n][1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * LD) =
          __floats2bfloat162_rn(acc[i][n][2] * i1, acc[i][n][3] * i1);
    }
  }
  __syncthreads();
  if (copier && col_ok) {
    __nv_bfloat16* ocol = o + (size_t)brow * Sq * C + ch;
    for (int r = row0; r < BQ && q0 + r < Sq; r += rpp)
      *reinterpret_cast<uint4*>(ocol + (size_t)(q0 + r) * C) =
          *reinterpret_cast<const uint4*>(qs + r * LD + col * 8);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int HB, int R, int QT, int warps, int smem, float scale_log2,
                   cudaStream_t stream) {
  const int G = HB * DH, VW = R * G, KS = min(KB, (Sk + 15) / 16 * 16);
  if (H % HB != 0 || G > GROUP || (R > 1 && (HB != H || VW > GROUP)) || R > B ||
      QT < 1 || warps < 1 || warps > MAX_WARPS ||
      warps * items_per_warp(DH) < R * HB * QT || (VW / 8) > warps * 32 ||
      KS != min(KB, (Sk + 15) / 16 * 16) ||
      smem != (16 * QT + STAGES * 2 * KS) * row_stride(VW) * 2)
    return cudaErrorInvalidValue;
  const int n_qblocks = (Sq + 16 * QT - 1) / (16 * QT);
  const long long gx = (long long)n_qblocks * ((B + R - 1) / R);
  if (gx > 0x7fffffffLL || H / HB > 65535) return cudaErrorInvalidValue;
  auto kernel = folded_attention_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)(H / HB)), warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, B, Sq, Sk, H, HB, R, QT, KS, n_qblocks, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// DH 8/16/32/64, scale > 0; pointers 16-byte aligned. The launch plan (heads
// per block, packed batch rows, query tiles of 16, warps, dynamic shared
// bytes) comes from ops/folded_attention.py::folded_plan; a
// plan that does not match the shape is refused.
extern "C" int anyv2v_folded_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int Sq, int Sk, int H, int DH, float scale,
                                       int heads_per_block, int rows_per_block, int q_tiles,
                                       int warps, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || heads_per_block <= 0 || rows_per_block <= 0 ||
      !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const float sl = scale * 1.4426950408889634f;
  switch (DH) {
#define ANYV2V_CASE(D)                                                                       \
  case D:                                                                                    \
    return (int)launch<D>(q, k, v, o, B, Sq, Sk, H, heads_per_block, rows_per_block, q_tiles, \
                          warps, smem_bytes, sl, s);
    ANYV2V_CASE(8)
    ANYV2V_CASE(16)
    ANYV2V_CASE(32)
    ANYV2V_CASE(64)
#undef ANYV2V_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* anyv2v_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
