// KN: the port's norms, each one pass over bf16 (or fp32) activations with
// fp32 statistics, written once in the dtype the caller uses next.
//  - Group norm over a channels-last x [N, P, C] (statistics of each
//    (n, group) over P pixels x C/G channels): kn_group_stats_kernel writes
//    each block's partial moments (count, mean, M2) of every group, then
//    kn_group_apply_kernel merges an image's partials, forms the per-channel
//    y = x * s + t (s = w * rstd, t = b - mean * s), optionally silu(y), in
//    fp32 and rounds once to the output type. For K4's prologue
//    (ops/temporal_conv.py groupnorm_scale_shift) kn_group_finalize_kernel
//    writes s, t [N, C] fp32 instead, which K4's own prologue kernel applies.
//  - Layer norm over rows of width C: kn_layer_norm_kernel, one pass per row
//    held in registers, fp32 mean and variance (two passes over the
//    registers), the affine, one rounded write.
// Inputs bf16 or fp32, outputs bf16 or fp32, the affine parameters bf16 or
// fp32 (read once a block). C a multiple of 8 for the group norm (16-byte
// loads of 8 channels), of 8 or 4 for the layer norm (i2vgen-xl's
// image-latent encoder normalises 4 channels), at most 4096.
//
// Replaces no Pallas kernel: the JAX package leaves its norms to XLA, which
// fuses each into its neighbours. The port's plain path made one an fp32
// round trip: the bf16 input upcast, var_mean, four fp32 elementwise
// passes, then the caller's SiLU in fp32 and cast back, about 56 bytes an
// element for a resnet's group norm with SiLU and 20 for a layer norm, and
// up to four fp32 copies of the activation alive at once (the VAE's 512^2
// decode: 17 GB above its input).
//
// What bounds it on the H100: HBM bytes; a few fp32 operations an element
// against 4-6 bytes. A layer norm reads x and writes y once (4 bytes an
// element in bf16). A group norm needs a whole image's statistics before
// its first output, so it reads x twice (6 bytes): once for the moments,
// once to apply them. Design:
//  - Every thread owns 8 channels of a pixel (a 16-byte load) and keeps
//    them over the pixels it walks, so its groups, its partial moments and,
//    in the apply, its per-channel s and t stay in registers; a block is C/8
//    such columns by `rows` pixel slots (ops/norm.py norm_plan), grid
//    (splits, N): a split is a contiguous run of an image's pixels, cut so
//    that the grid is about eight blocks an SM (two for K4's statistics
//    alone: one wave, measured fastest there) and each block streams at
//    least 32 KB. Four pixels' loads are issued before their arithmetic.
//  - Moments by Welford per channel (no sum of squares: a group holds up to
//    about 1 M elements at the VAE's 512^2), merged by Chan's formula:
//    across the channels of a group (equal counts), across pixel slots,
//    then across splits in the apply (one warp a group, four groups a warp
//    at once, a butterfly of shuffles), which spares a third launch; the
//    partials are N x G x splits x 3 floats of the caller's scratch.
//  - The apply cuts an image's pixels into splits of its own (`apply_splits`
//    of `apply_split_rows`), as many as fill the card, while the statistics
//    keep at most 128 splits an image: every apply block merges all of its
//    image's partials, so where N is small (a clip of 16 frames normalised
//    as one image: N 1-3 of 16 x 4096 pixels) more statistics splits would
//    cost each apply block more than their grid gains. Where N is large the
//    two grids are the same.
//  - Where x holds one share of each image's pixels (a rank's frames of a
//    clip split over ranks), the statistics and the apply are two calls, and
//    the caller gathers every share's partials between them: the apply
//    merges them all as it merges one share's (Chan's formula takes any
//    counts), so no fp32 copy is made and no variance is taken in one pass.
//  - The apply walks the blocks in the reverse order of the statistics, so
//    that its first blocks find the pixels that the statistics read last
//    still in the 50 MB L2 (a whole tensor below about 50 MB is read from
//    HBM once).
//  - The layer norm spreads a row over 1-32 lanes (`lanes`: at most 4
//    chunks of 8 channels a lane where C allows, so that 4 blocks an SM stay
//    resident; 8 at C 1280), the affine parameters in shared memory as fp32.
// No kernel allocates, synchronises or calls back into the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::ex2;
using hopper::pack_bf16;

constexpr int VEC = 8;                  // channels of a group-norm thread's load
constexpr int GN_MAX_THREADS = 512;
constexpr int LN_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                  v[4 * i + 3]);
}

__device__ __forceinline__ float param(const void* p, int i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// silu(v) = v / (1 + 2^(-v log2 e)): ex2.approx and a fast divide; v far
// below zero gives 2^+inf = inf and v * rcp(inf) = -0.
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + ex2(-v * LOG2E));
}

struct Moments {
  float n, mean, m2;
};

// Chan's merge of b into a (a count of 0 on either side is exact).
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.f) return;
  const float n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  a.mean = fmaf(d, f, a.mean);
  a.m2 += b.m2 + d * d * a.n * f;
  a.n = n;
}

// The mean and 1/sqrt(var + eps) of each group of image n from its
// partials part[n][g][0..splits)[3], into mean[G], rstd[G] (shared): one
// warp a group, each lane merging every 32nd split, then a butterfly; a
// warp carries MERGE_CHAINS groups at once, so that their partials' loads
// are in flight together (the merge is bound by their L2 latency where an
// apply block's own pixels are few; 8 chains, predicated to a warp's
// groups, measured slower). blockDim.x is a multiple of 32.
constexpr int MERGE_CHAINS = 4;

__device__ void group_moments(const float* __restrict__ part, int n, int G, int splits,
                              float eps, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int g0 = warp; g0 < G; g0 += MERGE_CHAINS * warps) {
    Moments a[MERGE_CHAINS];
    const float* p[MERGE_CHAINS];
#pragma unroll
    for (int u = 0; u < MERGE_CHAINS; ++u) {
      a[u] = Moments{0.f, 0.f, 0.f};
      // a chain past the last group reads the last group's partials again, unused
      p[u] = part + ((size_t)n * G + min(g0 + u * warps, G - 1)) * splits * 3;
    }
    for (int s = lane; s < splits; s += 32) {
      Moments m[MERGE_CHAINS];
#pragma unroll
      for (int u = 0; u < MERGE_CHAINS; ++u)
        m[u] = Moments{p[u][3 * s], p[u][3 * s + 1], p[u][3 * s + 2]};
#pragma unroll
      for (int u = 0; u < MERGE_CHAINS; ++u) merge(a[u], m[u]);
    }
#pragma unroll
    for (int u = 0; u < MERGE_CHAINS; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        merge(a[u], Moments{__shfl_xor_sync(~0u, a[u].n, o), __shfl_xor_sync(~0u, a[u].mean, o),
                            __shfl_xor_sync(~0u, a[u].m2, o)});
      const int g = g0 + u * warps;
      if (lane == 0 && g < G) {
        mean[g] = a[u].mean;
        rstd[g] = rsqrtf(fmaxf(a[u].m2 / a[u].n, 0.f) + eps);
      }
    }
  }
}

// One Welford step of a thread's 8 channels at its cnt-th pixel.
__device__ __forceinline__ void welford(float* mean, float* m2, const float* v, float rn) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float d = v[k] - mean[k];
    mean[k] = fmaf(d, rn, mean[k]);
    m2[k] = fmaf(d, v[k] - mean[k], m2[k]);
  }
}

// The partial moments of every group of image blockIdx.y over the pixels
// [split * split_rows, + split_rows) of split blockIdx.x, into
// part[n][g][split][3]. Thread t: channels 8 (t % (C/8)).. of pixel slot
// t / (C/8) (slots past `rows` only merge). Shared: the slots' per-channel
// moments [rows][C] x 2 and counts [rows], then per (slot, group) [rows][G] x 2.
template <typename T>
__global__ void __launch_bounds__(GN_MAX_THREADS) kn_group_stats_kernel(
    const T* __restrict__ x, float* __restrict__ part, int P, int C, int G, int rows,
    int split_rows) {
  extern __shared__ float sm[];
  float* s_mean = sm;
  float* s_m2 = s_mean + rows * C;
  float* s_n = s_m2 + rows * C;
  float* g_mean = s_n + rows;
  float* g_m2 = g_mean + rows * G;
  const int c8 = C / VEC, cg = C / G, col = threadIdx.x % c8, r = threadIdx.x / c8;
  const int n = blockIdx.y, split = blockIdx.x;
  if (r < rows) {
    float mean[VEC], m2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;
    int cnt = 0;
    const int p1 = min(P, (split + 1) * split_rows);
    const T* src = x + (size_t)n * P * C + col * VEC;
    int p = split * split_rows + r;
    for (; p + 3 * rows < p1; p += 4 * rows) {
      float v[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u) load<VEC>(src + (size_t)(p + u * rows) * C, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ++cnt;
        welford(mean, m2, v[u], 1.f / cnt);
      }
    }
    for (; p < p1; p += rows) {
      float v[VEC];
      load<VEC>(src + (size_t)p * C, v);
      ++cnt;
      welford(mean, m2, v, 1.f / cnt);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s_mean[r * C + col * VEC + k] = mean[k];
      s_m2[r * C + col * VEC + k] = m2[k];
    }
    if (col == 0) s_n[r] = (float)cnt;
  }
  __syncthreads();
  // a slot's channels of one group share its count: their mean is the
  // channels' mean, their M2 the channels' plus count x the spread of means
  const float inv_cg = 1.f / cg;
  for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
    const int slot = i / G, g = i % G;
    const float* mu = s_mean + slot * C + g * cg;
    const float* q = s_m2 + slot * C + g * cg;
    float m = 0.f;
    for (int c = 0; c < cg; ++c) m += mu[c];
    m *= inv_cg;
    float m2 = 0.f, spread = 0.f;
    for (int c = 0; c < cg; ++c) {
      const float d = mu[c] - m;
      m2 += q[c];
      spread = fmaf(d, d, spread);
    }
    g_mean[i] = m;
    g_m2[i] = fmaf(s_n[slot], spread, m2);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    Moments a{0.f, 0.f, 0.f};
    for (int slot = 0; slot < rows; ++slot)
      merge(a, Moments{s_n[slot] * cg, g_mean[slot * G + g], g_m2[slot * G + g]});
    float* out = part + (((size_t)n * G + g) * gridDim.x + split) * 3;
    out[0] = a.n;
    out[1] = a.mean;
    out[2] = a.m2;
  }
}

// y = x * s + t per (n, channel), silu(y) where SILU, rounded once to TO,
// over the pixels [split * split_rows, + split_rows) of one image, its split
// one of gridDim.x (the apply's own), its statistics merged from the
// stats_splits partials of the statistics; blocks in the reverse order of
// the statistics' (L2). Shared: mean[G], rstd[G].
template <typename TI, typename TO, bool SILU>
__global__ void __launch_bounds__(GN_MAX_THREADS) kn_group_apply_kernel(
    const TI* __restrict__ x, const float* __restrict__ part, const void* __restrict__ w,
    const void* __restrict__ b, bool param_bf16, TO* __restrict__ y, int P, int C, int G,
    int rows, int split_rows, int stats_splits, float eps) {
  extern __shared__ float sm[];
  const int splits = gridDim.x;
  const int n = gridDim.y - 1 - blockIdx.y, split = splits - 1 - blockIdx.x;
  group_moments(part, n, G, stats_splits, eps, sm, sm + G);
  __syncthreads();
  const int c8 = C / VEC, cg = C / G, col = threadIdx.x % c8, r = threadIdx.x / c8;
  if (r >= rows) return;
  float s[VEC], t[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = col * VEC + k, g = c / cg;
    s[k] = sm[G + g] * param(w, c, param_bf16);
    t[k] = fmaf(-sm[g], s[k], param(b, c, param_bf16));
  }
  const int p1 = min(P, (split + 1) * split_rows);
  const size_t base = (size_t)n * P * C + col * VEC;
  const TI* src = x + base;
  TO* dst = y + base;
  int p = split * split_rows + r;
  for (; p + 3 * rows < p1; p += 4 * rows) {
    float v[4][VEC];
#pragma unroll
    for (int u = 0; u < 4; ++u) load<VEC>(src + (size_t)(p + u * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[u][k] = fmaf(v[u][k], s[k], t[k]);
        if (SILU) v[u][k] = silu(v[u][k]);
      }
      store<VEC>(dst + (size_t)(p + u * rows) * C, v[u]);
    }
  }
  for (; p < p1; p += rows) {
    float v[VEC];
    load<VEC>(src + (size_t)p * C, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      v[k] = fmaf(v[k], s[k], t[k]);
      if (SILU) v[k] = silu(v[k]);
    }
    store<VEC>(dst + (size_t)p * C, v);
  }
}

// K4's prologue parameters: s, t [N, C] fp32 of image blockIdx.x from its
// partials. Shared: mean[G], rstd[G].
__global__ void __launch_bounds__(256) kn_group_finalize_kernel(
    const float* __restrict__ part, const void* __restrict__ w, const void* __restrict__ b,
    bool param_bf16, float* __restrict__ s, float* __restrict__ t, int C, int G, int splits,
    float eps) {
  extern __shared__ float sm[];
  const int n = blockIdx.x, cg = C / G;
  group_moments(part, n, G, splits, eps, sm, sm + G);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float sc = sm[G + g] * param(w, c, param_bf16);
    s[(size_t)n * C + c] = sc;
    t[(size_t)n * C + c] = fmaf(-sm[g], sc, param(b, c, param_bf16));
  }
}

// Sum over the `lanes` lanes (a power of two) that share a row.
__device__ __forceinline__ float lane_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Layer norm of rows [rows, C]: `lanes` lanes a row, lane l holding chunks
// l, l + lanes, ... (J at most) of V channels; every block walks the same
// number of steps, so the shuffles see whole warps. Shared: w[C], b[C] fp32.
template <typename TI, typename TO, int V, int J>
__global__ void __launch_bounds__(LN_THREADS) kn_layer_norm_kernel(
    const TI* __restrict__ x, const void* __restrict__ w, const void* __restrict__ b,
    bool param_bf16, TO* __restrict__ y, long long rows, int C, int lanes, float eps) {
  extern __shared__ float sm[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    sm[c] = param(w, c, param_bf16);
    sm[C + c] = param(b, c, param_bf16);
  }
  __syncthreads();
  const int chunks = C / V, lane = threadIdx.x % lanes;
  const long long per_block = blockDim.x / lanes, stride = per_block * gridDim.x;
  const float inv_c = 1.f / C;
  for (long long row0 = blockIdx.x * per_block; row0 < rows; row0 += stride) {
    const long long row = row0 + threadIdx.x / lanes;
    const bool valid = row < rows;
    const TI* src = x + row * C;
    float v[J][V];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int ch = j * lanes + lane;
      if (valid && ch < chunks) {
        load<V>(src + ch * V, v[j]);
#pragma unroll
        for (int k = 0; k < V; ++k) sum += v[j][k];
      }
    }
    const float mean = lane_sum(sum, lanes) * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (valid && j * lanes + lane < chunks) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = v[j][k] - mean;
          sq = fmaf(d, d, sq);
        }
      }
    }
    const float rstd = rsqrtf(lane_sum(sq, lanes) * inv_c + eps);
    TO* dst = y + row * C;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int ch = j * lanes + lane;
      if (valid && ch < chunks) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int c = ch * V + k;
          v[j][k] = fmaf((v[j][k] - mean) * rstd, sm[c], sm[C + c]);
        }
        store<V>(dst + ch * V, v[j]);
      }
    }
  }
}

// A cut of P pixels into `splits` runs of `split_rows` (a multiple of rows),
// none empty.
bool splits_ok(int P, int rows, int splits, int split_rows) {
  return split_rows > 0 && split_rows % rows == 0 && splits >= 1 &&
         (long long)splits * split_rows >= P && (long long)(splits - 1) * split_rows < P;
}

// A block of `threads` over `rows` pixel slots of C/8 columns each, on x [N, P, C].
bool block_ok(int N, int P, int C, int G, int threads, int rows) {
  if (N <= 0 || P <= 0 || C <= 0 || G <= 0 || C % VEC != 0 || C % G != 0 || C > 4096)
    return false;
  const int c8 = C / VEC;
  return threads % 32 == 0 && threads <= GN_MAX_THREADS && rows >= 1 && rows * c8 <= threads &&
         threads < rows * c8 + 32 && N <= 65535 && (long long)N * P * C < (1LL << 40);
}

// The statistics' launch, as ops/norm.py norm_plan gives it.
bool group_plan_ok(int N, int P, int C, int G, int threads, int rows, int splits,
                   int split_rows, int smem) {
  return block_ok(N, P, C, G, threads, rows) && splits_ok(P, rows, splits, split_rows) &&
         smem == (int)sizeof(float) * (2 * rows * C + rows + 2 * rows * G) && smem <= 48 * 1024;
}

template <typename T>
cudaError_t group_stats(const T* x, float* part, int N, int P, int C, int G, int threads,
                        int rows, int splits, int split_rows, int smem, cudaStream_t st) {
  kn_group_stats_kernel<T><<<dim3(splits, N), threads, smem, st>>>(x, part, P, C, G, rows,
                                                                   split_rows);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t group_apply(const TI* x, const float* part, const void* w, const void* b, bool pb,
                        TO* y, int N, int P, int C, int G, float eps, bool silu_, int threads,
                        int rows, int stats_splits, int splits, int split_rows,
                        cudaStream_t st) {
  const dim3 grid(splits, N);
  const int smem = 2 * G * sizeof(float);
  if (silu_)
    kn_group_apply_kernel<TI, TO, true><<<grid, threads, smem, st>>>(
        x, part, w, b, pb, y, P, C, G, rows, split_rows, stats_splits, eps);
  else
    kn_group_apply_kernel<TI, TO, false><<<grid, threads, smem, st>>>(
        x, part, w, b, pb, y, P, C, G, rows, split_rows, stats_splits, eps);
  return cudaGetLastError();
}

cudaError_t stats_any(const void* x, int x_bf16, float* part, int N, int P, int C, int G,
                      int threads, int rows, int splits, int split_rows, int smem,
                      cudaStream_t st) {
  return x_bf16 ? group_stats((const __nv_bfloat16*)x, part, N, P, C, G, threads, rows, splits,
                              split_rows, smem, st)
                : group_stats((const float*)x, part, N, P, C, G, threads, rows, splits,
                              split_rows, smem, st);
}

cudaError_t apply_any(const void* x, int x_bf16, const float* part, const void* w, const void* b,
                      bool pb, void* y, int y_bf16, int N, int P, int C, int G, float eps,
                      bool sl, int threads, int rows, int stats_splits, int splits,
                      int split_rows, cudaStream_t st) {
  if (x_bf16 && y_bf16)
    return group_apply((const __nv_bfloat16*)x, part, w, b, pb, (__nv_bfloat16*)y, N, P, C, G,
                       eps, sl, threads, rows, stats_splits, splits, split_rows, st);
  if (x_bf16)
    return group_apply((const __nv_bfloat16*)x, part, w, b, pb, (float*)y, N, P, C, G, eps, sl,
                       threads, rows, stats_splits, splits, split_rows, st);
  if (y_bf16)
    return group_apply((const float*)x, part, w, b, pb, (__nv_bfloat16*)y, N, P, C, G, eps, sl,
                       threads, rows, stats_splits, splits, split_rows, st);
  return group_apply((const float*)x, part, w, b, pb, (float*)y, N, P, C, G, eps, sl, threads,
                     rows, stats_splits, splits, split_rows, st);
}

template <typename TI, typename TO, int V>
cudaError_t layer_norm_v(const TI* x, const void* w, const void* b, bool pb, TO* y,
                         long long rows, int C, int lanes, int chunks, int grid, float eps,
                         cudaStream_t st) {
  const int smem = 2 * C * sizeof(float);
  switch (chunks) {
#define KN_CASE(J)                                                              \
  case J:                                                                       \
    kn_layer_norm_kernel<TI, TO, V, J><<<grid, LN_THREADS, smem, st>>>(x, w, b, pb, y, rows, C, \
                                                                       lanes, eps); \
    return cudaGetLastError();
    KN_CASE(1) KN_CASE(2) KN_CASE(4) KN_CASE(8) KN_CASE(16)
#undef KN_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename TI, typename TO>
cudaError_t layer_norm(const TI* x, const void* w, const void* b, bool pb, TO* y,
                       long long rows, int C, int vec, int lanes, int chunks, int grid,
                       float eps, cudaStream_t st) {
  return vec == 8 ? layer_norm_v<TI, TO, 8>(x, w, b, pb, y, rows, C, lanes, chunks, grid, eps, st)
                  : layer_norm_v<TI, TO, 4>(x, w, b, pb, y, rows, C, lanes, chunks, grid, eps,
                                            st);
}

}  // namespace

// Group norm of x [N, P, C] into y (silu(y) where `silu`): the statistics
// into the caller's scratch `part` (N x G x splits x 3 floats), then the
// apply over apply_splits runs of apply_split_rows pixels an image. The
// plan (ops/norm.py norm_plan) gives threads, rows, splits, split_rows, the
// statistics' shared bytes and the apply's cut. *_bf16: 1 for bf16, 0 for
// fp32. Pointers 16-byte aligned.
extern "C" int anyv2v_group_norm(const void* x, int x_bf16, const void* w, const void* b,
                                 int param_bf16, void* y, int y_bf16, float* part, int N, int P,
                                 int C, int G, float eps, int silu, int threads, int rows,
                                 int splits, int split_rows, int smem, int apply_splits,
                                 int apply_split_rows, void* stream) {
  if (!group_plan_ok(N, P, C, G, threads, rows, splits, split_rows, smem) ||
      !splits_ok(P, rows, apply_splits, apply_split_rows) || x == nullptr || y == nullptr ||
      part == nullptr || w == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      stats_any(x, x_bf16, part, N, P, C, G, threads, rows, splits, split_rows, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)apply_any(x, x_bf16, part, w, b, param_bf16 != 0, y, y_bf16, N, P, C, G, eps,
                        silu != 0, threads, rows, splits, apply_splits, apply_split_rows, st);
}

// The group norm in two calls, for an x [N, P, C] that holds one share of
// each image's pixels (a rank's frames of a clip): the statistics of this
// share into `part` (N x G x splits x 3 floats), which the caller gathers
// with every other share's into [N][G][stats_splits][3]; then the apply of
// those merged statistics to this share. Arguments as anyv2v_group_norm's.
extern "C" int anyv2v_group_stats(const void* x, int x_bf16, float* part, int N, int P, int C,
                                  int G, int threads, int rows, int splits, int split_rows,
                                  int smem, void* stream) {
  if (!group_plan_ok(N, P, C, G, threads, rows, splits, split_rows, smem) || x == nullptr ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)stats_any(x, x_bf16, part, N, P, C, G, threads, rows, splits, split_rows, smem,
                        (cudaStream_t)stream);
}

extern "C" int anyv2v_group_apply(const void* x, int x_bf16, const float* part,
                                  int stats_splits, const void* w, const void* b,
                                  int param_bf16, void* y, int y_bf16, int N, int P, int C,
                                  int G, float eps, int silu, int threads, int rows,
                                  int apply_splits, int apply_split_rows, void* stream) {
  if (!block_ok(N, P, C, G, threads, rows) ||
      !splits_ok(P, rows, apply_splits, apply_split_rows) || stats_splits < 1 || x == nullptr ||
      y == nullptr || part == nullptr || w == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)apply_any(x, x_bf16, part, w, b, param_bf16 != 0, y, y_bf16, N, P, C, G, eps,
                        silu != 0, threads, rows, stats_splits, apply_splits, apply_split_rows,
                        (cudaStream_t)stream);
}

// K4's prologue parameters: the statistics of x [N, P, C] into `part`, then
// s, t [N, C] fp32.
extern "C" int anyv2v_group_scale_shift(const void* x, int x_bf16, const void* w, const void* b,
                                        int param_bf16, float* part, float* s, float* t, int N,
                                        int P, int C, int G, float eps, int threads, int rows,
                                        int splits, int split_rows, int smem, void* stream) {
  if (!group_plan_ok(N, P, C, G, threads, rows, splits, split_rows, smem) || x == nullptr ||
      s == nullptr || t == nullptr || part == nullptr || w == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      stats_any(x, x_bf16, part, N, P, C, G, threads, rows, splits, split_rows, smem, st);
  if (err != cudaSuccess) return (int)err;
  kn_group_finalize_kernel<<<N, 256, 2 * G * sizeof(float), st>>>(part, w, b, param_bf16 != 0, s,
                                                                   t, C, G, splits, eps);
  return (int)cudaGetLastError();
}

// Layer norm of x [rows, C] into y. The plan (ops/norm.py layer_norm_plan)
// gives the channels a load (`vec`, 8 or 4), the lanes a row, the chunks a
// lane (1, 2, 4, 8 or 16) and the grid.
extern "C" int anyv2v_layer_norm(const void* x, int x_bf16, const void* w, const void* b,
                                 int param_bf16, void* y, int y_bf16, long long rows, int C,
                                 float eps, int vec, int lanes, int chunks, int grid,
                                 void* stream) {
  if (rows <= 0 || C <= 0 || C > 4096 || (vec != 8 && vec != 4) || C % vec != 0 ||
      (lanes & (lanes - 1)) != 0 || lanes < 1 || lanes > 32 || chunks < 1 ||
      (long long)chunks * lanes < C / vec || grid < 1 || x == nullptr || y == nullptr ||
      w == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool pb = param_bf16 != 0;
  if (x_bf16 && y_bf16)
    return (int)layer_norm((const __nv_bfloat16*)x, w, b, pb, (__nv_bfloat16*)y, rows, C, vec,
                           lanes, chunks, grid, eps, st);
  if (x_bf16)
    return (int)layer_norm((const __nv_bfloat16*)x, w, b, pb, (float*)y, rows, C, vec, lanes,
                           chunks, grid, eps, st);
  if (y_bf16)
    return (int)layer_norm((const float*)x, w, b, pb, (__nv_bfloat16*)y, rows, C, vec, lanes,
                           chunks, grid, eps, st);
  return (int)layer_norm((const float*)x, w, b, pb, (float*)y, rows, C, vec, lanes, chunks, grid,
                         eps, st);
}
