// KR: the partial rotary of ConsistI2V's and SEINE's temporal attention,
// one pass over bf16 x that writes the rotated copy once.
//  x is contiguous, seen as [R0, P, R1, G, D]: R0 batch rows, P positions
//  (the frame axis), R1 pixels, G groups of D channels (ConsistI2V: one group,
//  the whole projection, rot = D / 2; SEINE: one group a head, rot =
//  min(32, head width) of a head's stored width D). The first `rot` channels
//  of every group rotate in pairs (x_2i, x_2i+1) by the angle pos[p] *
//  freq[i]; the rest pass through. freq is the fp32 table
//  theta^(-2i/rot) that the wrapper makes once per (rot, device); pos the
//  caller's fp32 positions on the device (frame indices, zeros for
//  ConsistI2V's 8 augmented keys, a rank's offsets when frames are split).
//  Neither is copied from the host at a call, so a call never waits for the
//  device's queue.
//
// Replaces no Pallas kernel: the JAX package leaves its rotary to XLA. The
// port's plain path (ops/rotary.py) took about 12 launches a call (the fp32
// upcast, the angle product, repeat_interleave, neg, stack, cos, sin, two
// products, a sum, the cast back, the cat with the channels that pass
// through), and copied its numpy frequency table to the device at every
// call, a copy from pageable memory that drains the queue: 45 of
// ConsistI2V's 47 host syncs a forward.
//
// What bounds it on the H100: HBM bytes, x read once and the output written
// once (4 bytes an element). Design:
//  - A block serves one (row, position) slab, the contiguous R1 * G * D
//    elements at (r0, p), grid (blocks a slab, P, R0). It first forms the
//    cosine and sine of its position's rot / 2 angles into shared memory
//    (a few hundred precise sinf / cosf a block), so that each element costs
//    two loads of shared memory and not two transcendentals.
//  - Each thread moves KR_VECS 16-byte vectors of 8 channels (4 pairs), its
//    loads issued before any arithmetic; a vector's channel offset within
//    its group says whether its pairs rotate (a group's width is a multiple
//    of 8, rot any even width up to it: seine-tiny rotates 4 of 8).
//  - The arithmetic is the plain version's, so the two agree bit for bit:
//    the angle one fp32 product, precise cosf / sinf (the build has no
//    fast math), each product rounded alone and then the sum (no FMA
//    contraction), one round-to-nearest-even to bf16.
//  - The output is a new tensor: after PnP injection q and k may hold the
//    same rows, and x is never written.
// No kernel allocates, synchronises or calls back into the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::pack_bf16;

constexpr int KR_THREADS = 256;
constexpr int KR_VECS = 4;           // 16-byte vectors a thread
constexpr int KR_MAX_PAIRS = 1024;   // rot / 2 at most (the shared table)

// (x_e, x_o) of one bf16 pair rotated by the angle with cosine c and sine s.
__device__ __forceinline__ uint32_t rotate_pair(uint32_t w, float c, float s) {
  const float xe = __uint_as_float(w << 16), xo = __uint_as_float(w & 0xffff0000u);
  const float ye = __fadd_rn(__fmul_rn(xe, c), __fmul_rn(-xo, s));
  const float yo = __fadd_rn(__fmul_rn(xo, c), __fmul_rn(xe, s));
  return pack_bf16(ye, yo);
}

// One slab (r0 = blockIdx.z, p = blockIdx.y) of `slab_vecs` 16-byte vectors,
// groups of `d_vecs` vectors whose first `pairs` pairs rotate. Shared:
// (cos, sin) of each pair's angle.
__global__ void __launch_bounds__(KR_THREADS) kr_rotary_kernel(
    const uint4* __restrict__ x, const float* __restrict__ pos, const float* __restrict__ freq,
    uint4* __restrict__ y, int slab_vecs, int d_vecs, int pairs) {
  __shared__ float2 cs[KR_MAX_PAIRS];
  const float at = pos[blockIdx.y];
  for (int i = threadIdx.x; i < pairs; i += KR_THREADS) {
    const float a = __fmul_rn(at, freq[i]);
    cs[i] = make_float2(cosf(a), sinf(a));
  }
  __syncthreads();
  const size_t slab = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * (size_t)slab_vecs;
  x += slab;
  y += slab;
  const int first = blockIdx.x * (KR_THREADS * KR_VECS) + threadIdx.x;
  const int rot_vecs = (pairs + 3) / 4;
  uint4 v[KR_VECS];
#pragma unroll
  for (int j = 0; j < KR_VECS; ++j) {
    const int e = first + j * KR_THREADS;
    if (e < slab_vecs) v[j] = x[e];
  }
#pragma unroll
  for (int j = 0; j < KR_VECS; ++j) {
    const int e = first + j * KR_THREADS;
    if (e >= slab_vecs) break;
    const int c = e % d_vecs;
    if (c < rot_vecs) {
      uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = c * 4 + k;
        if (i < pairs) {
          const float2 t = cs[i];
          w[k] = rotate_pair(w[k], t.x, t.y);
        }
      }
      v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    y[e] = v[j];
  }
}

}  // namespace

// The rotary of x [R0, P, slab] (bf16, contiguous, 16-byte aligned; a slab
// of `slab_vecs` vectors of 8 channels, in groups of `d_vecs` vectors whose
// first `pairs` pairs rotate) into y of x's shape, at positions pos [P] with
// frequencies freq [pairs], both fp32 on the device. The plan
// (ops/rotary.py rotary_plan) gives `blocks`, the blocks a slab.
extern "C" int anyv2v_rotary(const void* x, const float* pos, const float* freq, void* y,
                             int r0, int P, int slab_vecs, int d_vecs, int pairs, int blocks,
                             void* stream) {
  if (r0 < 1 || r0 > 65535 || P < 1 || P > 65535 || slab_vecs < 1 || d_vecs < 1 ||
      slab_vecs % d_vecs != 0 || pairs < 1 || pairs > KR_MAX_PAIRS || pairs > 4 * d_vecs ||
      blocks < 1 || (long long)blocks * KR_THREADS * KR_VECS < slab_vecs || x == nullptr ||
      pos == nullptr || freq == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  kr_rotary_kernel<<<dim3(blocks, P, r0), KR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, pos, freq, (uint4*)y, slab_vecs, d_vecs, pairs);
  return (int)cudaGetLastError();
}
