"""Where K3's and K4's time goes, by phase and by warp role, on one NVIDIA
GPU: an instrumented copy of ``anyv2v_torch`` (never kept) whose GEMM main
loop sums ``clock()`` cycles by phase over every warp, with ``torch.addmm``
at each launch's product shape as the yardstick, timed in the same call.

    python3 scripts/torch_gemm_stamps.py [--tree DIR] [--out DIR]

The script copies ``anyv2v_torch/`` from ``--tree`` (default: this checkout)
into ``--out`` (default ``build/variants/gemm_stamps``, git-ignored), patches
the copy's ``csrc/hopper.cuh``, ``csrc/ffn.cu`` and ``csrc/temporal_conv.cu``
with the patch set of the tree's main loop (:data:`LOOPS`: the cooperative
loop of PR 7, which the tree of PR 14 still has, or the persistent loop with
its two schedules that replaced it), builds the copy, runs each case once at
``chip_smoke.py``'s shapes, and prints each phase's share of the summed
cycles of the consumer warps and of the producer's warps, with the kernel's
time by CUDA events (instrumented) and the yardstick's. The phases do not
nest: a warp's cycles are the named phases and ``other``.

Consumer phases (a phase is the time between two stamps of one warp; the
products and loads are asynchronous, so a phase that waits for them carries
their latency): ``full wait`` (a stage's full barrier), ``issue`` (issuing
and committing the step's ``wgmma``), ``wgmma wait`` (``wgmma.wait_group``)
and ``other`` (the rest: a tile's set-up, the stage releases, the loop); on
PR 7's loop also ``ldmatrix`` and ``prologue`` (K4: the raw x slice to
registers, ``silu(x*s + t)`` on it, before the issue), ``epi math`` (the
bias and the activation, with the bias's loads), ``epi stage`` (writing the
bf16 result: to the staging tile, or to global memory from registers) and
``epi store`` (the staging's barriers, the TMA store's issue and its
``bulk_wait_read``); on the persistent loop ``turn wait`` (ping-pong: the
named barrier that passes the tensor cores to a warpgroup) and
``epilogue`` (the whole epilogue, with the last ``bulk_wait_read``).
Producer phases: ``empty wait`` (a free slot), ``issue`` (the TMA loads or
``cp.async`` gathers) and ``tile setup`` (K4's per-row frames or source
table). On the persistent loop K4's prologue is a kernel of its own, which
the stamps do not cover: the instrumented time is both launches'.

K3's two launches are kernels of one call; their cycles are summed apart
(slot 1: launch 1, slot 0: launch 2; on the persistent loop, slot 1 is the
ping-pong schedule, launch 1's at these shapes).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PR7_PHASES = ("full wait", "ldmatrix", "prologue", "issue", "wgmma wait", "epi math",
              "epi stage", "epi store")
PERSISTENT_PHASES = ("full wait", "issue", "wgmma wait", "turn wait", "epilogue")
PRODUCER = ("empty wait", "issue", "tile setup")
N = 12             # stamp slots per role
TOTAL = N - 1      # the slot that holds each warp's whole time
SLOTS = 2          # kernel instances summed apart (K3: launch 2 = 0, launch 1 = 1)
FULL, LDSM, PRO, ISSUE, WGWAIT, EMATH, ESTAGE, ESTORE = range(8)
P_FULL, P_ISSUE, P_WGWAIT, P_TURN, P_EPI = range(5)   # the persistent loop's
PWAIT, PISSUE, PSETUP = range(3)

STAMP_DEFS = (
    "namespace hopper {\n",
    "namespace hopper {\n\n"
    f"static __device__ unsigned long long g_stamps[{SLOTS}][2][{N}];\n"
    "#define T0 t0 = clock()\n#define T1(c) st[c] += clock() - t0\n"
    "#define TC(c) sp[c] += clock() - t0\n"
    "#define FENCE(x) asm volatile(\"\" :: \"f\"(x))\n"
    "#define FENCE_U(x) asm volatile(\"\" :: \"r\"(x))\n"
    "__device__ __forceinline__ void stamps_flush(const uint32_t* st, int slot, int role) {\n"
    "  if (threadIdx.x % 32 == 0)\n"
    f"    for (int c = 0; c < {N}; ++c) atomicAdd(&g_stamps[slot][role][c], (unsigned long long)st[c]);\n"
    "}\n",
)


def _entry(name):
    return f"""
extern "C" int anyv2v_{name}_stamps(void* out, int reset) {{
  if (reset) {{
    unsigned long long z[{SLOTS * 2 * N}] = {{}};
    return (int)cudaMemcpyToSymbol(hopper::g_stamps, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(out, hopper::g_stamps, sizeof(hopper::g_stamps));
}}
"""


# the cooperative-only main loop (hopper.cuh gemm_main_loop whose consumers
# share every tile, K4's prologue on wgmma's register A), instrumented whole
COOP_LOOP = """  if (role == 2) {
    setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    const int tw = threadIdx.x - 256;
    if (tw >= Body::PRODUCER_THREADS) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      body.begin_produce(tile, tw);
      for (int k = 0; k < ksteps; ++k, ++it) {
        const int stage = it % S;
        if (it >= S) mbar_wait(&empty[stage], ((it / S) - 1) & 1);
        body.produce(tile, k, smem + stage * Body::STAGE_BYTES, &full[stage], tw);
      }
    }
  } else {
    setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    const bool lead = threadIdx.x % 32 == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      typename Body::Consumer c(body, tile, role);
      for (int k = 0; k < ksteps; ++k, ++it) {
        const int stage = it % S;
        mbar_wait(&full[stage], (it / S) & 1);
        c.mma(k, smem + stage * Body::STAGE_BYTES);
        wgmma_wait<1>();
        if (k > 0 && lead) mbar_arrive(&empty[(it - 1) % S]);
      }
      wgmma_wait<0>();
      if (lead) mbar_arrive(&empty[(it - 1) % S]);
      c.epilogue();
    }
    body.consumers_done();
  }
}
"""

COOP_LOOP_STAMPED = f"""  uint32_t st[{N}] = {{}};
  const uint32_t tall = clock();
  uint32_t t0 = tall;
  if (role == 2) {{
    setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    const int tw = threadIdx.x - 256;
    if (tw >= Body::PRODUCER_THREADS) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {{
      T0;
      body.begin_produce(tile, tw);
      T1({PSETUP});
      for (int k = 0; k < ksteps; ++k, ++it) {{
        const int stage = it % S;
        T0;
        if (it >= S) mbar_wait(&empty[stage], ((it / S) - 1) & 1);
        T1({PWAIT});
        T0;
        body.produce(tile, k, smem + stage * Body::STAGE_BYTES, &full[stage], tw);
        T1({PISSUE});
      }}
    }}
    st[{TOTAL}] = clock() - tall;
    stamps_flush(st, Body::STAMP_SLOT, 1);
  }} else {{
    setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    const bool lead = threadIdx.x % 32 == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {{
      typename Body::Consumer c(body, tile, role);
      c.sp = st;
      for (int k = 0; k < ksteps; ++k, ++it) {{
        const int stage = it % S;
        T0;
        mbar_wait(&full[stage], (it / S) & 1);
        T1({FULL});
        T0;
        c.mma(k, smem + stage * Body::STAGE_BYTES);
        T1({ISSUE});
        T0;
        wgmma_wait<1>();
        T1({WGWAIT});
        if (k > 0 && lead) mbar_arrive(&empty[(it - 1) % S]);
      }}
      T0;
      wgmma_wait<0>();
      T1({WGWAIT});
      if (lead) mbar_arrive(&empty[(it - 1) % S]);
      c.epilogue();
    }}
    body.consumers_done();
    st[{TOTAL}] = clock() - tall;
    stamps_flush(st, Body::STAMP_SLOT, 0);
  }}
}}
"""

# ffn.cu: the slot, the stamp pointer, and the epilogues split into math
# (in place in the accumulators) and the writes
FFN_BIAS_EPI = """#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row < g.M)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (size_t)row * g.cols + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
        }
      }
"""
FFN_BIAS_EPI_STAMPED = f"""      uint32_t t0 = clock();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {{
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {{
          acc[4 * j + 2 * h] += b.x;
          acc[4 * j + 2 * h + 1] += b.y;
        }}
      }}
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) FENCE(acc[i]);
      TC({EMATH});
      T0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {{
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {{
          const int row = r0 + 8 * h;
          if (row < g.M)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (size_t)row * g.cols + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }}
      }}
      TC({ESTAGE});
"""
FFN_ACT_EPI = """      if (tw == 0) bulk_wait_read();
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < TILE_COLS / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
        float2 b1 = b0;
        if constexpr (ACT == kGeglu)
          b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + g.cols + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (tw / 32) * 16 + lane / 4 + 8 * h;
          const float* v = acc + 4 * j + 2 * h;
          float y0, y1;
          if constexpr (ACT == kGeglu) {
            const float* gt = acc + 4 * (j + TILE_COLS / 8) + 2 * h;
            y0 = (v[0] + b0.x) * gelu_erf(gt[0] + b1.x);
            y1 = (v[1] + b0.y) * gelu_erf(gt[1] + b1.y);
          } else {
            y0 = gelu_erf(v[0] + b0.x);
            y1 = gelu_erf(v[1] + b0.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(st + (j / 8) * 8192 + r * 128 +
                                             (((j % 8) ^ (r % 8)) * 16) + 4 * t) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tw == 0) {
        tma_store_2d(g.o_map, st, n0, m0 + wg * 64);
        tma_store_2d(g.o_map, st + 8192, n0 + 64, m0 + wg * 64);
        bulk_commit();
      }
"""
FFN_ACT_EPI_STAMPED = f"""      uint32_t t0 = clock();
      if (tw == 0) bulk_wait_read();
      named_barrier(2 + wg, 128);
      TC({ESTORE});
      T0;
#pragma unroll
      for (int j = 0; j < TILE_COLS / 8; ++j) {{
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
        const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
        float2 b1 = b0;
        if constexpr (ACT == kGeglu)
          b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + g.cols + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {{
          float* v = acc + 4 * j + 2 * h;
          if constexpr (ACT == kGeglu) {{
            const float* gt = acc + 4 * (j + TILE_COLS / 8) + 2 * h;
            v[0] = (v[0] + b0.x) * gelu_erf(gt[0] + b1.x);
            v[1] = (v[1] + b0.y) * gelu_erf(gt[1] + b1.y);
          }} else {{
            v[0] = gelu_erf(v[0] + b0.x);
            v[1] = gelu_erf(v[1] + b0.y);
          }}
        }}
      }}
#pragma unroll
      for (int i = 0; i < TILE_COLS / 2; ++i) FENCE(acc[i]);
      TC({EMATH});
      T0;
#pragma unroll
      for (int j = 0; j < TILE_COLS / 8; ++j) {{
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.cols) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {{
          const int r = (tw / 32) * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(st + (j / 8) * 8192 + r * 128 +
                                             (((j % 8) ^ (r % 8)) * 16) + 4 * t) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }}
      }}
      TC({ESTAGE});
      T0;
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tw == 0) {{
        tma_store_2d(g.o_map, st, n0, m0 + wg * 64);
        tma_store_2d(g.o_map, st + 8192, n0 + 64, m0 + wg * 64);
        bulk_commit();
      }}
      TC({ESTORE});
"""
COOP_FFN = [
    ("  static constexpr bool STAGED = ACT != kBias;   // h staged and stored by TMA\n",
     "  static constexpr bool STAGED = ACT != kBias;   // h staged and stored by TMA\n"
     "  static constexpr int STAMP_SLOT = STAGED ? 1 : 0;\n"),
    ("    float acc[BN / 2];\n", "    float acc[BN / 2];\n    uint32_t* sp;\n"),
    # the staging pointer is called st in act_epilogue: rename it there
    ("      unsigned char* st = g.staging + wg * (STAGING_BYTES / 2);\n",
     "      unsigned char* sg = g.staging + wg * (STAGING_BYTES / 2);\n"),
    (FFN_BIAS_EPI, FFN_BIAS_EPI_STAMPED),
    (FFN_ACT_EPI, FFN_ACT_EPI_STAMPED.replace("(st + (j / 8)", "(sg + (j / 8)")
     .replace("st, n0, m0", "sg, n0, m0").replace("st + 8192, n0", "sg + 8192, n0")),
]

TCONV_STEP = """      const uint32_t sa = smem_addr(stage);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // matrices: rows 0-7 / 8-15 of the warp's 16, channels 0-7 / 8-15 of the step
        const int q = lane / 8, r = rbase + (q & 1) * 8 + lane % 8, c = 2 * kk + (q >> 1);
        ldmatrix_x4(a[BUF][kk], sa + r * 128 + ((c ^ (r % 8)) * 16));
      }
      if (g.s != nullptr) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)   // (row g, ch 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
            a[BUF][kk][e] = prologue(a[BUF][kk][e], e & 1, d, k0 + kk * 16 + 2 * t + (e >> 1) * 8);
      }
"""
TCONV_STEP_STAMPED = f"""      const uint32_t sa = smem_addr(stage);
      uint32_t t0 = clock();
      const uint32_t tin = t0;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {{
        const int q = lane / 8, r = rbase + (q & 1) * 8 + lane % 8, c = 2 * kk + (q >> 1);
        ldmatrix_x4(a[BUF][kk], sa + r * 128 + ((c ^ (r % 8)) * 16));
      }}
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {{ FENCE_U(a[BUF][kk][0]); FENCE_U(a[BUF][kk][3]); }}
      TC({LDSM});
      T0;
      if (g.s != nullptr) {{
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[BUF][kk][e] = prologue(a[BUF][kk][e], e & 1, d, k0 + kk * 16 + 2 * t + (e >> 1) * 8);
      }}
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {{ FENCE_U(a[BUF][kk][0]); FENCE_U(a[BUF][kk][3]); }}
      TC({PRO});
      sp[{ISSUE}] -= clock() - tin;   // the loop's issue stamp spans this step: not issue
"""
TCONV_EPI = """#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= g.Cout) continue;
        const float2 b2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row < g.M)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (size_t)row * g.Cout + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] + b2.x, acc[4 * j + 2 * h + 1] + b2.y);
        }
      }
"""
TCONV_EPI_STAMPED = (FFN_BIAS_EPI_STAMPED.replace("g.cols", "g.Cout").replace("b.x", "b2.x")
                     .replace("b.y", "b2.y").replace("const float2 b =", "const float2 b2 ="))
COOP_TCONV = [
    ("  static constexpr int STAGES = RING;\n",
     "  static constexpr int STAGES = RING;\n  static constexpr int STAMP_SLOT = 0;\n"),
    ("    uint32_t a[2][BK / 16][4];   // two steps' A fragments\n",
     "    uint32_t a[2][BK / 16][4];   // two steps' A fragments\n    uint32_t* sp;\n"),
    (TCONV_STEP, TCONV_STEP_STAMPED),
    (TCONV_EPI, TCONV_EPI_STAMPED),
]

# the persistent loop (hopper.cuh gemm_main_loop with its cooperative and
# ping-pong schedules), instrumented in the loop only: the bodies' epilogues
# are one phase
PERSISTENT_LOOP = """  if (role == 2) {
    setmaxnreg_dec<Body::PRODUCER_REGS>();
    const int tw = threadIdx.x - 256;
    if (tw >= Body::PRODUCER_THREADS) return;
    typename Body::Loader p(body, tw);
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x)
#pragma unroll
      for (int w = 0; w < (Body::PINGPONG ? 2 : 1); ++w) {
        const int tile = Body::PINGPONG ? 2 * u + w : u;
        if (tile >= tiles) continue;
        p.begin(tile);
        for (int k = 0; k < ksteps; ++k, ++it) {
          const int stage = it % S;
          if (it >= S) mbar_wait(&empty[stage], ((it / S) - 1) & 1);
          p.load(k, smem + stage * Body::STAGE_BYTES, &full[stage]);
        }
      }
  } else {
    setmaxnreg_inc<Body::CONSUMER_REGS>();
    const bool lead = threadIdx.x % 32 == 0;
    // the K steps of one tile, from step index `it` of the block's ring on
    auto k_loop = [&](typename Body::Consumer& c, int it) {
      for (int k = 0; k < ksteps; ++k, ++it) {
        const int stage = it % S;
        mbar_wait(&full[stage], (it / S) & 1);
        c.mma(k, smem + stage * Body::STAGE_BYTES);
        wgmma_wait<1>();
        if (k > 0 && lead) mbar_arrive(&empty[(it - 1) % S]);
      }
    };
    if constexpr (Body::PINGPONG) {
      // warpgroup 0 takes the first turn; the last unit's last turn is not
      // passed on, so that each barrier completes as often as it is awaited
      if (role == 1) named_barrier_arrive(GEMM_TURN_BARRIER, 256);
      for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
        const int tile = 2 * u + role, it = (2 * i + role) * ksteps;
        const bool pass = !(role == 1 && u + (int)gridDim.x >= units);
        named_barrier(GEMM_TURN_BARRIER + role, 256);
        if (tile < tiles) {
          typename Body::Consumer c(body, tile, role);
          k_loop(c, it);
          if (pass) named_barrier_arrive(GEMM_TURN_BARRIER + 1 - role, 256);
          wgmma_wait<0>();
          if (lead) mbar_arrive(&empty[(it + ksteps - 1) % S]);
          c.epilogue();
        } else if (pass) {
          named_barrier_arrive(GEMM_TURN_BARRIER + 1 - role, 256);
        }
      }
    } else {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, it += ksteps) {
        typename Body::Consumer c(body, tile, role);
        k_loop(c, it);
        wgmma_wait<0>();
        if (lead) mbar_arrive(&empty[(it + ksteps - 1) % S]);
        c.epilogue();
      }
    }
    body.consumers_done();
  }
}
"""

PERSISTENT_LOOP_STAMPED = f"""  constexpr int SLOT = Body::PINGPONG ? 1 : 0;
  uint32_t st[{N}] = {{}};
  const uint32_t tall = clock();
  uint32_t t0 = tall;
  if (role == 2) {{
    setmaxnreg_dec<Body::PRODUCER_REGS>();
    const int tw = threadIdx.x - 256;
    if (tw >= Body::PRODUCER_THREADS) return;
    typename Body::Loader p(body, tw);
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x)
#pragma unroll
      for (int w = 0; w < (Body::PINGPONG ? 2 : 1); ++w) {{
        const int tile = Body::PINGPONG ? 2 * u + w : u;
        if (tile >= tiles) continue;
        T0;
        p.begin(tile);
        T1({PSETUP});
        for (int k = 0; k < ksteps; ++k, ++it) {{
          const int stage = it % S;
          T0;
          if (it >= S) mbar_wait(&empty[stage], ((it / S) - 1) & 1);
          T1({PWAIT});
          T0;
          p.load(k, smem + stage * Body::STAGE_BYTES, &full[stage]);
          T1({PISSUE});
        }}
      }}
    st[{TOTAL}] = clock() - tall;
    stamps_flush(st, SLOT, 1);
  }} else {{
    setmaxnreg_inc<Body::CONSUMER_REGS>();
    const bool lead = threadIdx.x % 32 == 0;
    auto k_loop = [&](typename Body::Consumer& c, int it) {{
      for (int k = 0; k < ksteps; ++k, ++it) {{
        const int stage = it % S;
        T0;
        mbar_wait(&full[stage], (it / S) & 1);
        T1({P_FULL});
        T0;
        c.mma(k, smem + stage * Body::STAGE_BYTES);
        T1({P_ISSUE});
        T0;
        wgmma_wait<1>();
        T1({P_WGWAIT});
        if (k > 0 && lead) mbar_arrive(&empty[(it - 1) % S]);
      }}
    }};
    if constexpr (Body::PINGPONG) {{
      if (role == 1) named_barrier_arrive(GEMM_TURN_BARRIER, 256);
      for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {{
        const int tile = 2 * u + role, it = (2 * i + role) * ksteps;
        const bool pass = !(role == 1 && u + (int)gridDim.x >= units);
        T0;
        named_barrier(GEMM_TURN_BARRIER + role, 256);
        T1({P_TURN});
        if (tile < tiles) {{
          typename Body::Consumer c(body, tile, role);
          k_loop(c, it);
          if (pass) named_barrier_arrive(GEMM_TURN_BARRIER + 1 - role, 256);
          T0;
          wgmma_wait<0>();
          T1({P_WGWAIT});
          if (lead) mbar_arrive(&empty[(it + ksteps - 1) % S]);
          T0;
          c.epilogue();
          T1({P_EPI});
        }} else if (pass) {{
          named_barrier_arrive(GEMM_TURN_BARRIER + 1 - role, 256);
        }}
      }}
    }} else {{
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, it += ksteps) {{
        typename Body::Consumer c(body, tile, role);
        k_loop(c, it);
        T0;
        wgmma_wait<0>();
        T1({P_WGWAIT});
        if (lead) mbar_arrive(&empty[(it + ksteps - 1) % S]);
        T0;
        c.epilogue();
        T1({P_EPI});
      }}
    }}
    T0;
    body.consumers_done();
    T1({P_EPI});
    st[{TOTAL}] = clock() - tall;
    stamps_flush(st, SLOT, 0);
  }}
}}
"""

# (name, marker in hopper.cuh, consumer phases, source -> patches); the
# stamp entries (ffn.cu, temporal_conv.cu) are appended to every copy
LOOPS = (
    ("PR 7's cooperative loop (K4's prologue on wgmma's register A)",
     "body.begin_produce(tile, tw);", PR7_PHASES,
     {"hopper.cuh": [STAMP_DEFS, (COOP_LOOP, COOP_LOOP_STAMPED)], "ffn.cu": COOP_FFN,
      "temporal_conv.cu": COOP_TCONV}),
    ("the persistent loop (cooperative or ping-pong; K4's prologue a kernel of its own)",
     "auto k_loop = [&](typename Body::Consumer& c, int it) {", PERSISTENT_PHASES,
     {"hopper.cuh": [STAMP_DEFS, (PERSISTENT_LOOP, PERSISTENT_LOOP_STAMPED)], "ffn.cu": [],
      "temporal_conv.cu": []}),
)
ENTRIES = {"hopper.cuh": None, "ffn.cu": "ffn", "temporal_conv.cu": "tconv"}

# (kernel, label, shape): K3 (rows, C), K4 (b, f, p, c, prologue)
CASES = [
    ("ffn", "K3 L0 C320 rows 65536", (65536, 320)),
    ("ffn", "K3 L1 C640 rows 16384", (16384, 640)),
    ("tconv", "K4 L0 C320 P4096 F16 b1", (1, 16, 4096, 320, True)),
    ("tconv", "K4 L1 C640 P1024 F16 b3", (3, 16, 1024, 640, True)),
    ("tconv", "K4 mid C1280 P64 F16 b3", (3, 16, 64, 1280, True)),
    ("tconv", "K4 prologue-free L0 C320 P4096 F16 b1", (1, 16, 4096, 320, False)),
    ("tconv", "K4 prologue-free L1 C640 P1024 F16 b3", (3, 16, 1024, 640, False)),
    ("tconv", "K4 prologue-free mid C1280 P64 F16 b3", (3, 16, 64, 1280, False)),
]


def make_copy(tree: str, out: str):
    """The instrumented copy; returns the matched loop's (name, consumer phases)."""
    if os.path.exists(out):
        shutil.rmtree(out)
    shutil.copytree(os.path.join(tree, "anyv2v_torch"), os.path.join(out, "anyv2v_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(out, "anyv2v_torch", "csrc")
    with open(os.path.join(csrc, "hopper.cuh")) as f:
        hopper = f.read()
    loop = next((lp for lp in LOOPS if lp[1] in hopper), None)
    if loop is None:
        raise RuntimeError("no patch set matches the tree's main loop")
    for name, entry in ENTRIES.items():
        path = os.path.join(csrc, name)
        with open(path) as f:
            src = f.read()
        for anchor, new in loop[3][name]:
            if src.count(anchor) != 1:
                raise RuntimeError(f"anchor found {src.count(anchor)} times in {name}: {anchor!r}")
            src = src.replace(anchor, new)
        with open(path, "w") as f:
            f.write(src + (_entry(entry) if entry else ""))
    return loop[0], loop[2]


def _ms(fn, iters=5):
    """Device ms per call by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _shares(buf, names):
    tot = float(buf[TOTAL])
    named = sum(float(buf[c]) for c in range(len(names)))
    return (", ".join(f"{n} {100 * float(buf[c]) / tot:.1f} %" for c, n in enumerate(names))
            + f", other {100 * (tot - named) / tot:.1f} %")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "variants", "gemm_stamps"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    loop, phases = make_copy(os.path.abspath(a.tree), a.out)
    sys.path.insert(0, a.out)
    from anyv2v_torch.ops import _build, ffn
    from anyv2v_torch.ops import temporal_conv as tc

    if not _build.__file__.startswith(os.path.abspath(a.out)):
        raise RuntimeError(f"anyv2v_torch came from {_build.__file__}")
    # folded_attention.cu carries the library's error strings
    _build.SOURCES = ("ffn.cu", "temporal_conv.cu", "folded_attention.cu")
    lib = _build.library()
    print(f"instrumented copy of {a.tree} ({loop}) in {a.out}, built in "
          f"{_build.build_seconds} s")
    for line in _build.ptxas_report().splitlines():   # the instrumented kernels' registers
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas {line.strip()}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    for kind, label, shape in CASES:
        if kind == "ffn":
            n, c = shape
            i = 4 * c
            x, w1, b1 = rn(n, c), rn(2 * i, c, std=c ** -0.5), rn(2 * i, std=0.1)
            w2, b2 = rn(c, i, std=i ** -0.5), rn(c, std=0.1)
            h = rn(n, i)
            fn = lambda: ffn.ffn_geglu(x, w1, b1, w2, b2)   # noqa: E731
            yard = {"addmm [N, C] x [C, 2I] (launch 1's product)":
                    lambda: torch.addmm(b1, x, w1.t()),
                    "addmm [N, I] x [I, C] (launch 2)": lambda: torch.addmm(b2, h, w2.t())}
            slots = {1: "launch 1 (x W1 + GEGLU)", 0: "launch 2 (h W2 + b2)"}
        else:
            b, f, p, c, prologue = shape
            x, w, bias = rn(b, f, p, c), rn(3, c, c, std=(3 * c) ** -0.5), rn(c, std=0.1)
            s = (torch.rand(b, c, generator=g, device="cuda") + 0.5) if prologue else None
            t = torch.randn(b, c, generator=g, device="cuda") * 0.5 if prologue else None
            fn = lambda: tc.gn_silu_temporal_conv(x, s, t, w, bias)   # noqa: E731
            hp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
            taps = torch.cat([hp[:, d:d + f] for d in range(3)], dim=-1).reshape(-1, 3 * c)
            del hp
            w2d = w.reshape(3 * c, c)
            yard = {"addmm [BFP, 3C] x [3C, C'] (laid out beforehand)":
                    lambda: torch.addmm(bias, taps, w2d)}
            slots = {0: "K4"}
        stamps = getattr(lib, f"anyv2v_{kind}_stamps")
        fn()
        torch.cuda.synchronize()
        buf = np.zeros(SLOTS * 2 * N, np.uint64)
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        if stamps(ptr, 1):
            raise RuntimeError("stamps: reset failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if stamps(ptr, 0):
            raise RuntimeError("stamps: read failed")
        print(f"{label}: {start.elapsed_time(end):.4f} ms instrumented; "
              + "; ".join(f"{k} {_ms(v):.4f} ms" for k, v in yard.items()), flush=True)
        per = buf.reshape(SLOTS, 2, N)
        for slot, what in slots.items():
            cons, prod = per[slot, 0], per[slot, 1]
            if not cons[TOTAL]:
                continue
            print(f"  {what}: consumers {float(cons[TOTAL]):.4e} warp-cycles: "
                  + _shares(cons, phases), flush=True)
            print(f"  {what}: producer {float(prod[TOTAL]):.4e} warp-cycles: "
                  + _shares(prod, PRODUCER), flush=True)
        del x, yard
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
