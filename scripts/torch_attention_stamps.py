"""Where K1's and K2 long's time goes, by phase, on one NVIDIA GPU: an
instrumented copy of ``anyv2v_torch`` (never kept) whose kernels sum
``clock64`` cycles by phase over every warp.

    python3 scripts/torch_attention_stamps.py [--tree DIR] [--out DIR]

The script copies ``anyv2v_torch/`` from ``--tree`` (default: this checkout)
into ``--out`` (default ``build/variants/attention_stamps``, git-ignored),
patches the copy's ``csrc/folded_attention.cu`` and ``csrc/frame_attention.cu``
with the patch set that matches the tree's kernel bodies (the ``mma.sync``
bodies, or the ``wgmma`` bodies that replaced them), builds the copy, runs each
case once at ``chip_smoke.py``'s shapes, and prints each phase's share of the
summed cycles of the kernel's warps and the kernel's time by CUDA events.

With the Hopper body's two block layouts (a tree whose K1 has them), it also counts the
exponentials and prints the share of clocks the special-function units are
busy: exponentials / (16 x SMs x clocks), for the instrumented run (clocks:
the longest consumer warp's cycles) and at the time of the same tree
built without stamps (``--out``'s ``_plain`` copy, timed by CUDA events in a
process of its own; clocks: that time at the SM clock the instrumented run
measured).

Phases (a phase is the time between two stamps of one warp; the products and
loads are asynchronous, so a phase that waits for their results carries
their latency):

- ``wait``: the tile waits (``cp.async`` groups and ``__syncthreads``, or the
  full barriers), and in K2 long the wait for a pixel;
- ``copy``: issuing the loads (``mma.sync`` bodies) or, in the producer, the
  waits for free slots (``wgmma`` bodies);
- ``Q.K``: the score products; ``max``: masking, the row maxima and the
  correction factors; ``exp2``: the exponentials; ``pack``: P to bf16;
  ``P.V``: the P.V products with the row sums; ``rescale``: the output's
  correction (the online softmax of K1); ``epilogue``: normalise and store.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("wait", "copy", "Q.K", "max", "exp2", "pack", "P.V", "rescale", "epilogue")
WAIT, COPY, QK, MAX, EXP, PACK, PV, RESCALE, EPI = range(9)
TOTAL = 15

HEADER = ("namespace {\n", "namespace {\n\n__device__ unsigned long long g_stamps[32];\n"
          "#define T0 t0 = clock64()\n#define T1(c) st[c] += clock64() - t0\n"
          "#define FENCE(x) asm volatile(\"\" :: \"f\"(x))\n"
          "#define FENCE_U(x) asm volatile(\"\" :: \"r\"(x))\n")


def _entry(name):
    return f"""
extern "C" int anyv2v_{name}_stamps(void* out, int reset) {{
  if (reset) {{
    unsigned long long z[32] = {{}};
    return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}}
"""


FLUSH = (f"  st[{TOTAL}] = clock64() - tall;\n"
         "  if (threadIdx.x % 32 == 0)\n"
         "    for (int c = 0; c < 16; ++c) atomicAdd(&g_stamps[c], st[c]);\n")

# the mma.sync K1 body (on a cp.async ring); marker: its row-sum product
K1_MMA_SYNC = ("mma_m16n8k16(lt, pa, BF16_ONES, BF16_ONES);", [
    HEADER,
    ("  const int b0 = (blockIdx.x / n_qblocks) * R;\n",
     "  unsigned long long st[16] = {};\n  const long long tall = clock64();\n"
     "  long long t0 = tall;\n  const int b0 = (blockIdx.x / n_qblocks) * R;\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();   // tile t has landed; every warp is done with"
     " tile t-1's stage\n",
     f"    T0;\n    cp_async_wait<0>();\n    __syncthreads();\n    T1({WAIT});\n    T0;\n"),
    ("    const __nv_bfloat16* ks = ring + (t % STAGES) * 2 * KS * LD;\n",
     f"    T1({COPY});\n    const __nv_bfloat16* ks = ring + (t % STAGES) * 2 * KS * LD;\n"),
    ("      float s[KB / 2];   // 8 tiles of 8 keys, m16n8 accumulators\n",
     "      T0;\n      float s[KB / 2];\n"),
    ("      if (nk < KB) {   // the ragged last tile: keys past Sk\n",
     f"#pragma unroll\n      for (int x = 0; x < KB / 2; ++x) FENCE(s[x]);\n      T1({QK});\n"
     "      T0;\n      if (nk < KB) {\n"),
    ("      m[i][0] = mn0;\n      m[i][1] = mn1;\n"
     "      const float o0 = -mn0 * scale_log2, o1 = -mn1 * scale_log2;\n",
     "      m[i][0] = mn0;\n      m[i][1] = mn1;\n"
     "      const float o0 = -mn0 * scale_log2, o1 = -mn1 * scale_log2;\n"
     f"      FENCE(corr0);\n      FENCE(corr1);\n      T1({MAX});\n      T0;\n"),
    ("      float lt[4] = {0.f, 0.f, 0.f, 0.f};\n",
     "#pragma unroll\n      for (int n = 0; n < NT; ++n)\n#pragma unroll\n"
     "        for (int x = 0; x < 4; ++x) FENCE(acc[i][n][x]);\n"
     f"      T1({RESCALE});\n      T0;\n"
     "      float pall[KB / 2];\n#pragma unroll\n      for (int np = 0; np < KB / 16; ++np)\n"
     "#pragma unroll\n        for (int x = 0; x < 8; ++x)\n"
     "          pall[np * 8 + x] = np * 16 < nk ? ex2(fmaf(s[np * 8 + x], scale_log2, "
     "(x & 2) ? o1 : o0)) : 0.f;\n"
     "#pragma unroll\n      for (int x = 0; x < KB / 2; ++x) FENCE(pall[x]);\n"
     f"      T1({EXP});\n      T0;\n"
     "      uint32_t paall[KB / 16][4];\n#pragma unroll\n      for (int np = 0; np < KB / 16; ++np)\n"
     "#pragma unroll\n        for (int x = 0; x < 4; ++x) {\n"
     "          paall[np][x] = pack_bf16(pall[np * 8 + 2 * x], pall[np * 8 + 2 * x + 1]);\n"
     "          FENCE_U(paall[np][x]);\n        }\n"
     f"      T1({PACK});\n      T0;\n"
     "      float lt[4] = {0.f, 0.f, 0.f, 0.f};\n"),
    ("          float p[8];\n#pragma unroll\n          for (int x = 0; x < 8; ++x)\n"
     "            p[x] = ex2(fmaf(s[np * 8 + x], scale_log2, (x & 2) ? o1 : o0));\n"
     "          const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),\n"
     "                                  pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};\n",
     "          const uint32_t (&pa)[4] = paall[np];\n"),
    ("      l[i][1] = fmaf(l[i][1], corr1, lt[2]);\n",
     "      l[i][1] = fmaf(l[i][1], corr1, lt[2]);\n      FENCE(l[i][0]);\n      FENCE(l[i][1]);\n"
     f"      T1({PV});\n"),
    ("  // Normalise each item into its own Q tile, then store whole rows.\n",
     "  T0;\n"),
    ("          *reinterpret_cast<const uint4*>(qs + r * LD + col * 8);\n  }\n}\n",
     f"          *reinterpret_cast<const uint4*>(qs + r * LD + col * 8);\n  }}\n  T1({EPI});\n"
     + FLUSH + "}\n"),
])

# the mma.sync frame-axis body (K2 and K2 long share it; only K2 long cases run)
K2_MMA_SYNC = ("item_scores<DH, KT, BIAS>(qs, ks, LD, qt", [
    HEADER,
    ("                                            uint32_t (&pa)[KT / 2][4]) {\n",
     "                                            uint32_t (&pa)[KT / 2][4],\n"
     "                                            unsigned long long (&st)[16]) {\n"
     "  long long t0 = clock64();\n"),
    ("  const int r0 = qt * 16 + g;\n  if (BIAS) {\n",
     f"#pragma unroll\n  for (int x = 0; x < KT * 4; ++x) FENCE(s[x]);\n  T1({QK});\n  T0;\n"
     "  const int r0 = qt * 16 + g;\n  if (BIAS) {\n"),
    ("  const float o0 = -m0 * k, o1 = -m1 * k;\n#pragma unroll\n  for (int nt = 0; nt < KT; ++nt) {\n"
     "    pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(ex2(fmaf(s[nt * 4 + 0], k, o0)), "
     "ex2(fmaf(s[nt * 4 + 1], k, o0)));\n"
     "    pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ex2(fmaf(s[nt * 4 + 2], k, o1)), "
     "ex2(fmaf(s[nt * 4 + 3], k, o1)));\n  }\n}\n",
     "  float o0 = -m0 * k, o1 = -m1 * k;\n  FENCE(o0);\n  FENCE(o1);\n"
     f"  T1({MAX});\n  T0;\n"
     "#pragma unroll\n  for (int x = 0; x < KT * 4; ++x) s[x] = ex2(fmaf(s[x], k, (x & 2) ? o1 : o0));\n"
     f"#pragma unroll\n  for (int x = 0; x < KT * 4; ++x) FENCE(s[x]);\n  T1({EXP});\n  T0;\n"
     "#pragma unroll\n  for (int nt = 0; nt < KT; ++nt) {\n"
     "    pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(s[nt * 4 + 0], s[nt * 4 + 1]);\n"
     "    pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(s[nt * 4 + 2], s[nt * 4 + 3]);\n"
     "    FENCE_U(pa[nt / 2][(nt % 2) * 2 + 0]);\n    FENCE_U(pa[nt / 2][(nt % 2) * 2 + 1]);\n"
     f"  }}\n  T1({PACK});\n}}\n"),
    ("                                        int qt, int hc, int Sk, const uint32_t (&pa)[KT / 2][4]) {\n",
     "                                        int qt, int hc, int Sk, const uint32_t (&pa)[KT / 2][4],\n"
     "                                        unsigned long long (&st)[16]) {\n"
     "  const long long t0 = clock64();\n"),
    ("        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * LD) =\n"
     "            __floats2bfloat162_rn(acc[n][2] * i1, acc[n][3] * i1);\n      }\n    }\n  }\n}\n",
     "        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * LD) =\n"
     "            __floats2bfloat162_rn(acc[n][2] * i1, acc[n][3] * i1);\n      }\n    }\n  }\n"
     f"  T1({PV});\n}}\n"),
    ("  const int bp0 = blockIdx.x * P;\n",
     "  unsigned long long st[16] = {};\n  const long long tall = clock64();\n"
     "  long long t0 = tall;\n  const int bp0 = blockIdx.x * P;\n"),
    ("  cp_async_commit();\n  cp_async_wait<1>();\n  __syncthreads();\n",
     f"  cp_async_commit();\n  T1({COPY});\n  T0;\n  cp_async_wait<1>();\n  __syncthreads();\n"
     f"  T1({WAIT});\n"),
    ("                                scale_log2, pa);\n", "                                scale_log2, pa, st);\n"),
    ("    if (first) {   // every warp passes here once: V has landed\n"
     "      cp_async_wait<0>();\n      __syncthreads();\n    }\n",
     f"    if (first) {{\n      T0;\n      cp_async_wait<0>();\n      __syncthreads();\n"
     f"      T1({WAIT});\n    }}\n"),
    ("    item_pv<DH, KT>(qs, ks + rows_k * LD, LD, qt, hh * DH, Sk, pa);\n",
     "    item_pv<DH, KT>(qs, ks + rows_k * LD, LD, qt, hh * DH, Sk, pa, st);\n"),
    ("  __syncthreads();\n  for (int x = 0; x < npix; ++x) {\n    const long long b = (bp0 + x) / HW;\n"
     "    const int p = (bp0 + x) % HW;\n    const __nv_bfloat16* qs = base + x * pix_elems;\n",
     f"  T0;\n  __syncthreads();\n  T1({WAIT});\n  T0;\n"
     "  for (int x = 0; x < npix; ++x) {\n    const long long b = (bp0 + x) / HW;\n"
     "    const int p = (bp0 + x) % HW;\n    const __nv_bfloat16* qs = base + x * pix_elems;\n"),
    ("          *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);\n    }\n  }\n}\n",
     f"          *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);\n    }}\n  }}\n  T1({EPI});\n"
     + FLUSH + "}\n"),
])


# the Hopper bodies: consumers as above, and the producer's waits for free
# slots (its cycles in g_stamps[16:])
PRODUCER_FLUSH = (f"    ps[{TOTAL}] = clock64() - pall;\n"
                  "    for (int c = 0; c < 16; ++c) atomicAdd(&g_stamps[16 + c], ps[c]);\n")


def _producer_wait(line):
    return (line, "      { const long long a = clock64();\n" + line
            + f"      ps[{COPY}] += clock64() - a; }}\n")


K1_WGMMA = ("auto step = [&]", [
    HEADER,
    ("    int qi = 0, kv = 0;\n    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++qi) {\n"
     "      const Item x = item_of(p, it);\n      const int slot = qi % QS;\n",
     "    int qi = 0, kv = 0;\n    unsigned long long ps[16] = {};\n"
     "    const long long pall = clock64();\n"
     "    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++qi) {\n"
     "      const Item x = item_of(p, it);\n      const int slot = qi % QS;\n"),
    _producer_wait("      if (qi >= QS) mbar_wait(&qempty[slot], ((qi / QS) - 1) & 1);\n"),
    _producer_wait("        if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);\n"),
    _producer_wait("        if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);\n"),
    ("    return;\n  }\n\n  // ---- consumers ----\n",
     PRODUCER_FLUSH + "    return;\n  }\n\n  // ---- consumers ----\n"
     "  unsigned long long st[16] = {};\n  const long long tall = clock64();\n  long long t0 = tall;\n"),
    ("    mbar_spin(&qfull[slot], (qi / QS) & 1);\n    for (int t = 0; t < T; ++t) {\n",
     f"    T0;\n    mbar_spin(&qfull[slot], (qi / QS) & 1);\n    T1({WAIT});\n"
     "    for (int t = 0; t < T; ++t) {\n"),
    ("      if (i == 0) mbar_spin(&kfull[(kv + t) % KS], ph(t));\n"
     "      if (!first && ip == 0) mbar_spin(&vfull[(kv + tp) % KS], ph(tp));\n",
     "      T0;\n      if (i == 0) mbar_spin(&kfull[(kv + t) % KS], ph(t));\n"
     "      if (!first && ip == 0) mbar_spin(&vfull[(kv + tp) % KS], ph(tp));\n"
     f"      T1({WAIT});\n      T0;\n"),
    ("      wgmma_wait<1>();\n      fence_frag(s);\n",
     f"      wgmma_wait<1>();\n      fence_frag(s);\n      T1({QK});\n"),
    ("      const int n = min(BK, p.Sk - t * BK);\n",
     "      T0;\n      const int n = min(BK, p.Sk - t * BK);\n"),
    ("      m1[i] = mx1;\n",
     f"      m1[i] = mx1;\n      FENCE(c0);\n      FENCE(c1);\n      T1({MAX});\n      T0;\n"),
    ("      exp2_frag(s, sl, -mx0 * sl, -mx1 * sl, (n + 7) / 8);\n",
     "      exp2_frag(s, sl, -mx0 * sl, -mx1 * sl, (n + 7) / 8);\n"
     f"#pragma unroll\n      for (int x = 0; x < BK / 2; ++x) FENCE(s[x]);\n      T1({EXP});\n      T0;\n"),
    ("      wgmma_wait<0>();\n      fence_frag(acc[ip]);\n      fence_pa();\n",
     f"      wgmma_wait<0>();\n      fence_frag(acc[ip]);\n      fence_pa();\n      T1({PV});\n      T0;\n"),
    ("      pack_frag(s, pa);\n",
     "      pack_frag(s, pa);\n#pragma unroll\n      for (int x = 0; x < BK / 16; ++x) {\n"
     "        FENCE_U(pa[x][0]);\n        FENCE_U(pa[x][3]);\n      }\n"
     f"      T1({PACK});\n      T0;\n"),
    ("        acc[i][r + 3] *= c1;\n      }\n    };\n",
     f"        acc[i][r + 3] *= c1;\n      }}\n      T1({RESCALE});\n    }};\n"),
    ("    // the last step's P.V (at U 1 its stage's V is awaited here first)\n",
     "    T0;\n"),
    ("      bulk_commit();\n    }\n  }\n  if (tw == 0) bulk_wait();\n}\n",
     f"      bulk_commit();\n    }}\n    T1({EPI});\n  }}\n  if (tw == 0) bulk_wait();\n"
     + FLUSH + "}\n"),
])

# K1's Hopper body with its row maxima moved lazily ("max" is the
# masking, the per-thread maxima, the vote and, where it passes, the quad's
# shuffles and the correction; "rescale" runs only there)
K1_WGMMA_LAZY = ("const bool grow =", [
    *K1_WGMMA[1][:10],
    ("        m1[i] = mx1;\n      }\n",
     f"        m1[i] = mx1;\n      }}\n      FENCE(c0);\n      FENCE(c1);\n      T1({MAX});\n      T0;\n"),
    ("      exp2_frag(s, sl, -m0[i] * sl, -m1[i] * sl, (n + 7) / 8);\n",
     "      exp2_frag(s, sl, -m0[i] * sl, -m1[i] * sl, (n + 7) / 8);\n"
     f"#pragma unroll\n      for (int x = 0; x < BK / 2; ++x) FENCE(s[x]);\n      T1({EXP});\n      T0;\n"),
    K1_WGMMA[1][12], K1_WGMMA[1][13],
    ("          acc[i][r + 3] *= c1;\n        }\n      }\n    };\n",
     f"          acc[i][r + 3] *= c1;\n        }}\n      }}\n      T1({RESCALE});\n    }};\n"),
    K1_WGMMA[1][15], K1_WGMMA[1][16],
])

K2_WGMMA = ("frame_attention_long_kernel(const __grid_constant__ Params p)", [
    HEADER,
    ("    int n = 0;\n    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {\n"
     "      const int hg = it % p.ng, px = it / p.ng, b = px / p.HW, pix = px % p.HW;\n"
     "      const int stage = n % ST, round = n / ST;\n",
     "    int n = 0;\n    unsigned long long ps[16] = {};\n    const long long pall = clock64();\n"
     "    for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {\n"
     "      const int hg = it % p.ng, px = it / p.ng, b = px / p.HW, pix = px % p.HW;\n"
     "      const int stage = n % ST, round = n / ST;\n"),
    _producer_wait("      if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);\n"),
    ("    return;\n  }\n\n  // ---- consumers ----\n",
     PRODUCER_FLUSH + "    return;\n  }\n\n  // ---- consumers ----\n"
     "  unsigned long long st[16] = {};\n  const long long tall = clock64();\n  long long t0 = tall;\n"),
    ("    mbar_spin(&full[stage], (n / ST) & 1);\n",
     f"    T0;\n    mbar_spin(&full[stage], (n / ST) & 1);\n    T1({WAIT});\n"),
    ("      fence_frag(s);\n      fence_frag(acc);\n      fence_pa();\n      turn_begin();\n",
     "      T0;\n      fence_frag(s);\n      fence_frag(acc);\n      fence_pa();\n      turn_begin();\n"),
    ("        wgmma_wait<0>();\n      }\n      fence_frag(s);\n",
     f"        wgmma_wait<0>();\n      }}\n      fence_frag(s);\n      T1({QK});\n      T0;\n"),
    ("      quad_row_max(s, m0, m1);   // key 0 exists, so both maxima are finite\n",
     f"      quad_row_max(s, m0, m1);\n      FENCE(m0);\n      FENCE(m1);\n      T1({MAX});\n      T0;\n"),
    ("      exp2_frag(s, kf, -m0 * kf, -m1 * kf, (p.Sk + 7) / 8);\n",
     "      exp2_frag(s, kf, -m0 * kf, -m1 * kf, (p.Sk + 7) / 8);\n"
     f"#pragma unroll\n      for (int x = 0; x < NK / 2; ++x) FENCE(s[x]);\n      T1({EXP});\n      T0;\n"),
    ("        wgmma_wait<0>();\n        fence_frag(acc);\n        fence_pa();\n        if (prev >= 0) {\n",
     f"        wgmma_wait<0>();\n        fence_frag(acc);\n        fence_pa();\n        T1({PV});\n"
     "        T0;\n        if (prev >= 0) {\n"),
    ("        prev = u;\n", f"        prev = u;\n        T1({PACK});\n"),
    ("        store_unit(u);\n      }\n    }\n",
     f"        store_unit(u);\n        T1({PV});\n      }}\n    }}\n"),
    ("    if (OVERLAP && prev >= 0) {   // the last unit's P.V\n",
     "    T0;\n    if (OVERLAP && prev >= 0) {\n"),
    ("    fence_proxy_async();\n    if (split) {\n",
     f"    T1({EPI});\n    T0;\n    fence_proxy_async();\n    if (split) {{\n"),
    ("        mbar_arrive(&empty[stage]);\n      }\n    }\n  }\n  if (tw == 0) bulk_wait();\n}\n",
     f"        mbar_arrive(&empty[stage]);\n      }}\n    }}\n    T1({EPI});\n  }}\n"
     "  if (tw == 0) bulk_wait();\n" + FLUSH + "}\n"),
])

# K1's Hopper body with its two block layouts: the lazy set's phases,
# the consumers' stamps started past their setmaxnreg, the three-warpgroup
# layout's epilogue (the output stored from the registers), and the counts
# the special-function units' share needs: the exponentials
# (g_stamps[EXPS], by lane 0 of each warp), the consumer warps
# (g_stamps[WARPS]) and the longest consumer warp's cycles (g_stamps[LIFE])
EXPS, WARPS, LIFE = 12, 11, 10
_LAZY = dict(enumerate(K1_WGMMA_LAZY[1]))
K1_LAYOUTS = ("setmaxnreg_inc<F::CONSUMER_REGS>", [
    *[_LAZY[i] for i in range(5)],
    ("    return;\n  }\n\n  // ---- consumers ----\n"
     "  if constexpr (F::PRODUCER_WG) setmaxnreg_inc<F::CONSUMER_REGS>();\n",
     PRODUCER_FLUSH + "    return;\n  }\n\n  // ---- consumers ----\n"
     "  if constexpr (F::PRODUCER_WG) setmaxnreg_inc<F::CONSUMER_REGS>();\n"
     "  unsigned long long st[16] = {};\n  const long long tall = clock64();\n  long long t0 = tall;\n"),
    *[_LAZY[i] for i in range(6, 11)],
    ("      exp2_frag(s, sl, -m0[i] * sl, -m1[i] * sl, (n + 7) / 8);\n",
     "      exp2_frag(s, sl, -m0[i] * sl, -m1[i] * sl, (n + 7) / 8);\n"
     f"      st[{EXPS}] += 4 * min((n + 7) / 8, BK / 8) + (grow ? 2 : 0);\n"
     f"#pragma unroll\n      for (int x = 0; x < BK / 2; ++x) FENCE(s[x]);\n      T1({EXP});\n      T0;\n"),
    *[_LAZY[i] for i in range(12, 16)],
    ("      continue;\n    }\n", f"      T1({EPI});\n      continue;\n    }}\n"),
    ("      bulk_commit();\n    }\n  }\n  if (!F::PRODUCER_WG && tw == 0) bulk_wait();\n}\n",
     f"      bulk_commit();\n    }}\n    T1({EPI});\n  }}\n"
     f"  if (!F::PRODUCER_WG && tw == 0) bulk_wait();\n  st[{WARPS}] = 1;\n" + FLUSH
     + f"  if (threadIdx.x % 32 == 0) atomicMax(&g_stamps[{LIFE}], st[{TOTAL}]);\n}}\n"),
])

# source -> (stamp entry name, [patch sets]); a patch set applies where its marker is found
SOURCES = {
    "folded_attention.cu": ("folded", [K1_LAYOUTS, K1_WGMMA_LAZY, K1_WGMMA, K1_MMA_SYNC]),
    "frame_attention.cu": ("frame", [K2_WGMMA, K2_MMA_SYNC]),
}

# (kernel, label, shape)
CASES = [
    ("folded", "K1 L0 self b2 S4096 h64 dh8", (2, 4096, 4096, 64, 8, 5)),
    ("folded", "K1 L1 self b2 S1024 h64 dh16", (2, 1024, 1024, 64, 16, 10)),
    ("folded", "K1 L0 cross b2 Sq4096 Sk157 h64 dh8", (2, 4096, 157, 64, 8, 5)),
    ("folded", "K1 row 5 class b2 S8192 h64 dh8", (2, 8192, 8192, 64, 8, 5)),
    ("frame", "K2 long L0 b3 S128 HW4096 h64 dh8", (3, 128, 128, 4096, 64, 8, 5)),
    ("frame", "K2 long transformer_in b3 S128 HW4096 h8 dh64", (3, 128, 128, 4096, 8, 64, 64)),
]


def make_copy(tree: str, out: str, stamped: bool = True) -> None:
    if os.path.exists(out):
        shutil.rmtree(out)
    shutil.copytree(os.path.join(tree, "anyv2v_torch"), os.path.join(out, "anyv2v_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if not stamped:
        return
    for name, (entry, sets) in SOURCES.items():
        path = os.path.join(out, "anyv2v_torch", "csrc", name)
        with open(path) as f:
            src = f.read()
        patches = next((p for marker, p in sets if marker in src), None)
        if patches is None:
            raise RuntimeError(f"no patch set matches {name}")
        for anchor, new in patches:
            if src.count(anchor) != 1:
                raise RuntimeError(f"anchor found {src.count(anchor)} times in {name}: {anchor!r}")
            src = src.replace(anchor, new)
        with open(path, "w") as f:
            f.write(src + _entry(entry))


def time_plain(tree: str, out: str) -> dict:
    """{case label: ms} of the tree built without stamps, in a process of its own."""
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree, "--out", out,
                        "--plain"], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"the plain copy failed: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    return {line.split(" ms ", 1)[1]: float(line.split(" ms ", 1)[0].split()[-1])
            for line in p.stdout.splitlines() if line.startswith("plain ")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "variants", "attention_stamps"))
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    plain_ms = {} if a.plain else time_plain(os.path.abspath(a.tree), a.out + "_plain")
    make_copy(os.path.abspath(a.tree), a.out, stamped=not a.plain)
    sys.path.insert(0, a.out)
    from anyv2v_torch.ops import _build
    from anyv2v_torch.ops import folded_attention as fa
    from anyv2v_torch.ops import frame_attention as fr

    if not _build.__file__.startswith(os.path.abspath(a.out)):
        raise RuntimeError(f"anyv2v_torch came from {_build.__file__}")
    _build.SOURCES = tuple(SOURCES)
    lib = _build.library()
    print(f"instrumented copy of {a.tree} in {a.out}, built in {_build.build_seconds} s")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    for kind, label, shape in CASES:
        if kind == "folded":
            b, sq, sk, h, dh, true_dh = shape
            args = (rn(b, sq, h * dh), rn(b, sk, h * dh), rn(b, sk, h * dh), h, true_dh ** -0.5)
            fn = fa.folded_attention
        else:
            b, s, sk, hw, h, dh, true_dh = shape
            args = (rn(b, s, hw, h * dh), rn(b, sk, hw, h * dh), rn(b, sk, hw, h * dh), h,
                    true_dh ** -0.5)
            fn = fr.frame_attention_long
        fn(*args)
        torch.cuda.synchronize()
        if a.plain:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            print(f"plain {start.elapsed_time(end) / 5:.4f} ms {label}", flush=True)
            del args
            continue
        stamps = getattr(lib, f"anyv2v_{kind}_stamps")
        buf = np.zeros(32, np.uint64)
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        if stamps(ptr, 1):
            raise RuntimeError("stamps: reset failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if stamps(ptr, 0):
            raise RuntimeError("stamps: read failed")
        tot, ms = float(buf[TOTAL]), start.elapsed_time(end)
        if not tot:
            print(f"{label}: {ms:.4f} ms, no stamps (a body without a patch set)", flush=True)
            del args
            continue
        print(f"{label}: {ms:.4f} ms instrumented, {tot:.4e} warp-cycles; "
              + ", ".join(f"{n} {100 * float(buf[c]) / tot:.1f} %" for c, n in enumerate(PHASES)
                          if buf[c]), flush=True)
        if kind == "folded" and buf[WARPS]:
            # the SFU-busy share: exponentials / (16 x SMs x clocks)
            exps, cycles = 32 * float(buf[EXPS]), float(buf[LIFE])
            sms = fa.folded_plan(*shape[:5])["grid"][0]
            mhz = cycles / (ms * 1e3)
            line = (f"  {exps:.4e} exponentials, SM clock {mhz:.0f} MHz; special-function units "
                    f"busy {100 * exps / (16 * sms * cycles):.1f} % of the instrumented run")
            if label in plain_ms:
                line += (f", {100 * exps / (16 * sms * mhz * 1e3 * plain_ms[label]):.1f} % at the "
                         f"plain build's {plain_ms[label]:.4f} ms")
            print(line, flush=True)
        if buf[16 + TOTAL]:
            print(f"  producer: {100 * float(buf[16 + COPY]) / float(buf[16 + TOTAL]):.1f} % "
                  "of its cycles waiting for free slots", flush=True)
        del args
    return 0


if __name__ == "__main__":
    sys.exit(main())
