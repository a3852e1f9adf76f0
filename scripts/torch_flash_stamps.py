"""Where K5's time goes, by phase, on one NVIDIA GPU: an instrumented copy
of ``anyv2v_torch`` (never kept) whose kernel sums ``clock64`` cycles per
block and role.

    python3 scripts/torch_flash_stamps.py [--out DIR]

The script copies ``anyv2v_torch/`` into ``DIR`` (default
``build/variants/stamps``, git-ignored), patches the copy's
``csrc/flash_attention.cu`` so that thread 0 of each consumer warpgroup and
the producer thread add up the cycles of each phase of their loops into a
device array, builds the copy, runs K5 once per case at ``chip_smoke.py``'s
shapes, and prints, per role, each phase's share of the role's cycles
(averaged over the blocks) and the kernel's time by CUDA events:

- consumers: waits on the Q, K and V full barriers; waits for their turn
  to issue (ping-pong); waits for the scores; the softmax (with the bias);
  the wait for P.V; the rescale and P's packing; the epilogue (normalise,
  stage, store);
- producer: waits for a free Q slot, a free K slot, a free V slot.

A phase whose share is large where the kernel is slow is what bounds it.

    python3 scripts/torch_flash_stamps.py --short [--filter TEXT ...]

``--short`` stamps the one-key-tile body instead (``flash_attention_kernel``
over ``ShortParams``): per consumer warpgroup the K/V segment waits, the Q
chunk waits, the score waits, the softmax, the P.V issue and wait and the
stores; per producer its waits for free Q slots and for the K/V buffer. Its
cases: the cross-attentions and the IP adapter's.

    python3 scripts/torch_flash_stamps.py --loads [--tree DIR] [--filter TEXT ...]

``--loads`` instruments the K/V ring instead (a copy of DIR's
``anyv2v_torch``, default this checkout): for each of a block's first
``LOAD_MAX`` K and V tile loads, the producer's ``clock64`` when it wanted
the slot and when it issued the copy, and per consumer warpgroup when it
arrived at the tile's full barrier, when the wait ended and when it
released the slot. It prints, per case, where the consumers' K and V
waits sit (an item's first tile, or a later one: the steady state; and
for warpgroup 1, whether warpgroup 0 had passed the same barrier before:
the wait then sits behind the ping-pong turn), the copies' latency from
issue to the end of a wait, how far ahead of the consumers the producer
issued them, and what held the producer's issue (the K slot or the V
slot). The cases run by default are split-KV L0 and SEINE L0 self.
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
CONSUMER = ("Q waits", "K waits", "V waits", "turn waits", "score wait", "softmax", "P.V wait",
            "rescale+pack", "epilogue")
PRODUCER = ("Q slot waits", "K slot waits", "V slot waits")
TOTAL = 15   # the column of a role's whole loop
Q, K, V, TURN, SCORE, SOFTMAX, PV, PACK, EPI = range(9)

# (anchor in csrc/flash_attention.cu, its instrumented form)
PATCHES = [
    ("namespace {\n", "namespace {\n\n__device__ unsigned long long g_stamps[4096][16];\n"
     "#define T0 t0 = clock64()\n#define T1(c) st[c] += clock64() - t0\n"),
    ("    int qi = 0, kv = 0, prev = -1;\n",
     "    int qi = 0, kv = 0, prev = -1;\n    unsigned long long ps[16] = {};\n"
     "    const long long pall = clock64();\n"),
    ("      if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);\n",
     "      { const long long a = clock64();\n"
     "      if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);\n"
     "      ps[1] += clock64() - a; }\n"),
    ("      if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);\n",
     "      { const long long a = clock64();\n"
     "      if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);\n"
     "      ps[2] += clock64() - a; }\n"),
    ("      if (qi >= QS) mbar_wait(&qempty[slot], ((qi / QS) - 1) & 1);\n",
     "      { const long long a = clock64();\n"
     "      if (qi >= QS) mbar_wait(&qempty[slot], ((qi / QS) - 1) & 1);\n"
     "      ps[0] += clock64() - a; }\n"),
    ("    return;\n  }\n\n  // ---- consumers ----\n",
     f"    ps[{TOTAL}] = clock64() - pall;\n"
     "    for (int c = 0; c < 16; ++c) g_stamps[blockIdx.x * 3 + 2][c] = ps[c];\n"
     "    return;\n  }\n\n  // ---- consumers ----\n"),
    ("  int qi = 0, kv = 0;\n  for (int it",
     "  unsigned long long st[16] = {};\n"
     "  long long t0 = 0;\n  const long long tall = clock64();\n"
     "  int qi = 0, kv = 0;\n  for (int it"),
    ("    mbar_spin(&qfull[slot], (qi / QS) & 1);\n",
     f"    T0;\n    mbar_spin(&qfull[slot], (qi / QS) & 1);\n    T1({Q});\n"),
    ("    mbar_spin(&kfull[kv % KS], phase(0));\n",
     f"    T0;\n    mbar_spin(&kfull[kv % KS], phase(0));\n    T1({K});\n"),
    ("      mbar_spin(&kfull[(kv + j) % KS], phase(j));\n"
     "      mbar_spin(&vfull[(kv + j - 1) % KS], phase(j - 1));\n",
     f"      T0;\n      mbar_spin(&kfull[(kv + j) % KS], phase(j));\n      T1({K});\n"
     f"      T0;\n      mbar_spin(&vfull[(kv + j - 1) % KS], phase(j - 1));\n      T1({V});\n"),
    ("    mbar_spin(&vfull[(kv + T - 1) % KS], phase(T - 1));\n",
     f"    T0;\n    mbar_spin(&vfull[(kv + T - 1) % KS], phase(T - 1));\n    T1({V});\n"),
    ("turn_begin();\n", f"{{ T0; turn_begin(); T1({TURN}); }}\n"),
    ("    wgmma_wait<0>();\n#pragma unroll\n    for (int i = 0; i < BK / 2; ++i) fence_operand(s[i]);\n",
     f"    T0;\n    wgmma_wait<0>();\n    T1({SCORE});\n#pragma unroll\n"
     "    for (int i = 0; i < BK / 2; ++i) fence_operand(s[i]);\n"),
    ("      if constexpr (F::template OVERLAP<BIAS>) {\n",
     "      T0;\n      if constexpr (F::template OVERLAP<BIAS>) {\n"),
    ("        wgmma_wait<0>();\n      }\n", f"        wgmma_wait<0>();\n      }}\n      T1({SCORE});\n"),
    ("    scores_done(0);\n", f"    T0;\n    scores_done(0);\n    T1({SOFTMAX});\n"),
    ("      scores_done(j);\n      wgmma_wait<0>();\n",
     f"      T0;\n      scores_done(j);\n      T1({SOFTMAX});\n      T0;\n      wgmma_wait<0>();\n"),
    ("      if (lead) mbar_arrive(&vempty[(kv + j - 1) % KS]);\n",
     f"      T1({PV});\n      T0;\n      if (lead) mbar_arrive(&vempty[(kv + j - 1) % KS]);\n"),
    ("      pack_frag(s, pa);\n    }\n", f"      pack_frag(s, pa);\n      T1({PACK});\n    }}\n"),
    ("    turn_end(it + w.step >= w.end);\n    wgmma_wait<0>();\n",
     f"    turn_end(it + w.step >= w.end);\n    T0;\n    wgmma_wait<0>();\n    T1({PV});\n"),
    ("    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);\n",
     "    T0;\n    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);\n"),
    ("      bulk_commit();\n    }\n  }\n", f"      bulk_commit();\n    }}\n    T1({EPI});\n  }}\n"),
    ("  if (tw == 0) bulk_wait();\n}\n",
     f"  if (tw == 0) {{\n    bulk_wait();\n    st[{TOTAL}] = clock64() - tall;\n"
     "    for (int c = 0; c < 16; ++c) g_stamps[blockIdx.x * 3 + wg][c] = st[c];\n  }\n}\n"),
]
# the short body (the one-key-tile class): consumers' and producer's phases
SHORT_CONSUMER = ("K/V waits", "Q chunk waits", "score waits", "softmax", "P.V waits",
                  "stores", "P.V issue")
SHORT_PRODUCER = ("Q slot waits", "K/V slot waits")
SKV, SQ, SSC, SSM, SPV, SST, SPI = range(7)
SHORT_PATCHES = [
    ("namespace {\n", "namespace {\n\n__device__ unsigned long long g_stamps[4096][16];\n"
     "#define T0 t0 = clock64()\n#define T1(c) st[c] += clock64() - t0\n"),
    ("    const bool tma = tw == 0;\n    int seg = -1, pb = -1, pg = -1;\n",
     "    const bool tma = tw == 0;\n    int seg = -1, pb = -1, pg = -1;\n"
     "    unsigned long long ps[16] = {};\n    const long long pall = clock64();\n"),
    ("        if (seg > 0) mbar_wait(kvempty, (seg - 1) & 1);\n",
     "        { const long long a = clock64();\n        if (seg > 0) mbar_wait(kvempty, (seg - 1) & 1);\n"
     "        ps[1] += clock64() - a; }\n"),
    ("        if (q >= NS) mbar_wait(&qempty[slot], ((q / NS) - 1) & 1);\n",
     "        { const long long a = clock64();\n        if (q >= NS) mbar_wait(&qempty[slot], ((q / NS) - 1) & 1);\n"
     "        ps[0] += clock64() - a; }\n"),
    ("        tma_load_3d(smem + slot * SHORT_CHUNK, &p.q, &qfull[slot], g * G * DH + c * 64, r0, b);\n      }\n    }\n    return;\n",
     "        tma_load_3d(smem + slot * SHORT_CHUNK, &p.q, &qfull[slot], g * G * DH + c * 64, r0, b);\n      }\n    }\n"
     f"    ps[{TOTAL}] = clock64() - pall;\n"
     "    if (tma) for (int c = 0; c < 16; ++c) g_stamps[blockIdx.x * 4 + 3][c] = ps[c];\n    return;\n"),
    ("  setmaxnreg_inc<160>();\n",
     "  setmaxnreg_inc<160>();\n  unsigned long long st[16] = {};\n"
     "  long long t0 = 0;\n  const long long tall = clock64();\n"),
    ("      mbar_spin(kvfull, seg & 1);\n",
     f"      T0;\n      mbar_spin(kvfull, seg & 1);\n      T1({SKV});\n"),
    ("        mbar_spin(&qfull[(qbase + waited) % NS], ((qbase + waited) / NS) & 1);\n",
     f"        {{ long long t0; T0;\n        mbar_spin(&qfull[(qbase + waited) % NS], ((qbase + waited) / NS) & 1);\n"
     f"        T1({SQ}); }}\n"),
    ("      issue_scores(h);\n      wgmma_wait<0>();\n",
     f"      issue_scores(h);\n      T0;\n      wgmma_wait<0>();\n      T1({SSC});\n"),
    ("      if (p.Sk < NK) mask_keys(s, p.Sk);\n", "      T0;\n      if (p.Sk < NK) mask_keys(s, p.Sk);\n"),
    ("      pack_frag(s, ph);\n", f"      pack_frag(s, ph);\n      T1({SSM});\n"),
    ("      issue_pv(h, pa);\n      wgmma_wait<0>();\n      store(h, l0, l1);\n    }\n  }\n}\n",
     f"      T0;\n      issue_pv(h, pa);\n      T1({SPI});\n      T0;\n      wgmma_wait<0>();\n      T1({SPV});\n"
     f"      T0;\n      store(h, l0, l1);\n      T1({SST});\n    }}\n  }}\n"
     f"  if (tw == 0) {{\n    st[{TOTAL}] = clock64() - tall;\n"
     "    for (int c = 0; c < 16; ++c) g_stamps[blockIdx.x * 4 + wg][c] = st[c];\n  }\n}\n"),
]

LOAD_MAX, LOAD_FIELDS, LOAD_BLOCKS = 1024, 20, 256
# per load: producer want / issue of K and of V; per consumer warpgroup w:
# K arrive / exit (4 + 2w, 5 + 2w), V arrive / exit (8 + 2w, 9 + 2w),
# K release (12 + w), V release (14 + w); the tile's index in its item (16),
# the consumer's item count (17); the end of each warpgroup's turn wait
# before the tile's score product (18 + w)
P_WANT_K, P_ISSUE_K, P_WANT_V, P_ISSUE_V = range(4)
LOAD_PATCHES = [
    ("namespace {\n", "namespace {\n\n"
     f"__device__ unsigned long long g_loads[{LOAD_BLOCKS} * {LOAD_MAX} * {LOAD_FIELDS}];\n"
     f"#define LREC(n, f) do {{ if ((n) < {LOAD_MAX} && blockIdx.x < {LOAD_BLOCKS}) g_loads[((size_t)blockIdx.x * {LOAD_MAX} + "
     f"(n)) * {LOAD_FIELDS} + (f)] = clock64(); }} while (0)\n"
     f"#define LSET(n, f, v) do {{ if ((n) < {LOAD_MAX} && blockIdx.x < {LOAD_BLOCKS}) g_loads[((size_t)blockIdx.x * {LOAD_MAX} + "
     f"(n)) * {LOAD_FIELDS} + (f)] = (v); }} while (0)\n"),
    ("      if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);\n",
     "      LREC(n, 0);\n      if (round > 0) mbar_wait(&kempty[stage], (round - 1) & 1);\n"
     "      LREC(n, 1);\n"),
    ("      if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);\n",
     "      LREC(n, 2);\n      if (round > 0) mbar_wait(&vempty[stage], (round - 1) & 1);\n"
     "      LREC(n, 3);\n"),
    ("    mbar_spin(&kfull[kv % KS], phase(0));\n",
     "    if (tw == 0) LREC(kv, 4 + 2 * wg);\n    mbar_spin(&kfull[kv % KS], phase(0));\n"
     "    if (tw == 0) { LREC(kv, 5 + 2 * wg); LSET(kv, 16, 0); LSET(kv, 17, qi); }\n"),
    ("      mbar_spin(&kfull[(kv + j) % KS], phase(j));\n"
     "      mbar_spin(&vfull[(kv + j - 1) % KS], phase(j - 1));\n",
     "      if (tw == 0) LREC(kv + j, 4 + 2 * wg);\n"
     "      mbar_spin(&kfull[(kv + j) % KS], phase(j));\n"
     "      if (tw == 0) { LREC(kv + j, 5 + 2 * wg); LSET(kv + j, 16, j); LSET(kv + j, 17, qi);\n"
     "                     LREC(kv + j - 1, 8 + 2 * wg); }\n"
     "      mbar_spin(&vfull[(kv + j - 1) % KS], phase(j - 1));\n"
     "      if (tw == 0) LREC(kv + j - 1, 9 + 2 * wg);\n"),
    ("    mbar_spin(&vfull[(kv + T - 1) % KS], phase(T - 1));\n",
     "    if (tw == 0) LREC(kv + T - 1, 8 + 2 * wg);\n"
     "    mbar_spin(&vfull[(kv + T - 1) % KS], phase(T - 1));\n"
     "    if (tw == 0) LREC(kv + T - 1, 9 + 2 * wg);\n"),
    ("    if (lead && release) mbar_arrive(&kempty[kv % KS]);\n",
     "    if (tw == 0 && release) LREC(kv, 12 + wg);\n"
     "    if (lead && release) mbar_arrive(&kempty[kv % KS]);\n"),
    ("      if (lead) mbar_arrive(&kempty[(kv + j) % KS]);\n",
     "      if (tw == 0) LREC(kv + j, 12 + wg);\n"
     "      if (lead) mbar_arrive(&kempty[(kv + j) % KS]);\n"),
    ("      if (lead) mbar_arrive(&vempty[(kv + j - 1) % KS]);\n",
     "      if (tw == 0) LREC(kv + j - 1, 14 + wg);\n"
     "      if (lead) mbar_arrive(&vempty[(kv + j - 1) % KS]);\n"),
    ("    if (lead && release) mbar_arrive(&vempty[(kv + T - 1) % KS]);\n",
     "    if (tw == 0 && release) LREC(kv + T - 1, 14 + wg);\n"
     "    if (lead && release) mbar_arrive(&vempty[(kv + T - 1) % KS]);\n"),
    ("      turn_begin();\n      wgmma_fence();\n      issue_scores<DH>(s, q_addr, q_chunk, k_addr(j));\n",
     "      turn_begin();\n      if (tw == 0) LREC(kv + j, 18 + wg);\n      wgmma_fence();\n"
     "      issue_scores<DH>(s, q_addr, q_chunk, k_addr(j));\n"),
    ("    turn_begin();\n    wgmma_fence();\n    issue_scores<DH>(s, q_addr, q_chunk, k_addr(0));\n",
     "    turn_begin();\n    if (tw == 0) LREC(kv, 18 + wg);\n    wgmma_fence();\n"
     "    issue_scores<DH>(s, q_addr, q_chunk, k_addr(0));\n"),
]
LOAD_ENTRY = """
extern "C" int anyv2v_flash_loads(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_loads, sizeof(g_loads));
}
"""

ENTRY = """
extern "C" int anyv2v_flash_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
"""


def make_copy(out: str, tree: str = HERE, patches=None, entry=None) -> None:
    if os.path.exists(out):
        shutil.rmtree(out)
    shutil.copytree(os.path.join(tree, "anyv2v_torch"), os.path.join(out, "anyv2v_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(out, "anyv2v_torch", "csrc", "flash_attention.cu")
    with open(path) as f:
        src = f.read()
    for anchor, new in patches or PATCHES:
        if anchor not in src:
            raise RuntimeError(f"anchor not found in flash_attention.cu: {anchor!r}")
        src = src.replace(anchor, new)
    with open(path, "w") as f:
        f.write(src + (entry or ENTRY))


def pct(x, q):
    return float(np.percentile(x, q)) if len(x) else float("nan")


def report_loads(label, lib, fn, args, grid, kv_stages):
    """Where a case's K/V waits sit, from the per-load stamps."""
    fn(*args)
    torch.cuda.synchronize()
    buf = np.zeros((LOAD_BLOCKS, LOAD_MAX, LOAD_FIELDS), np.uint64)
    rc = lib.anyv2v_flash_loads(buf.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"anyv2v_flash_loads: CUDA error {rc}")
    d = buf[:grid].astype(np.float64)
    issued = d[:, :, P_ISSUE_V] > 0
    n_loads = int(issued.sum())
    print(f"{label}: grid {grid}, {kv_stages} K/V stages, {n_loads} loads stamped "
          f"(the first {LOAD_MAX} of each block)")
    # one step: the time between consecutive K arrivals of warpgroup 0 within an item
    arr0 = d[:, :, 4]
    steps = np.diff(arr0, axis=1)[(d[:, 1:, 16] > 0) & (arr0[:, 1:] > 0) & (arr0[:, :-1] > 0)]
    step = pct(steps, 50)
    print(f"  one step (warpgroup 0, K arrival to the next): median {step:.0f} cycles")
    for kind, a0, name in ((0, 4, "K"), (1, 8, "V")):
        for w in (0, 1):
            arr, ext = d[:, :, a0 + 2 * w], d[:, :, a0 + 2 * w + 1]
            ok = (arr > 0) & (ext >= arr)
            if not ok.any():
                continue
            wait = np.where(ok, ext - arr, 0.0)
            first = ok & (d[:, :, 16] == 0)
            total = wait.sum()
            line = (f"  warpgroup {w} {name} waits: {total / max(1, ok.sum()):.0f} cycles a tile; "
                    f"item's first tile {100 * wait[first].sum() / max(total, 1):.1f} %, "
                    f"later tiles {100 * wait[ok & ~first].sum() / max(total, 1):.1f} %")
            if w == 1:
                other = d[:, :, a0 + 1]   # warpgroup 0's exit from the same wait
                behind = ok & (other > 0) & (other <= arr)
                line += (f"; with warpgroup 0 through the same barrier before it "
                         f"{100 * wait[behind].sum() / max(total, 1):.1f} %")
            print(line)
    # latency of a copy, issue to the end of a consumer's wait (where one waited)
    for name, iss, a0 in (("K", P_ISSUE_K, 4), ("V", P_ISSUE_V, 8)):
        lat, lead_w, lead_n = [], [], []
        for w in (0, 1):
            arr, ext, ist = d[:, :, a0 + 2 * w], d[:, :, a0 + 2 * w + 1], d[:, :, iss]
            ok = (arr > 0) & (ist > 0) & (ext >= arr)
            waited = ok & (ext - arr > 200)
            lat += list((ext - ist)[waited])
            lead_w += list((arr - ist)[waited])
            lead_n += list((arr - ist)[ok & ~waited])
        print(f"  {name} copies: issue to the end of a wait {pct(lat, 50):.0f} cycles median "
              f"({pct(lat, 10):.0f}-{pct(lat, 90):.0f}, 10-90 %); issued ahead of the consumer's "
              f"arrival: {pct(lead_w, 50):.0f} cycles where it waited, {pct(lead_n, 50):.0f} "
              f"where it did not")
    want_k, iss_k = d[:, :, P_WANT_K], d[:, :, P_ISSUE_K]
    want_v, iss_v = d[:, :, P_WANT_V], d[:, :, P_ISSUE_V]
    ok = issued & (want_k > 0)
    k_slot = (iss_k - want_k)[ok].sum()
    v_slot = (iss_v - want_v)[ok].sum()
    span = (d[:, :, P_ISSUE_V].max(axis=1) - np.where(want_k > 0, want_k, np.inf).min(axis=1))
    span = span[np.isfinite(span)].sum()
    print(f"  producer: waits for a K slot {100 * k_slot / max(span, 1):.1f} %, for a V slot "
          f"{100 * v_slot / max(span, 1):.1f} % of its stamped span")
    # which consumer release freed the slot a K copy waited for
    rel_k = np.maximum(d[:, :, 12], d[:, :, 13])
    gap = []
    for blk in range(d.shape[0]):
        for n in range(kv_stages, LOAD_MAX):
            if ok[blk, n] and iss_k[blk, n] - want_k[blk, n] > 200 and rel_k[blk, n - kv_stages]:
                gap.append(iss_k[blk, n] - rel_k[blk, n - kv_stages])
    print(f"  K copies that waited for their slot: {len(gap)}; from the slot's release to the "
          f"issue {pct(gap, 50):.0f} cycles median")


def report(label, lib, fn, args, grid, consumer=CONSUMER, producer=PRODUCER, consumers=2):
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    buf = np.zeros((4096, 16), np.uint64)
    rc = lib.anyv2v_flash_stamps(buf.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"anyv2v_flash_stamps: CUDA error {rc}")
    roles = consumers + 1   # the consumer warpgroups, then the producer
    rows = buf[:roles * grid].reshape(grid, roles, 16).astype(np.float64)
    print(f"{label}: {start.elapsed_time(end):.4f} ms, grid {grid}")
    for role, names in [(w, consumer) for w in range(consumers)] + [(consumers, producer)]:
        tot = rows[:, role, TOTAL]
        if not tot.any():
            continue
        share = [rows[:, role, c].sum() / tot.sum() for c in range(len(names))]
        who = f"warpgroup {role}" if role < consumers else "producer"
        print(f"  {who}: {tot.mean():.4e} cycles a block; " + ", ".join(
            f"{n} {100 * x:.1f} %" for n, x in zip(names, share)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "variants", "stamps"))
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--loads", action="store_true")
    ap.add_argument("--short", action="store_true")
    ap.add_argument("--filter", action="append", default=[])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    if a.loads:
        make_copy(a.out, os.path.abspath(a.tree), LOAD_PATCHES, LOAD_ENTRY)
    elif a.short:
        make_copy(a.out, os.path.abspath(a.tree), SHORT_PATCHES)
    else:
        make_copy(a.out, os.path.abspath(a.tree))
    sys.path.insert(0, a.out)
    from anyv2v_torch.ops import _build
    from anyv2v_torch.ops import flash_attention as fl

    _build.SOURCES = ("folded_attention.cu", "flash_attention.cu")
    lib = _build.library()
    print(f"instrumented copy in {a.out}, built in {_build.build_seconds} s")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    cases = [
        ("split-KV L0 51 rows Sq4096 Sk4096+4096 h5 dh64", 51, 4096, 4096, 5, 64, 4096, 17, None),
        ("SEINE L0 spatial self b48 S4096 h8 dh40", 48, 4096, 4096, 8, 40, 0, 1, None),
        ("SEINE L0 shared bias", 48, 4096, 4096, 8, 40, 0, 1, "shared"),
        ("SDXL L1 self b3 S4096 h10 dh64", 3, 4096, 4096, 10, 64, 0, 1, None),
        ("spatial cross L0 b51 Sq4096 Sk77 h5 dh64", 51, 4096, 77, 5, 64, 0, 1, None),
        ("temporal cross L0 b3 Sq17*4096 Sk77 h8 dh40", 3, 17 * 4096, 77, 8, 40, 0, 1, None),
    ]
    cases += [
        ("SD1.5 L0 cross b3 Sq4096 Sk77 h8 dh40", 3, 4096, 77, 8, 40, 0, 1, None),
        ("temporal cross L2 b3 Sq17*256 Sk77 h8 dh160", 3, 17 * 256, 77, 8, 160, 0, 1, None),
        ("InstantStyle IP b2 Sq1024 Sk4 h20 dh64", 2, 1024, 4, 20, 64, 0, 1, None),
    ]
    default = (["split-KV L0", "SEINE L0 spatial self"] if a.loads else
               ["cross", "IP"] if a.short else [""])
    filters = a.filter or default
    cases = [c for c in cases if any(f in c[0] for f in filters)]
    for label, b, sq, sk, h, dh, sk2, frames, bias in cases:
        c = h * dh
        args = [rn(b, sq, c), rn(b, sk, c), rn(b, sk, c), h, dh ** -0.5]
        kw = {}
        if sk2:
            args += [rn(b // frames, sk2, c), rn(b // frames, sk2, c), frames]
        if bias:
            kw["bias"] = rn(h, sq, sk, dtype=torch.float32)
        plan = fl.flash_plan(b, sq, h, dh, bias, sk, sk2=sk2, sms=_build.sm_count(args[0].device))
        body = plan.get("body", "tiles")
        if (body == "short") != a.short:   # the other body writes no stamps
            print(f"{label}: the {body} body takes it, not stamped in this mode")
            continue
        if a.loads:
            report_loads(label, lib, lambda *x: fl.flash_attention(*x, **kw), args,
                         plan["grid"][0], plan["kv_stages"])
        elif a.short:
            report(label, lib, lambda *x: fl.flash_attention(*x, **kw), args, plan["grid"][0],
                   SHORT_CONSUMER, SHORT_PRODUCER, fl.SHORT_WGS)
        else:
            report(label, lib, lambda *x: fl.flash_attention(*x, **kw), args, plan["grid"][0])
        del args, kw
    return 0


if __name__ == "__main__":
    sys.exit(main())
