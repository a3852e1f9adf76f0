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
ENTRY = """
extern "C" int anyv2v_flash_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
"""


def make_copy(out: str) -> None:
    if os.path.exists(out):
        shutil.rmtree(out)
    shutil.copytree(os.path.join(HERE, "anyv2v_torch"), os.path.join(out, "anyv2v_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(out, "anyv2v_torch", "csrc", "flash_attention.cu")
    with open(path) as f:
        src = f.read()
    for anchor, new in PATCHES:
        if anchor not in src:
            raise RuntimeError(f"anchor not found in flash_attention.cu: {anchor!r}")
        src = src.replace(anchor, new)
    with open(path, "w") as f:
        f.write(src + ENTRY)


def report(label, lib, fn, args, grid):
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
    rows = buf[:3 * grid].reshape(grid, 3, 16).astype(np.float64)
    print(f"{label}: {start.elapsed_time(end):.4f} ms, grid {grid}")
    for role, names in ((0, CONSUMER), (1, CONSUMER), (2, PRODUCER)):
        tot = rows[:, role, TOTAL]
        if not tot.any():
            continue
        share = [rows[:, role, c].sum() / tot.sum() for c in range(len(names))]
        who = f"warpgroup {role}" if role < 2 else "producer"
        print(f"  {who}: {tot.mean():.4e} cycles a block; " + ", ".join(
            f"{n} {100 * x:.1f} %" for n, x in zip(names, share)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "variants", "stamps"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    make_copy(a.out)
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
    for label, b, sq, sk, h, dh, sk2, frames, bias in cases:
        c = h * dh
        args = [rn(b, sq, c), rn(b, sk, c), rn(b, sk, c), h, dh ** -0.5]
        kw = {}
        if sk2:
            args += [rn(b // frames, sk2, c), rn(b // frames, sk2, c), frames]
        if bias:
            kw["bias"] = rn(h, sq, sk, dtype=torch.float32)
        plan = fl.flash_plan(b, sq, h, dh, bias, sk, sk2=sk2, sms=_build.sm_count(args[0].device))
        report(label, lib, lambda *x: fl.flash_attention(*x, **kw), args, plan["grid"][0])
        del args, kw
    return 0


if __name__ == "__main__":
    sys.exit(main())
