"""Checks and times the kernels at ``chip_smoke.py``'s cases on one NVIDIA
GPU, without the model paths (by default the attention kernels K1 and K2).

    python3 scripts/torch_attention_probe.py [--tree DIR] [--filter TEXT ...] [--profile]
        [--sources FILE,...] [--sass]

``anyv2v_torch`` (and its ``csrc/``) is imported from DIR (default: this
checkout), the cases and their check from this checkout's ``chip_smoke.py``
(``phase_kernels`` on a subset of its cases), so two trees can be compared in
one call (parent, change, change, parent). ``--filter`` keeps the cases whose
kernel name or label contains one of the texts (default: K1, K2 and K2 long).

Prints ptxas's registers and spills of the kernels the cases reach, then
``chip_smoke.py``'s line for each case (its error against the plain version
and the fp32 truth, the kernel's, plain version's and SDPA's times, the
bound) and the exp2 floors. With ``--profile``, then each case's device time
per kernel symbol under torch.profiler (a call that makes several launches,
as K3's two GEMMs, shows each). Exits 1 if a case fails its check.

``--sources`` builds only the named sources of ``csrc/`` (seconds instead of
a minute; the cases must need no other, and every build needs
``folded_attention.cu``, which holds ``anyv2v_error_string``). ``--sass`` prints, for each instance of the cases' kernels, what
``cuobjdump -sass`` shows of its registers (the highest register number
used, plus one: ptxas's "Used N registers" is the launch's allocation, not
what the code past a ``setmaxnreg`` takes) and of its local-memory spills
(``STL`` / ``LDL`` instructions), and every line of ptxas's report that
names a ``wgmma`` serialisation (warnings C7510-C7515), word for word.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--filter", action="append", default=[])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sources", default="")
    ap.add_argument("--sass", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import anyv2v_torch
    from anyv2v_torch.ops import _build

    if not anyv2v_torch.__file__.startswith(tree):
        raise RuntimeError(f"anyv2v_torch came from {anyv2v_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.log(f"anyv2v_torch from {tree}")
    from anyv2v_torch.ops import folded_attention as fa

    if not hasattr(fa, "SHORT_MAX_QUERIES"):
        # a tree from before K1 had two bodies: every K1 case reports to its one record
        smoke._k1_record = lambda name, make: (
            "folded_attention" if name == "folded_attention_short" else name)
    smoke.phase_env()   # torch, CUDA, the card's name and power limit
    if a.sources:
        _build.SOURCES = tuple(a.sources.split(","))
    _build.library()
    smoke.log(f"build: nvcc {_build.build_seconds} s")
    filters = a.filter or ["folded_attention", "frame_attention"]
    cases = [c for c in smoke._kernel_cases() if any(f in c[0] or f in c[1] for f in filters)]
    kernels = {c[0] for c in cases}
    symbols = [key for _, key, name in smoke._KERNEL_GROUPS if name in kernels]
    for line in smoke._ptxas_summary(_build.ptxas_report(), symbols):
        smoke.log(f"ptxas {line}")
    if a.sass:
        for line in sass_summary(_build, symbols):
            smoke.log(line)
    try:
        smoke.phase_kernels(cases)
    except RuntimeError as e:
        smoke.log(str(e))
        return 1
    if a.profile:
        profile_cases(smoke, cases)
    return 0


def sass_summary(build, symbols):
    """Per instance of the named kernels: the registers its SASS uses (the
    highest R number + 1), its STL / LDL count, its MUFU / FFMA / FADD
    count; then ptxas's wgmma-serialisation warnings."""
    so = os.path.join(build.BUILD_DIR, f"libanyv2v_{build._source_hash()}.so")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    out = []
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not any(s + "I" in name for s in symbols):
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", func)]
        ops = collections.Counter(
            o.split(".")[0] for o in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func))
        out.append(f"sass {name}: {max(regs) + 1 if regs else 0} registers used, "
                   f"STL {ops['STL']}, LDL {ops['LDL']}, MUFU {ops['MUFU']}, "
                   f"FFMA {ops['FFMA']}, FADD {ops['FADD']}, WARPGROUP {ops['WARPGROUP']}, "
                   f"HGMMA {ops['HGMMA']}, instructions {sum(ops.values())}")
    out += [f"ptxas warning: {line.strip()}" for line in build.ptxas_report().splitlines()
            if re.search(r"C75\d\d|wgmma", line)]
    return out


def profile_cases(smoke, cases, calls=3):
    """Device ms per call of each kernel symbol that a case's wrapper launches."""
    from torch.profiler import ProfilerActivity, profile

    kernels = smoke._kernels()
    for name, label, make, *_ in cases:
        fn, args = kernels[name][3], make()
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total]
        smoke.log(f"profile {name} [{label}]: " + "; ".join(
            f"{e.key[:90]} {e.self_device_time_total / 1e3 / calls:.4f} ms x{e.count // calls}"
            for e in rows))
        del args


if __name__ == "__main__":
    sys.exit(main())
