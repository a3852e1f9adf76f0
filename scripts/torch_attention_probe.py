"""Checks and times the attention kernels at ``chip_smoke.py``'s cases on one
NVIDIA GPU, without the model paths.

    python3 scripts/torch_attention_probe.py [--tree DIR] [--filter TEXT ...]

``anyv2v_torch`` (and its ``csrc/``) is imported from DIR (default: this
checkout), the cases and their check from this checkout's ``chip_smoke.py``
(``phase_kernels`` on a subset of its cases), so two trees can be compared in
one call (parent, change, change, parent). ``--filter`` keeps the cases whose
kernel name or label contains one of the texts (default: K1, K2 and K2 long).

Prints ptxas's registers and spills of the K1 and K2 kernels, then
``chip_smoke.py``'s line for each case (its error against the plain version
and the fp32 truth, the kernel's, plain version's and SDPA's times, the
bound) and the exp2 floors. Exits 1 if a case fails its check.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--filter", action="append", default=[])
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
    smoke.phase_env()   # torch, CUDA, the card's name and power limit
    _build.library()
    smoke.log(f"build: nvcc {_build.build_seconds} s")
    for line in smoke._ptxas_summary(_build.ptxas_report(),
                                     ("folded_attention_kernel", "frame_attention_kernel",
                                      "frame_attention_long_kernel")):
        smoke.log(f"ptxas {line}")
    filters = a.filter or ["folded_attention", "frame_attention"]
    cases = [c for c in smoke._kernel_cases() if any(f in c[0] or f in c[1] for f in filters)]
    try:
        smoke.phase_kernels(cases)
    except RuntimeError as e:
        smoke.log(str(e))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
