"""Runs the port's bench entries on several trees in one call, in the order
given, on one NVIDIA GPU, so that two trees can be compared on one card
(parent, change, change, parent).

    python3 scripts/torch_bench_ab.py TREE [TREE ...]

For each TREE (a checkout or ``git archive`` of one, in a git-ignored
directory), runs ``python3 -m anyv2v_torch.bench`` (i2vgen-xl) and
``python3 -m anyv2v_torch.bench_backbones consisti2v seine`` from it, each
in its own process (projected, 16 frames, as ``chip_smoke.py``'s bench
phase), and prints each JSON line as it comes, then one summary line per
run and backbone: the tree, the projected seconds and their invert, edit,
encode and decode parts. The card's name and power limit come first, the
SM clock, power draw and temperature after each tree. Exits 1 if an entry fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def run_tree(tree: str) -> list:
    records = []
    for cmd in (["-m", "anyv2v_torch.bench"],
                ["-m", "anyv2v_torch.bench_backbones", "consisti2v", "seine"]):
        p = subprocess.run([sys.executable, *cmd], cwd=tree, capture_output=True, text=True)
        if p.returncode:
            print(p.stdout[-4000:], p.stderr[-4000:], sep="\n")
            raise RuntimeError(f"{' '.join(cmd)} in {tree}: exit {p.returncode}")
        for line in p.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                records.append(json.loads(line))
    return records


def clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def summary(rec: dict) -> str:
    d = rec["detail"]
    parts = ", ".join(f"{k} {d[k]}" for k in ("invert_s", "edit_s", "vae_encode_s",
                                              "vae_decode_s"))
    return f"{rec['metric'].split(' invert')[0]}: {rec['value']} s ({parts})"


def main():
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        print(__doc__)
        return 2
    print(f"card: {card()}", flush=True)
    lines = []
    try:
        for tree in trees:
            for rec in run_tree(tree):
                lines.append(f"{tree}: {summary(rec)}")
                print(lines[-1], flush=True)
            print(f"clocks after {tree}: {clocks()}", flush=True)
    except RuntimeError as e:
        print(e)
        return 1
    print("summary:")
    for line in lines:
        print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
