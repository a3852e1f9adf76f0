"""K1's two bodies at the same shapes on one NVIDIA GPU: where the short body
(``folded_attention_short_kernel``, ``mma.sync`` on a ``cp.async`` ring) and
the Hopper body (``folded_attention_kernel``) cross over as the key axis
grows, and how few blocks the short body's grid may have.

    python3 scripts/torch_k1_classes.py [--tree DIR]

``anyv2v_torch`` is imported from DIR (default: this checkout). For each base
shape (batch rows, Sq, heads, stored and true head width) and each Sk of its
sweep, both bodies are launched through ``folded_attention.launch`` with a
plan of each (the tree's rule would take only one), each held against the
plain version within ``chip_smoke.py``'s bound (``0.01 + 0.02 max|ref|``),
and each timed by ``chip_smoke._time_ms`` (CUDA events over 5 launches behind
a spin kernel). Prints one line a shape: both times, the short body's grid
in blocks, and the body the tree's rule takes. Exits 1 if a launch fails its
check.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, batch rows, Sq, heads, stored head width, true head width, Sk sweep)
SWEEPS = [
    ("i2vgen L0 cross-like", 2, 4096, 64, 8, 5, (64, 128, 157, 192, 256, 320, 321, 448, 640)),
    ("i2vgen L1 cross-like", 2, 1024, 64, 16, 10, (77, 157, 192, 256, 320, 321, 448)),
    ("i2vgen L2 cross-like", 2, 256, 64, 32, 20, (77, 157, 256)),
    ("i2vgen L2 self-like", 48, 256, 64, 32, 20, (157, 256, 320, 384)),
    ("i2vgen mid self-like", 16, 64, 64, 32, 20, (64, 128, 192, 256)),
    ("ConsistI2V mid cross-like", 51, 64, 20, 64, 64, (77, 128, 192, 256, 320, 321, 448)),
    ("128-frame encoder-like", 3 * 4096, 128, 2, 8, 4, (128, 192, 256)),
    ("seine-tiny-like", 24, 64, 2, 8, 8, (64, 77)),
    ("few rows", 2, 300, 5, 8, 8, (65, 157)),
    ("few rows dh32", 3, 65, 4, 32, 20, (64, 157)),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from anyv2v_torch.ops import _build
    from anyv2v_torch.ops import folded_attention as fa

    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"anyv2v_torch came from {fa.__file__}, not {tree}")
    smoke.phase_env()
    _build.library()
    sms = _build.sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    failures = 0
    for label, b, sq, heads, dh, true_dh, sks in SWEEPS:
        for sk in sks:
            q, k, v = (torch.randn(b, n, heads * dh, generator=g, device="cuda")
                       .to(torch.bfloat16) for n in (sq, sk, sk))
            scale = true_dh ** -0.5
            shape = {"b": b, "sq": sq, "sk": sk, "heads": heads, "head_dim": dh, "sms": sms}
            plans = {"short": {"shape": shape, "body": "short",
                               **fa._short_plan(b, sq, sk, heads, dh)},
                     "hopper": {"shape": shape, "body": "hopper",
                                **fa._hopper_plan(b, sq, sk, heads, dh, sms)}}
            want = fa.folded_attention_plain(q, k, v, heads, scale).float()
            bound = 0.01 + 0.02 * want.abs().max().item()
            times = {}
            for body, plan in plans.items():
                err = (fa.launch(q, k, v, heads, scale, plan).float() - want).abs().max().item()
                if not err <= bound:
                    failures += 1
                    print(f"MISS {label} Sk {sk} {body}: max_abs_err {err:.3e} > {bound:.3e}")
                times[body] = smoke._time_ms(lambda: fa.launch(q, k, v, heads, scale, plan), 5)
            blocks = plans["short"]["grid"][0] * plans["short"]["grid"][1]
            rule = fa.folded_plan(b, sq, sk, heads, dh, sms=sms)["body"]
            print(f"classes {label} b{b} Sq{sq} Sk{sk} h{heads} dh{dh}: short "
                  f"{times['short']:.4f} ms ({blocks} blocks), hopper {times['hopper']:.4f} ms "
                  f"({plans['hopper']['items']} items); faster "
                  f"{min(times, key=times.get)}, the rule takes {rule}", flush=True)
            del q, k, v, want
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
