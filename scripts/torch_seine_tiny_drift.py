"""How much of the seine-tiny reference check's error in ``chip_smoke.py``
is bf16 rounding and how much is the kernels, on one NVIDIA GPU.

    python3 scripts/torch_seine_tiny_drift.py [--seeds N]

1. K1 (``folded_attention``) on the inputs it receives in the check (input
   seed 4, as ``chip_smoke.py`` runs it). The kernel and its plain version
   are each held against the fp32 truth: the plain version on the inputs
   cast to fp32, with the output left unrounded.
2. The check over input seeds 0..N-1, in two forms. In the first the
   reference runs on the card's bf16-rounded weights and inputs, as
   ``chip_smoke.py`` runs it. In the second it runs on the unrounded fp32
   ones. Each form runs once with the kernels and once with the check's
   attention kernels (K1, K2, K5) swapped for their plain versions on the
   card. It prints the max error over the bound and the mean error.

Needs a CUDA GPU and nvcc (the kernels build as in ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from anyv2v_torch.ops import _build, attention  # noqa: E402
from anyv2v_torch.ops import flash_attention as fl  # noqa: E402
from anyv2v_torch.ops import folded_attention as fa  # noqa: E402
from anyv2v_torch.ops import frame_attention as fr  # noqa: E402
from anyv2v_torch.utils.model_zoo import build_seine_pipeline  # noqa: E402

PLAIN = {"folded_attention": fa.folded_attention_plain,
         "flash_attention": fl.flash_attention_plain,
         "frame_attention": fr.frame_attention_plain}
PNP = {"pnp": (True, True, True, True)}


@contextlib.contextmanager
def plain_attention():
    """The dispatcher's three kernel routes on their plain versions."""
    saved = {n: getattr(attention, n) for n in PLAIN}
    for n, f in PLAIN.items():
        setattr(attention, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(attention, n, f)


def k1_calls():
    """K1's inputs in the check at seed 4, each call's errors against the
    fp32 truth."""
    calls = []
    launch = attention.folded_attention

    def capture(q, k, v, heads, scale):
        if q.is_cuda:   # the card's calls, not the CPU reference's
            calls.append((q.clone(), k.clone(), v.clone(), heads, scale))
        return launch(q, k, v, heads, scale)

    wrappers = chip_smoke._wrappers()
    for w in wrappers.values():
        w.launches = 0
    attention.folded_attention = capture
    try:
        chip_smoke._reference_error("seine-tiny", build_seine_pipeline,
                                    chip_smoke.seine_tiny_args(4), PNP)
    finally:
        attention.folded_attention = launch
    print(f"launches in one check: {({n: w.launches for n, w in wrappers.items()})}")
    worst = [0.0, 0.0]
    for i, (q, k, v, heads, scale) in enumerate(calls):
        truth = fa.folded_attention_plain(q.float(), k.float(), v.float(), heads, scale)
        kern = fa.folded_attention(q, k, v, heads, scale).float()
        plain = fa.folded_attention_plain(q, k, v, heads, scale).float()
        errs = [(x - truth).abs().max().item() for x in (kern, plain)]
        worst = [max(a, b) for a, b in zip(worst, errs)]
        print(f"K1 call {i:2d} q{tuple(q.shape)} k{tuple(k.shape)}: max|truth| "
              f"{truth.abs().max().item():.3e}, vs fp32 truth: kernel {errs[0]:.3e}, plain "
              f"{errs[1]:.3e}; kernel != plain in {int((kern != plain).sum())} of "
              f"{kern.numel()} outputs, by at most {(kern - plain).abs().max().item():.3e}")
    print(f"K1 over its {len(calls)} calls, worst error vs fp32 truth: kernel {worst[0]:.3e}, "
          f"plain {worst[1]:.3e}")


def sweep(seeds):
    for rounded in (True, False):
        worst = {"kernels": [0.0, -1], "plain": [0.0, -1]}
        for seed in range(seeds):
            row = []
            for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_attention)):
                with ctx():
                    err, mean, bound = chip_smoke._reference_error(
                        "seine-tiny", build_seine_pipeline, chip_smoke.seine_tiny_args(seed),
                        PNP, rounded=rounded)
                if err / bound > worst[label][0]:
                    worst[label] = [err / bound, seed]
                row.append(f"{label} max/bound {err / bound:.3f} mean {mean:.3e}")
            print(f"reference {'rounded' if rounded else 'fp32'} seed {seed}: " + ", ".join(row))
        print(f"reference {'rounded' if rounded else 'fp32'}, worst of {seeds} seeds: "
              + ", ".join(f"{k} {v[0]:.3f} (seed {v[1]})" for k, v in worst.items()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    seeds = ap.parse_args().seeds
    if not torch.cuda.is_available():
        print("no CUDA GPU: torch.cuda.is_available() is False")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    chip_smoke.phase_env()
    k1_calls()
    sweep(seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
