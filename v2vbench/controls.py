"""Readings for the limits of ``correct``: for each seed, the program's numbers
on one request of a cell, and the control's, in one process.

    python3 -m v2vbench.controls --workload <cell> --seeds 11,12,13 [--device cpu]

The control is the reference put in the program's place one precision below
the configuration's bfloat16: every operand of a matrix product or a
convolution in float8 e4m3 (``Params(..., fp8=True)``),
evaluated on the same states as the program's sampled steps, the same first
frames and the same edited latents. Both are compared with the float32
reference by :func:`v2vbench.cell.compare`. One JSON line a seed:
``{"seed", "program": {...}, "control": {...}, "limits": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def readings(workload: str, seed: int, device) -> dict:
    from . import cell as cell_mod, manifest
    from .benchguard import hard_sync
    from .reference.nn import strict_fp32

    spec = manifest.cell(workload)
    cell = manifest.adapter(spec["config"]).Cell(spec["config"], spec["traffic"], seed, device)
    cell.warm()
    record = cell.request(0)
    hard_sync(record.outputs["latents"] if "latents" in record.outputs else record.outputs["traj"])
    program = cell.program_outputs(record)
    cell.release()
    strict_fp32()
    out = {"seed": seed}
    with torch.inference_mode():
        reference = cell.reference_outputs(record, program)
        out["program"] = cell_mod.compare(program, reference)
        control = cell.reference_outputs(record, program, fp8=True)
        out["control"] = cell_mod.compare(control, reference)
    out["limits"] = spec["limits"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("v2vbench.controls: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
