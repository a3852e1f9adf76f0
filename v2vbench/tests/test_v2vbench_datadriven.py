"""The harness is driven by data: in a copy, a new configuration, traffic
mix, per-layer metric and kernel family, each a new file with new
BENCHMARK.json entries (the cell's rate a split of its own), run without any
file of the benchmark edited."""

from __future__ import annotations

import hashlib
import json
import os

from v2vbench.tests.helpers import run_cell, tiny_copy, write_json

FAMILY = '''"""The 3x3 convolutions (cuDNN), counted at their shapes."""

NAME = "conv3x3"
PATTERNS = (r"conv2d|implicit_gemm|xmma_fprop",)
WRAP = (("anyv2v_torch.models.layers", "conv_nhwc"),)


def cost(conv, x, *args, **kwargs):
    n, h, w, c = x.shape
    o = conv.weight.shape[0]
    k = conv.weight.shape[2] * conv.weight.shape[3]
    sh, sw = conv.stride
    flops = 2 * n * (h // sh) * (w // sw) * o * c * k
    return flops, 2 * (x.numel() + conv.weight.numel() + n * (h // sh) * (w // sw) * o)
'''

CALLS = '''"""Calls of the 3x3 convolutions in the traced request."""


def read(trace):
    return trace.shapes.calls.get("conv3x3") or None
'''


def digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, "v2vbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_run_unedited(tmp_path):
    root = tiny_copy(str(tmp_path))
    before = digests(root)
    b = os.path.join(root, "v2vbench")
    with open(os.path.join(b, "tests", "configs", "consisti2v-tiny.json")) as f:
        conf = json.load(f)
    conf.update(name="consisti2v-tiny-wide", text_tokens=6)
    conf["edit"]["frame_stride"] = 2
    write_json(os.path.join(b, "configs", "consisti2v-tiny-wide.json"), conf)
    write_json(os.path.join(b, "traffic", "edit3.json"), {
        "request": "edit", "frames": 3, "pool": 3,
        "metric": {"name": "edit_s", "per": "requests", "times": 1},
        "check": {"steps_per_segment": 1}})
    cell = "consisti2v-tiny-wide.edit3"
    write_json(os.path.join(b, "limits", f"{cell}.json"),
               {"encode": 0.04, "unet": 0.08, "step": 0.15, "decode": 0.02, "traj_row": 0.0})
    with open(os.path.join(b, "metrics", "conv_calls.edit.py"), "w") as f:
        f.write(CALLS)
    with open(os.path.join(b, "kernels", "conv3x3.py"), "w") as f:
        f.write(FAMILY)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "consisti2v-tiny-wide", "source": "test",
                             "file": "v2vbench/configs/consisti2v-tiny-wide.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell, "config": "consisti2v-tiny-wide", "traffic": "edit3",
                               "chips": 1, "why": "test"})
    # the new cell's rate under a split of its own, with its own bound
    rate = "edit_s.tiny-wide"
    bench["end_to_end"].append({"name": rate, "unit": "s", "better": "lower", "bound": 0.05,
                                "source": "host_clock", "workloads": [cell]})
    bench["per_layer"].append({"name": "conv_calls.edit", "unit": "calls", "better": "lower",
                               "source": "program_counter", "layer": "model step",
                               "moves": rate, "workloads": [cell]})
    write_json(os.path.join(root, "BENCHMARK.json"), bench)

    rc, result, err = run_cell(root, cell, trace=0)
    assert rc == 0 and result["correct"], err[-3000:]
    assert {rate, "setup_s", "peak_mem_gib"} == set(result["metrics"])
    rc, result, err = run_cell(root, cell, trace=1)
    assert rc == 0 and result["correct"], err[-3000:]
    assert result["metrics"]["conv_calls.edit"]["value"] > 0
    after = digests(root)
    assert all(after[p] == d for p, d in before.items())
