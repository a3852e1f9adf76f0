"""Tiny cells for the tests: a copy of the benchmark in a temporary directory
with test configurations, traffic mixes, limits and BENCHMARK.json entries
added, and a runner for its command."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TRAFFIC = {
    "edit2": {"request": "edit", "frames": 2, "pool": 2,
              "metric": {"name": "edit_s", "per": "requests", "times": 1},
              "check": {"steps_per_segment": 1}},
    "invert2": {"request": "invert", "frames": 2, "steps_per_call": 4, "traj_store": "device",
                "metric": {"name": "invert_s", "per": "steps", "times": 500},
                "check": {"steps": 2}},
    "invert2host": {"request": "invert", "frames": 2, "steps_per_call": 4, "traj_store": "host",
                    "metric": {"name": "invert_s", "per": "steps", "times": 500},
                    "check": {"steps": 2}},
}
# limits for the tiny cells, between the bf16 program's and the float8 control's
# readings at these sizes (test_v2vbench_controls.py holds them apart)
LIMITS = {"edit": {"encode": 0.04, "unet": 0.08, "step": 0.15, "decode": 0.02, "traj_row": 0.0},
          "invert": {"encode": 0.04, "unet": 0.08, "step": 0.12}}
CELLS = ("i2vgen-tiny.edit2", "consisti2v-tiny.edit2", "i2vgen-tiny.invert2",
         "consisti2v-tiny.invert2", "i2vgen-tiny.invert2host")


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


def tiny_copy(dst: str) -> str:
    """The benchmark and BENCHMARK.json copied under ``dst``, with the tiny
    cells added as files and entries: each reports its traffic's rate and
    the per-layer metrics that move it (an entry of its own where
    BENCHMARK.json has none for that rate)."""
    shutil.copytree(BENCH, os.path.join(dst, "v2vbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("i2vgen-tiny", "consisti2v-tiny"):
        shutil.copy(os.path.join(HERE, "configs", f"{name}.json"),
                    os.path.join(dst, "v2vbench", "configs", f"{name}.json"))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"v2vbench/configs/{name}.json", "reduced": [],
                                 "why": "test"})
    for name, traffic in TRAFFIC.items():
        write_json(os.path.join(dst, "v2vbench", "traffic", f"{name}.json"), traffic)
    for cell in CELLS:
        config, traffic = cell.split(".")
        kind, rate_name = TRAFFIC[traffic]["request"], TRAFFIC[traffic]["metric"]["name"]
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "test"})
        write_json(os.path.join(dst, "v2vbench", "limits", f"{cell}.json"), LIMITS[kind])
        rates = [m for m in bench["end_to_end"] if m["name"].split(".")[0] == rate_name]
        if not rates:
            rates = [{"name": rate_name, "unit": "s", "better": "lower", "bound": 0.05,
                      "source": "host_clock", "workloads": []}]
            bench["end_to_end"].append(rates[0])
            bench["per_layer"] += [
                {"name": f"mfu.{kind}", "unit": "%", "better": "higher", "source": "device_trace",
                 "layer": "model step", "moves": rate_name, "workloads": []},
                {"name": f"host_syncs.{kind}", "unit": "syncs/forward", "better": "lower",
                 "source": "device_trace", "layer": "pipeline", "moves": rate_name,
                 "workloads": []}]
        rates[0]["workloads"].append(cell)
        for m in bench["per_layer"]:
            if m["moves"] == rates[0]["name"] and "workloads" in m:
                m["workloads"].append(cell)
    write_json(os.path.join(dst, "BENCHMARK.json"), bench)
    return dst


def run_cell(root: str, cell: str, seed: int = 5, trace: int = 0, seconds: float = 0.5,
             module: str = "v2vbench.run", pre=()):
    """(exit code, the last line of standard output as JSON or None, standard
    error) of one run of ``cell`` on the CPU in the copy at ``root``."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", module, *pre, "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return proc.returncode, result, proc.stderr
