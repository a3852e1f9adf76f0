"""The control, the reference in float8 put in the program's place, fails the
limits the program passes: at the tiny sizes on the CPU here, and at each
cell's own size on a card (marked ``card``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from v2vbench.tests.helpers import REPO, tiny_copy


def control_readings(root, cell, seeds, device):
    """The i2vgen-xl program with its temporal norm as published (see
    ``published_norm.py``)."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    wrap = ["v2vbench.tests.published_norm"] if cell.startswith("i2vgen") else []
    proc = subprocess.run([sys.executable, "-m", *wrap, "v2vbench.controls", "--workload", cell,
                           "--seeds", ",".join(map(str, seeds)), "--device", device],
                          cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.strip().splitlines()]


def fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", ["i2vgen-tiny.edit2", "consisti2v-tiny.edit2",
                                  "i2vgen-tiny.invert2"])
def test_control_fails_where_the_program_passes_tiny(tmp_path, cell):
    root = tiny_copy(str(tmp_path))
    for r in control_readings(root, cell, (21, 22, 23), "cpu"):
        assert not fails(r["program"], r["limits"]), r
        assert fails(r["control"], r["limits"]), r


@pytest.mark.card
@pytest.mark.parametrize("cell", ["i2vgen-xl.edit16", "consisti2v.edit16", "i2vgen-xl.invert16",
                                  "i2vgen-xl.invert128"])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        if cell not in {w["name"] for w in json.load(f)["workloads"]}:
            pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    for r in control_readings(REPO, cell, (31, 32, 33), "cuda"):
        assert not fails(r["program"], r["limits"]), r
        assert fails(r["control"], r["limits"]), r
