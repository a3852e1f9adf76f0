"""The last line of a run: exactly the keys the benchmark's contract names (and the
compared numbers last), the metrics of the cell, and no result without a
card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from v2vbench.tests.helpers import REPO, run_cell, tiny_copy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def first_cell() -> str:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)["workloads"][0]["name"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("v2vbench")))


def test_untraced_line(copy):
    rc, result, err = run_cell(copy, "i2vgen-tiny.invert2")
    assert rc == 0, err[-3000:]
    assert list(result) == KEYS + ["checks"]
    assert set(result["metrics"]) == {"invert_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    tail = [line for line in err.strip().splitlines()][-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_traced_line(copy):
    rc, result, err = run_cell(copy, "i2vgen-tiny.edit2", trace=1)
    assert rc == 0, err[-3000:]
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "edit_s" not in result["metrics"] and "mfu.edit" in result["metrics"]


def test_no_result_without_a_card():
    """Asked for the card on a machine without one (this one), the run
    exits with an error and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "v2vbench.run", "--workload", first_cell(),
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark alone, no result."""
    import shutil

    shutil.copytree(os.path.join(REPO, "v2vbench"), tmp_path / "v2vbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "v2vbench.run", "--workload", first_cell(),
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert json.load(open(tmp_path / "BENCHMARK.json"))
