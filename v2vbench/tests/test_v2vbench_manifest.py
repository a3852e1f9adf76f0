"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from v2vbench import manifest
from v2vbench.tests.helpers import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
PL_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["v2vbench"] and bench["command"][:2] == ["python3", "-m"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_the_contract(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[k]}) == len(bench[k])
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS and c["file"].startswith("v2vbench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == WORKLOAD_KEYS and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == PL_KEYS and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in bench["end_to_end"] if manifest.applies(m, w["name"])}
        pl = [m for m in bench["per_layer"] if manifest.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and pl
        assert all(m["moves"] in e2e for m in pl)


def test_files_load_by_name(bench):
    for w in bench["workloads"]:
        spec = manifest.cell(w["name"])
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["request"] in ("edit", "invert")
        assert set(spec["limits"]) <= {"encode", "unet", "step", "decode", "traj_row"}
        assert manifest.adapter(spec["config"]).Cell
        for m in spec["per_layer"]:
            assert callable(manifest.metric_reader(m["name"]).read)
    fams = manifest.kernel_families()
    assert {"k1", "k2", "k2long", "k3", "k4", "k5"} <= set(fams)
    for fam in fams.values():
        assert fam.PATTERNS and fam.WRAP and callable(fam.cost)


@pytest.mark.parametrize("name,arch", [("i2vgen-xl", "i2vgen-xl"), ("consisti2v", "consisti2v")])
def test_configurations_are_the_programs(name, arch):
    """The configuration files hold the program's published configurations,
    field for field (as they are run)."""
    import dataclasses

    from anyv2v_torch.utils.model_zoo import ARCHS

    with open(os.path.join(REPO, "v2vbench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    for part in ("unet", "vae"):
        zoo = dataclasses.asdict(ARCHS[arch][part])
        zoo.pop("dtype")
        want = json.loads(json.dumps(zoo))
        have = {k: conf[part].get(k, want[k]) for k in want}
        assert have == want, part
        assert set(conf[part]) <= set(want)
