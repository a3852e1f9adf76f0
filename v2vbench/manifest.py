"""``BENCHMARK.json`` and the files it names, found by name: a configuration
by its ``file``, a traffic mix at ``v2vbench/traffic/<traffic>.json``, a
cell's limits at ``v2vbench/limits/<cell>.json``, a per-layer metric's reader
at ``v2vbench/metrics/<metric>.py`` (or ``<base>.py`` for a split quantity), an adapter at
``v2vbench/backbones/<backbone>.py`` and every kernel family in
``v2vbench/kernels/``. A later cell, mix, metric or family is a new file and
a new entry; no file here changes for it."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: str = ROOT) -> dict:
    """Everything one run of ``workload`` reads."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry,
            "config": _json(os.path.join(root, conf["file"])),
            "traffic": _json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")),
            "limits": _json(os.path.join(HERE, "limits", f"{workload}.json")),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
            "per_layer": [m for m in bench["per_layer"] if applies(m, workload)]}


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adapter(config: dict):
    """The backbone adapter's module (its ``Cell`` class)."""
    return importlib.import_module(f"v2vbench.backbones.{config['backbone']}")


def metric_reader(name: str):
    """``metrics/<name>.py``, or where there is none the reader of the
    quantity that the name splits, ``metrics/<base>.py`` (the name up to its
    first dot: ``mfu.edit`` and ``mfu.invert`` read by ``mfu.py``)."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return load_file(path, f"v2vbench_metric_{stem}")
    raise FileNotFoundError(f"no reader for the metric {name!r} in v2vbench/metrics/")


def kernel_families() -> dict:
    """Name -> module of every file in ``v2vbench/kernels/``."""
    folder = os.path.join(HERE, "kernels")
    return {n[:-3]: load_file(os.path.join(folder, n), f"v2vbench_kernel_{n[:-3]}")
            for n in sorted(os.listdir(folder)) if n.endswith(".py") and not n.startswith("_")}
