"""The port's bench entries (``anyv2v_torch/bench.py``,
``anyv2v_torch/bench_backbones.py``) on the tiny architectures on the CPU.

Each backbone's workload runs end to end at 4 frames of 64^2 with short
scans (4 inversion and 2 edit steps measured, 1-step warm-ups) and returns
the JAX entries' record: ``metric``, ``value``, ``unit``, ``vs_baseline``
and ``detail`` (invert, edit, VAE encode and decode seconds, device, mode),
the value the sum of the four phases and the scans projected to 500 and 50
steps. The CLIs print one JSON line per backbone and write no file. These
are CPU times of tiny models, not measurements of the workload.
"""

import functools
import json
import os

import pytest

from anyv2v_torch import bench, bench_backbones

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(device="cpu", frames=4, size=64, inv_steps=4, edit_steps=2, warm_steps=1)
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL = {"invert_s", "edit_s", "vae_encode_s", "vae_decode_s", "device", "mode"}


def _check_record(rec, arch):
    assert set(rec) == KEYS and set(rec["detail"]) == DETAIL
    d = rec["detail"]
    assert rec["unit"] == "s" and rec["vs_baseline"] is None
    assert d["device"] == "cpu" and d["mode"] == "projected"
    assert rec["metric"] == (f"4f 64^2 {arch} invert(500)+pnp-edit(50) wall-clock, CPU "
                             "(projected from warm short scans)")
    parts = [d[k] for k in ("invert_s", "edit_s", "vae_encode_s", "vae_decode_s")]
    assert all(p > 0 for p in parts) and rec["value"] == pytest.approx(sum(parts), rel=1e-12)


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fn,arch", [(bench.bench_i2vgen, "i2vgen-tiny"),
                                     (bench_backbones.bench_consisti2v, "consisti2v-tiny"),
                                     (bench_backbones.bench_seine, "seine-tiny")])
def test_each_backbone_runs_the_workload(one_thread, monkeypatch, fn, arch):
    """The whole protocol on a tiny arch; every scan's projection is its
    measured seconds times 500 / 4 (inversion) or 50 / 2 (edit)."""
    seen = []
    real = bench.timed

    def spy(f):
        out, sec = real(f)
        seen.append(sec)
        return out, sec

    monkeypatch.setattr(bench, "timed", spy)
    rec = fn(arch=arch, **TINY)
    _check_record(rec, arch)
    # timed calls: encode warm + timed, decode warm + timed, then per scan warm + measured
    assert len(seen) == 8
    assert rec["detail"]["vae_encode_s"] == seen[1] and rec["detail"]["vae_decode_s"] == seen[3]
    assert rec["detail"]["invert_s"] == pytest.approx(seen[5] * 500 / 4, rel=1e-12)
    assert rec["detail"]["edit_s"] == pytest.approx(seen[7] * 50 / 2, rel=1e-12)


def test_scan_warms_projects_and_guards(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "timed", lambda f: (f(), 0.5))
    out, sec = bench.scan("s", lambda n: calls.append(n) or n, 20, 500, warm_steps=2)
    assert calls == [2, 20] and out == 20 and sec == pytest.approx(0.5 * 500 / 20)
    assert bench.step_counts(True) == (500, 50) and bench.step_counts(False) == (20, 10)
    # a scan faster than the 10 ms-per-step floor is refused, not recorded
    monkeypatch.setattr(bench, "timed", lambda f: (f(), 0.001))
    with pytest.raises(RuntimeError, match="implausible"):
        bench.scan("s", lambda n: n, 20, 500)


def test_backbones_cli_prints_one_line_per_backbone_and_writes_nothing(
        one_thread, monkeypatch, capsys):
    record = os.path.join(REPO, "BENCH_BACKBONES.json")
    before = os.stat(record).st_mtime_ns if os.path.exists(record) else None
    monkeypatch.setattr(bench_backbones, "BACKBONES", {
        "consisti2v": functools.partial(bench_backbones.bench_consisti2v,
                                        arch="consisti2v-tiny", **TINY),
        "seine": functools.partial(bench_backbones.bench_seine, arch="seine-tiny", **TINY)})
    bench_backbones.main(["seine"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    _check_record(json.loads(lines[0]), "seine-tiny")
    after = os.stat(record).st_mtime_ns if os.path.exists(record) else None
    assert after == before


def test_bench_cli_reads_its_environment(monkeypatch, capsys):
    got = {}
    monkeypatch.setattr(bench, "bench_i2vgen", lambda **kw: got.update(kw) or {"value": 1.0})
    for k, v in {"BENCH_FULL": "1", "BENCH_FRAMES": "128", "BENCH_ARCH": "i2vgen-tiny",
                 "BENCH_PROFILE": "/nonexistent/trace"}.items():
        monkeypatch.setenv(k, v)
    bench.main()
    assert got == {"arch": "i2vgen-tiny", "frames": 128, "full": True,
                   "profile_dir": "/nonexistent/trace"}
    assert json.loads(capsys.readouterr().out) == {"value": 1.0}
