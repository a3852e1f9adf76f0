"""The reduction of the light request (``v2vbench/spans.py``) and its readers.

On a synthetic timeline with a span nested in another, the reduction puts
each device operation down to the span that launched it (self and total),
each idle gap to the span the host was in when the device went idle, each
synchronising call to its span, and gives the four per-layer numbers. On the
CPU the light request runs with the program's tracer and gives no numbers,
and a traced run of the harness keeps its line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from anyv2v_torch.utils.profiling import Span
from v2vbench import manifest, spans
from v2vbench.tests.helpers import LIMITS, REPO, run_cell, tiny_copy

US = 1000   # the synthetic times are in us, the timeline's in ns
NEW = ("idle.edit", "norm_ms.edit", "conv_ms.edit", "dispatch_ms.edit")


def _spans():
    rows = [("pipe.edit", 0, 1000, -1), ("unet.forward", 100, 500, 0),
            ("layer.norm", 150, 200, 1), ("layer.conv", 250, 300, 1),
            ("layer.norm", 260, 280, 3), ("unet.forward", 600, 900, 0),
            ("layer.conv", 650, 700, 5)]
    return [Span(n, s * US, e * US, p, 0) for n, s, e, p in rows]


# (name, device start, device end, correlation) and each correlation's launch
OPS = [("a", 210, 260, 1), ("b", 300, 330, 2), ("c", 330, 350, 3), ("d", 400, 500, 4),
       ("e", 700, 800, 5), ("f", 1100, 1150, 6), ("g", 1150, 1160, 99)]
LAUNCH = {1: 160, 2: 255, 3: 270, 4: 120, 5: 660, 6: 1050}
SYNC = [("cudaStreamSynchronize", 170, 190), ("cudaMemcpy", 680, 720),
        ("cudaDeviceSynchronize", 1060, 1090)]


@pytest.fixture
def timeline():
    return spans.SpanTimeline(
        _spans(), [(n, s * US, e * US, c) for n, s, e, c in OPS],
        {c: t * US for c, t in LAUNCH.items()},
        [(n, s * US, e * US) for n, s, e in SYNC], (0, 1200 * US))


def _us(d: dict) -> dict:
    return {k: round(v * 1e6, 6) for k, v in d.items()}


def test_innermost_open_span():
    got = spans.innermost(_spans(), [t * US for t in (0, 150, 199, 200, 265, 280, 500, 650,
                                                     999, 1000)])
    assert got == [0, 2, 2, 1, 4, 3, 0, 6, 0, -1]


def test_device_time_by_span(timeline):
    assert _us(timeline.self_s) == {"layer.norm": 70, "layer.conv": 130, "unet.forward": 100,
                                    spans.OUTSIDE: 50, spans.NO_LAUNCH: 10}
    assert _us(timeline.total_s) == {"layer.norm": 70, "layer.conv": 150, "unet.forward": 300,
                                     "pipe.edit": 300, spans.OUTSIDE: 50, spans.NO_LAUNCH: 10}
    assert sum(timeline.self_s.values()) == pytest.approx(timeline.op_s) == 360e-6
    assert timeline.device_ops == 7
    assert timeline.outside_pct() == pytest.approx(100 * 50 / 360)


def test_idle_gaps_by_span(timeline):
    assert _us(timeline.idle_by) == {"pipe.edit": 410, "layer.norm": 40, "unet.forward": 350,
                                     spans.OUTSIDE: 40}
    assert timeline.busy_s == pytest.approx(360e-6) and timeline.window_s == 1200e-6
    assert timeline.idle_pct() == pytest.approx(70.0)


def test_syncs_and_dispatch(timeline):
    assert timeline.syncs_by == {"layer.norm": 1, "layer.conv": 1, spans.OUTSIDE: 1}
    assert timeline.syncs_per_forward() == 1.0
    # (400 - 20) and (300 - 40) us of host time a forward
    assert timeline.dispatch_ms() == pytest.approx(0.32)
    assert "layer.conv" in timeline.tables() and json.dumps(timeline.summary())


def test_readers(timeline):
    want = {"idle.edit": 70.0, "norm_ms.edit": 0.07, "conv_ms.edit": 0.15,
            "dispatch_ms.edit": 0.32}
    for name, value in want.items():
        reader = manifest.metric_reader(name)
        assert reader.read(SimpleNamespace(spans=timeline)) == pytest.approx(value)
        assert reader.read(SimpleNamespace()) is None


class _Event:
    def __init__(self, name, start, dur, cuda, corr, annotation=False):
        self._v = (name, start, dur, cuda, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_from_kineto_events():
    events = [_Event("cudaLaunchKernel", 160 * US, 5 * US, False, 1),
              _Event("kernel_a", 210 * US, 50 * US, True, 1),
              _Event("cudaMemcpy", 680 * US, 40 * US, False, 2),
              _Event("Memcpy DtoH", 690 * US, 20 * US, True, 2),
              _Event("request", 0, 1000 * US, True, 0, annotation=True)]
    tl = spans.from_kineto(events, _spans(), (0, 1200 * US))
    assert tl.device_ops == 2
    assert _us(tl.self_s) == {"layer.norm": 50, "layer.conv": 20}
    assert tl.syncs_by == {"layer.conv": 1}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("v2vbench")))


def test_light_request_on_the_cpu_gives_no_numbers(copy):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "v2vbench.spans", "--workload",
                           "consisti2v-tiny.edit2", "--seed", "2147483911", "--requests", "1",
                           "--device", "cpu"], cwd=copy, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["light_s"] > 0 and len(out["untraced_s"]) == 1
    assert not {"idle_pct", "norm_ms", "conv_ms", "dispatch_ms"} & set(out)


def test_traced_line_keeps_its_keys(copy):
    rc, result, err = run_cell(copy, "consisti2v-tiny.edit2", trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["checks"]) == set(LIMITS["edit"])
    assert {"mfu.edit", "host_syncs.edit", "vae_ms.edit"} <= set(result["metrics"])
    assert not set(NEW) & set(result["metrics"])
