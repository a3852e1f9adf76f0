"""The port's span tracer (``anyv2v_torch/utils/profiling.py``) and the spans
the program opens.

The tracer: nesting, parent links, request identifiers, self times (a span
less its children), nothing recorded while it is off, names outside
``SPAN_NAMES`` refused, and its clock shared with ``torch.profiler`` (a
``record_function`` block inside a span lands inside it to 50 us). The
program: tiny i2vgen and ConsistI2V pipelines, one host-store inversion and
one edit from it each, with the frames encoded and the edit decoded, give
bitwise the same outputs with tracing on and off, open only names of
``SPAN_NAMES``, and nest them as the layers nest.
"""

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from anyv2v_torch.utils import profiling
from anyv2v_torch.utils.model_zoo import build_consisti2v_pipeline, build_i2vgen_pipeline
from anyv2v_torch.utils.profiling import SPAN_NAMES, span, tracing

CLOCK_SLACK_NS = 50_000


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ticks(monkeypatch):
    """The tracer's clock as a counter: 0, 10, 20, ..."""
    state = {"t": -10}

    def clock():
        state["t"] += 10
        return state["t"]

    monkeypatch.setattr(profiling, "clock_ns", clock)


def test_nesting_parents_requests_and_self_time(ticks):
    with tracing(request="r1") as tracer:
        with span("pipe.edit"):                 # 0 .. 70
            with span("pipe.step"):             # 10 .. 40
                with span("unet.forward"):      # 20 .. 30
                    pass
            tracer.request = "r2"
            with span("pipe.guide"):            # 50 .. 60
                pass
        with span("pipe.decode"):               # 80 .. 90
            pass
    spans = tracer.take()
    assert [s.name for s in spans] == ["pipe.edit", "pipe.step", "unet.forward", "pipe.guide",
                                       "pipe.decode"]
    assert [(s.start_ns, s.end_ns) for s in spans] == [(0, 70), (10, 40), (20, 30), (50, 60),
                                                       (80, 90)]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.request for s in spans] == ["r1", "r1", "r1", "r2", "r2"]
    assert profiling.self_ns(spans) == [70 - 30 - 10, 30 - 10, 10, 10, 10]
    assert tracer.take() == []


def test_off_records_nothing_and_shares_one_null_context():
    assert profiling._tracer is None
    assert span("layer.norm") is span("unet.forward") is profiling._OFF
    with span("layer.norm"):
        torch.ones(3).sum()
    with tracing() as tracer:
        pass
    assert tracer.take() == []
    assert profiling._tracer is None


def test_refuses_unknown_names_open_takes_and_nested_tracing():
    with pytest.raises(RuntimeError, match="already on"):
        with tracing():
            with tracing():
                pass
    assert profiling._tracer is None
    with tracing() as tracer:
        with pytest.raises(ValueError, match="SPAN_NAMES"):
            with span("layer.nope"):
                pass
        with span("pipe.edit"):
            with pytest.raises(RuntimeError, match="still open"):
                tracer.take()
    assert [s.name for s in tracer.take()] == ["pipe.edit"]


def test_spans_share_the_profiler_clock():
    """A ``record_function`` block inside a program span, under the CPU
    profiler, lies inside that span to within 50 us at either end."""
    with tracing() as tracer, profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with span("layer.conv"):
                with record_function("inner_block"):
                    torch.ones(256).cumsum(0)
    spans = tracer.take()
    inner = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() == "inner_block")
    assert len(spans) == len(inner) == 5
    for s, (a, b) in zip(spans, inner):
        assert a >= s.start_ns - CLOCK_SLACK_NS and b <= s.end_ns + CLOCK_SLACK_NS


def _i2vgen_run():
    pipe = build_i2vgen_pipeline("i2vgen-tiny", device="cpu", seed=3, dtype=torch.float32,
                                 components=("unet", "vae"))
    dim = pipe.unet.config.cross_attention_dim
    rng = np.random.RandomState(0)
    frames01 = rng.rand(2, 64, 64, 3).astype(np.float32)
    text = torch.from_numpy(rng.randn(1, 6, dim).astype(np.float32))
    img_emb = torch.from_numpy(rng.randn(1, 1, dim).astype(np.float32))

    def run():
        latents = pipe.encode_video(frames01)
        img_lat = pipe.prepare_image_latents(frames01[0], 2)
        traj, inv_ts = pipe.invert(latents, text, img_lat, img_emb, num_inversion_steps=4,
                                   traj_store="host", chunk_steps=2)
        rows3 = [torch.cat([x] * 3) for x in (text, img_lat, img_emb)]
        edited = pipe.sample_with_pnp(traj, inv_ts, *rows3, num_inference_steps=4)
        return [latents, np.asarray(traj), edited, pipe.decode_latents(edited)]

    return run


def _consisti2v_run():
    pipe = build_consisti2v_pipeline("consisti2v-tiny", device="cpu", seed=3,
                                     dtype=torch.float32, components=("unet", "vae"))
    dim = pipe.unet.config.cross_attention_dim
    rng = np.random.RandomState(1)
    frames01 = rng.rand(3, 64, 64, 3).astype(np.float32)
    text = torch.from_numpy(rng.randn(1, 6, dim).astype(np.float32))

    def run():
        latents = pipe.encode_video(frames01)
        traj, inv_ts = pipe.invert(latents, text, num_inversion_steps=4, traj_store="host",
                                   chunk_steps=2)
        ff = latents[:, :1]
        edited = pipe.sample_with_pnp(traj, inv_ts, torch.cat([text] * 3), ff, ff,
                                      num_inference_steps=4, t_idx=0)
        return [latents, np.asarray(traj), edited, pipe.decode_latents(edited)]

    return run


def _ancestors(spans, i):
    out = []
    while spans[i].parent >= 0:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


@pytest.mark.parametrize("make", [_i2vgen_run, _consisti2v_run], ids=["i2vgen", "consisti2v"])
def test_pipelines_equal_with_tracing_on_and_off(one_thread, make):
    run = make()
    with torch.inference_mode():
        off = run()
        with tracing(request=7) as tracer:
            on = run()
    spans = tracer.take()
    for a, b in zip(off, on):
        a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
        assert a.dtype == b.dtype and torch.equal(a, b)

    names = {s.name for s in spans}
    assert names <= set(SPAN_NAMES)
    assert {"pipe.encode", "pipe.decode", "pipe.invert", "pipe.edit", "pipe.segment",
            "pipe.step", "pipe.guide", "traj.to_host", "traj.to_device", "unet.forward",
            "unet.embed", "unet.resnet", "unet.spatial", "unet.temporal", "layer.norm",
            "layer.conv", "layer.attn", "vae.encode", "vae.decode"} <= names
    assert all(s.request == 7 and s.start_ns <= s.end_ns for s in spans)
    count = {n: sum(s.name == n for s in spans) for n in names}
    assert count["pipe.invert"] == count["pipe.edit"] == 1
    assert count["unet.forward"] == count["pipe.step"] == 4 + 4
    assert count["traj.to_host"] == 2                      # one copy per chunk of 2 steps
    for i, s in enumerate(spans):
        up = _ancestors(spans, i)
        if s.name.startswith(("unet.", "layer.")) and s.name != "unet.forward":
            assert "unet.forward" in up or "vae.encode" in up or "vae.decode" in up, s.name
        if s.name == "unet.forward":
            assert up[0] == "pipe.step", up
        if s.name == "pipe.step":
            assert up[0] in ("pipe.segment", "pipe.invert"), up
        if s.name == "pipe.segment":
            assert up == ["pipe.edit"]
        if s.name.startswith("vae."):
            assert up[0] in ("pipe.encode", "pipe.decode"), up
    self_ns = profiling.self_ns(spans)
    assert all(v >= 0 for v in self_ns)


def test_i2vgen_norms_and_k1_run_under_their_spans(one_thread, monkeypatch):
    """A tiny i2vgen encode, inversion, edit and decode with tracing on:
    every norm over a clip (a KN ``group_norm`` call on ``[B, F*H*W, C]``)
    runs inside a ``layer.norm`` span directly under ``unet.temporal``, one
    a temporal transformer; every K1 call (``folded_attention``) runs
    inside ``layer.attn``; and of the CPU profiler's operations fewer than
    1 % start outside every span."""
    from anyv2v_torch.ops import attention, norm

    calls = []

    def recorder(kind, fn):
        def call(x, *args, **kwargs):
            t0 = profiling.clock_ns()
            out = fn(x, *args, **kwargs)
            calls.append((kind, x.dim(), t0, profiling.clock_ns()))
            return out
        return call

    monkeypatch.setattr(norm, "group_norm", recorder("kn", norm.group_norm))
    monkeypatch.setattr(attention, "folded_attention",
                        recorder("k1", attention.folded_attention))
    run = _i2vgen_run()
    with torch.inference_mode(), tracing() as tracer, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = tracer.take()

    def inside(t0, t1, name):
        return [i for i, s in enumerate(spans)
                if s.name == name and s.start_ns <= t0 and t1 <= s.end_ns]

    clip = [c for c in calls if c[0] == "kn" and c[1] == 3]
    k1 = [c for c in calls if c[0] == "k1"]
    assert clip and k1
    assert len(clip) == sum(s.name == "unet.temporal" for s in spans)
    for _, _, t0, t1 in clip:
        norms = inside(t0, t1, "layer.norm")
        assert norms and spans[spans[norms[-1]].parent].name == "unet.temporal"
    for _, _, t0, t1 in k1:
        assert inside(t0, t1, "layer.attn")
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    outside = [o for o in ops
               if not any(s.start_ns <= o[0] <= s.end_ns for s in spans if s.parent < 0)]
    assert ops and len(outside) < 0.01 * len(ops)
