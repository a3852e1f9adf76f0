"""Profiling hooks (counterpart of ``anyv2v_tpu/utils/profiling.py``): a
``torch.profiler`` trace, per-phase wall-clock timers, and the program's own
spans.

Usage:
    with trace_if("/tmp/trace"):           # no-op when dir is falsy
        run_hot_loop()

    timers = PhaseTimers("cuda")
    out = {}
    with timers.phase("invert", sync=out):
        out["trajectory"] = ...
    timers.report()   # {"invert": 12.3, ...}

    with tracing(request="edit 3") as spans:   # the program's spans, on
        pipe.sample_with_pnp(...)
    rows = spans.take()                        # [Span(name, start_ns, ...), ...]

The trace is a Chrome trace (``chrome://tracing``, Perfetto) with the
device's kernels, the host's calls, and the program's spans on a track of
their own.

Spans. The program opens a span at each of its layer boundaries
(``with span("pipe.step"):``, or ``@spanned("unet.forward")`` on a whole
function), under one of the names of
:data:`SPAN_NAMES`. While tracing is off (the default) ``span`` reads one
module global and returns a shared null context: it allocates nothing,
records nothing and does no device work. Inside :func:`tracing` each span
records its name, its start and end on :func:`clock_ns` (epoch nanoseconds,
the clock of ``torch.profiler``'s events, so a span and a profiler event of
the same host interval compare directly), the index of its parent (the
span it opened inside) and the request identifier the tracer holds. Spans
are host intervals: they never synchronise, so a span's length is the
host's time to issue its work, and the device work it launched is found
through the profiler's launch events. One thread's spans: the program
issues its work from one thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from typing import Dict, List, Optional

import torch

from .benchguard import hard_sync

# Every span the program opens, outside in:
SPAN_NAMES = (
    "pipe.edit",        # a PnP edit (``sample_with_pnp``)
    "pipe.invert",      # a DDIM inversion
    "pipe.segment",     # a run of edit steps with one injection pattern, or the guided tail
    "pipe.step",        # one denoising or inversion step
    "pipe.guide",       # the CFG combine and the DDIM update after the UNet
    "pipe.encode",      # ``encode_video``
    "pipe.decode",      # ``decode_latents``
    "traj.to_device",   # host trajectory rows to the device
    "traj.to_host",     # a trajectory chunk to the host (``HostTrajectory.append``)
    "unet.forward",     # one UNet forward
    "unet.embed",       # timestep, frame-stride / fps and first-frame or image embeddings
    "unet.resnet",      # a spatial or temporal resnet block
    "unet.spatial",     # a spatial transformer block
    "unet.temporal",    # a temporal transformer block
    "layer.norm",       # ``group_norm``, ``layer_norm``
    "layer.conv",       # ``conv_nhwc``, its permutes and copy included
    "layer.attn",       # the attention dispatcher's entries
    "layer.ffn",        # a feed-forward
    "layer.tconv",      # groupnorm + SiLU + (3,1,1) temporal conv
    "layer.rotary",     # rotary positions of a temporal attention
    "vae.encode",       # ``AutoencoderKL.encode_moments``
    "vae.decode",       # ``AutoencoderKL.decode``
)
_KNOWN = frozenset(SPAN_NAMES)

clock_ns = time.time_ns   # the spans' clock: epoch ns, as torch.profiler's events


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span. ``parent``: the index, in the same list, of the
    span it was opened inside; -1 for none."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: object


class SpanTracer:
    """The spans of the calls made while it is on, in the order they were
    opened. ``request``: the identifier each new span records; the caller
    may change it between requests."""

    def __init__(self, request=None) -> None:
        self.request = request
        self._rows: list = []     # [name, start, end, parent, request]
        self._open: List[int] = []

    def _begin(self, name: str) -> int:
        if name not in _KNOWN:
            raise ValueError(f"span {name!r} is not in SPAN_NAMES")
        i = len(self._rows)
        self._rows.append([name, clock_ns(), 0, self._open[-1] if self._open else -1,
                           self.request])
        self._open.append(i)
        return i

    def _end(self, i: int) -> None:
        self._rows[i][2] = clock_ns()
        self._open.pop()

    def take(self) -> List[Span]:
        """The spans recorded so far, which the tracer then forgets. Raises
        while a span is open (its parent links would point past the list)."""
        if self._open:
            raise RuntimeError(f"{len(self._open)} span(s) still open")
        rows, self._rows = self._rows, []
        return [Span(*r) for r in rows]


class _Open:
    __slots__ = ("tracer", "name", "index")

    def __init__(self, tracer: SpanTracer, name: str) -> None:
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.index = self.tracer._begin(self.name)

    def __exit__(self, *exc):
        self.tracer._end(self.index)


_OFF = contextlib.nullcontext()
_tracer: Optional[SpanTracer] = None   # the tracer that is on, or None


def span(name: str):
    """The context of one program span ``name`` (one of :data:`SPAN_NAMES`):
    the shared null context while tracing is off."""
    t = _tracer
    if t is None:
        return _OFF
    return _Open(t, name)


def spanned(name: str):
    """A decorator: every call of the function inside :func:`span` ``name``;
    while tracing is off, the one check and the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = _tracer
            if t is None:
                return fn(*args, **kwargs)
            with _Open(t, name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def tracing(request=None):
    """Turn the span tracer on for the block and yield it; its spans stay in
    it until :meth:`SpanTracer.take`. ``request``: the identifier the spans
    record."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("span tracing is already on")
    _tracer = tracer = SpanTracer(request)
    try:
        yield tracer
    finally:
        _tracer = None


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's self time: its length less its children's (a child lies
    inside its parent, and siblings do not overlap)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def add_spans_to_chrome_trace(path: str, spans: List[Span]) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    of a process of their own ("anyv2v_torch spans", one thread per
    request), on the trace's clock (its ``ts`` microseconds after
    ``baseTimeNanoseconds``, epoch microseconds where it has none)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = 1 + max([e["pid"] for e in events if isinstance(e.get("pid"), int)], default=0)
    tids: Dict[object, int] = {}
    events += [{"ph": "M", "name": "process_name", "pid": pid, "args": {"name":
                                                                          "anyv2v_torch spans"}},
               {"ph": "M", "name": "process_sort_index", "pid": pid, "args": {"sort_index": -1}}]
    for s in spans:
        tid = tids.setdefault(s.request, len(tids))
        events.append({"ph": "X", "cat": "anyv2v_torch", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"parent": s.parent, "request": str(s.request)}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]):
    """``torch.profiler.profile`` over the CPU and CUDA activities, with the
    program's spans on, its Chrome trace written to ``trace_dir/trace.json``
    with the spans added (:func:`add_spans_to_chrome_trace`), when
    ``trace_dir`` is set; else nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing("trace_if") as spans, profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    add_spans_to_chrome_trace(path, spans.take())


class PhaseTimers:
    """Named wall-clock phases with device-sync boundaries on ``device``."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block. ``sync``: the phase's outputs (tensors, nested
        containers, a HostTrajectory), passed to :func:`hard_sync` at exit,
        so the timer covers the device work that made them and raises on a
        non-finite output; a container the block fills is read as it is at
        exit. Without ``sync``, a CUDA device is synchronised at exit. A CUDA
        device is also synchronised at entry, so the phase does not take on
        earlier queued work."""
        self._drain()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                hard_sync(sync)
            else:
                self._drain()
            self.seconds[name] = self.seconds.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self.seconds.items()}
