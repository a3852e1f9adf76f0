"""The program's own spans on the device trace's clock: one lightly traced
request, and what the device did under each span.

    python3 -m v2vbench.spans --workload <cell> --seed <n> [--requests 3] [--profiled 1]

The light request (:func:`light_request`) is one ``cell.request`` with the
program's span tracer on (``anyv2v_torch.utils.profiling.tracing``) under
``torch.profiler`` with CUDA activity alone (kernels, copies and the CUDA
runtime calls, no host operator events) and no external correlation, so the
profiler adds little host time. Its window runs on the tracer's clock (epoch ns, the profiler's) from
the call to the return, which ends in ``hard_sync``. A program without the
tracer, or a run on the CPU, gives no reduction (None).

The reduction (:class:`SpanTimeline`) puts down to the innermost program span
open at the time:

- each device operation (kernel, copy, set), at its launch: the runtime call
  of the same correlation id; an operation of no launch event is counted
  apart (``no launch event``);
- each idle gap of the device (between the union of the operations'
  intervals, and at the window's ends), at the gap's start;
- each synchronising runtime call (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``), at
  its start.

It gives the per-layer numbers read by ``v2vbench/metrics/{idle,norm_ms,
conv_ms,dispatch_ms}.py`` from a trace that carries it as ``trace.spans``,
and three tables for the log: device seconds by span (self and total), idle
seconds by span, syncs a UNet forward by span.

The command runs a cell as ``v2vbench.run`` sets it up, ``--requests``
untraced requests (their lengths: what the light request's length is held
to), with ``--profiled 1`` the harness's profiled request (its syncs a
forward, in the harness's spans), then the light request; its last line is
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

OUTSIDE = "outside every span"
NO_LAUNCH = "no launch event"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def innermost(spans, times) -> list:
    """For each of ``times`` (ascending), the index of the innermost span
    open then (``start <= t < end``), or -1. ``spans``: one thread's nested
    spans in the order they were opened (``.start_ns``, ``.end_ns``)."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].start_ns <= t:
            while stack and spans[stack[-1]].end_ns <= spans[j].start_ns:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]].end_ns <= t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def ancestry(spans, i):
    """Span ``i`` and its ancestors, innermost first (none for -1)."""
    while i >= 0:
        yield i
        i = spans[i].parent


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class SpanTimeline:
    """One request's device timeline put down to the program's spans.

    ``spans``: the tracer's spans (``name``, ``start_ns``, ``end_ns``,
    ``parent``); ``ops``: device operations ``(name, start_ns, end_ns,
    correlation)``; ``launches``: correlation -> the launching runtime
    call's start; ``syncs``: synchronising runtime calls ``(name, start_ns,
    end_ns)``; ``window``: the request's ``(start_ns, end_ns)``. Every time
    is on one clock."""

    def __init__(self, spans, ops, launches: dict, syncs, window):
        self.spans = list(spans)
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e9
        ops = [o for o in ops if o[2] > w0 and o[1] < w1]
        self.device_ops = len(ops)
        self.op_s = sum(e - s for _, s, e, _ in ops) / 1e9
        names = [s.name for s in self.spans]

        def label(i):
            return names[i] if i >= 0 else OUTSIDE

        def chain(i):
            """The distinct names of span i and its ancestors."""
            return list(dict.fromkeys(names[k] for k in ancestry(self.spans, i))) or [OUTSIDE]

        # device seconds by the span that launched each operation
        launched = sorted((launches[c], e - s) for _, s, e, c in ops if c in launches)
        self.self_s, self.total_s = {}, {}
        for (_, d), i in zip(launched, innermost(self.spans, [t for t, _ in launched])):
            self.self_s[label(i)] = self.self_s.get(label(i), 0.0) + d / 1e9
            for n in chain(i):
                self.total_s[n] = self.total_s.get(n, 0.0) + d / 1e9
        orphan = sum(e - s for _, s, e, c in ops if c not in launches) / 1e9
        if orphan:
            self.self_s[NO_LAUNCH] = self.total_s[NO_LAUNCH] = orphan

        # idle gaps, by the span the host was in when the device went idle
        busy = _union([(max(s, w0), min(e, w1)) for _, s, e, _ in ops])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = sorted((edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                      if edges[k + 1] > edges[k])
        self.idle_by = {}
        for (s, e), i in zip(gaps, innermost(self.spans, [s for s, _ in gaps])):
            self.idle_by[label(i)] = self.idle_by.get(label(i), 0.0) + (e - s) / 1e9

        # synchronising calls: by span, and their time inside each UNet forward
        syncs = sorted((x for x in syncs if w0 <= x[1] < w1), key=lambda x: x[1])
        self.forwards = [i for i, n in enumerate(names) if n == "unet.forward"]
        self.syncs_by = {}
        waits = {i: 0 for i in self.forwards}
        self.unet_syncs = 0
        for (_, s, e), i in zip(syncs, innermost(self.spans, [x[1] for x in syncs])):
            self.syncs_by[label(i)] = self.syncs_by.get(label(i), 0) + 1
            fwd = next((k for k in ancestry(self.spans, i) if k in waits), None)
            if fwd is not None:
                self.unet_syncs += 1
                waits[fwd] += min(e, self.spans[fwd].end_ns) - s
        self.dispatch_s = [(self.spans[k].end_ns - self.spans[k].start_ns - waits[k]) / 1e9
                           for k in self.forwards]

    # -- the per-layer numbers ------------------------------------------------------

    def idle_pct(self):
        """The device's idle share of the request's window, in %."""
        return 100.0 * (1.0 - self.busy_s / self.window_s) if self.window_s > 0 else None

    def device_ms(self, name: str):
        """Device ms of the operations launched inside spans ``name``."""
        return 1e3 * self.total_s.get(name, 0.0)

    def dispatch_ms(self):
        """Host ms a UNet forward, less the synchronising calls' time in it."""
        return 1e3 * statistics.mean(self.dispatch_s) if self.dispatch_s else None

    def syncs_per_forward(self):
        return self.unet_syncs / len(self.forwards) if self.forwards else None

    def outside_pct(self):
        """The share of device time launched outside every span, in %."""
        return 100.0 * self.self_s.get(OUTSIDE, 0.0) / self.op_s if self.op_s else None

    def tables(self) -> str:
        n = len(self.forwards) or 1
        rows = ["device s by span (self / total):"]
        rows += [f"  {k:<20} {self.self_s.get(k, 0.0):10.4f} {self.total_s.get(k, 0.0):10.4f}"
                 for k in sorted(self.total_s, key=lambda k: -self.total_s[k])]
        rows += [f"  sum of self {sum(self.self_s.values()):.4f} s; device ops {self.op_s:.4f} s"
                 f" ({self.device_ops} ops); outside every span {self.outside_pct():.3f} %"]
        rows += ["idle s by span:"]
        rows += [f"  {k:<20} {v:10.4f}" for k, v in sorted(self.idle_by.items(),
                                                            key=lambda kv: -kv[1])]
        rows += [f"syncs a forward by span ({len(self.forwards)} forwards):"]
        rows += [f"  {k:<20} {v / n:10.3f}" for k, v in sorted(self.syncs_by.items(),
                                                              key=lambda kv: -kv[1])]
        return "\n".join(rows)

    def summary(self) -> dict:
        return {"idle_pct": self.idle_pct(), "norm_ms": self.device_ms("layer.norm"),
                "conv_ms": self.device_ms("layer.conv"), "dispatch_ms": self.dispatch_ms(),
                "syncs_per_forward": self.syncs_per_forward(), "forwards": len(self.forwards),
                "window_s": self.window_s, "busy_s": self.busy_s, "device_op_s": self.op_s,
                "attributed_s": sum(self.self_s.values()), "outside_pct": self.outside_pct(),
                "device_ops": self.device_ops, "spans": len(self.spans),
                "self_s": self.self_s, "total_s": self.total_s, "idle_s": self.idle_by,
                "syncs": self.syncs_by}


def from_kineto(events, spans, window) -> SpanTimeline:
    """A :class:`SpanTimeline` from ``torch.profiler``'s kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, launches, syncs = [], {}, []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == cuda:
            if not (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                ops.append((name, s, end, e.correlation_id()))
        elif name in SYNCS:
            syncs.append((name, s, end))
            launches[e.correlation_id()] = s
        elif name.startswith("cu"):
            launches[e.correlation_id()] = s
    return SpanTimeline(spans, ops, launches, syncs, window)


def light_request(cell, index: int):
    """``cell.request(index)`` under the program's tracer and, on a card,
    ``torch.profiler`` with CUDA activity alone. Returns (the request's
    seconds on the tracer's clock, its :class:`SpanTimeline` or None: on the
    CPU, and where the program has no tracer)."""
    try:
        from anyv2v_torch.utils import profiling
        tracing, clock = profiling.tracing, profiling.clock_ns
    except (ImportError, AttributeError):
        return None, None
    if cell.device.type != "cuda":
        with tracing(request=index):
            t0 = clock()
            cell.request(index)
            return (clock() - t0) / 1e9, None
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    # no external correlation: the runtime calls' own correlation ids link the
    # launches; with it on a request ran 9.8 % longer, without it 2.9 % (PERF.md §6)
    light = dict(activities=[ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(disable_external_correlation=True))
    with tracing(request=index) as tracer, profile(**light) as prof:
        w0 = clock()
        cell.request(index)
        w1 = clock()
    timeline = from_kineto(prof.profiler.kineto_results.events(), tracer.take(), (w0, w1))
    return (w1 - w0) / 1e9, timeline


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--profiled", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from . import manifest

    torch.set_num_threads(run.THREADS)
    spec = manifest.cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("v2vbench.spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    card = run.power_limit() if device.type == "cuda" else "cpu"
    cell = manifest.adapter(spec["config"]).Cell(spec["config"], spec["traffic"], args.seed,
                                                 device)
    cell.warm()
    run.log(f"{args.workload}: seed {args.seed}; set up; {card}")
    lengths, _ = run.closed_loop(cell.request, float("inf"), max_requests=args.requests)
    run.log(f"untraced requests {lengths}")
    out = {"workload": args.workload, "seed": args.seed, "card": card, "untraced_s": lengths}
    if args.profiled and device.type == "cuda":
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from . import trace as trace_mod

        shapes = trace_mod.Shapes(manifest.kernel_families())
        with trace_mod.spans(cell), shapes, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("request"):
                cell.request(len(lengths))
            out["profiled_s"] = time.perf_counter() - t0
        tr = trace_mod.Trace(prof.profiler.kineto_results.events(), shapes, 0, (1, 1.0))
        out["profiled_host_syncs"] = tr.syncs_per_forward()
        del prof
    t0 = time.perf_counter()
    seconds, timeline = light_request(cell, len(lengths) + 1)
    run.log(f"light request {seconds!r} s (host clock {time.perf_counter() - t0:.3f} s); "
            f"reduced: {timeline is not None}")
    out["light_s"] = seconds
    out["light_over_untraced"] = seconds / statistics.median(lengths) if seconds else None
    if timeline is not None:
        print(timeline.tables(), file=sys.stderr)
        out.update(timeline.summary())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
