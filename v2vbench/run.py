"""Run one cell of ``BENCHMARK.json`` once, on one NVIDIA GPU:

    python3 -m v2vbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``): the process's imports, the weights drawn from the seed
on the device, the program's modules loaded with them, the cell's inputs,
and one short warm-up request over every shape the window uses. The kernel
library is built into the checkout's ``build/anyv2v_torch/`` by the first
run of a checkout and loaded by every later one.

Window: one client in a closed loop, requests of the cell's traffic one
after another; a request ends when :func:`v2vbench.benchguard.hard_sync` has
waited for its outputs. No request starts that the previous one's length
says would end after ``--seconds``; the window holds at least one. With
``--trace 1`` one more request follows the window, under ``torch.profiler``
and the harness's spans: the per-layer metrics are read from it, and those
that are rates (``mfu``) over the untraced window, which the profiler's host
time does not stretch.

After the window: one finished request, drawn from the seed, is checked
against the plain reference (``v2vbench/reference``) in float32, once the
peak memory has been read and the program freed: ``correct`` is whether
every number of :func:`v2vbench.cell.compare` is within the cell's limit
(``v2vbench/limits/<cell>.json``). The last lines on standard error and the
last key of the result give each number beside its limit.

The last line of standard output is the result, one JSON object. The run
fails, printing no result, where no CUDA device (or too few) is present, or
where JAX or the JAX package was loaded. ``--device cpu`` skips the look for
a card: the tests' tiny runs.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")

FORBIDDEN = {"jax", "jaxlib", "flax", "anyv2v_tpu"}
THREADS = 1


def log(msg: str) -> None:
    print(f"[v2vbench +{time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def closed_loop(request, seconds: float, clock=time.perf_counter, max_requests=None):
    """Requests one after another: ``request(i)`` for i = 0, 1, ..., none
    started that the last one's length says would end after ``seconds``, at
    least one. Returns (the requests' lengths, the window's seconds)."""
    lengths = []
    t0 = clock()
    while not lengths or (clock() - t0 + lengths[-1] <= seconds
                          and (max_requests is None or len(lengths) < max_requests)):
        s = clock()
        request(len(lengths))
        lengths.append(clock() - s)
    return lengths, clock() - t0


def rate(traffic: dict, window_s: float, requests: int, steps: int) -> float:
    """The traffic's end-to-end rate: ``times`` x window seconds per whole
    request or per UNet step."""
    m = traffic["metric"]
    per = {"requests": requests, "steps": steps}[m["per"]]
    return m["times"] * window_s / per


class Reservoir:
    """One finished request, drawn uniformly from the seed: the n-th replaces
    the kept one with probability 1/n, so that only two are ever held."""

    def __init__(self, seed: int):
        import numpy as np

        self.rng = np.random.default_rng([int(seed), 5])
        self.kept, self.seen = None, 0

    def offer(self, record) -> None:
        self.seen += 1
        if self.rng.random() * self.seen < 1.0:
            self.kept = record


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(THREADS)   # one process, few host threads: steadier host dispatch

    from . import cell as cell_mod, manifest
    from .benchguard import check_scan_time
    from .reference.nn import strict_fp32

    spec = manifest.cell(args.workload)
    chips = int(spec["entry"]["chips"])
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"v2vbench: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device, kind = torch.device("cuda", 0), torch.cuda.get_device_name(0)
        card = power_limit()
    else:
        device, kind, card = torch.device("cpu"), "cpu", "cpu"
    config, traffic = spec["config"], spec["traffic"]
    log(f"{args.workload}: seed {args.seed}, {args.seconds} s, trace {args.trace}; {card}")

    cell = manifest.adapter(config).Cell(config, traffic, args.seed, device)
    cell.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s")

    reservoir = Reservoir(args.seed)
    steps = []

    def request(i):
        rec = cell.request(i)
        steps.append(rec.steps)
        reservoir.offer(rec)

    trace = None
    lengths, window_s = closed_loop(request, args.seconds)
    log(f"window {window_s:.3f} s, {len(lengths)} requests {lengths}, {sum(steps)} steps")
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        from torch.autograd.profiler import record_function

        from . import trace as trace_mod

        # after the untraced window, one request under the profiler and the spans:
        # the profiler's own host time stretches it, so rates are read from the window
        shapes = trace_mod.Shapes(manifest.kernel_families())
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        window = (len(lengths), window_s)
        with trace_mod.spans(cell), shapes, profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with record_function("request"):
                request(len(lengths))
            lengths.append(time.perf_counter() - t0)
        log(f"traced request {lengths[-1]:.3f} s")
    for i, (sec, n) in enumerate(zip(lengths, steps)):
        check_scan_time(f"{args.workload} request {i}", sec, n)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics = {}
    if args.trace:
        events = prof.profiler.kineto_results.events()
        t0 = time.perf_counter()
        trace = trace_mod.Trace(events, shapes, cell.request_flops(), window)
        del prof, events
        log(f"trace read in {time.perf_counter() - t0:.1f} s: {trace.device_ops} device ops, "
            f"busy {trace.busy_s:.4f} of {trace.window_s:.4f} s; UNet forwards "
            f"{trace.unet_forwards}, syncs in them {trace.unet_syncs}, VAE calls "
            f"{trace.vae_calls}; calls by family {trace.shapes.calls}")
        if trace.unmatched:
            top = sorted(trace.unmatched.items(), key=lambda kv: -kv[1])[:30]
            log("kernels of no family (other): " + "; ".join(f"{n[:90]} x{c}" for n, c in top))
        if trace.unmatched_port:
            print(f"v2vbench: port kernels of no family: {trace.unmatched_port}", file=sys.stderr)
            return 3
        for m in spec["per_layer"]:
            value = manifest.metric_reader(m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        log("family device s: " + ", ".join(f"{k} {v!r}" for k, v in trace.family_s.items())
            + f"; per-layer {metrics}; {card}")
    else:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30}
        for m in spec["end_to_end"]:
            # the traffic's rate, under each of its splits (``edit_s``, ``edit_s.<cells>``)
            if m["name"].split(".")[0] == traffic["metric"]["name"]:
                values[m["name"]] = rate(traffic, window_s, len(lengths), sum(steps))
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # the check: the sampled request against the reference, the program freed first
    record = reservoir.kept
    program = cell.program_outputs(record)
    cell.release()
    strict_fp32()
    t0 = time.perf_counter()
    with torch.inference_mode():
        reference = cell.reference_outputs(record, program)
        numbers = cell_mod.compare(program, reference)
    log(f"reference check of request {record.index} in {time.perf_counter() - t0:.1f} s")
    limits = spec["limits"]
    correct = set(limits) <= set(numbers) and all(
        numbers[k] <= limits[k] for k in limits)   # a NaN compares false

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"v2vbench: the run loaded {loaded}", file=sys.stderr)
        return 4

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": peak, "card": card}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
    result = {"correct": bool(correct), "attempted": len(lengths), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    for k in limits:
        print(f"check {k} {numbers.get(k)!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
