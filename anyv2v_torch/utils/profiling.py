"""Profiling hooks (counterpart of ``anyv2v_tpu/utils/profiling.py``): a
``torch.profiler`` trace and per-phase wall-clock timers.

Usage:
    with trace_if("/tmp/trace"):           # no-op when dir is falsy
        run_hot_loop()

    timers = PhaseTimers("cuda")
    out = {}
    with timers.phase("invert", sync=out):
        out["trajectory"] = ...
    timers.report()   # {"invert": 12.3, ...}

The trace is a Chrome trace (``chrome://tracing``, Perfetto) with the host's
calls and the device's kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .benchguard import hard_sync


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]):
    """``torch.profiler.profile`` over the CPU and CUDA activities, its Chrome
    trace written to ``trace_dir/trace.json``, when ``trace_dir`` is set;
    else nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


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
