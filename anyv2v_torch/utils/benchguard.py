"""Benchmark synchronisation and plausibility guards (counterpart of
``anyv2v_tpu/utils/benchguard.py``).

1. :func:`hard_sync` pushes a dependent scalar through every tensor of an
   output: one fp32 mean per tensor, queued on the tensor's own stream behind
   the work that produced it, summed on the device and read back with one
   ``.item()``. The read-back waits for every mean, so for every producer; the
   transfer is one float whatever the output's size. The scalar is also the
   finiteness witness: a NaN or Inf anywhere makes it non-finite.
2. :func:`check_scan_time` rejects a timing that no device could reach: a
   timed scan of ``n`` UNet steps must take at least ``n * min_step_s``.

Unlike the JAX version, :func:`hard_sync` never returns without syncing
something: it checks the chunks of a :class:`HostTrajectory`, and it raises
when a non-empty input holds no tensor (the JAX version returns 0.0 for
both).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Per-step wall-clock floor for one 16-frame 512^2 video-UNet forward, any
# backbone, any batch: the fastest forward measured is SEINE's at batch 1,
# 86.5 ms (PERF.md, chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W). 10 ms
# sits near an order of magnitude under it and still catches a sync that
# returned early (0.9 ms per step).
MIN_UNET_STEP_S = 0.010


def _leaves(x, out: list) -> None:
    """Append the tensors of ``x`` (nested dicts, lists, tuples, dataclasses;
    numpy arrays as host tensors; a HostTrajectory as its chunks) to
    ``out``."""
    from ..pipelines.common import HostTrajectory

    if torch.is_tensor(x):
        out.append(x)
    elif isinstance(x, np.ndarray):
        out.append(torch.from_numpy(x))
    elif isinstance(x, HostTrajectory):
        out.extend(x._chunks)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)


def _is_empty(x) -> bool:
    return x is None or (isinstance(x, (dict, list, tuple)) and len(x) == 0)


def hard_sync(x) -> float:
    """Wait for every tensor in ``x`` and return the sum of their fp32 means.

    Raises ``FloatingPointError`` on a non-finite sum, and ``TypeError`` when
    ``x`` is not empty but holds no tensor to wait for. ``None`` and empty
    containers return 0.0."""
    leaves: list = []
    _leaves(x, leaves)
    if not leaves:
        if _is_empty(x):
            return 0.0
        raise TypeError(f"hard_sync: {type(x).__name__} holds no tensor to sync")
    cuda = [t.device for t in leaves if t.device.type == "cuda"]
    home = cuda[0] if cuda else torch.device("cpu")
    means = [t.float().mean() if t.dim() else t.float() for t in leaves]
    total = torch.stack([m.to(home) for m in means]).sum()
    val = total.item()
    if not math.isfinite(val):
        raise FloatingPointError(f"hard_sync: non-finite output (tensor-mean sum = {val})")
    return val


def check_scan_time(label: str, measured_s: float, n_steps: int,
                    min_step_s: float = MIN_UNET_STEP_S) -> float:
    """Return ``measured_s`` if it is at least ``n_steps * min_step_s``;
    raise ``RuntimeError`` otherwise, the signature of a sync that returned
    before the device drained."""
    floor = n_steps * min_step_s
    if measured_s < floor:
        raise RuntimeError(
            f"implausible timing for {label}: measured {measured_s:.4f}s for "
            f"{n_steps} steps, below the {floor:.3f}s physical floor "
            f"({min_step_s*1e3:.0f} ms/step); the sync likely returned before "
            f"the device drained — do not record this number")
    return measured_s
