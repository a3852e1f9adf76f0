"""Synchronisation and plausibility guards of the timed window: a frozen copy
of the program's ``utils/benchguard.py``, so that a change to the program
cannot change how the benchmark waits for it.

1. :func:`hard_sync` pushes a dependent scalar through every tensor of an
   output: one fp32 mean per tensor, queued on the tensor's own stream behind
   the work that produced it, summed on the device and read back with one
   ``.item()``. The read-back waits for every producer. The scalar is also
   the finiteness witness: a NaN or Inf anywhere makes it non-finite.
2. :func:`check_scan_time` rejects a timing that no device could reach: a
   timed request of ``n`` UNet steps must take at least ``n * min_step_s``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Per-step floor of one 16-frame 512^2 video-UNet forward: the fastest the
# program has measured is SEINE's at batch 1, 86.5 ms on an NVIDIA H100 80GB
# HBM3 at 700 W; 10 ms still catches a sync that returned early.
MIN_UNET_STEP_S = 0.010


def _leaves(x, out: list) -> None:
    """The tensors of ``x`` (nested dicts, lists, tuples, dataclasses; numpy
    arrays as host tensors; a host trajectory store as its chunks)."""
    if torch.is_tensor(x):
        out.append(x)
    elif isinstance(x, np.ndarray):
        out.append(torch.from_numpy(x))
    elif hasattr(x, "_chunks"):
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


def hard_sync(x) -> float:
    """Wait for every tensor in ``x`` and return the sum of their fp32 means.
    Raises ``FloatingPointError`` on a non-finite sum and ``TypeError`` when
    ``x`` holds no tensor."""
    leaves: list = []
    _leaves(x, leaves)
    if not leaves:
        raise TypeError(f"hard_sync: {type(x).__name__} holds no tensor to sync")
    cuda = [t.device for t in leaves if t.device.type == "cuda"]
    home = cuda[0] if cuda else torch.device("cpu")
    means = [t.float().mean() if t.dim() else t.float() for t in leaves]
    val = torch.stack([m.to(home) for m in means]).sum().item()
    if not math.isfinite(val):
        raise FloatingPointError(f"hard_sync: non-finite output (tensor-mean sum = {val})")
    return val


def check_scan_time(label: str, measured_s: float, n_steps: int,
                    min_step_s: float = MIN_UNET_STEP_S) -> float:
    """``measured_s``, if at least ``n_steps * min_step_s``; else raise: the
    signature of a sync that returned before the device drained."""
    floor = n_steps * min_step_s
    if measured_s < floor:
        raise RuntimeError(
            f"implausible timing for {label}: {measured_s:.4f} s for {n_steps} steps, below "
            f"the {floor:.3f} s floor ({min_step_s * 1e3:.0f} ms a step)")
    return measured_s
