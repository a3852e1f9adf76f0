"""AnyV2V in PyTorch for one NVIDIA Hopper GPU.

The counterpart of :mod:`anyv2v_tpu` (JAX + Pallas), which stays the
reference this package is tested against. Module names mirror the JAX
package (``schedulers/ddim.py`` <-> ``anyv2v_tpu/schedulers/ddim.py`` and so
on). Public functions keep the JAX layouts: video latents are
``[B, F, h, w, 4]`` channels-last, attention tokens ``[B, S, heads*dh]``,
temporal tokens ``[B, F, HW, C]``.

The device is always explicit: every entry point takes ``device`` and there is
no "CUDA if available" default. Asking for ``"cuda"`` on a machine without a
GPU raises instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, checked.

    Raises when a CUDA device is asked for and none is present: the port
    never falls back to the CPU behind the caller's back."""
    if device is None:
        raise ValueError("device is required: pass 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
