"""Plug-and-play feature injection (counterpart of ``anyv2v_tpu/ops/pnp.py``).

The PnP edit runs the CFG batch ``[src, uncond, cond]``; where a layer
injects, every batch chunk is replaced by the source chunk. In eager PyTorch
the per-step flags are Python bools, so a layer whose flag is off does no
injection work at all.
"""

from __future__ import annotations

import numpy as np
import torch


def inject_source_rows(x: torch.Tensor, inject: bool, num_chunks: int = 3) -> torch.Tensor:
    """Replace every batch chunk of ``x`` ([num_chunks * b, ...]) with the first
    (source) chunk when ``inject``; ``x`` itself otherwise."""
    if not inject or num_chunks == 1:
        return x
    b = x.shape[0] // num_chunks
    if b * num_chunks != x.shape[0]:
        raise ValueError(f"batch {x.shape[0]} not divisible by num_chunks {num_chunks}")
    return x[:b].repeat((num_chunks,) + (1,) * (x.dim() - 1))


def injection_step_mask(timesteps: np.ndarray, threshold: float,
                        num_inference_steps: int) -> np.ndarray:
    """Inject on the first ``int(num_inference_steps * threshold)`` entries of
    the FULL descending sampling grid (and at t == 1000); callers running a
    truncated loop slice the mask with the same ``[t_idx:]``."""
    timesteps = np.asarray(timesteps)
    mask = np.zeros(len(timesteps), dtype=bool)
    mask[:int(num_inference_steps * threshold)] = True
    mask |= timesteps == 1000
    return mask
