"""Rotary position embeddings for ConsistI2V's temporal attention
(counterpart of ``anyv2v_tpu/ops/rotary.py``).

The reference vendors ``rotary_embedding_torch``
(``consisti2v/consisti2v/models/rotary_embedding.py``): 'lang' frequencies
and the interleaved-pair convention. ConsistI2V builds ``RotaryEmbedding(
inner // 2)``, so only the first ``inner // 2`` channels of the flattened
(pre head split) projection rotate; the rest pass through.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rotary_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    """Default 'lang' frequencies: theta^(-2i/dim) for i in [0, dim/2)."""
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))


def rotary_angles(positions: torch.Tensor, freqs) -> torch.Tensor:
    """positions ``[..., S]`` x freqs -> angles ``[..., S, 2 * len(freqs)]``,
    each frequency repeated for its pair of channels, fp32."""
    f = torch.as_tensor(np.asarray(freqs), dtype=torch.float32, device=positions.device)
    ang = positions.float()[..., None] * f
    return ang.repeat_interleave(2, dim=-1)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x_{2i}, x_{2i+1}) by ``angles`` (broadcastable to x), in
    fp32; returns x's dtype."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(xf.shape)
    return (xf * torch.cos(angles) + rotated * torch.sin(angles)).to(x.dtype)


def apply_rotary_partial(x: torch.Tensor, angles: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Rotate the first ``rot_dim`` channels of x's last axis; identity on
    the rest. ``angles``: broadcastable ``[..., rot_dim]``."""
    if rot_dim >= x.shape[-1]:
        return apply_rotary(x, angles)
    return torch.cat([apply_rotary(x[..., :rot_dim], angles), x[..., rot_dim:]], dim=-1)


def rotate_queries_or_keys(x: torch.Tensor, freqs,
                           seq_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate ``[..., S, D]`` at positions 0..S-1, or at ``seq_pos`` (the
    reference's ``rotate_queries_or_keys(..., seq_pos=key_pos_idx)``,
    ``rotary_embedding.py:143-165``)."""
    if seq_pos is None:
        seq_pos = torch.arange(x.shape[-2], dtype=torch.float32, device=x.device)
    return apply_rotary(x, rotary_angles(seq_pos, freqs))
