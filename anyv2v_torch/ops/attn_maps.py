"""Attention maps for visualisation (counterpart of
``anyv2v_tpu/ops/attn_maps.py``): a plain function over Q and K, since the
port injects by data and has no processors to hook."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_probs(query: torch.Tensor, key: torch.Tensor, heads: int,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(Q K^T * scale) per head, in fp32: query ``[B, Sq, H*dh]``, key
    ``[B, Sk, H*dh]`` -> ``[B, H, Sq, Sk]``; ``scale`` defaults to
    ``1 / sqrt(dh)``."""
    b, sq, d = query.shape
    dh = d // heads
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    q = query.float().reshape(b, sq, heads, dh)
    k = key.float().reshape(b, key.shape[1], heads, dh)
    return torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)


def attn_map_grid(probs: torch.Tensor, h: int, w: int, token_idx: int = 0) -> torch.Tensor:
    """The head-averaged map of one context token on the spatial grid:
    ``[B, H, Sq, Sk]`` -> ``[B, h, w]``."""
    m = probs.mean(dim=1)[..., token_idx]
    return m.reshape(m.shape[0], h, w)
