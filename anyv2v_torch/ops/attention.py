"""Attention dispatcher (counterpart of ``anyv2v_tpu/ops/attention.py``).

Contract, as in the JAX package: flat ``[B, S, heads*dh]`` tokens in and out,
an explicit ``scale`` (the true head width's, since projections store each
head padded by :func:`padded_head_dim`), and :func:`temporal_attention` on
``[B, S, HW, C]`` temporal tokens with no transposes.

Routing on CUDA tensors, the same on every call:

- K1 :func:`..ops.folded_attention.folded_attention` for every folded
  attention (no bias, no mask) whose head width is 8, 16, 32 or 64 and
  whose heads window-pack (:func:`window_packable`) or which is short
  (Sq, Sk <= 128): the spatial self and cross attention of the 64-head
  i2vgen-xl levels and the image-latent temporal encoder;
- K2 :func:`..ops.frame_attention.frame_attention` for all frame-axis
  attention with S <= 32;
- everything else (the VAE's one 512-wide head, CLIP's causal attention)
  to PyTorch's ``scaled_dot_product_attention``.

The JAX row and length thresholds were tuned on a TPU and are not copied.
On CPU tensors every route takes the kernel's plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .folded_attention import HEAD_DIMS, folded_attention
from .frame_attention import MAX_FRAMES, frame_attention


def padded_head_dim(d: int) -> int:
    """Storage width of one head: widths that are not a multiple of 8 pad to
    the next power of two (>= 8) — i2vgen-xl's 5/10/20 become 8/16/32.
    Zero q/k columns add nothing to a score and zero v columns give zero
    output lanes, so the padded math is exact."""
    if d % 8 == 0:
        return d
    p = 8
    while p < d:
        p *= 2
    return p


def window_packable(heads: int, head_dim: int) -> bool:
    """Whole heads tile 128-channel windows (the JAX package's
    ``_window_packable``): the 64-head i2vgen-xl split at dh 8/16/32."""
    return (head_dim <= 64 and 128 % head_dim == 0
            and (heads * head_dim) % 128 == 0 and heads >= 128 // head_dim)


def uses_folded_kernel(sq: int, sk: int, heads: int, head_dim: int) -> bool:
    """K1's route (the same on CPU, where the route runs its plain version)."""
    return head_dim in HEAD_DIMS and (window_packable(heads, head_dim)
                                      or (sq <= 128 and sk <= 128))


def multi_head_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                         heads: int, scale: float, causal: bool = False) -> torch.Tensor:
    """query ``[B, Sq, H*dh]``, key/value ``[B, Sk, H*dh]`` -> ``[B, Sq, H*dh]``."""
    b, sq, c = query.shape
    dh = c // heads
    if not causal and uses_folded_kernel(sq, key.shape[1], heads, dh):
        return folded_attention(query, key, value, heads, scale)

    def split(x):
        return x.reshape(b, x.shape[1], heads, dh).transpose(1, 2)

    out = F.scaled_dot_product_attention(split(query), split(key), split(value),
                                         is_causal=causal, scale=scale)
    return out.transpose(1, 2).reshape(b, sq, c)


def temporal_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                       heads: int, scale: float) -> torch.Tensor:
    """Self-attention over the frame axis S of ``[B, S, HW, C]`` tokens."""
    if query.shape[1] > MAX_FRAMES:
        raise NotImplementedError(
            f"{query.shape[1]} frames: attention over more than {MAX_FRAMES} "
            "frames is not ported yet")
    return frame_attention(query, key, value, heads, scale)
