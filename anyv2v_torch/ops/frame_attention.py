"""K2: self-attention over the frame axis S of temporal tokens ``[B, S, HW, C]``.

Replaces ``anyv2v_tpu/ops/pallas_temporal_ew.py::_ew_kernel`` (L0 temporal
attention) and ``anyv2v_tpu/ops/pallas_short_attention.py::_strided_kernel``
(L1/L2/mid temporal attention and ``transformer_in``). Both read the native
layout, so the module never transposes its tokens; ``csrc/frame_attention.cu``
does the same with one kernel for every level.

Keys equal queries in count (Sk == S, S <= 32) and there is no bias: the
longer key axis and per-head bias that ConsistI2V and SEINE need are not
ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_FRAMES = 32


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version on a transposed view, fp32 softmax."""
    b, s, hw, c = q.shape
    dh = c // heads

    def t(x):
        return x.permute(0, 2, 1, 3).reshape(b * hw, s, heads, dh).transpose(1, 2).float()

    scores = torch.matmul(t(q), t(k).transpose(-1, -2)) * scale
    out = torch.matmul(torch.softmax(scores, dim=-1), t(v))     # [b*hw, H, s, dh]
    out = out.transpose(1, 2).reshape(b, hw, s, c).permute(0, 2, 1, 3)
    return out.to(q.dtype).contiguous()


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """q, k, v ``[B, S, HW, C]`` -> ``[B, S, HW, C]``, attending over S."""
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, heads, scale)
    _build.require_cuda("frame_attention", q, k, v)
    b, s, hw, c = q.shape
    dh = c // heads if heads else 0
    if k.shape != q.shape or v.shape != q.shape or c != heads * dh:
        raise ValueError(f"frame_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    if not 1 <= s <= MAX_FRAMES:
        raise ValueError(f"frame_attention: {s} frames, at most {MAX_FRAMES}")
    if dh not in (2, 4, 8, 16, 32, 64):
        raise ValueError(f"frame_attention: head width {dh} is not a power of two in [2, 64]")
    out = torch.empty_like(q)
    rc = _build.library().anyv2v_frame_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_int(hw), ctypes.c_int(c),
        ctypes.c_int(dh), ctypes.c_float(scale), _build.stream())
    _build.check(rc, "frame_attention")
    frame_attention.launches += 1
    return out


frame_attention.launches = 0
