"""K2: self-attention over the frame axis S of temporal tokens ``[B, S, HW, C]``.

Replaces ``anyv2v_tpu/ops/pallas_temporal_ew.py::_ew_kernel`` (L0 temporal
attention) and ``anyv2v_tpu/ops/pallas_short_attention.py::_strided_kernel``
(the other temporal layers, ``transformer_in``, and ConsistI2V's augmented
temporal attention). Both read the native layout, so the module never
transposes its tokens; ``csrc/frame_attention.cu`` does the same.

Keys and values may carry up to 16 frames more than the queries (ConsistI2V's
8 first-frame window keys, appended on the frame axis with their rotary
positions already applied). An optional fp32 ``bias [heads, S, Sk]``, shared by
every batch row and pixel (SEINE's T5 relative-position bias), is added to the
scaled scores before the softmax, as the Pallas kernels add it.

Two kernel bodies sit behind the one wrapper and its one launch count:
``Sk == S`` with a power-of-two head width up to 64 (i2vgen-xl) takes the
channel-pair body; every other shape (``S <= Sk <= S + 16``, head widths
8/16/40/80/160, the ConsistI2V archs' temporal heads) takes the row body.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_FRAMES = 32
MAX_EXTRA_KEYS = 16
PAIR_HEAD_DIMS = (2, 4, 8, 16, 32, 64)
ROW_HEAD_DIMS = (8, 16, 40, 80, 160)


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version on a transposed view, fp32 scores and softmax."""
    b, s, hw, c = q.shape
    dh = c // heads

    def t(x):
        n = x.shape[1]
        return x.permute(0, 2, 1, 3).reshape(b * hw, n, heads, dh).transpose(1, 2).float()

    scores = torch.matmul(t(q), t(k).transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    out = torch.matmul(torch.softmax(scores, dim=-1), t(v))     # [b*hw, H, s, dh]
    out = out.transpose(1, 2).reshape(b, hw, s, c).permute(0, 2, 1, 3)
    return out.to(q.dtype).contiguous()


def takes(s: int, sk: int, head_dim: int) -> bool:
    """The shapes the kernel takes."""
    if not (1 <= s <= MAX_FRAMES and s <= sk <= s + MAX_EXTRA_KEYS):
        return False
    return (sk == s and head_dim in PAIR_HEAD_DIMS) or head_dim in ROW_HEAD_DIMS


def _check_bias(bias: torch.Tensor, q: torch.Tensor, k: torch.Tensor, heads: int) -> None:
    """The bias operand: fp32, contiguous, on q's device, ``[heads, S, Sk]``."""
    want = (heads, q.shape[1], k.shape[1])
    if (bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != q.device
            or tuple(bias.shape) != want):
        raise ValueError(f"frame_attention: bias must be a contiguous float32 tensor of shape "
                         f"{list(want)} on {q.device}; got {bias.dtype} {list(bias.shape)} on "
                         f"{bias.device}{'' if bias.is_contiguous() else ', not contiguous'}")


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, S, HW, C]``, k/v ``[B, Sk, HW, C]`` -> ``[B, S, HW, C]``,
    attending over the frame axis; ``bias [heads, S, Sk]`` (fp32) is added to
    the scaled scores."""
    if bias is not None:
        _check_bias(bias, q, k, heads)
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, heads, scale, bias)
    _build.require_cuda("frame_attention", q, k, v)
    _build.require_aligned("frame_attention", q, k, v)
    b, s, hw, c = q.shape
    sk = k.shape[1]
    dh = c // heads if heads else 0
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]
            or c != heads * dh):
        raise ValueError(f"frame_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    if not takes(s, sk, dh):
        raise ValueError(f"frame_attention: {s} query frames, {sk} key frames, head "
                         f"width {dh}: takes S <= {MAX_FRAMES}, S <= Sk <= S + "
                         f"{MAX_EXTRA_KEYS}, widths {PAIR_HEAD_DIMS} at Sk == S or "
                         f"{ROW_HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = _build.library()
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v),
            ctypes.c_void_p(None) if bias is None else _build.ptr(bias), _build.ptr(out),
            ctypes.c_int(b), ctypes.c_int(s))
    if sk == s and dh in PAIR_HEAD_DIMS:
        rc = lib.anyv2v_frame_attention(*args, ctypes.c_int(hw), ctypes.c_int(c),
                                        ctypes.c_int(dh), ctypes.c_float(scale),
                                        _build.stream())
    else:
        rc = lib.anyv2v_frame_attention_rows(*args, ctypes.c_int(sk), ctypes.c_int(hw),
                                             ctypes.c_int(c), ctypes.c_int(dh),
                                             ctypes.c_float(scale), _build.stream())
    _build.check(rc, "frame_attention")
    frame_attention.launches += 1
    return out


frame_attention.launches = 0
