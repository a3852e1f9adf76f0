"""K2: self-attention over the frame axis S of temporal tokens ``[B, S, HW, C]``.

Replaces ``anyv2v_tpu/ops/pallas_temporal_ew.py::_ew_kernel`` (L0 temporal
attention), ``anyv2v_tpu/ops/pallas_short_attention.py::_strided_kernel``
(the other temporal layers, ``transformer_in``, and ConsistI2V's augmented
temporal attention) and, past 32 frames, ``_short_kernel`` as
``short_attention_frames`` reaches it on the transposed view (long video).
The first two read the native layout; the JAX package transposes its tokens
for the third. This module never transposes: ``csrc/frame_attention.cu``
reads the native layout at every frame count.

Keys and values may carry up to 16 frames more than the queries (ConsistI2V's
8 first-frame window keys, appended on the frame axis with their rotary
positions already applied). An optional fp32 ``bias [heads, S, Sk]``, shared by
every batch row and pixel (SEINE's T5 relative-position bias), is added to the
scaled scores before the softmax, as the Pallas kernels add it.

Two wrappers, each with its own launch count:

- :func:`frame_attention` (S <= 32): ``Sk == S`` with a power-of-two head
  width up to 64 (i2vgen-xl) takes the channel-pair body; every other shape
  (``S <= Sk <= S + 16``, head widths 8/16/40/80/160, the ConsistI2V archs'
  temporal heads) takes the row body.
- :func:`frame_attention_long` ("K2 long", 32 < S <= 128): a tensor-core
  body (``mma.sync`` on operands brought in by ``cp.async``), head widths
  8/16/32/40/64/80/160. A block holds one pixel's Q, K and V for a group of
  whole heads in shared memory; :func:`long_plan` sizes that group and the
  launch, and the C entry refuses a plan that does not match the shape. It
  keeps the JAX kernel's cap of 128 frames (``_short_kernel`` takes S, Sk <=
  128) and raises past it.
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
LONG_MAX_FRAMES = 128
LONG_HEAD_DIMS = (8, 16, 32, 40, 64, 80, 160)
LONG_GROUP_CHANNELS = 128   # channels per K2 long block (one head where it is wider)
LONG_MAX_WARPS = 8


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version on a transposed view, fp32 scores and softmax.

    Chunks over pixels so the fp32 score tensor stays near 1 GiB: a 128-frame
    L0 edit call would need [3*4096, 64, 128, 128] fp32 = 51.5 GB at once."""
    b, s, hw, c = q.shape
    sk = k.shape[1]
    dh = c // heads
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    step = max(1, (1 << 28) // (heads * s * sk))

    def t(x, bi, p0, p1):
        """Pixels p0:p1 of batch row bi as ``[P, heads, frames, dh]`` fp32."""
        x = x[bi, :, p0:p1].permute(1, 0, 2)
        return x.reshape(p1 - p0, x.shape[1], heads, dh).transpose(1, 2).float()

    for bi in range(b):
        for p0 in range(0, hw, step):
            p1 = min(hw, p0 + step)
            scores = torch.matmul(t(q, bi, p0, p1), t(k, bi, p0, p1).transpose(-1, -2)) * scale
            if bias is not None:
                scores = scores + bias.float()
            o = torch.matmul(torch.softmax(scores, dim=-1), t(v, bi, p0, p1))  # [P, H, s, dh]
            out[bi, :, p0:p1] = o.transpose(1, 2).reshape(p1 - p0, s, c).permute(1, 0, 2)
    return out


def takes(s: int, sk: int, head_dim: int) -> bool:
    """The shapes :func:`frame_attention` takes (S <= 32)."""
    if not (1 <= s <= MAX_FRAMES and s <= sk <= s + MAX_EXTRA_KEYS):
        return False
    return (sk == s and head_dim in PAIR_HEAD_DIMS) or head_dim in ROW_HEAD_DIMS


def takes_long(s: int, sk: int, head_dim: int) -> bool:
    """The shapes :func:`frame_attention_long` takes (32 < S <= 128)."""
    return (MAX_FRAMES < s <= LONG_MAX_FRAMES and s <= sk <= s + MAX_EXTRA_KEYS
            and head_dim in LONG_HEAD_DIMS)


def long_plan(b: int, s: int, sk: int, hw: int, heads: int, head_dim: int) -> dict:
    """The launch of K2 long's kernel for one shape: one block per (batch row,
    pixel, group of heads). The group is the most whole heads that fit in
    ``LONG_GROUP_CHANNELS`` channels (one head if it is wider). The block
    holds Q ``[S, G]``, K and V ``[Sk, G]`` (G = group channels) in shared
    memory, rows padded to 16 and each row strided by an odd number of
    16-byte units (no ldmatrix bank conflict); one warp per (head, 16 query
    frames), at most ``LONG_MAX_WARPS``. ``csrc/frame_attention.cu``
    recomputes the shared bytes and refuses a plan that differs."""
    hb = max(d for d in range(1, heads + 1)
             if heads % d == 0 and d * head_dim <= max(LONG_GROUP_CHANNELS, head_dim))
    g = hb * head_dim
    row_stride = g + 8 + 8 * ((g // 8) % 2)
    rows_q, rows_k = -(-s // 16) * 16, -(-sk // 16) * 16
    return {"heads_per_block": hb, "row_stride": row_stride,
            "smem_bytes": (rows_q + 2 * rows_k) * row_stride * 2,
            "threads": 32 * min(LONG_MAX_WARPS, hb * rows_q // 16),
            "grid": (b * hw, heads // hb)}


def _check_bias(bias: torch.Tensor, q: torch.Tensor, k: torch.Tensor, heads: int) -> None:
    """The bias operand: fp32, contiguous, on q's device, ``[heads, S, Sk]``."""
    want = (heads, q.shape[1], k.shape[1])
    if (bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != q.device
            or tuple(bias.shape) != want):
        raise ValueError(f"frame_attention: bias must be a contiguous float32 tensor of shape "
                         f"{list(want)} on {q.device}; got {bias.dtype} {list(bias.shape)} on "
                         f"{bias.device}{'' if bias.is_contiguous() else ', not contiguous'}")


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int, takes_fn, limits: str):
    """The checks both wrappers make before a launch; returns (b, s, sk, hw,
    c, dh)."""
    _build.require_cuda(name, q, k, v)
    _build.require_aligned(name, q, k, v)
    b, s, hw, c = q.shape
    sk = k.shape[1]
    dh = c // heads if heads else 0
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]
            or c != heads * dh):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    if not takes_fn(s, sk, dh):
        raise ValueError(f"{name}: {s} query frames, {sk} key frames, head width {dh}: "
                         f"takes {limits}")
    return b, s, sk, hw, c, dh


def _bias_ptr(bias: Optional[torch.Tensor]):
    return ctypes.c_void_p(None) if bias is None else _build.ptr(bias)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, S, HW, C]``, k/v ``[B, Sk, HW, C]`` -> ``[B, S, HW, C]``,
    attending over the frame axis (S <= 32); ``bias [heads, S, Sk]`` (fp32)
    is added to the scaled scores."""
    if bias is not None:
        _check_bias(bias, q, k, heads)
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, heads, scale, bias)
    b, s, sk, hw, c, dh = _check_shapes(
        "frame_attention", q, k, v, heads, takes,
        f"S <= {MAX_FRAMES}, S <= Sk <= S + {MAX_EXTRA_KEYS}, widths {PAIR_HEAD_DIMS} "
        f"at Sk == S or {ROW_HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = _build.library()
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _bias_ptr(bias), _build.ptr(out),
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


def frame_attention_long(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, scale: float,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 long: :func:`frame_attention` for 32 < S <= 128 frames (long video),
    same operands and layout."""
    if bias is not None:
        _check_bias(bias, q, k, heads)
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, heads, scale, bias)
    b, s, sk, hw, c, dh = _check_shapes(
        "frame_attention_long", q, k, v, heads, takes_long,
        f"{MAX_FRAMES} < S <= {LONG_MAX_FRAMES}, S <= Sk <= S + {MAX_EXTRA_KEYS}, "
        f"widths {LONG_HEAD_DIMS}")
    plan = long_plan(b, s, sk, hw, heads, dh)
    _build.check_plan("frame_attention_long", plan)
    out = torch.empty_like(q)
    rc = _build.library().anyv2v_frame_attention_long(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _bias_ptr(bias), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_int(sk), ctypes.c_int(hw),
        ctypes.c_int(c), ctypes.c_int(dh), ctypes.c_float(scale),
        ctypes.c_int(plan["heads_per_block"]), ctypes.c_int(plan["threads"]),
        ctypes.c_int(plan["smem_bytes"]), _build.stream())
    _build.check(rc, "frame_attention_long")
    frame_attention_long.launches += 1
    return out


frame_attention_long.launches = 0
