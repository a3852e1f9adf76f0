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

One tensor-core body (``mma.sync`` on operands brought in by ``cp.async``)
serves every frame count up to 128 and head widths 8/16/32/40/64/80/160. It
replaces two CUDA-core bodies for S <= 32 (a channel-pair body and a row
body, 4-9x their byte bound on an H100). A block holds Q, K and V of
several pixels for a group of whole heads in shared memory; :func:`frame_plan`
sizes that group, the pixels per block and the launch, and the C entry
refuses a plan that does not match the shape. Two wrappers, each with its own
launch count, launch that body:

- :func:`frame_attention` (S <= 32, :func:`takes`);
- :func:`frame_attention_long` ("K2 long", 32 < S <= 128, :func:`takes_long`),
  the long-video route. It keeps the JAX kernel's cap of 128 frames
  (``_short_kernel`` takes S, Sk <= 128) and raises past it.

Both take ``S <= Sk <= S + 16``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_FRAMES = 32
MAX_EXTRA_KEYS = 16
LONG_MAX_FRAMES = 128
HEAD_DIMS = (8, 16, 32, 40, 64, 80, 160)
GROUP_CHANNELS = 128        # channels per block (one head where it is wider)
MAX_WARPS = 8
MIN_BLOCK_BYTES = 16384     # pixels are added to a block until it moves this much


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version on a transposed view, fp32 scores and softmax.

    Chunks over pixels so the fp32 score tensor stays near 1 GiB: a 128-frame
    L0 edit call would need [3*4096, 64, 128, 128] fp32 = 51.5 GB at once.
    A chunk spans several batch rows where their pixels fit in it (the
    ``[B, S, 1, C]`` view of ``[B, S, C]`` tokens has one pixel a row)."""
    b, s, hw, c = q.shape
    sk = k.shape[1]
    dh = c // heads
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    step = max(1, (1 << 28) // (heads * s * sk))
    rows = max(1, step // hw)

    def t(x, b0, b1, p0, p1):
        """Pixels p0:p1 of batch rows b0:b1 as ``[P, heads, frames, dh]`` fp32."""
        x = x[b0:b1, :, p0:p1].permute(0, 2, 1, 3)
        return x.reshape(-1, x.shape[2], heads, dh).transpose(1, 2).float()

    for b0 in range(0, b, rows):
        b1 = min(b, b0 + rows)
        for p0 in range(0, hw, step):
            p1 = min(hw, p0 + step)
            scores = torch.matmul(t(q, b0, b1, p0, p1),
                                  t(k, b0, b1, p0, p1).transpose(-1, -2)) * scale
            if bias is not None:
                scores = scores + bias.float()
            o = torch.matmul(torch.softmax(scores, dim=-1), t(v, b0, b1, p0, p1))
            out[b0:b1, :, p0:p1] = o.transpose(1, 2).reshape(
                b1 - b0, p1 - p0, s, c).permute(0, 2, 1, 3)
    return out


def takes(s: int, sk: int, head_dim: int) -> bool:
    """The shapes :func:`frame_attention` takes (S <= 32)."""
    return (1 <= s <= MAX_FRAMES and s <= sk <= s + MAX_EXTRA_KEYS
            and head_dim in HEAD_DIMS)


def takes_long(s: int, sk: int, head_dim: int) -> bool:
    """The shapes :func:`frame_attention_long` takes (32 < S <= 128)."""
    return (MAX_FRAMES < s <= LONG_MAX_FRAMES and s <= sk <= s + MAX_EXTRA_KEYS
            and head_dim in HEAD_DIMS)


def frame_plan(b: int, s: int, sk: int, hw: int, heads: int, head_dim: int) -> dict:
    """The launch of the frame-axis kernel for one shape (1 <= S <= 128): one
    block per (group of pixels, group of heads). The head group is the most
    whole heads that fit in ``GROUP_CHANNELS`` channels (one head if it is
    wider). One pixel's Q ``[S, G]``, K and V ``[Sk, G]`` (G = group
    channels), rows padded to 16 and each row strided by an odd number of
    16-byte units (no ldmatrix bank conflict), take ``pixel_bytes`` of
    shared memory. A block holds ``pixels_per_block`` consecutive pixels (of
    the ``B * HW`` in batch-major order): enough to move ``MIN_BLOCK_BYTES``,
    while two blocks still share one SM. Past ``MAX_FRAMES`` frames (K2
    long) a block holds one pixel, which the kernel knows at compile time.
    One warp per (pixel, head, 16 query frames), at most ``MAX_WARPS``.
    ``csrc/frame_attention.cu`` recomputes the shared bytes and refuses a
    plan that differs."""
    hb = max(d for d in range(1, heads + 1)
             if heads % d == 0 and d * head_dim <= max(GROUP_CHANNELS, head_dim))
    g = hb * head_dim
    row_stride = g + 8 + 8 * ((g // 8) % 2)
    rows_q, rows_k = -(-s // 16) * 16, -(-sk // 16) * 16
    pixel_bytes = (rows_q + 2 * rows_k) * row_stride * 2
    pixels = 1 if s > MAX_FRAMES else max(1, min(b * hw, -(-MIN_BLOCK_BYTES // pixel_bytes),
                                                 _build.SMEM_LIMIT // (2 * pixel_bytes)))
    return {"heads_per_block": hb, "pixels_per_block": pixels, "row_stride": row_stride,
            "pixel_bytes": pixel_bytes, "smem_bytes": pixels * pixel_bytes,
            "threads": 32 * min(MAX_WARPS, pixels * hb * rows_q // 16),
            "grid": (-(-b * hw // pixels), heads // hb)}


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


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            scale: float, bias: Optional[torch.Tensor], takes_fn, limits: str) -> torch.Tensor:
    """Check the operands and the plan, then launch the kernel."""
    b, s, sk, hw, c, dh = _check_shapes(name, q, k, v, heads, takes_fn, limits)
    plan = frame_plan(b, s, sk, hw, heads, dh)
    _build.check_plan(name, plan)
    out = torch.empty_like(q)
    rc = _build.library().anyv2v_frame_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _bias_ptr(bias), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_int(sk), ctypes.c_int(hw),
        ctypes.c_int(c), ctypes.c_int(dh), ctypes.c_float(scale),
        *(ctypes.c_int(plan[key]) for key in ("heads_per_block", "pixels_per_block", "threads",
                                              "smem_bytes")),
        _build.stream())
    _build.check(rc, name)
    return out


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
    out = _launch("frame_attention", q, k, v, heads, scale, bias, takes,
                  f"S <= {MAX_FRAMES}, S <= Sk <= S + {MAX_EXTRA_KEYS}, widths {HEAD_DIMS}")
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
    out = _launch("frame_attention_long", q, k, v, heads, scale, bias, takes_long,
                  f"{MAX_FRAMES} < S <= {LONG_MAX_FRAMES}, S <= Sk <= S + {MAX_EXTRA_KEYS}, "
                  f"widths {HEAD_DIMS}")
    frame_attention_long.launches += 1
    return out


frame_attention_long.launches = 0
