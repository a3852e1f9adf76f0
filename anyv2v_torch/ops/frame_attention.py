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

Two bodies of ``csrc/frame_attention.cu``, each a kernel symbol of its own,
serve head widths 8/16/32/40/64/80/160, and each wrapper keeps its own
launch count:

- :func:`frame_attention` (S <= 32, :func:`takes`): ``mma.sync`` on
  operands brought in by ``cp.async``, several pixels for a group of whole
  heads in a block (it replaced two CUDA-core bodies, 4-9x their byte bound
  on an H100); :func:`frame_plan` sizes the block;
- :func:`frame_attention_long` ("K2 long", 32 < S <= 128, :func:`takes_long`),
  the long-video route: persistent blocks whose producer warp loads each
  (pixel, head group)'s Q, K and V as TMA boxes of the native layout onto a
  ring of two item stages, two consumer warpgroups on ``wgmma`` with the
  exact one-pass softmax over all Sk keys; :func:`frame_long_plan` sizes
  it. It keeps the JAX kernel's cap of 128 frames (``_short_kernel`` takes
  S, Sk <= 128) and raises past it.

The C entries refuse a plan that does not match the shape, and
:func:`check_frame_long_plan` (in ``_build.PLAN_CHECKS``) one with any
field changed.

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
LONG_THREADS = 288          # K2 long: two consumer warpgroups and a producer warp
LONG_BARRIER_BYTES, LONG_ALIGN = 64, 1024   # the slack aligns the tiles to the swizzle atom


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


def frame_plan(b: int, s: int, sk: int, hw: int, heads: int, head_dim: int,
               sms: int = _build.H100_SMS) -> dict:
    """The launch of the frame-axis kernel for one shape: for S <= 32 one
    block per (group of pixels, group of heads), past that
    :func:`frame_long_plan`. The head group is the most whole heads that fit
    in ``GROUP_CHANNELS`` channels (one head if it is wider). One pixel's Q
    ``[S, G]``, K and V ``[Sk, G]`` (G = group channels), rows padded to 16
    and each row strided by an odd number of 16-byte units (no ldmatrix bank
    conflict), take ``pixel_bytes`` of shared memory. A block holds
    ``pixels_per_block`` consecutive pixels (of the ``B * HW`` in
    batch-major order): enough to move ``MIN_BLOCK_BYTES``, while two blocks
    still share one SM. One warp per (pixel, head, 16 query frames), at most
    ``MAX_WARPS``. ``csrc/frame_attention.cu`` recomputes the shared bytes
    and refuses a plan that differs."""
    if s > MAX_FRAMES:
        return frame_long_plan(b, s, sk, hw, heads, head_dim, sms)
    hb = _head_group(heads, head_dim)
    g = hb * head_dim
    row_stride = g + 8 + 8 * ((g // 8) % 2)
    rows_q, rows_k = -(-s // 16) * 16, -(-sk // 16) * 16
    pixel_bytes = (rows_q + 2 * rows_k) * row_stride * 2
    pixels = max(1, min(b * hw, -(-MIN_BLOCK_BYTES // pixel_bytes),
                        _build.SMEM_LIMIT // (2 * pixel_bytes)))
    return {"heads_per_block": hb, "pixels_per_block": pixels, "row_stride": row_stride,
            "pixel_bytes": pixel_bytes, "smem_bytes": pixels * pixel_bytes,
            "threads": 32 * min(MAX_WARPS, pixels * hb * rows_q // 16),
            "grid": (-(-b * hw // pixels), heads // hb)}


def _head_group(heads: int, head_dim: int) -> int:
    """The most whole heads within ``GROUP_CHANNELS`` channels (one head if
    it is wider)."""
    return max(d for d in range(1, heads + 1)
               if heads % d == 0 and d * head_dim <= max(GROUP_CHANNELS, head_dim))


def frame_long_layout_bytes(group_channels: int, q_tiles: int, key_rows: int,
                            stages: int) -> int:
    """Shared bytes of one K2 long block (``csrc/frame_attention.cu``
    ``long_body::make_layout``): ``stages`` item stages of Q ``[64 * q_tiles,
    G]``, K and V ``[key_rows, G]``, a zero and a ones chunk of ``key_rows``
    rows of 16 bytes, the barriers and the alignment slack."""
    stage = 64 * q_tiles * group_channels * 2 + 2 * key_rows * group_channels * 2
    return stages * stage + 2 * key_rows * 16 + LONG_BARRIER_BYTES + LONG_ALIGN


def frame_long_plan(b: int, s: int, sk: int, hw: int, heads: int, head_dim: int,
                    sms: int = _build.H100_SMS) -> dict:
    """K2 long's launch (32 < S <= 128): items of (batch row and pixel, head
    group), head group fastest, over a persistent grid of one block per SM
    (``sms``), or one per item where there are fewer. The head group is
    :func:`frame_plan`'s. An item is ``q_tiles * heads_per_block`` units of
    (64 query frames, head) split over two consumer warpgroups:
    ``q_tiles`` 2 where S > 64, else 1. Its keys are one tile of
    ``key_rows`` (128 for Sk <= 128, else 144), so the softmax is exact in
    one pass. ``stages`` item stages (2 where they fit, else 1) ring the
    next pixel's loads under this one's math. ``swizzle``: where the group
    is whole 64-channel slabs of heads 8 to 64 wide, Q, K and V land as
    128-byte-swizzled slabs (each row one 128-byte piece of a TMA box), else
    as 8-channel chunks (16-byte pieces). Past 128 frames, or keys out
    of ``S <= Sk <= S + 16``, there is no launch (ValueError)."""
    if not (MAX_FRAMES < s <= LONG_MAX_FRAMES and s <= sk <= s + MAX_EXTRA_KEYS):
        raise ValueError(f"frame_attention_long: no launch for S {s}, Sk {sk}")
    hb = _head_group(heads, head_dim)
    g = hb * head_dim
    q_tiles = 2 if s > 64 else 1
    key_rows = 128 if sk <= 128 else 144
    stages = 2 if frame_long_layout_bytes(g, q_tiles, key_rows, 2) <= _build.SMEM_LIMIT else 1
    items = b * hw * (heads // hb)
    return {"shape": {"b": b, "s": s, "sk": sk, "hw": hw, "heads": heads,
                      "head_dim": head_dim, "sms": sms},
            "heads_per_block": hb, "q_tiles": q_tiles, "key_rows": key_rows,
            "swizzle": 64 % head_dim == 0 and g % 64 == 0,
            "stages": stages, "items": items, "threads": LONG_THREADS,
            "smem_bytes": frame_long_layout_bytes(g, q_tiles, key_rows, stages),
            "grid": (max(1, min(items, sms)),)}


def check_frame_long_plan(plan: dict) -> None:
    """Raise unless ``plan`` is :func:`frame_long_plan`'s plan for its own
    ``shape``: a plan with any field changed is refused before a launch."""
    if plan != frame_long_plan(**plan["shape"]):
        raise ValueError(f"frame_attention_long: no launch for this plan: {plan}")


_build.PLAN_CHECKS["frame_attention_long"] = check_frame_long_plan


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
    plan = frame_plan(b, s, sk, hw, heads, dh, sms=_build.sm_count(q.device))
    _build.check_plan(name, plan)
    out = torch.empty_like(q)
    operands = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _bias_ptr(bias), _build.ptr(out),
                ctypes.c_int(b), ctypes.c_int(s), ctypes.c_int(sk), ctypes.c_int(hw),
                ctypes.c_int(c), ctypes.c_int(dh), ctypes.c_float(scale))
    if s > MAX_FRAMES:
        rc = _build.library().anyv2v_frame_attention_long(
            *operands, *(ctypes.c_int(int(plan[key])) for key in (
                "heads_per_block", "q_tiles", "swizzle", "stages")),
            ctypes.c_int(plan["grid"][0]), ctypes.c_int(plan["smem_bytes"]), _build.stream())
    else:
        rc = _build.library().anyv2v_frame_attention(
            *operands, *(ctypes.c_int(plan[key]) for key in (
                "heads_per_block", "pixels_per_block", "threads", "smem_bytes")),
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
