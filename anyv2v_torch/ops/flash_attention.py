"""K5: softmax attention with an online softmax on tensor cores, heads folded
into the channel dim ``[B, S, H*dh]``, with an optional split-KV context.

Replaces ``anyv2v_tpu/ops/pallas_attention.py`` (``_flash_kernel``,
``_flash_splitkv_kernel``) and ``anyv2v_tpu/ops/pallas_cross_attention.py``
(``_cross_kernel``); ``csrc/flash_attention.cu`` is one body for the three,
``wgmma`` on tiles that TMA loads into an mbarrier-guarded ring
(:func:`flash_plan` sizes it):

- long self or cross attention at head widths 40/64/80/160 (ConsistI2V's
  spatial cross-attention, 5/10/20 heads of 64, and its temporal
  transformer's cross-attention over ``[B, F*HW, C]``, 8 heads of 40/80/160);
- split-KV: each query row ``b`` attends over its own keys and, under the
  same softmax, over the context row ``b // frames`` (ConsistI2V's
  first-frame K/V shared by the frames of a batch row). The plain version
  builds the repeated context; the kernel never does.

:func:`flash_attention` is the entry: CPU tensors take the plain version,
CUDA tensors launch the kernel (and nothing else).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .folded_attention import folded_attention_plain

HEAD_DIMS = (8, 16, 40, 64, 80, 160)
BLOCK_ROWS = 128   # query rows per block: two consumer warpgroups of 64
BLOCK_KEYS = 128   # keys per K/V tile
THREADS = 384      # two consumer warpgroups and one producer warpgroup


def flash_plan(b: int, sq: int, heads: int, head_dim: int) -> dict:
    """The launch of K5's kernel: one block per (128 query rows, head, batch
    row); shared memory holds Q (the score depth padded to 16) and a ring of
    K/V tiles of 128 keys, 3 stages (2 at head widths past 80), plus one
    mbarrier per stage and direction, one for Q, and 128 bytes of alignment
    slack. ``csrc/flash_attention.cu`` refuses a plan whose bytes differ
    from its own layout."""
    dp = -(-head_dim // 16) * 16
    stages = 2 if head_dim > 80 else 3
    q_bytes = BLOCK_ROWS * dp * 2
    kv_bytes = BLOCK_KEYS * (dp + head_dim) * 2
    return {"stages": stages, "threads": THREADS,
            "smem_bytes": q_bytes + stages * kv_bytes + (2 * stages + 1) * 8 + 128,
            "grid": (-(-sq // BLOCK_ROWS), heads, b)}


def _with_context(k: torch.Tensor, k_ctx: Optional[torch.Tensor], frames: int) -> torch.Tensor:
    if k_ctx is None:
        return k
    return torch.cat([k, k_ctx.repeat_interleave(frames, dim=0)], dim=1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          scale: float, k_ctx: Optional[torch.Tensor] = None,
                          v_ctx: Optional[torch.Tensor] = None,
                          frames: int = 1) -> torch.Tensor:
    """Plain PyTorch version: the context repeated per frame and concatenated
    on the key axis, then fp32 scores and softmax."""
    return folded_attention_plain(q, _with_context(k, k_ctx, frames),
                                  _with_context(v, v_ctx, frames), heads, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: float, k_ctx: Optional[torch.Tensor] = None,
                    v_ctx: Optional[torch.Tensor] = None, frames: int = 1) -> torch.Tensor:
    """q ``[B, Sq, H*dh]``, k/v ``[B, Sk, H*dh]``, optional k_ctx/v_ctx
    ``[B // frames, Sk2, H*dh]`` -> ``[B, Sq, H*dh]``. ``scale`` is explicit."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, heads, scale, k_ctx, v_ctx, frames)
    _build.require_cuda("flash_attention", q, k, v, k_ctx, v_ctx)
    _build.require_aligned("flash_attention", q, k, v, k_ctx, v_ctx)
    b, sq, c = q.shape
    sk = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != c or heads <= 0
            or c % heads):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    sk2 = 0
    if (k_ctx is None) != (v_ctx is None):
        raise ValueError("flash_attention: k_ctx and v_ctx go together")
    if k_ctx is not None:
        sk2 = k_ctx.shape[1]
        if (k_ctx.shape != v_ctx.shape or frames <= 0 or k_ctx.shape[0] * frames != b
                or k_ctx.shape[2] != c or sk2 == 0):
            raise ValueError(f"flash_attention: context k{tuple(k_ctx.shape)} "
                             f"v{tuple(v_ctx.shape)} for {b} rows of {frames} frames")
    dh = c // heads
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {dh} not in {HEAD_DIMS}")
    if sq == 0 or sk == 0:
        raise ValueError("flash_attention: empty query or key axis")
    plan = flash_plan(b, sq, heads, dh)
    _build.check_plan("flash_attention", plan)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    rc = _build.library().anyv2v_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        null if k_ctx is None else _build.ptr(k_ctx),
        null if v_ctx is None else _build.ptr(v_ctx), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(sq), ctypes.c_int(sk), ctypes.c_int(sk2),
        ctypes.c_int(frames), ctypes.c_int(heads), ctypes.c_int(dh),
        ctypes.c_float(scale), ctypes.c_int(plan["smem_bytes"]), _build.stream())
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
