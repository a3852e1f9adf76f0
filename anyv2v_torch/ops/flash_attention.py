"""K5: softmax attention with an online softmax on tensor cores, heads folded
into the channel dim ``[B, S, H*dh]``, with an optional additive score bias
or an optional split-KV context.

Replaces ``anyv2v_tpu/ops/pallas_attention.py`` (``_flash_kernel``,
``_flash_splitkv_kernel``) and ``anyv2v_tpu/ops/pallas_cross_attention.py``
(``_cross_kernel``); ``csrc/flash_attention.cu`` is one body for the three,
``wgmma`` on tiles that TMA loads into an mbarrier-guarded ring
(:func:`flash_plan` sizes it):

- long self or cross attention at head widths 40/64/80/160 (ConsistI2V's
  spatial cross-attention, 5/10/20 heads of 64, and its temporal
  transformer's cross-attention over ``[B, F*HW, C]``, 8 heads of 40/80/160);
- the same with an fp32 score bias added after the scale (``_flash_kernel``'s
  ``bias_ref``): ``[H, Sq, Sk]`` shared by the batch, or ``[B, H, Sq, Sk]``,
  at every width of :data:`HEAD_DIMS`: the Pallas kernel's (every multiple
  of 8 up to 128) and 160 (SD1.5's and VideoLDM's widest heads), which
  cover the padded widths of the repo's models (8/16/32 stored for
  i2vgen-xl's 5/10/20, and 40/64/80/160);
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

HEAD_DIMS = tuple(range(8, 129, 8)) + (160,)
BLOCK_ROWS = 128   # query rows per block: two consumer warpgroups of 64
BLOCK_KEYS = 128   # keys per K/V tile
THREADS = 384      # two consumer warpgroups and one producer warpgroup


def flash_plan(b: int, sq: int, heads: int, head_dim: int, bias: Optional[str] = None,
               sk: int = 0) -> dict:
    """The launch of K5's kernel: one block per (128 query rows, head, batch
    row); shared memory holds Q (the score depth padded to 16) and a ring of
    K/V tiles of 128 keys, 3 stages (2 at head widths past 80), plus one
    mbarrier per stage and direction, one for Q, and 128 bytes of alignment
    slack. ``csrc/flash_attention.cu`` refuses a plan whose bytes differ
    from its own layout. ``bias`` ("shared" or "batch", over ``sk`` keys)
    adds no shared memory: each consumer thread reads its scores' bias from
    global memory, every block its own ``[128, Sk]`` rows, so that
    ``bias_bytes_read`` is the whole bias once per batch row whichever its
    form (the grid's batch index is the slowest)."""
    if bias not in (None, "shared", "batch"):
        raise ValueError(f"flash_plan: bias {bias!r}, expected None, 'shared' or 'batch'")
    dp = -(-head_dim // 16) * 16
    stages = 2 if head_dim > 80 else 3
    q_bytes = BLOCK_ROWS * dp * 2
    kv_bytes = BLOCK_KEYS * (dp + head_dim) * 2
    return {"stages": stages, "threads": THREADS, "bias": bias,
            "bias_bytes_read": 0 if bias is None else b * heads * sq * sk * 4,
            "smem_bytes": q_bytes + stages * kv_bytes + (2 * stages + 1) * 8 + 128,
            "grid": (-(-sq // BLOCK_ROWS), heads, b)}


def bias_form(bias: torch.Tensor, b: int, heads: int, sq: int, sk: int) -> Optional[str]:
    """The kernel's name for a bias operand's shape: "shared" for ``[H, Sq,
    Sk]`` or ``[1, H, Sq, Sk]``, "batch" for ``[B, H, Sq, Sk]``, else None
    (a shape the kernel does not take)."""
    shape = tuple(bias.shape)
    if shape in ((heads, sq, sk), (1, heads, sq, sk)):
        return "shared"
    if shape == (b, heads, sq, sk):
        return "batch"
    return None


def _with_context(k: torch.Tensor, k_ctx: Optional[torch.Tensor], frames: int) -> torch.Tensor:
    if k_ctx is None:
        return k
    return torch.cat([k, k_ctx.repeat_interleave(frames, dim=0)], dim=1)


def _biased_plain(q, k, v, heads, scale, bias):
    """fp32 scores plus the bias, softmax, output in q's dtype; chunked over
    (batch, head) pairs as :func:`folded_attention_plain` is."""
    b, sq, c = q.shape
    sk = k.shape[1]
    dh = c // heads

    def split(x, s):
        return x.reshape(b, s, heads, dh).transpose(1, 2).reshape(b * heads, s, dh)

    qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
    b4 = bias.reshape(-1, heads, sq, sk)   # a shared bias is never expanded over the batch
    pairs = torch.arange(b * heads, device=q.device)
    out = torch.empty_like(qh)
    step = max(1, (1 << 28) // max(1, sq * sk))
    for i in range(0, b * heads, step):
        idx = pairs[i:i + step]
        s = torch.bmm(qh[i:i + step].float(), kh[i:i + step].float().transpose(1, 2)) * scale
        p = torch.softmax(s + b4[(idx // heads) % b4.shape[0], idx % heads].float(), dim=-1)
        out[i:i + step] = torch.bmm(p, vh[i:i + step].float()).to(q.dtype)
    return out.reshape(b, heads, sq, dh).transpose(1, 2).reshape(b, sq, c)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          scale: float, k_ctx: Optional[torch.Tensor] = None,
                          v_ctx: Optional[torch.Tensor] = None,
                          frames: int = 1, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the context repeated per frame and concatenated
    on the key axis, then fp32 scores (plus the bias) and softmax."""
    if bias is not None:
        return _biased_plain(q, k, v, heads, scale, bias)
    return folded_attention_plain(q, _with_context(k, k_ctx, frames),
                                  _with_context(v, v_ctx, frames), heads, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: float, k_ctx: Optional[torch.Tensor] = None,
                    v_ctx: Optional[torch.Tensor] = None, frames: int = 1,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, Sq, H*dh]``, k/v ``[B, Sk, H*dh]``, optional k_ctx/v_ctx
    ``[B // frames, Sk2, H*dh]`` -> ``[B, Sq, H*dh]``. ``scale`` is explicit.
    ``bias``: a contiguous fp32 ``[H, Sq, Sk]`` / ``[1, H, Sq, Sk]`` (shared
    by the batch) or ``[B, H, Sq, Sk]``, added to the scaled scores; not with
    a context (the split-KV Pallas kernel has no bias either)."""
    if bias is not None:
        if k_ctx is not None:
            raise ValueError("flash_attention: a bias and a split-KV context do not go together")
        form = bias_form(bias, q.shape[0], heads, q.shape[1], k.shape[1])
        if form is None or bias.dtype != torch.float32 or bias.device != q.device:
            raise ValueError(f"flash_attention: bias must be float32 [H, Sq, Sk], [1, H, Sq, "
                             f"Sk] or [B, H, Sq, Sk] on {q.device}; got {bias.dtype} "
                             f"{list(bias.shape)} on {bias.device} for q{tuple(q.shape)} "
                             f"k{tuple(k.shape)} heads={heads}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, heads, scale, k_ctx, v_ctx, frames, bias)
    _build.require_cuda("flash_attention", q, k, v, k_ctx, v_ctx)
    _build.require_aligned("flash_attention", q, k, v, k_ctx, v_ctx)
    if bias is not None:
        _build.require_cuda("flash_attention", bias, dtype=torch.float32)
        _build.require_aligned("flash_attention", bias)
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
    form = None if bias is None else bias_form(bias, b, heads, sq, sk)
    plan = flash_plan(b, sq, heads, dh, form, sk)
    _build.check_plan("flash_attention", plan)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    rc = _build.library().anyv2v_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        null if k_ctx is None else _build.ptr(k_ctx),
        null if v_ctx is None else _build.ptr(v_ctx), _build.ptr(out),
        null if bias is None else _build.ptr(bias), ctypes.c_int(form == "batch"),
        ctypes.c_int(b), ctypes.c_int(sq), ctypes.c_int(sk), ctypes.c_int(sk2),
        ctypes.c_int(frames), ctypes.c_int(heads), ctypes.c_int(dh),
        ctypes.c_float(scale), ctypes.c_int(plan["smem_bytes"]), _build.stream())
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    if bias is not None:
        flash_attention.bias_launches += 1
    return out


flash_attention.launches = 0
flash_attention.bias_launches = 0   # of the launches, those with a bias
