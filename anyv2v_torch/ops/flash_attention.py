"""K5: softmax attention with an online softmax on tensor cores, heads folded
into the channel dim ``[B, S, H*dh]``, with an optional additive score bias
or an optional split-KV context.

Replaces ``anyv2v_tpu/ops/pallas_attention.py`` (``_flash_kernel``,
``_flash_splitkv_kernel``) and ``anyv2v_tpu/ops/pallas_cross_attention.py``
(``_cross_kernel``); ``csrc/flash_attention.cu`` holds two bodies for the
three, both persistent blocks of consumer warpgroups beside a TMA producer
(a warp; the short body's a warpgroup) on mbarrier-guarded rings, ``wgmma``
for both products (:func:`flash_plan` picks the body, the walk, the tiles
and the rings):

- the tiles body (``body`` "tiles"): (query tile, head, batch row) items over
  128-key K/V tiles, the softmax of one key tile overlapped with the
  previous tile's products, K/V kept resident where the key axis is one
  tile, the output staged and TMA-stored; every biased or split-KV call and
  every long key axis;
- the short body (``body`` "short", the one-key-tile class without a bias
  at the models' head widths): items of 64 query rows and a group of heads
  whose channels are whole 64-channel chunks (8 heads of 40, 5 of 64, 4 of
  80, 2 of 160), one of three consumer warpgroups an item, the group's K
  and V resident per (batch row, group) at a
  key width of Sk rounded up to 16, Q streamed as 128-byte-swizzled chunks,
  one exact softmax per head, the output written from the accumulators;

at the calls:

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
import math
from typing import Optional

import torch

from . import _build
from .folded_attention import folded_attention_plain

HEAD_DIMS = tuple(range(8, 129, 8)) + (160,)
TILE_ROWS = (64, 128)   # query rows of a work item: one consumer warpgroup per 64
BLOCK_KEYS = 128        # keys per K/V tile
MAX_STAGES = 4          # of the Q ring and of the K/V ring
BARRIER_BYTES, ALIGN_SLACK = 256, 1024   # the slack aligns the tiles to the swizzle atom
L2_BYTES = 50 * 2 ** 20
# the one-key-tile body ("short"): the models' head widths, 64-row items, a
# group of heads of at most 320 channels, Q chunks of 64 rows x 64 channels
SHORT_HEAD_DIMS = (40, 64, 80, 160)
SHORT_ROWS, SHORT_SLOTS, SHORT_CHUNK = 64, 15, 64 * 128
SHORT_WGS = 3   # consumer warpgroups of the short body, each its own items
GROUP_CHANNELS = 320
SHORT_MAX_KEYS = 80     # past it the tiles body measured faster
KEY_TILES = tuple(range(16, SHORT_MAX_KEYS + 1, 16))   # the short body's key widths


def flash_layout_bytes(head_dim: int, tile_rows: int, q_stages: int, kv_stages: int) -> int:
    """Shared bytes of one block (``csrc/flash_attention.cu`` ``make_layout``):
    a ring of Q tiles ``[tile_rows, dh]`` and one of K and V tiles ``[128,
    dh]`` (Q and K with the score depth padded to 16), the output's staging
    ``[tile_rows, dh]``, the barriers and 1024 bytes of alignment slack."""
    dp = -(-head_dim // 16) * 16
    return (q_stages * tile_rows * dp * 2 + kv_stages * BLOCK_KEYS * (dp + head_dim) * 2
            + tile_rows * head_dim * 2 + BARRIER_BYTES + ALIGN_SLACK)


def _fits(head_dim, tile_rows, q_stages, kv_stages):
    return flash_layout_bytes(head_dim, tile_rows, q_stages, kv_stages) <= _build.SMEM_LIMIT


def flash_short_bytes(key_tile: int, q_chunks: int, slots: int) -> int:
    """Shared bytes of one block of the short body (``csrc/flash_attention.cu``
    ``make_short_layout``): ``slots`` Q chunks of 64 rows x 64 channels; K,
    ``key_tile`` rows of an item's ``q_chunks`` 64-channel chunks and 16
    bytes more (the zero chunk of the unswizzled layout); V from the next
    1024-byte boundary without the 16 bytes; the barriers and the alignment
    slack."""
    row = q_chunks * 128
    k_bytes = -(-(row + 16) * key_tile // 1024) * 1024
    return slots * SHORT_CHUNK + k_bytes + row * key_tile + BARRIER_BYTES + ALIGN_SLACK


def _short_plan(b: int, sq: int, heads: int, head_dim: int, sk: int, sms: int) -> Optional[dict]:
    """The short body's fields for an unbiased one-key-tile call of at most
    :data:`SHORT_MAX_KEYS` keys, or None where it does not take the call:
    another width, or no head group of whole 64-channel chunks (or of every
    head) whose Q ring holds an item's chunks for each consumer warpgroup
    beside its K and V and whose items give each consumer warpgroup of
    ``sms`` blocks one at least (a block's heads run one after another, so a
    call of fewer items is faster on the tiles body's one head an item).
    The largest group whose items give every warpgroup two is taken, else
    the largest whose items give it one."""
    if head_dim not in SHORT_HEAD_DIMS or not 0 < sk <= SHORT_MAX_KEYS:
        return None
    key_tile = -(-sk // 16) * 16
    span = math.lcm(head_dim, 64)   # the fewest heads that are whole 64-channel chunks
    unit = span // head_dim
    for rounds in (2, 1):
        for group in range(unit * max(1, GROUP_CHANNELS // span), 0, -unit):
            group = min(group, heads)
            chunks = -(-group * head_dim // 64)
            room = (_build.SMEM_LIMIT - flash_short_bytes(key_tile, chunks, 0)) // SHORT_CHUNK
            slots = min(SHORT_SLOTS, room)
            items = -(-sq // SHORT_ROWS) * -(-heads // group) * b
            if slots >= SHORT_WGS * chunks and items >= rounds * SHORT_WGS * sms:
                return {"key_tile": key_tile, "head_group": group, "q_chunks": chunks,
                        "q_slots": slots, "items": items,
                        "smem_bytes": flash_short_bytes(key_tile, chunks, slots)}
    return None


def flash_plan(b: int, sq: int, heads: int, head_dim: int, bias: Optional[str] = None,
               sk: int = 0, *, sk2: int = 0, sms: int = _build.H100_SMS) -> dict:
    """The launch of K5's persistent kernel over ``b * heads * ceil(sq /
    tile_rows)`` work items (a query tile, a head, a batch row); ``sk`` and
    ``sk2`` are the own and context key lengths (0: not known, and then K/V
    is never taken as resident).

    - ``tile_rows``: 128 (two consumer warpgroups), or 64 (one) where
      128-row items would leave the ``sms`` SMs under one wave, or where
      128 rows do not fit with two K/V stages (head width 160).
    - ``resident``: the whole key axis is one tile (``0 < sk <= 128``, no
      context); a block then walks a contiguous run of items and loads each
      (batch row, head)'s K/V once for the run (1 or 2 K/V stages), Q
      through a ring of up to 4. Otherwise the walk is strided (block x
      takes items x, x + grid, ...), 2 Q stages and as many K/V stages as
      fit, up to 4.
    - ``threads``: 128 a consumer warpgroup and a producer warp of 32 (the
      short body: :data:`SHORT_WGS` consumer warpgroups and a producer
      warpgroup).
    - ``order``: which index of an item runs fastest, "query" (its K/V is
      shared with the items in flight) or "batch" (with a bias shared by the
      batch and a strided walk: the blocks in flight read the same bias
      rows).
    - ``grid``: one block per SM, or one per item where there are fewer.
    - ``bias_bytes_read``: the bias bytes from HBM in this order: a shared
      bias once where the batch runs fastest or it fits half the 50 MB L2,
      else once per batch row; a per-row bias once.

    ``csrc/flash_attention.cu`` refuses a plan whose bytes are not its layout
    of these fields; :func:`check_flash_plan` (through ``_build.check_plan``)
    refuses one that is not this function's plan for its ``shape``.

    ``body`` names the kernel body (both are ``flash_attention_kernel``,
    overloaded on their parameters): "tiles", every call above, ``key_tile``
    128, ``head_group`` 1, the output staged and TMA-stored (``store``
    "tma"); or "short", an unbiased call with ``0 < sk <= 80``, no context
    and a head width of :data:`SHORT_HEAD_DIMS` (:func:`_short_plan`): items
    of 64 query rows and ``head_group`` heads (8 of 40, 5 of 64, 4 of 80, 2
    of 160: 320 channels, whole 64-channel chunks; fewer where the items
    would not give each warpgroup two), one of the block's
    :data:`SHORT_WGS` consumer warpgroups an item, ``threads`` with a
    producer warpgroup, ``key_tile`` = ``sk`` rounded up to 16 (the score
    product's width and P.V's depth), K and V of the group resident per
    (batch row, group), Q through ``q_slots`` chunk slots of 64 rows x 64
    channels (``q_chunks`` an item), the output written from the
    accumulators (``store`` "plain"); a block walks a contiguous run of
    items, query tile fastest, then group, then batch row."""
    if bias not in (None, "shared", "batch"):
        raise ValueError(f"flash_plan: bias {bias!r}, expected None, 'shared' or 'batch'")
    shape = {"b": b, "sq": sq, "heads": heads, "head_dim": head_dim, "bias": bias, "sk": sk,
             "sk2": sk2, "sms": sms}
    short = _short_plan(b, sq, heads, head_dim, sk, sms) if bias is None and sk2 == 0 else None
    if short is not None:
        return {"shape": shape, "body": "short", "store": "plain", "tile_rows": SHORT_ROWS,
                "threads": 128 * (SHORT_WGS + 1), "resident": True, "order": "query", **short,
                "bias": None, "bias_bytes_read": 0, "grid": (max(1, min(short["items"], sms)),)}
    resident = 0 < sk <= BLOCK_KEYS and sk2 == 0
    kv_min = 1 if resident else 2
    tile_rows = 128
    if -(-sq // 128) * heads * b < sms or not _fits(head_dim, 128, 2, kv_min):
        tile_rows = 64
    if resident:
        kv_stages = 2 if _fits(head_dim, tile_rows, 2, 2) else 1
        q_stages = next(n for n in range(MAX_STAGES, 1, -1)
                        if _fits(head_dim, tile_rows, n, kv_stages))
    else:
        q_stages = 2
        kv_stages = next(n for n in range(MAX_STAGES, 1, -1) if _fits(head_dim, tile_rows, 2, n))
    items = -(-sq // tile_rows) * heads * b
    order = "batch" if bias == "shared" and not resident else "query"
    one_read = heads * sq * sk * 4
    if bias is None:
        bias_bytes = 0
    elif bias == "shared" and (order == "batch" or one_read <= L2_BYTES // 2):
        bias_bytes = one_read
    else:
        bias_bytes = b * one_read
    return {"shape": shape, "body": "tiles", "store": "tma", "key_tile": BLOCK_KEYS,
            "head_group": 1, "tile_rows": tile_rows, "threads": 128 * (tile_rows // 64) + 32,
            "resident": resident, "order": order, "q_stages": q_stages, "kv_stages": kv_stages, "items": items,
            "bias": bias, "bias_bytes_read": bias_bytes,
            "smem_bytes": flash_layout_bytes(head_dim, tile_rows, q_stages, kv_stages),
            "grid": (max(1, min(items, sms)),)}


def check_flash_plan(plan: dict) -> None:
    """Raise unless ``plan`` is :func:`flash_plan`'s plan for its own
    ``shape``: a plan with any field changed is refused before a launch."""
    if plan != flash_plan(**plan["shape"]):
        raise ValueError(f"flash_attention: no launch for this plan: {plan}")


_build.PLAN_CHECKS["flash_attention"] = check_flash_plan


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
    plan = flash_plan(b, sq, heads, dh, form, sk, sk2=sk2, sms=_build.sm_count(q.device))
    _build.check_plan("flash_attention", plan)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    if plan["body"] == "short":
        rc = _build.library().anyv2v_flash_attention_short(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), ctypes.c_int(b),
            ctypes.c_int(sq), ctypes.c_int(sk), ctypes.c_int(heads), ctypes.c_int(dh),
            ctypes.c_float(scale), ctypes.c_int(plan["key_tile"]),
            ctypes.c_int(plan["head_group"]), ctypes.c_int(plan["q_slots"]),
            ctypes.c_int(plan["grid"][0]), ctypes.c_int(plan["smem_bytes"]), _build.stream())
        _build.check(rc, "flash_attention")
        flash_attention.launches += 1
        return out
    rc = _build.library().anyv2v_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        null if k_ctx is None else _build.ptr(k_ctx),
        null if v_ctx is None else _build.ptr(v_ctx), _build.ptr(out),
        null if bias is None else _build.ptr(bias), ctypes.c_int(form == "batch"),
        ctypes.c_int(b), ctypes.c_int(sq), ctypes.c_int(sk), ctypes.c_int(sk2),
        ctypes.c_int(frames), ctypes.c_int(heads), ctypes.c_int(dh),
        ctypes.c_float(scale), ctypes.c_int(plan["tile_rows"]), ctypes.c_int(plan["q_stages"]),
        ctypes.c_int(plan["kv_stages"]), ctypes.c_int(plan["resident"]),
        ctypes.c_int(plan["order"] == "batch"), ctypes.c_int(plan["grid"][0]),
        ctypes.c_int(plan["smem_bytes"]), _build.stream())
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    if bias is not None:
        flash_attention.bias_launches += 1
    return out


flash_attention.launches = 0
flash_attention.bias_launches = 0   # of the launches, those with a bias
