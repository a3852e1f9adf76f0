"""K1: softmax attention on heads folded into the channel dim, ``[B, S, H*dh]``.

Replaces the head-packed Pallas family of ``anyv2v_tpu/ops/``:
``pallas_packed_flash.py`` (``_packed_whole_pipe_kernel``, ``_wide_kv_kernel``,
``_wide_t_kernel``, ``_packed_whole_kernel``, ``_packed_kernel``) and
``pallas_short_attention.py::_short_kernel``. Those bodies differ only in how
they fit the TPU's 128-lane tiles; on the GPU one tensor-core kernel
(``csrc/folded_attention.cu``: ``mma.sync`` on K/V tiles brought in by a
``cp.async`` ring) covers self and cross attention at every Sq and Sk and
padded head widths 8/16/32/64. It replaces a CUDA-core body with one thread
per query row, which took 2.2-3.0x SDPA's time at i2vgen-xl's L0 and L1 self.
At dh 8 the softmax's exp2 count bounds it, not bytes (the source says how
the design keeps the instructions around each exp2 few).

:func:`folded_plan` sizes a launch: a block owns a tile of queries of one
batch row and a group of whole heads spanning at most 128 channels, or, where
a row is narrower, several batch rows packed side by side. The C entry
refuses a plan that does not match the shape.

:func:`folded_attention` is the entry: CPU tensors take the plain version
below, CUDA tensors launch the kernel (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (8, 16, 32, 64)
GROUP_CHANNELS = 128   # channels of one block's tile, at most
KEY_TILE = 64          # keys per stage of the K/V ring
MAX_WARPS = 8
STAGES = 2             # K/V ring stages (fixed in the kernel): two blocks share an SM


def folded_plan(b: int, sq: int, sk: int, heads: int, head_dim: int) -> dict:
    """The launch of K1's kernel for one shape.

    The head group is the most whole heads that fit in ``GROUP_CHANNELS``
    channels; where it spans the whole row (``C < 128``), ``rows_per_block``
    batch rows are packed side by side into one tile. A warp owns up to
    ``64 / head_dim`` items of (head, 16 queries), so a block of
    ``MAX_WARPS`` warps holds ``q_tiles`` tiles of 16 queries (64 queries
    at 128 channels), fewer when Sq is short; there the block still takes
    one warp per item, up to ``MAX_WARPS``, so that a short block (the
    16-frame image-latent encoder: 8 rows of 2 heads, one query tile) does
    not run on two warps. Shared memory holds Q
    ``[16 * q_tiles, W]`` and ``STAGES`` stages of K and V ``[key_rows, W]``
    (W = the packed tile's channels; ``key_rows`` 64, or Sk rounded to 16
    where it is shorter), rows strided by an odd number of
    16-byte units. The grid is (query blocks x row groups, head groups).
    ``csrc/folded_attention.cu`` recomputes the shared bytes and refuses a
    plan that differs."""
    hb = max(d for d in range(1, heads + 1)
             if heads % d == 0 and d * head_dim <= GROUP_CHANNELS)
    g = hb * head_dim
    rows = min(b, GROUP_CHANNELS // g) if hb == heads else 1
    width = rows * g
    vheads = rows * hb
    per_warp = 64 // head_dim
    q_tiles = max(1, min(MAX_WARPS * per_warp // vheads, -(-sq // 16)))
    warps = min(MAX_WARPS, vheads * q_tiles)
    row_stride = width + 8 + 8 * ((width // 8) % 2)
    key_rows = min(KEY_TILE, -(-sk // 16) * 16)
    return {"heads_per_block": hb, "rows_per_block": rows, "q_tiles": q_tiles,
            "warps": warps, "row_stride": row_stride, "key_rows": key_rows,
            "smem_bytes": (16 * q_tiles + STAGES * 2 * key_rows) * row_stride * 2,
            "grid": (-(-sq // (16 * q_tiles)) * -(-b // rows), heads // hb)}


def folded_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores and softmax, output in q's dtype.

    Chunks over (batch, head) pairs so the fp32 score tensor stays near
    1 GiB: the L0 self-attention of an edit step would need
    [48, 64, 4096, 4096] fp32 = 206 GB at once."""
    b, sq, c = q.shape
    sk = k.shape[1]
    dh = c // heads

    def split(x, s):
        return x.reshape(b, s, heads, dh).transpose(1, 2).reshape(b * heads, s, dh)

    qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
    out = torch.empty_like(qh)
    step = max(1, (1 << 28) // max(1, sq * sk))
    for i in range(0, b * heads, step):
        s = torch.bmm(qh[i:i + step].float(), kh[i:i + step].float().transpose(1, 2)) * scale
        p = torch.softmax(s, dim=-1)
        out[i:i + step] = torch.bmm(p, vh[i:i + step].float()).to(q.dtype)
    return out.reshape(b, heads, sq, dh).transpose(1, 2).reshape(b, sq, c)


def folded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: float) -> torch.Tensor:
    """q ``[B, Sq, H*dh]``, k/v ``[B, Sk, H*dh]`` -> ``[B, Sq, H*dh]``.

    ``scale`` is explicit: with padded head storage it comes from the true
    head width, not from ``dh``."""
    if q.device.type == "cpu":
        return folded_attention_plain(q, k, v, heads, scale)
    _build.require_cuda("folded_attention", q, k, v)
    b, sq, c = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != c or c % heads:
        raise ValueError(f"folded_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    dh = c // heads
    if dh not in HEAD_DIMS:
        raise ValueError(f"folded_attention: head width {dh} not in {HEAD_DIMS}")
    _build.require_aligned("folded_attention", q, k, v)
    plan = folded_plan(b, sq, k.shape[1], heads, dh)
    _build.check_plan("folded_attention", plan)
    out = torch.empty_like(q)
    rc = _build.library().anyv2v_folded_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(sq), ctypes.c_int(k.shape[1]),
        ctypes.c_int(heads), ctypes.c_int(dh), ctypes.c_float(scale),
        *(ctypes.c_int(plan[key]) for key in ("heads_per_block", "rows_per_block", "q_tiles",
                                              "warps", "smem_bytes")),
        _build.stream())
    _build.check(rc, "folded_attention")
    folded_attention.launches += 1
    return out


folded_attention.launches = 0
