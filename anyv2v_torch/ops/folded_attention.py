"""K1: softmax attention on heads folded into the channel dim, ``[B, S, H*dh]``.

Replaces the head-packed Pallas family of ``anyv2v_tpu/ops/``:
``pallas_packed_flash.py`` (``_packed_whole_pipe_kernel``, ``_wide_kv_kernel``,
``_wide_t_kernel``, ``_packed_whole_kernel``, ``_packed_kernel``) and
``pallas_short_attention.py::_short_kernel``. Those bodies differ only in how
they fit the TPU's 128-lane tiles. On the GPU (``csrc/folded_attention.cu``)
two bodies cover self and cross attention at every Sq and Sk and padded head
widths 8/16/32/64, each a kernel symbol of its own:

- ``folded_attention_kernel``, the Hopper body: persistent blocks of a TMA
  producer and ``wgmma`` consumer warpgroups on mbarrier rings, each
  warpgroup stepping through (64 query rows, head) units over 64-key stages,
  for the long key axes (the spatial self-attentions), in one of two block
  layouts (``LAYOUTS``): "wg3" at head width 8 where its items fill the card,
  three consumer warpgroups beside a producer warpgroup that gives its
  registers up by ``setmaxnreg`` (three softmax chains a sub-partition);
  "warp2" elsewhere, two consumer warpgroups and a producer warp;
- ``folded_attention_short_kernel``, the short body: ``mma.sync`` on K/V
  tiles from a ``cp.async`` ring, for Sq <= 32 (the image-latent encoder at
  16 frames, seine-tiny's short calls), where a 64-row ``wgmma`` would be
  three quarters empty, and for the short-key class (Sk <= 192 where its
  grid fills the card: the cross-attentions over 157 keys, the mid block's
  self-attention, the 128-frame image-latent encoder), where an item of the
  Hopper body is one to three key stages and its fixed costs outweigh its
  steps.

:func:`folded_plan` sizes a launch and :func:`check_folded_plan` (registered
in ``_build.PLAN_CHECKS``) refuses a plan with any field changed; the C
entries refuse a plan that does not match the shape.

:func:`folded_attention` is the entry: CPU tensors take the plain version
below, CUDA tensors launch a kernel (and nothing else). Its ``launches``
counts every launch, ``short_launches`` those of the short body.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (8, 16, 32, 64)
SHORT_MAX_QUERIES = 32   # Sq up to this takes the short body
SHORT_MAX_KEYS = 192     # and Sk up to this, where its grid fills the card
GROUP_CHANNELS = 128     # channels of one block's head group, at most

# the Hopper body
BLOCK_KEYS = 64          # keys per K/V stage
UNITS = {8: 4, 16: 4, 32: 2, 64: 1}   # (64 rows, head) units a consumer warpgroup holds, at most
Q_STAGES, KV_STAGES = 2, 4
BARRIER_BYTES, ALIGN = 256, 128
# its block layouts (csrc Form, by id): consumer warpgroups, the producer's
# threads (a warp, or a warpgroup that gives registers up), the registers a
# thread of each after setmaxnreg (None: no setmaxnreg), and whether the
# output is staged for TMA stores (else stored from the registers)
LAYOUTS = {
    "warp2": {"id": 0, "warpgroups": 2, "producer_threads": 32, "producer_regs": None,
              "consumer_regs": None, "staged": True},
    "wg3": {"id": 1, "warpgroups": 3, "producer_threads": 128, "producer_regs": 24,
            "consumer_regs": 160, "staged": False},
}
# "wg3" at head width 8 where its items fill the card WG3_MIN_WAVES times and
# its 192-row items pad Sq to at most WG3_MAX_PAD times the rows of "warp2"'s
# 128-row items
WG3_MIN_WAVES, WG3_MAX_PAD = 4, 1.0625

# the short body
KEY_TILE = 64            # keys per stage of the K/V ring
MAX_WARPS = 8
STAGES = 2               # K/V ring stages (fixed in the kernel): two blocks share an SM


def folded_layout_bytes(head_dim: int, heads_per_block: int, q_tiles: int, staged: int,
                        q_stages: int, kv_stages: int) -> int:
    """Shared bytes of one Hopper-body block (``csrc/folded_attention.cu``
    ``make_layout``): a ring of Q tiles ``[64 * q_tiles, G]`` and one of K
    and V tiles ``[64, G]`` (G = the head group's channels), the output's
    staging (``staged`` units of ``[64, dh]``: every consumer warpgroup's
    where the layout stages it, else none), a zero and a ones chunk of 64 rows
    of 16 bytes, the barriers and the alignment slack."""
    g = heads_per_block * head_dim
    return (q_stages * 64 * q_tiles * g * 2 + 2 * kv_stages * BLOCK_KEYS * g * 2
            + staged * 64 * head_dim * 2 + 2 * BLOCK_KEYS * 16 + BARRIER_BYTES + ALIGN)


def _short_plan(b: int, sq: int, sk: int, heads: int, head_dim: int) -> dict:
    """The short body's launch: a block owns a tile of queries of one
    batch row and a group of whole heads spanning at most 128 channels, or,
    where the row is narrower, ``rows_per_block`` batch rows packed side by
    side. A warp owns up to ``64 / head_dim`` items of (head, 16 queries);
    the block takes one warp per item, up to ``MAX_WARPS``. Shared memory
    holds Q ``[16 * q_tiles, W]`` and ``STAGES`` stages of K and V
    ``[key_rows, W]`` (W = the packed tile's channels; ``key_rows`` 64, or
    Sk rounded to 16 where it is shorter), rows strided by an odd number of
    16-byte units. The grid is (query blocks x row groups, head groups)."""
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


def _hopper_plan(b: int, sq: int, sk: int, heads: int, head_dim: int, sms: int,
                 layout: str) -> dict:
    """The Hopper body's launch in ``layout`` (``LAYOUTS``) of ``nwg``
    consumer warpgroups: items of (batch row, head group, query tile of
    ``64 * q_tiles`` rows), ``q_tiles`` ``nwg`` where Sq > 64, else 1. An
    item is ``q_tiles * heads_per_block`` units of (64 rows, head), split
    over the consumer warpgroups, ``units`` each: each warpgroup takes its 64
    rows of every head (``nwg`` tiles) or every ``nwg``-th head (1 tile). The
    head group is the most whole heads that keep ``units`` within
    ``UNITS[head_dim]`` and the group within 128 channels. ``ntiles`` stages
    of ``BLOCK_KEYS`` keys an item, in a ring of ``KV_STAGES`` stages or as
    many as fit (at least 2); a persistent grid of one block per SM
    (``sms``), or one per item where there are fewer."""
    lay = LAYOUTS[layout]
    nwg = lay["warpgroups"]
    q_tiles = nwg if sq > 64 else 1
    cap = UNITS[head_dim] * (nwg // q_tiles)
    hb = max(d for d in range(1, heads + 1)
             if heads % d == 0 and d <= cap and d * head_dim <= GROUP_CHANNELS)
    units = -(-q_tiles * hb // nwg)
    staged = nwg * units if lay["staged"] else 0
    items = b * (heads // hb) * -(-sq // (64 * q_tiles))
    kv_stages = next((n for n in range(KV_STAGES, 2, -1) if folded_layout_bytes(
        head_dim, hb, q_tiles, staged, Q_STAGES, n) <= _build.SMEM_LIMIT), 2)
    return {"layout": layout, "warpgroups": nwg,
            "threads": 128 * nwg + lay["producer_threads"],
            "producer_regs": lay["producer_regs"], "consumer_regs": lay["consumer_regs"],
            "heads_per_block": hb, "q_tiles": q_tiles, "units": units, "q_stages": Q_STAGES,
            "kv_stages": kv_stages, "ntiles": -(-sk // BLOCK_KEYS), "items": items,
            "smem_bytes": folded_layout_bytes(head_dim, hb, q_tiles, staged, Q_STAGES,
                                              kv_stages),
            "grid": (max(1, min(items, sms)),)}


def folded_plan(b: int, sq: int, sk: int, heads: int, head_dim: int,
                sms: int = _build.H100_SMS) -> dict:
    """The launch of K1 for one shape; ``body`` names the kernel.

    The short body (:func:`_short_plan`) takes Sq <= ``SHORT_MAX_QUERIES``,
    and Sk <= ``SHORT_MAX_KEYS`` wherever its grid has at least one block
    per SM (``sms``): there an item of the Hopper body is one to three key
    stages, and its fixed costs (the Q wait, the first step, the staging and
    the store) outweigh its steps. ``scripts/torch_k1_classes.py`` times both
    bodies over a sweep of Sk at each head width: past 192 keys the short
    body still wins at 64 queries, but loses at i2vgen-xl's L2
    self-attention (256 queries, 256 keys). The Hopper body
    (:func:`_hopper_plan`) takes the rest, in the layout "wg3" at head width
    8 where its items fill the card ``WG3_MIN_WAVES`` times (its 192-row
    items leave the last wave of a small call part empty) and pad the query
    rows no more than ``WG3_MAX_PAD`` times "warp2"'s (Sq 200: 384 rows
    against 256, and 11-20 % slower), else "warp2"."""
    shape = {"b": b, "sq": sq, "sk": sk, "heads": heads, "head_dim": head_dim, "sms": sms}
    short = _short_plan(b, sq, sk, heads, head_dim)
    if sq <= SHORT_MAX_QUERIES or (sk <= SHORT_MAX_KEYS
                                   and short["grid"][0] * short["grid"][1] >= sms):
        return {"shape": shape, "body": "short", **short}
    plan = _hopper_plan(b, sq, sk, heads, head_dim, sms, "warp2")
    if head_dim == 8 and _takes_wg3(b, sq, sk, heads, sms):
        plan = _hopper_plan(b, sq, sk, heads, head_dim, sms, "wg3")
    return {"shape": shape, "body": "hopper", **plan}


def _takes_wg3(b: int, sq: int, sk: int, heads: int, sms: int) -> bool:
    """Whether a Hopper-body call at head width 8 takes the layout "wg3"."""
    wg3 = _hopper_plan(b, sq, sk, heads, 8, sms, "wg3")
    return (wg3["items"] >= WG3_MIN_WAVES * sms
            and -(-sq // 192) * 192 <= WG3_MAX_PAD * -(-sq // 128) * 128)


def check_folded_plan(plan: dict) -> None:
    """Raise unless ``plan`` is :func:`folded_plan`'s plan for its own
    ``shape``: a plan with any field changed is refused before a launch."""
    if plan != folded_plan(**plan["shape"]):
        raise ValueError(f"folded_attention: no launch for this plan: {plan}")


_build.PLAN_CHECKS["folded_attention"] = check_folded_plan


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
    plan = folded_plan(b, sq, k.shape[1], heads, dh, sms=_build.sm_count(q.device))
    _build.check_plan("folded_attention", plan)
    return launch(q, k, v, heads, scale, plan)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float,
           plan: dict) -> torch.Tensor:
    """Launch the kernel of ``plan["body"]`` on checked CUDA tensors; the C
    entry refuses a plan that does not match the shape. The wrapper takes
    :func:`folded_plan`'s plan; a probe may take either body's plan for a
    shape (``scripts/torch_k1_classes.py``)."""
    b, sq, c = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    shape = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             ctypes.c_int(b), ctypes.c_int(sq), ctypes.c_int(k.shape[1]),
             ctypes.c_int(heads), ctypes.c_int(c // heads), ctypes.c_float(scale))
    if plan["body"] == "short":
        rc = lib.anyv2v_folded_attention_short(
            *shape, *(ctypes.c_int(plan[key]) for key in (
                "heads_per_block", "rows_per_block", "q_tiles", "warps", "smem_bytes")),
            _build.stream())
    else:
        rc = lib.anyv2v_folded_attention(
            *shape, ctypes.c_int(LAYOUTS[plan["layout"]]["id"]), *(ctypes.c_int(plan[key]) for key in (
                "heads_per_block", "q_tiles", "units", "q_stages", "kv_stages")),
            ctypes.c_int(plan["grid"][0]), ctypes.c_int(plan["smem_bytes"]), _build.stream())
    _build.check(rc, "folded_attention")
    folded_attention.launches += 1
    if plan["body"] == "short":
        folded_attention.short_launches += 1
    return out


folded_attention.launches = 0
folded_attention.short_launches = 0
