"""KN: the port's norms, each one pass with fp32 statistics that writes its
output once, in the dtype the caller uses next (``csrc/norm.cu``).

- :func:`group_norm`: group norm over every axis but the first and last of a
  channels-last ``[N, ..., C]`` tensor, SiLU fused where the caller applies
  one: a statistics kernel (Welford per channel, Chan's merge across
  channels, pixel slots and blocks), then an apply kernel
  ``y = x * s + t`` per (n, channel) in fp32, rounded once. The apply cuts
  the pixels of an image on its own grid: where N is small (i2vgen-xl's
  temporal norm takes a whole clip as one image) it fills the card while
  the statistics keep few partials for each apply block to merge. Where
  each image is split over ranks (a rank's frames of a clip), the two
  kernels are two calls, and every rank's partials are gathered between
  them.
- :func:`group_scale_shift`: the same statistics as K4's prologue takes
  them, ``s, t [N, C]`` fp32 (:mod:`anyv2v_torch.ops.temporal_conv`).
- :func:`layer_norm`: layer norm over rows of width C, one pass a row held
  in registers.

No Pallas kernel corresponds: the JAX package leaves its norms to XLA. Each
wrapper has its plain PyTorch version beside it (the same arithmetic: fp32
statistics, fp32 affine and SiLU, one rounding), which runs for CPU tensors
only; for CUDA tensors the wrapper launches the kernels or raises, and counts
its calls that launched (``.launches``). Inputs bf16 or fp32, outputs bf16
or fp32, the affine parameters bf16 or fp32; C a multiple of 8 (of 4 for the
layer norm) up to 4096. The kernels allocate nothing: the wrapper allocates
the output and the group norm's partial statistics (``N x G x splits x 3``
floats).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 4096
DTYPES = (torch.bfloat16, torch.float32)
GN_MAX_THREADS = 512
GN_SMEM_LIMIT = 48 * 1024      # static-size default: no attribute is set
# the statistics' grid aims at this many blocks an SM: the group norm's
# (statistics, then apply) at 8; K4's statistics alone at 2, one wave
GN_BLOCKS_PER_SM, GN_BLOCKS_PER_SM_STATS_ONLY = 8, 2
MIN_SPLIT_BYTES = 32 * 1024    # of x a split streams, at least
# statistics splits an image at most: the apply merges G x splits partials in
# every block; K4's statistics merge them once, in one block an image. The
# apply's own splits have no such cap.
MAX_SPLITS, MAX_SPLITS_STATS_ONLY = 128, 256
LN_THREADS = 256
LN_CHUNKS = (1, 2, 4, 8, 16)   # chunks a lane (csrc/norm.cu instances)
LN_BLOCKS_PER_SM = 4


def norm_plan(n: int, p: int, c: int, groups: int, itemsize: int = 2, stats_only: bool = False,
              sms: int = _build.H100_SMS, shares: int = 1) -> dict:
    """The group norm's launches over ``[N, P, C]``: blocks of ``C / 8``
    channel columns (a thread's 16-byte load is 8 channels) by ``rows``
    pixel slots (``256 // (C / 8)``, at least 1), rounded up to whole warps;
    grid ``(splits, N)``, a split ``split_rows`` contiguous pixels of one
    image (a multiple of ``rows``). The splits follow from N, P and C: as
    many as put ``GN_BLOCKS_PER_SM`` blocks on every SM
    (``GN_BLOCKS_PER_SM_STATS_ONLY`` for K4's statistics), but at most one a
    ``rows`` pixels, one a ``MIN_SPLIT_BYTES`` of x, and ``MAX_SPLITS``
    (``MAX_SPLITS_STATS_ONLY`` for K4's statistics, whose partials one block
    an image merges). The apply's grid ``(apply_splits, N)`` cuts the same
    way without ``MAX_SPLITS`` (each of its blocks merges the statistics'
    partials, whatever its own pixels): where that cap binds (N of 1-3
    clips, the VAE's encode of one frame) the apply still fills the card.
    Where x is one of ``shares`` shares of each image's pixels (a rank's
    frames), the apply merges every share's partials: the statistics then
    take at most ``MAX_SPLITS // shares`` splits, so that it merges no more
    than one whole image's would. ``smem_bytes``: the statistics block's
    shared memory (per-channel moments of every slot, per-group moments of
    every slot);
    ``scratch_floats``: the partials."""
    if c <= 0 or c % 8 or c > MAX_CHANNELS or groups <= 0 or c % groups:
        raise ValueError(f"norm_plan: C={c}, groups={groups}: C must be a multiple of 8 and "
                         f"of the groups, at most {MAX_CHANNELS}")
    if n <= 0 or p <= 0:
        raise ValueError(f"norm_plan: N={n}, P={p}")
    c8 = c // 8
    rows = max(1, 256 // c8)
    threads = -(-c8 * rows // 32) * 32
    cap, per_sm = ((MAX_SPLITS_STATS_ONLY, GN_BLOCKS_PER_SM_STATS_ONLY) if stats_only
                   else (max(1, MAX_SPLITS // shares), GN_BLOCKS_PER_SM))
    most = min(-(-p // rows), max(1, p * c * itemsize // MIN_SPLIT_BYTES))

    def cut(at_most):
        splits = max(1, min(-(-per_sm * sms // n), at_most))
        split_rows = -(-(-(-p // splits)) // rows) * rows
        return -(-p // split_rows), split_rows

    splits, split_rows = cut(min(cap, most))
    apply_splits, apply_split_rows = cut(most) if not stats_only else (splits, split_rows)
    return {"threads": threads, "rows": rows, "splits": splits, "split_rows": split_rows,
            "grid": (splits, n, 1), "apply_splits": apply_splits,
            "apply_split_rows": apply_split_rows,
            "smem_bytes": 4 * (2 * rows * c + rows + 2 * rows * groups),
            "scratch_floats": n * groups * splits * 3}


def check_group_plan(plan: dict) -> None:
    if plan["smem_bytes"] > GN_SMEM_LIMIT or plan["threads"] > GN_MAX_THREADS:
        raise ValueError(f"group_norm: no launch for this shape: {plan}")


_build.PLAN_CHECKS["group_norm"] = check_group_plan


def layer_norm_plan(rows: int, c: int, sms: int = _build.H100_SMS) -> dict:
    """The layer norm's launch over ``[rows, C]``: loads of ``vec`` channels
    (8, or 4 where C is not a multiple of 8), ``lanes`` lanes a row (the
    least power of two, at most 32, that leaves each lane 4 chunks or fewer),
    each lane ``chunks`` chunks at most (a power of two up to 16: 8 at C
    1280, 16 past 2048; more chunks a lane cost registers and residency);
    blocks of 256 threads, as many as the rows need up to
    ``LN_BLOCKS_PER_SM`` an SM (a block walks further rows)."""
    if c <= 0 or c % 4 or c > MAX_CHANNELS:
        raise ValueError(f"layer_norm_plan: C={c}: C must be a multiple of 4, at most "
                         f"{MAX_CHANNELS}")
    if rows <= 0:
        raise ValueError(f"layer_norm_plan: {rows} rows")
    vec = 8 if c % 8 == 0 else 4
    n_chunks = c // vec
    lanes = min(32, 1 << (-(-n_chunks // 4) - 1).bit_length())
    chunks = next((j for j in LN_CHUNKS if j * lanes >= n_chunks), None)
    if chunks is None:
        raise ValueError(f"layer_norm_plan: C={c} needs more than {LN_CHUNKS[-1]} chunks a lane")
    per_block = LN_THREADS // lanes
    grid = max(1, min(-(-rows // per_block), LN_BLOCKS_PER_SM * sms))
    return {"vec": vec, "lanes": lanes, "chunks": chunks, "threads": LN_THREADS,
            "grid": (grid, 1, 1), "smem_bytes": 8 * c}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float, dtype: torch.dtype, silu: bool = False,
                     gather=None) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
    if gather is not None:
        var, mean = _merged_moments(gather, var, mean, xf.shape[1] * xf.shape[3])
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    return (F.silu(y) if silu else y).to(dtype)


def _merged_moments(gather, var, mean, count):
    """The variance and mean of each (n, group) over every share: this
    share's (count, mean, M2) ``[N, G, 1, 3]`` gathered along axis 2 with
    every other share's, then merged by Chan's formula, as the apply kernel
    merges its partials."""
    shape = mean.shape
    mean, var = mean.reshape(shape[0], -1), var.reshape(shape[0], -1)
    cnt = torch.full_like(mean, count)
    part = gather(torch.stack([cnt, mean, var * cnt], dim=-1)[:, :, None])
    cnt, mu, m2 = part.unbind(-1)
    total = cnt.sum(-1)
    merged = (cnt * mu).sum(-1) / total
    var = (m2 + cnt * (mu - merged[..., None]).square()).sum(-1) / total
    return var.reshape(shape), merged.reshape(shape)


def group_scale_shift_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            groups: int, eps: float):
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False)     # [N, G]
    inv = torch.rsqrt(var + eps)
    s = inv.repeat_interleave(c // groups, dim=1) * weight.float()[None]
    t = bias.float()[None] - mean.repeat_interleave(c // groups, dim=1) * s
    return s.contiguous(), t.contiguous()


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _require(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {x.device}")
    if x.dtype not in DTYPES or dtype not in DTYPES or weight.dtype not in DTYPES:
        raise ValueError(f"{name}: x {x.dtype}, output {dtype}, weight {weight.dtype}: "
                         "expected bfloat16 or float32")
    if bias.dtype != weight.dtype or weight.shape != (x.shape[-1],) or bias.shape != weight.shape:
        raise ValueError(f"{name}: weight {weight.dtype}{tuple(weight.shape)}, bias "
                         f"{bias.dtype}{tuple(bias.shape)} for C={x.shape[-1]}")
    for t in (weight, bias):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: parameters on {t.device}, contiguous {t.is_contiguous()}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor of shape {tuple(x.shape)} is not contiguous")
    _build.require_aligned(name, x)


def _flags(x, weight, dtype):
    bf16 = torch.bfloat16
    return (ctypes.c_int(x.dtype == bf16), ctypes.c_int(weight.dtype == bf16),
            ctypes.c_int(dtype == bf16))


def _group_launch(x, groups, stats_only, shares=1):
    n, c = x.shape[0], x.shape[-1]
    p = x.numel() // (n * c)
    plan = norm_plan(n, p, c, groups, x.element_size(), stats_only, _build.sm_count(x.device),
                     shares)
    _build.check_plan("group_norm", plan)
    part = torch.empty(plan["scratch_floats"], dtype=torch.float32, device=x.device)
    sizes = [ctypes.c_int(v) for v in (n, p, c, groups)]
    shape = [ctypes.c_int(plan[k]) for k in ("threads", "rows", "splits", "split_rows",
                                             "smem_bytes")]
    return part, sizes, shape, plan


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, dtype: torch.dtype, silu: bool = False, gather=None,
               shares: int = 1) -> torch.Tensor:
    """x ``[N, ..., C]`` -> its group norm over every axis but N and C, with
    ``weight``/``bias`` ``[C]``, then ``silu`` where asked, computed in fp32
    and rounded once to ``dtype``.

    Where x is one of ``shares`` equal shares of each image's pixels (a
    rank's frames of a clip), ``gather`` maps this share's partial moments
    ``[N, G, S, 3]`` (count, mean, M2) to every share's ``[N, G, shares * S,
    3]`` (an all-gather over the ranks along axis 2), and the statistics
    span every share: the statistics kernel, the gather, then the apply
    kernel on the gathered partials."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, dtype, silu, gather)
    _require("group_norm", x, weight, bias, dtype)
    part, sizes, shape, plan = _group_launch(x, groups, False,
                                             1 if gather is None else shares)
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    _build.require_aligned("group_norm", y)
    xb, pb, yb = _flags(x, weight, dtype)
    lib = _build.library()
    apply_cut = (ctypes.c_int(plan["apply_splits"]), ctypes.c_int(plan["apply_split_rows"]))
    if gather is None:
        rc = lib.anyv2v_group_norm(
            _build.ptr(x), xb, _build.ptr(weight), _build.ptr(bias), pb, _build.ptr(y), yb,
            _build.ptr(part), *sizes, ctypes.c_float(eps), ctypes.c_int(bool(silu)), *shape,
            *apply_cut, _build.stream())
    else:
        rc = lib.anyv2v_group_stats(_build.ptr(x), xb, _build.ptr(part), *sizes, *shape,
                                    _build.stream())
        _build.check(rc, "group_norm")
        part = gather(part.view(x.shape[0], groups, plan["splits"], 3)).contiguous()
        rc = lib.anyv2v_group_apply(
            _build.ptr(x), xb, _build.ptr(part), ctypes.c_int(part.shape[2]), _build.ptr(weight),
            _build.ptr(bias), pb, _build.ptr(y), yb, *sizes, ctypes.c_float(eps),
            ctypes.c_int(bool(silu)), shape[0], shape[1], *apply_cut, _build.stream())
        group_norm.gathered_launches += 1
    _build.check(rc, "group_norm")
    group_norm.launches += 1
    return y


def group_scale_shift(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                      eps: float):
    """Per-(n, channel) fp32 ``s, t [N, C]`` such that the group norm of x
    ``[N, ..., C]`` is ``x * s + t`` (K4's prologue applies them)."""
    if x.device.type == "cpu":
        return group_scale_shift_plain(x, weight, bias, groups, eps)
    _require("group_scale_shift", x, weight, bias, torch.float32)
    part, sizes, shape, _ = _group_launch(x, groups, True)
    n, c = x.shape[0], x.shape[-1]
    s = torch.empty((n, c), dtype=torch.float32, device=x.device)
    t = torch.empty_like(s)
    xb, pb, _ = _flags(x, weight, torch.float32)
    rc = _build.library().anyv2v_group_scale_shift(
        _build.ptr(x), xb, _build.ptr(weight), _build.ptr(bias), pb, _build.ptr(part),
        _build.ptr(s), _build.ptr(t), *sizes, ctypes.c_float(eps), *shape, _build.stream())
    _build.check(rc, "group_scale_shift")
    group_scale_shift.launches += 1
    return s, t


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """Layer norm of x ``[..., C]`` over its last axis with ``weight``/``bias``
    ``[C]``, computed in fp32 and rounded once to ``dtype``."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, dtype)
    _require("layer_norm", x, weight, bias, dtype)
    c = x.shape[-1]
    rows = x.numel() // c
    plan = layer_norm_plan(rows, c, _build.sm_count(x.device))
    _build.check_plan("layer_norm", plan)
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    _build.require_aligned("layer_norm", y)
    xb, pb, yb = _flags(x, weight, dtype)
    rc = _build.library().anyv2v_layer_norm(
        _build.ptr(x), xb, _build.ptr(weight), _build.ptr(bias), pb, _build.ptr(y), yb,
        ctypes.c_longlong(rows), ctypes.c_int(c), ctypes.c_float(eps),
        *[ctypes.c_int(plan[k]) for k in ("vec", "lanes", "chunks")],
        ctypes.c_int(plan["grid"][0]), _build.stream())
    _build.check(rc, "layer_norm")
    layer_norm.launches += 1
    return y


group_norm.launches = 0
group_norm.gathered_launches = 0    # those whose statistics span every share (gather)
group_scale_shift.launches = 0
layer_norm.launches = 0
