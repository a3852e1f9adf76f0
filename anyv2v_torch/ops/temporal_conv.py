"""K4: groupnorm-apply + SiLU + (3,1,1) temporal convolution over ``[B, F, P, C]``.

Replaces ``anyv2v_tpu/ops/pallas_temporal_conv.py::_tconv_kernel``, which every
``TemporalConvLayer`` runs four times. The group statistics stay outside
the kernel (:func:`groupnorm_scale_shift`: KN's statistics,
:func:`anyv2v_torch.ops.norm.group_scale_shift`), as the JAX code keeps them
outside Pallas; the kernel (``csrc/temporal_conv.cu``) applies
``silu(x * s + t)`` in fp32, rounds to the compute dtype and convolves along
frames with zero frame padding, accumulating in fp32.

The kernel (``csrc/temporal_conv.cu``) is the prologue as a kernel of its
own, writing h = silu(x*s + t) in bf16 (the tensor the Pallas body and the
plain path round at the same point), then one GEMM ``[B*F*P, 3C] x [3C,
C']`` of h on ``hopper.cuh``'s TMA-fed wgmma main loop: W[d] slices by TMA,
the rows of A by TMA from a 4-D map where ``P % 128 == 0`` (a tile is 128
pixels of one frame) and gathered per tap with ``cp.async`` elsewhere (a
tile spans frames where P is small). Fused into the GEMM, the prologue ran 3
times per x element for each output column tile (3, 6 and 12 at C'
320/640/1280 with tiles of up to 320 columns) and held the tensor cores
back; on its own it runs once, for a round trip of h through HBM.

Weights use the kernel layout ``[3, C, C']`` (tap, in, out).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build
from . import norm as _norm


def tconv_plan(b: int, f: int, p: int, c: int, c_out: int, sms: int = _build.H100_SMS) -> dict:
    """The launch over ``[B, F, P, C] -> [B, F, P, C']``: cooperative tiles
    of 128 rows by 64..320 columns (the width that spreads the tiles over
    ``sms`` best, :func:`_build.gemm_width`), K steps over 3 taps x
    ceil(C / 64) channel slices; ``tma_a``: A comes by TMA (P % 128 == 0, a
    tile is 128 pixels of one frame), else the producer gathers it;
    ``evaluations`` is how many times the prologue runs on each x element
    (once: a kernel of its own before the GEMM, writing h). C and C' must be
    multiples of 8 (16-byte gathers, TMA strides)."""
    if c % 8 or c_out % 8:
        raise ValueError(f"tconv_plan: C={c}, C'={c_out} not multiples of 8")
    col_tiles, width = _build.gemm_width(c_out, b * f * p, sms)
    plan = _build.gemm_plan(b * f * p, col_tiles, width, 3 * -(-c // _build.GEMM_DEPTH),
                            sms=sms)
    return {**plan, "evaluations": 1, "tma_a": p % _build.GEMM_ROWS == 0}


def groupnorm_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          groups: int, eps: float):
    """Per-(batch, channel) fp32 ``s, t`` such that groupnorm(x) = x*s + t,
    statistics over every axis but batch and channel. x ``[B, ..., C]``.

    Outside a manual-SPMD region: the KN statistics
    (:func:`anyv2v_torch.ops.norm.group_scale_shift`, called through its
    module, as the benchmark wraps it). Inside one, x is this rank's share (of
    the frames, or of the pixels of every frame) and the statistics are
    global: the per-rank mean and mean square are averaged over the ranks
    (one all-reduce; equal shares make the mean of means exact), in plain
    PyTorch."""
    from ..parallel.mesh import pmean_axis, sharded_region

    region = sharded_region()
    if region is None:
        return _norm.group_scale_shift(x.contiguous(), gamma, beta, groups, eps)
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    moments = pmean_axis(torch.stack([xf.mean(dim=(1, 3)), xf.square().mean(dim=(1, 3))]),
                         region[0])
    mean, var = moments[0], moments[1] - moments[0].square()
    inv = torch.rsqrt(var + eps)
    s = inv.repeat_interleave(c // groups, dim=1) * gamma.float()[None]
    t = beta.float()[None] - mean.repeat_interleave(c // groups, dim=1) * s
    return s.contiguous(), t.contiguous()


def gn_silu_temporal_conv_plain(x, s, t, w, b):
    """Plain PyTorch version: prologue in fp32, rounded to x's dtype, the three
    frame taps as one matmul over ``[.., 3C]`` (fp32 accumulation, one
    rounding), then the bias."""
    if s is not None:
        h = (x.float() * s[:, None, None, :] + t[:, None, None, :])
        h = F.silu(h).to(x.dtype)
    else:
        h = x
    f = x.shape[1]
    hp = F.pad(h, (0, 0, 0, 0, 1, 1))
    taps = torch.cat([hp[:, d:d + f] for d in range(3)], dim=-1)
    out = torch.matmul(taps, w.reshape(3 * w.shape[1], w.shape[2]))
    return (out.float() + b.float()).to(x.dtype)


def gn_silu_temporal_conv(x: torch.Tensor, s: Optional[torch.Tensor],
                          t: Optional[torch.Tensor], w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """x ``[B, F, P, C]``, s/t ``[B, C]`` fp32 (or both None: no prologue),
    w ``[3, C, C']``, b ``[C']`` -> ``[B, F, P, C']``."""
    if x.device.type == "cpu":
        return gn_silu_temporal_conv_plain(x, s, t, w, b)
    _build.require_cuda("gn_silu_temporal_conv", x, w, b)
    _build.require_cuda("gn_silu_temporal_conv", s, t, dtype=torch.float32)
    _build.require_aligned("gn_silu_temporal_conv", x, s, t, w, b)
    bsz, f, p, c = x.shape
    c_out = w.shape[2]
    if (x.dim() != 4 or w.shape != (3, c, c_out) or b.shape != (c_out,)
            or (s is None) != (t is None)
            or (s is not None and (s.shape != (bsz, c) or t.shape != (bsz, c)))):
        raise ValueError(f"gn_silu_temporal_conv: x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"b{tuple(b.shape)}")
    plan = tconv_plan(bsz, f, p, c, c_out, _build.sm_count(x.device))
    _build.check_plan("gn_silu_temporal_conv", plan)
    out = torch.empty((bsz, f, p, c_out), dtype=x.dtype, device=x.device)
    h = torch.empty_like(x) if s is not None else None   # the prologue kernel's output
    null = ctypes.c_void_p(0)
    rc = _build.library().anyv2v_temporal_conv(
        _build.ptr(x), null if s is None else _build.ptr(s),
        null if t is None else _build.ptr(t), null if h is None else _build.ptr(h),
        _build.ptr(w), _build.ptr(b),
        _build.ptr(out), ctypes.c_int(bsz), ctypes.c_int(f), ctypes.c_int(p),
        ctypes.c_int(c), ctypes.c_int(c_out), ctypes.c_int(plan["width"]),
        ctypes.c_int(plan["grid"][0]), ctypes.c_int(plan["smem_bytes"]), _build.stream())
    _build.check(rc, "gn_silu_temporal_conv")
    gn_silu_temporal_conv.launches += 1
    if s is not None:
        gn_silu_temporal_conv.prologue_launches += 1
    return out


# every launch of the GEMM; those that the prologue kernel preceded
gn_silu_temporal_conv.launches = 0
gn_silu_temporal_conv.prologue_launches = 0


@spanned("layer.tconv")
def groupnorm_silu_temporal_conv(x: torch.Tensor, norm: torch.nn.GroupNorm, w: torch.Tensor,
                                 b: torch.Tensor, pixel_sharded: bool = False) -> torch.Tensor:
    """groupnorm (``norm``'s groups, eps and affine) -> SiLU -> (3,1,1) conv
    of ``[B, F, P, C]``: the statistics (:func:`groupnorm_scale_shift`), then
    one K4 launch.

    Inside a manual-SPMD region the conv needs every frame, and the op
    reshards itself around it
    (:func:`anyv2v_torch.parallel.mesh.around_frame_op`).
    ``pixel_sharded``: the caller already holds every frame of its pixels
    (it hoisted the all-to-all around several convs)."""
    from ..parallel.mesh import around_frame_op

    s, t = groupnorm_scale_shift(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
    if pixel_sharded:
        return gn_silu_temporal_conv(x, s, t, w, b)
    return around_frame_op(lambda y, _: gn_silu_temporal_conv(y, s, t, w, b), (x,))
