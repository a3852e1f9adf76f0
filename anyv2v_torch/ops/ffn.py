"""K3: fused GEGLU feed-forward, ``(v * gelu(g)) @ W2 + b2`` with
``[v, g] = x @ W1 + b1``, without the ``[N, 2*4C]`` intermediate in HBM.

Replaces ``anyv2v_tpu/ops/pallas_ffn.py::_ffn_kernel``. Weights use the torch
``nn.Linear`` layout: ``w1 [2I, C]``, ``w2 [C, I]``. GELU is the exact erf
form (the Pallas body used a degree-9 fit). The kernel is
``csrc/ffn.cu``; it serves ``C <= 768`` with ``C % 32 == 0``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 768


def fits(c: int, inner: int) -> bool:
    """The shapes K3 takes: C <= 768, C % 32 == 0 (so 4C % 128 == 0), and an
    inner width that is a multiple of the kernel's 64-column chunk."""
    return c <= MAX_CHANNELS and c % 32 == 0 and inner % 64 == 0


def ffn_geglu_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version: the pre-activation in fp32, the product
    ``v * gelu(g)`` rounded to x's dtype before the second matmul (as the
    Pallas kernel and the unfused JAX path do). Runs 2^18 rows at a time: a
    128-frame L0 edit call (3*128*4096 rows at C 320) would hold a 16 GB
    fp32 pre-activation at once."""
    rows = 1 << 18
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty((flat.shape[0], w2.shape[0]), dtype=x.dtype, device=x.device)
    for i in range(0, flat.shape[0], rows):
        v, g = F.linear(flat[i:i + rows], w1, b1).float().chunk(2, dim=-1)
        out[i:i + rows] = F.linear((v * F.gelu(g)).to(x.dtype), w2, b2)
    return out.reshape(*x.shape[:-1], w2.shape[0])


def ffn_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x ``[..., C]`` -> ``[..., C]``."""
    if x.device.type == "cpu":
        return ffn_geglu_plain(x, w1, b1, w2, b2)
    _build.require_cuda("ffn_geglu", x, w1, b1, w2, b2)
    c = x.shape[-1]
    inner = w2.shape[1]
    if (w1.shape != (2 * inner, c) or b1.shape != (2 * inner,)
            or w2.shape != (c, inner) or b2.shape != (c,)):
        raise ValueError(f"ffn_geglu: x{tuple(x.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} b2{tuple(b2.shape)}")
    if not fits(c, inner):
        raise ValueError(f"ffn_geglu: C={c}, inner={inner} outside the kernel's range")
    n = x.numel() // c
    out = torch.empty_like(x)
    rc = _build.library().anyv2v_ffn_geglu(
        _build.ptr(x), _build.ptr(w1), _build.ptr(b1), _build.ptr(w2),
        _build.ptr(b2), _build.ptr(out), ctypes.c_int(n), ctypes.c_int(c),
        ctypes.c_int(inner), _build.stream())
    _build.check(rc, "ffn_geglu")
    ffn_geglu.launches += 1
    return out


ffn_geglu.launches = 0
