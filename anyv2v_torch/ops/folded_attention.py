"""K1: softmax attention on heads folded into the channel dim, ``[B, S, H*dh]``.

Replaces the head-packed Pallas family of ``anyv2v_tpu/ops/``:
``pallas_packed_flash.py`` (``_packed_whole_pipe_kernel``, ``_wide_kv_kernel``,
``_wide_t_kernel``) and ``pallas_short_attention.py::_short_kernel``. Those
four bodies differ only in how they fit the TPU's 128-lane tiles; on the GPU
one kernel (``csrc/folded_attention.cu``) covers self and cross attention with
Sq and Sk from 16 to 4096 and padded head widths 8/16/32/64.

:func:`folded_attention` is the entry: CPU tensors take the plain version
below, CUDA tensors launch the kernel (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (8, 16, 32, 64)


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
    out = torch.empty_like(q)
    rc = _build.library().anyv2v_folded_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(sq), ctypes.c_int(k.shape[1]),
        ctypes.c_int(heads), ctypes.c_int(dh), ctypes.c_float(scale),
        _build.stream())
    _build.check(rc, "folded_attention")
    folded_attention.launches += 1
    return out


folded_attention.launches = 0
