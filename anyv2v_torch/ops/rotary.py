"""Rotary position embeddings for ConsistI2V's and SEINE's temporal attention
(counterpart of ``anyv2v_tpu/ops/rotary.py``).

The reference vendors ``rotary_embedding_torch``
(``consisti2v/consisti2v/models/rotary_embedding.py``): 'lang' frequencies
and the interleaved-pair convention. ConsistI2V builds ``RotaryEmbedding(
inner // 2)``, so only the first ``inner // 2`` channels of the flattened
(pre head split) projection rotate; the rest pass through. SEINE rotates the
first ``min(32, head_dim)`` channels of each head.

:func:`rotate_partial` is the models' entry: KR (``csrc/rotary.cu``) for
CUDA tensors, one pass over bf16 that writes the rotated copy once, and the
plain fp32 formula below for CPU tensors, with the same arithmetic (the two
agree bit for bit). Either reads its frequencies from a table made once per
``(rot, device)`` (:func:`rotary_table`), so that no call copies from the
host, which would wait for the device's queue to drain. No Pallas kernel
corresponds: the JAX package leaves its rotary to XLA. For CUDA tensors the
entry launches KR or raises, and counts its calls that launched
(``rotate_partial.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _build

KR_THREADS, KR_VECS = 256, 4   # csrc/rotary.cu: a block's threads, a thread's 16-byte vectors
KR_MAX_PAIRS = 1024            # rot / 2 at most: the block's shared table of (cos, sin)
VEC = 8                        # bf16 channels of a 16-byte vector


def rotary_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    """Default 'lang' frequencies: theta^(-2i/dim) for i in [0, dim/2)."""
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))


@functools.lru_cache(maxsize=None)
def rotary_table(rot: int, device: torch.device) -> torch.Tensor:
    """``rotary_freqs(rot)`` as fp32 ``[rot // 2]`` on ``device``, made once
    per (rot, device): a copy from host memory waits for the device's queue
    to drain."""
    with torch.inference_mode(False):
        return torch.as_tensor(rotary_freqs(rot), dtype=torch.float32, device=device)


def rotary_angles(positions: torch.Tensor, freqs) -> torch.Tensor:
    """positions ``[..., S]`` x freqs (numpy, or an fp32 tensor on the
    positions' device) -> angles ``[..., S, 2 * len(freqs)]``, each frequency
    repeated for its pair of channels, fp32."""
    f = freqs if torch.is_tensor(freqs) else torch.as_tensor(
        np.asarray(freqs), dtype=torch.float32, device=positions.device)
    ang = positions.float()[..., None] * f
    return ang.repeat_interleave(2, dim=-1)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x_{2i}, x_{2i+1}) by ``angles`` (broadcastable to x), in
    fp32; returns x's dtype."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(xf.shape)
    return (xf * torch.cos(angles) + rotated * torch.sin(angles)).to(x.dtype)


def apply_rotary_partial(x: torch.Tensor, angles: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Rotate the first ``rot_dim`` channels of x's last axis; identity on
    the rest. ``angles``: broadcastable ``[..., rot_dim]``."""
    if rot_dim >= x.shape[-1]:
        return apply_rotary(x, angles)
    return torch.cat([apply_rotary(x[..., :rot_dim], angles), x[..., rot_dim:]], dim=-1)


def rotate_queries_or_keys(x: torch.Tensor, freqs,
                           seq_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate ``[..., S, D]`` at positions 0..S-1, or at ``seq_pos`` (the
    reference's ``rotate_queries_or_keys(..., seq_pos=key_pos_idx)``,
    ``rotary_embedding.py:143-165``)."""
    if seq_pos is None:
        seq_pos = torch.arange(x.shape[-2], dtype=torch.float32, device=x.device)
    return apply_rotary(x, rotary_angles(seq_pos, freqs))


def rotary_plan(shape: tuple, rot: int, groups: int = 1) -> dict:
    """KR's launch over x ``[R0, P, ..., C]``: C holds ``groups`` groups of
    ``D = C / groups`` channels (a multiple of 8), the first ``rot`` of each
    (even, at most D and ``2 * KR_MAX_PAIRS``) rotate. A slab, the elements
    at one (r0, p), is ``slab_vecs`` 16-byte vectors, ``blocks`` blocks of
    ``KR_THREADS`` threads of ``KR_VECS`` vectors each; grid ``(blocks, P,
    R0)``. Raises on a layout KR does not take."""
    if len(shape) < 3 or min(shape) <= 0:
        raise ValueError(f"rotate_partial: x of shape {shape}: expected [R0, P, ..., C]")
    c = shape[-1]
    if groups <= 0 or c % groups or (c // groups) % VEC:
        raise ValueError(f"rotate_partial: KR takes groups of a multiple of {VEC} channels, "
                         f"not C={c} in {groups} groups")
    d = c // groups
    if rot <= 0 or rot % 2 or rot > d or rot // 2 > KR_MAX_PAIRS:
        raise ValueError(f"rotate_partial: KR rotates an even width up to the group's {d} "
                         f"channels and {2 * KR_MAX_PAIRS}, not {rot}")
    slab_vecs = int(np.prod(shape[2:])) // VEC
    if slab_vecs > 2 ** 31 - KR_THREADS * KR_VECS:
        raise ValueError(f"rotate_partial: a slab of {slab_vecs} vectors is too long for KR")
    blocks = -(-slab_vecs // (KR_THREADS * KR_VECS))
    return {"slab_vecs": slab_vecs, "d_vecs": d // VEC, "pairs": rot // 2,
            "threads": KR_THREADS, "grid": (blocks, shape[1], shape[0]),
            "smem_bytes": 8 * KR_MAX_PAIRS}


def rotate_partial_plain(x: torch.Tensor, positions: torch.Tensor, rot: int,
                         groups: int = 1) -> torch.Tensor:
    shape = x.shape
    xg = x.reshape(shape[0], shape[1], -1, groups, shape[-1] // groups)
    ang = rotary_angles(positions, rotary_table(rot, x.device))[:, None, None, :]
    return apply_rotary_partial(xg, ang, rot).reshape(shape)


def rotate_partial(x: torch.Tensor, positions: torch.Tensor, rot: int,
                   groups: int = 1) -> torch.Tensor:
    """x ``[B, P, ..., C]`` with each of the ``groups`` groups of its C
    channels rotated on its first ``rot`` channels, at the position
    ``positions[p]`` (fp32 ``[P]`` on x's device) of its index p along axis
    1: ConsistI2V's ``[B, F, HW, inner]`` at ``rot = inner // 2``, SEINE's
    ``[B, F, HW, heads * D]`` in ``heads`` groups. A new tensor of x's shape
    and dtype."""
    if x.device.type == "cpu":
        return rotate_partial_plain(x, positions, rot, groups)
    plan = rotary_plan(tuple(x.shape), rot, groups)
    _build.require_cuda("rotate_partial", x)
    _build.require_cuda("rotate_partial", positions, dtype=torch.float32)
    if tuple(positions.shape) != (x.shape[1],) or positions.device != x.device:
        raise ValueError(f"rotate_partial: positions of shape {tuple(positions.shape)} on "
                         f"{positions.device}: expected [{x.shape[1]}] on {x.device}")
    _build.check_plan("rotate_partial", plan)
    _build.require_aligned("rotate_partial", x)
    table = rotary_table(rot, x.device)
    y = torch.empty_like(x)
    rc = _build.library().anyv2v_rotary(
        _build.ptr(x), _build.ptr(positions), _build.ptr(table), _build.ptr(y),
        *[ctypes.c_int(v) for v in (x.shape[0], x.shape[1], plan["slab_vecs"], plan["d_vecs"],
                                    plan["pairs"], plan["grid"][0])],
        _build.stream())
    _build.check(rc, "rotate_partial")
    rotate_partial.launches += 1
    return y


rotate_partial.launches = 0
