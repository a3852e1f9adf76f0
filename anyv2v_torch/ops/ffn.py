"""K3: the feed-forward in its two forms, without the fp32 pre-activation in
HBM: GEGLU, ``(v * gelu(g)) @ W2 + b2`` with ``[v, g] = x @ W1 + b1``
(:func:`ffn_geglu`), and GELU, ``gelu(x @ W1 + b1) @ W2 + b2``
(:func:`ffn_gelu`).

Replaces ``anyv2v_tpu/ops/pallas_ffn.py::_ffn_kernel`` (both of its
``activation`` branches). Weights use the torch ``nn.Linear`` layout:
``w1 [2I, C]`` (GEGLU) or ``[I, C]`` (GELU), ``w2 [C, I]``. GELU is the exact
erf form (the Pallas body used a degree-9 fit, 6.5e-6 from it). It serves
``C <= 768`` with ``C % 32 == 0``.

The Pallas kernel keeps W1 and W2 resident in 16 MB of VMEM and the
intermediate on chip. An H100 block holds 227 KB, so a fused form would
re-read the weights from L2 for every row tile (``24 * C^2 * N / BM`` bytes,
BM at most 128 at C 320 and 64 at C 640 for the fp32 accumulator to fit the
register file: 1.26 GB at L0, 2.5 GB at L1), while writing h in bf16 and
reading it back costs ``16 * C * N`` bytes (0.34 and 0.17 GB). So the kernel
(``csrc/ffn.cu``) is two wgmma GEMMs on ``hopper.cuh``'s TMA-fed main loop:
``x @ W1^T`` with the activation in its epilogue, storing h ``[N, I]`` bf16 (the
tensor the Pallas body and the plain path round at the same point), on the
ping-pong schedule (each consumer warpgroup's epilogue runs while the other's
products do; cooperative where the tiles do not outnumber the SMs), then
``h @ W2^T + b2`` on the cooperative one. :func:`ffn_plan` sizes both
launches; rows run in chunks of at most 2^18 so that h stays under 0.7 GB.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 768
CHUNK_ROWS = 1 << 18   # rows per launch pair: h [2^18, 1280] bf16 is 0.67 GB
ACTIVATIONS = ("geglu", "gelu")
# launch 1, per form: tiles of 128 rows by 128 W1 rows, h columns per tile
# (GEGLU: 64 of v, the same 64 of g); per schedule the ring's stages and each
# consumer warpgroup's rows of a tile (its h staging)
LAUNCH1_WIDTH = 128
LAUNCH1_H_COLS = {"geglu": 64, "gelu": 128}
LAUNCH1 = {("geglu", "pingpong"): {"stages": 5, "rows": 128},
           ("geglu", "cooperative"): {"stages": 6, "rows": 64},
           ("gelu", "pingpong"): {"stages": 4, "rows": 128},
           ("gelu", "cooperative"): {"stages": 5, "rows": 64}}


def fits(c: int, inner: int) -> bool:
    """The shapes K3 takes: C <= 768, C % 32 == 0 (so 4C % 128 == 0), and an
    inner width that is a multiple of 64."""
    return c <= MAX_CHANNELS and c % 32 == 0 and inner % 64 == 0


def ffn_plan(n: int, c: int, inner: int, sms: int = _build.H100_SMS,
             activation: str = "geglu") -> dict:
    """The two launches over ``n <= CHUNK_ROWS`` rows: the activation's
    (x @ W1^T, K = C: tiles of 128 rows by 128 rows of W1, 64 or 128 h
    columns, on the ping-pong schedule where they outnumber the SMs and on
    the cooperative one elsewhere, each consumer warpgroup's h staged for its
    TMA store and b1 beside the ring), keyed by ``activation``, and ``out``
    (h @ W2^T, K = I, cooperative, C in tiles of 64..320 columns, b2 beside
    the ring)."""
    if not 0 < n <= CHUNK_ROWS:
        raise ValueError(f"ffn_plan: {n} rows, expected 1..{CHUNK_ROWS}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"ffn_plan: activation {activation!r}, expected one of {ACTIVATIONS}")
    depth = _build.GEMM_DEPTH
    h_cols = LAUNCH1_H_COLS[activation]
    col_tiles1 = -(-inner // h_cols)
    schedule = "pingpong" if -(-n // _build.GEMM_ROWS) * col_tiles1 > sms else "cooperative"
    form = LAUNCH1[activation, schedule]
    staging = 2 * form["rows"] * h_cols * 2
    b1_bytes = 2 * (2 * inner if activation == "geglu" else inner)
    first = _build.gemm_plan(n, col_tiles1, LAUNCH1_WIDTH, -(-c // depth), staging + b1_bytes,
                             sms, form["stages"], pingpong=schedule == "pingpong")
    first["h_cols"] = h_cols
    col_tiles, width = _build.gemm_width(c)
    out = _build.gemm_plan(n, col_tiles, width, -(-inner // depth), 2 * c, sms)
    return {activation: first, "out": out}


def ffn_geglu_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version: the pre-activation in fp32, the product
    ``v * gelu(g)`` rounded to x's dtype before the second matmul (as the
    Pallas kernel and the unfused JAX path do). Runs 2^18 rows at a time: a
    128-frame L0 edit call (3*128*4096 rows at C 320) would hold a 16 GB
    fp32 pre-activation at once."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty((flat.shape[0], w2.shape[0]), dtype=x.dtype, device=x.device)
    for i in range(0, flat.shape[0], CHUNK_ROWS):
        v, g = F.linear(flat[i:i + CHUNK_ROWS], w1, b1).float().chunk(2, dim=-1)
        out[i:i + CHUNK_ROWS] = F.linear((v * F.gelu(g)).to(x.dtype), w2, b2)
    return out.reshape(*x.shape[:-1], w2.shape[0])


def ffn_gelu_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of the GELU form: the pre-activation in fp32,
    ``gelu`` of it rounded to x's dtype before the second matmul (where the
    Pallas kernel and the unfused JAX path round), 2^18 rows at a time."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty((flat.shape[0], w2.shape[0]), dtype=x.dtype, device=x.device)
    for i in range(0, flat.shape[0], CHUNK_ROWS):
        h = F.gelu(F.linear(flat[i:i + CHUNK_ROWS], w1, b1).float())
        out[i:i + CHUNK_ROWS] = F.linear(h.to(x.dtype), w2, b2)
    return out.reshape(*x.shape[:-1], w2.shape[0])


def _launch(activation: str, x, w1, b1, w2, b2) -> torch.Tensor:
    """Check the operands, then launch both GEMMs per chunk of rows."""
    name = f"ffn_{activation}"
    _build.require_cuda(name, x, w1, b1, w2, b2)
    _build.require_aligned(name, x, w1, b1, w2, b2)
    c = x.shape[-1]
    inner = w2.shape[1]
    rows1 = 2 * inner if activation == "geglu" else inner
    if (w1.shape != (rows1, c) or b1.shape != (rows1,)
            or w2.shape != (c, inner) or b2.shape != (c,)):
        raise ValueError(f"{name}: x{tuple(x.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} b2{tuple(b2.shape)}")
    if not fits(c, inner):
        raise ValueError(f"{name}: C={c}, inner={inner} outside the kernel's range")
    n = x.numel() // c
    flat, out = x.reshape(n, c), torch.empty_like(x)
    flat_out = out.view(n, c)
    h = torch.empty((min(n, CHUNK_ROWS), inner), dtype=x.dtype, device=x.device)
    sms = _build.sm_count(x.device)
    entry = getattr(_build.library(), f"anyv2v_{name}")
    for i in range(0, n, CHUNK_ROWS):
        rows = min(CHUNK_ROWS, n - i)
        plan = ffn_plan(rows, c, inner, sms, activation)
        for part in (activation, "out"):
            _build.check_plan(name, plan[part])
        rc = entry(
            _build.ptr(flat[i:]), _build.ptr(w1), _build.ptr(b1), _build.ptr(w2),
            _build.ptr(b2), _build.ptr(h), _build.ptr(flat_out[i:]), ctypes.c_int(rows),
            ctypes.c_int(c), ctypes.c_int(inner),
            ctypes.c_int(plan[activation]["schedule"] == "pingpong"),
            ctypes.c_int(plan["out"]["width"]),
            ctypes.c_int(plan[activation]["grid"][0]),
            ctypes.c_int(plan[activation]["smem_bytes"]),
            ctypes.c_int(plan["out"]["grid"][0]), ctypes.c_int(plan["out"]["smem_bytes"]),
            _build.stream())
        _build.check(rc, name)
    return out


def ffn_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The GEGLU form: x ``[..., C]``, w1 ``[2I, C]`` -> ``[..., C]``."""
    if x.device.type == "cpu":
        return ffn_geglu_plain(x, w1, b1, w2, b2)
    out = _launch("geglu", x, w1, b1, w2, b2)
    ffn_geglu.launches += 1
    return out


ffn_geglu.launches = 0


def ffn_gelu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The GELU form: x ``[..., C]``, w1 ``[I, C]`` -> ``[..., C]``."""
    if x.device.type == "cpu":
        return ffn_gelu_plain(x, w1, b1, w2, b2)
    out = _launch("gelu", x, w1, b1, w2, b2)
    ffn_gelu.launches += 1
    return out


ffn_gelu.launches = 0
