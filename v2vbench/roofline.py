"""The yardstick of the device: the published peaks of one H100 SXM and the
operations and bytes of each kernel family's calls, counted at the
configuration's true widths (a head's width comes from the softmax scale the
call is given, ``scale = d ** -0.5``, never from its padded storage). Each
input is read once and the output written once."""

from __future__ import annotations

PEAK_FLOPS = 989e12     # bf16 dense tensor-core peak, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3 bandwidth, H100 SXM
BF16 = 2


def true_head_dim(scale: float) -> int:
    return int(round(scale ** -2))


def nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def attention_cost(b: int, sq: int, sk: int, heads: int, d: int, kv_rows: int = None,
                   extra_kv: tuple = (0, 0), bias=None):
    """(operations, bytes) of softmax attention: ``b`` rows of ``sq`` queries
    over ``sk`` keys (plus ``extra_kv = (rows, keys)`` of a context shared by
    several rows), ``heads`` heads of width ``d``: Q.K and P.V, q, k, v and
    the bias read, the output written."""
    ctx_rows, ctx_keys = extra_kv
    kv_rows = b if kv_rows is None else kv_rows
    flops = 4 * b * heads * sq * (sk + ctx_keys) * d
    elems = 2 * b * sq * heads * d + 2 * (kv_rows * sk + ctx_rows * ctx_keys) * heads * d
    return flops, elems * BF16 + nbytes(bias)


def ideal_seconds(flops: float, nbytes_: float) -> float:
    """The least time the chip could take: the larger of its two bounds."""
    return max(flops / PEAK_FLOPS, nbytes_ / PEAK_BYTES)
