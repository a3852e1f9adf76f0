"""T5-style relative position bias for SEINE's temporal attention
(counterpart of ``anyv2v_tpu/ops/relpos.py``).

Bucketed relative positions index a learned ``[num_buckets, heads]`` table;
the result is added to the scaled attention scores. Positions are static (the
frame count), so the bucketing is plain numpy and the bias is one gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucketing: half the buckets for each sign, exact
    buckets for short distances, log-spaced ones up to ``max_distance``."""
    ret = 0
    n = -relative_position
    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)

    max_exact = num_buckets // 2
    is_small = n < max_exact

    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)

    ret += np.where(is_small, n, val_if_large)
    return ret


@functools.lru_cache(maxsize=None)
def _bucket_index(q_len: int, k_len: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The ``[q_len, k_len]`` bucket table on ``device``, made once: a copy
    from host memory waits for the device's queue to drain."""
    rel = np.arange(k_len, dtype=np.int64)[None, :] - np.arange(q_len, dtype=np.int64)[:, None]
    buckets = relative_position_bucket(rel, num_buckets=num_buckets, max_distance=max_distance)
    with torch.inference_mode(False):
        return torch.from_numpy(buckets).to(device)


def relative_position_bias(embedding: torch.Tensor, q_len: int, k_len: int,
                           num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """Bias ``[heads, q_len, k_len]`` from the ``[num_buckets, heads]`` table,
    in the table's dtype."""
    index = _bucket_index(q_len, k_len, num_buckets, max_distance, embedding.device)
    return embedding[index].permute(2, 0, 1)
