"""The least bytes of one K4 call (``ivf_exact_rerank``), beside
``bytecount.py``, whose rate (``bytecount.bound_s``) times it.

Copied from ``chip_smoke.py`` (``_k4_bytes``): each distinct live pool row
once (a pool slot is live when its id is in range and its coarse score is
finite; with copies, an id the pool holds twice is read once), the queries,
the pool's ids and coarse scores, and the k (distance, id) pairs written.
"""

from __future__ import annotations

import torch


def k4_bytes(vectors, queries, pool, coarse, k: int, *_) -> int:
    """The least bytes of a K4 call on its operands (``keep["k4"]`` of a
    search: vectors, queries, pool, coarse, k, metric, dedup)."""
    live = pool[(pool >= 0) & (pool < vectors.shape[0]) & torch.isfinite(coarse)]
    rows = int(torch.unique(live).numel())
    B, D = queries.shape
    return rows * D * vectors.element_size() + pool.numel() * 8 + B * D * 4 + B * k * 8
