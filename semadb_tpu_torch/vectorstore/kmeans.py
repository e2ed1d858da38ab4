"""k-means for the IVF coarse quantizer, in PyTorch.

Port of the IVF subset of ``semadb_tpu/vectorstore/kmeans.py``:
:func:`kmeans_assign` (top-t nearest centroids, ``:120-155``),
:func:`kmeans_fit_large` (``:158-249``) and :func:`_kmeans_fit_gather`
(``:252-301``). Assignment is a row-blocked ``torch.matmul`` (full f32, as
``ops.distance`` requires) plus ``argmin`` / ``topk``; the centroid update is
a segment sum by ``index_add_``. The JAX package leaves these products to
XLA outside any Pallas kernel, so here they stay plain torch.

Seeding draws the initial centroids with a ``torch.Generator`` seeded from
``seed``: JAX's ``random.choice`` cannot be reproduced, so a build is held
to the JAX package's on recall, not on bits. Not ported: ``kmeans_fit`` and
``kmeans_fit_subvectors`` (product quantization) and the two-level fit for
65,537 clusters or more.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def kmeans_assign(
    data: torch.Tensor, cents: torch.Tensor, t: int = 1, row_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Top-t nearest centroids per row → i32[N, t] (ascending distance).

    Row-blocked so the [NB, K] distance matrix stays ≤ 2^26 elements. With
    ``row_ids``, ``data`` is the full backing matrix and rows are gathered
    block by block (a full [N, D] gather would double peak device memory)."""
    n = row_ids.shape[0] if row_ids is not None else data.shape[0]
    k = cents.shape[0]
    sq_c = (cents * cents).sum(-1)[None, :]
    nb = max(2**26 // k, 512)
    out = torch.empty((n, t), dtype=torch.int32, device=cents.device)
    for lo in range(0, n, nb):
        blk = data[row_ids[lo : lo + nb].long()] if row_ids is not None else data[lo : lo + nb]
        dist = (blk * blk).sum(-1, keepdim=True) - 2.0 * (blk @ cents.T) + sq_c
        out[lo : lo + nb] = torch.topk(dist, t, dim=-1, largest=False, sorted=True).indices.to(torch.int32)
    return out


def kmeans_fit_large(
    data: torch.Tensor,
    k: int,
    seed: int = 0,
    iters: int = 15,
    block_rows: int = 0,
    row_ids: Optional[torch.Tensor] = None,
):
    """Large-K k-means for the IVF coarse quantizer → (centroids f32[k, d],
    labels i32[N]).

    Sampled init (k distinct rows), a fixed number of Lloyd iterations, and
    a segment-sum update; a cluster that loses every row keeps its centroid.
    The assignment is blocked over rows so the [NB, K] distance matrix stays
    ≤ 2^27 elements (at 1M x 32,768 clusters an unblocked one would be
    137 GB). With ``row_ids``, ``data`` is the full backing matrix and fit
    rows are gathered per block (:func:`_kmeans_fit_gather`)."""
    if row_ids is not None:
        return _kmeans_fit_gather(data, row_ids, k, seed, iters, block_rows)
    n = data.shape[0]
    return _lloyd(lambda lo, hi: data[lo:hi], n, data[_init_rows(n, k, seed, data.device)], iters, block_rows)


def _kmeans_fit_gather(data, row_ids, k, seed, iters, block_rows):
    """:func:`kmeans_fit_large` over rows gathered per block from the full
    matrix ``data``."""
    n = row_ids.shape[0]
    rows = row_ids.long()
    init = data[rows[_init_rows(n, k, seed, data.device)]]
    return _lloyd(lambda lo, hi: data[rows[lo:hi]], n, init, iters, block_rows)


def _init_rows(n: int, k: int, seed: int, device) -> torch.Tensor:
    """k distinct row positions in [0, n), drawn from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:k].to(device)


def _lloyd(block: Callable[[int, int], torch.Tensor], n: int, cents: torch.Tensor, iters: int, block_rows: int):
    k, d = cents.shape
    nb = block_rows or max(2**27 // k, 512)

    def labels_of(blk, c, sq_c):
        return torch.argmin((blk * blk).sum(-1, keepdim=True) - 2.0 * (blk @ c.T) + sq_c, dim=-1)

    for _ in range(iters):
        sq_c = (cents * cents).sum(-1)[None, :]
        sums = torch.zeros((k, d), dtype=torch.float32, device=cents.device)
        cnt = torch.zeros((k,), dtype=torch.float32, device=cents.device)
        for lo in range(0, n, nb):
            blk = block(lo, min(lo + nb, n))
            lab = labels_of(blk, cents, sq_c)
            sums.index_add_(0, lab, blk)
            cnt.index_add_(0, lab, torch.ones_like(lab, dtype=torch.float32))
        cents = torch.where((cnt > 0)[:, None], sums / cnt.clamp(min=1.0)[:, None], cents)
    sq_c = (cents * cents).sum(-1)[None, :]
    labs = torch.cat([labels_of(block(lo, min(lo + nb, n)), cents, sq_c) for lo in range(0, n, nb)])
    return cents, labs.to(torch.int32)
