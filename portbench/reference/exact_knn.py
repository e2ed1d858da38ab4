"""The plain reference of a vector store: exact nearest neighbours in float64.

It holds the rows the benchmark made, regenerated from the data seed, and
answers by brute force. It imports nothing of the program and takes nothing
the program made.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench import datagen

QUERY_BLOCK = 256  # queries a distance block holds
ROW_BLOCK = 1 << 20  # rows a distance block holds


class Store:
    """The corpus by node id: ``table`` f32[first_id + n_points, D], the
    rows below ``first_id`` zero, and ``live`` bool[first_id + n_points]."""

    def __init__(self, mix: datagen.Mixture, n_points: int, first_id: int):
        dev = mix.device
        top = first_id + n_points
        self.live = torch.zeros(top, dtype=torch.bool, device=dev)
        self.live[first_id:] = True
        self.table = torch.zeros((top, mix.dim), dtype=torch.float32, device=dev)
        for a in range(0, n_points, ROW_BLOCK):
            b = min(a + ROW_BLOCK, n_points)
            self.table[first_id + a : first_id + b] = mix.rows(datagen.CORPUS, a, b - a)


def exact_knn(store: Store, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest live ids of each query by squared euclidean distance in
    float64, nearest first: (ids i64[Q, k], distances f64[Q, k]); the
    distances of the winners are taken again by difference."""
    table = store.table
    dev = table.device
    nq = len(queries)
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float64, device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
    for r in range(0, table.shape[0], ROW_BLOCK):
        x = table[r : r + ROW_BLOCK].double()
        xsq = (x * x).sum(1)[None, :].masked_fill(~store.live[r : r + ROW_BLOCK][None, :], float("inf"))
        for a in range(0, nq, QUERY_BLOCK):
            q = queries[a : a + QUERY_BLOCK].double()
            d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T) + xsq
            v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            v, pos = torch.topk(torch.cat([best_d[a : a + len(q)], v], 1), k, dim=1, largest=False)
            best_i[a : a + len(q)] = torch.gather(torch.cat([best_i[a : a + len(q)], i + r], 1), 1, pos)
            best_d[a : a + len(q)] = v
    out_i = best_i
    d = pair_distances(store, queries, torch.arange(nq, device=dev), out_i, torch.isfinite(best_d))
    d, order = torch.sort(d, dim=1, stable=True)
    return torch.gather(out_i, 1, order), d


def pair_distances(store: Store, queries: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared euclidean distance in float64, by difference, between query
    ``qidx[j]`` and row ``ids[j, c]``: f64[n, c]; ``valid`` False → inf."""
    rows = store.table[ids.clamp(0, store.table.shape[0] - 1)].double()
    diff = rows - queries[qidx].double()[:, None, :]
    d = (diff * diff).sum(-1)
    return d if valid is None else d.masked_fill(~valid, float("inf"))
