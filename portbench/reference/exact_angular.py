"""The plain reference of an angular vector store: exact nearest neighbours by
1 - q·x in float64.

It answers over ``exact_knn.Store`` (the corpus regenerated from the data
seed; under the cosine metric the mixture's rows are unit-normed), imports
nothing of the program and takes nothing the program made. The distance is
the port's cosine distance, 1 - q·x over the stored rows, which assumes
unit-norm rows as the engines do.
"""

from __future__ import annotations

import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import compare
from portbench.reference.exact_knn import QUERY_BLOCK, ROW_BLOCK, Store


def exact_knn(store: Store, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest live ids of each query by 1 - q·x in float64, nearest
    first: (ids i64[Q, k], distances f64[Q, k])."""
    table = store.table
    dev = table.device
    nq = len(queries)
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float64, device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
    for r in range(0, table.shape[0], ROW_BLOCK):
        x = table[r : r + ROW_BLOCK].double()
        dead = ~store.live[r : r + ROW_BLOCK][None, :]
        for a in range(0, nq, QUERY_BLOCK):
            q = queries[a : a + QUERY_BLOCK].double()
            d = (1.0 - q @ x.T).masked_fill(dead, float("inf"))
            v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            v, pos = torch.topk(torch.cat([best_d[a : a + len(q)], v], 1), k, dim=1, largest=False)
            best_i[a : a + len(q)] = torch.gather(torch.cat([best_i[a : a + len(q)], i + r], 1), 1, pos)
            best_d[a : a + len(q)] = v
    d = pair_distances(store, queries, torch.arange(nq, device=dev), best_i, torch.isfinite(best_d))
    d, order = torch.sort(d, dim=1, stable=True)
    return torch.gather(best_i, 1, order), d


def pair_distances(store: Store, queries: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 - q·x in float64 between query ``qidx[j]`` and row ``ids[j, c]``:
    f64[n, c]; ``valid`` False → inf."""
    rows = store.table[ids.clamp(0, store.table.shape[0] - 1)].double()
    d = 1.0 - (rows * queries[qidx].double()[:, None, :]).sum(-1)
    return d if valid is None else d.masked_fill(~valid, float("inf"))


# compare.judge_answers itself, its two distance functions bound to the ones
# above: the same three numbers, by the same arithmetic, under 1 - q·x
_judge_answers = types.FunctionType(compare.judge_answers.__code__,
                                    {**compare.judge_answers.__globals__, "exact_knn": exact_knn,
                                     "pair_distances": pair_distances},
                                    "judge_answers", compare.judge_answers.__defaults__)


def judge_answers(store: Store, queries: torch.Tensor, answers: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                  k: int) -> Dict[str, float]:
    """``compare.judge_answers`` under 1 - q·x: ``recall_min``,
    ``dist_err_max`` (over the median 1 - cos of the queries' k-th true
    neighbours) and ``bad_ids``."""
    return _judge_answers(store, queries, answers, k)
