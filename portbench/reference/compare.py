"""The comparison that decides ``correct``: the program's answers against
the plain reference (``exact_knn``), as numbers held to limits.

Numbers, each over every answer it is given:

- ``recall_min``: the lowest recall@k of one request, the share of the
  reference's k nearest live ids that the request returned;
- ``dist_err_max``: the widest gap between a returned distance and the
  reference's float64 distance of the same (query, id), over the median
  distance of the queries' k-th true neighbours;
- ``bad_ids``: returned ids that are not in the reference's corpus (never
  written, out of range) or that repeat within one answer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.exact_knn import Store, exact_knn, pair_distances

CHUNK_ROWS = 1 << 15  # answer rows judged at once


def judge_answers(store: Store, queries: torch.Tensor, answers: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                  k: int) -> Dict[str, float]:
    """``answers``: one (query rows, ids i32[B, k], distances f32[B, k]) a
    request, the query rows indexing ``queries``. With no answer to judge,
    every number is NaN, which no limit holds."""
    if not answers:
        return {"recall_min": math.nan, "dist_err_max": math.nan, "bad_ids": math.nan}
    dev = queries.device
    truth, true_d = exact_knn(store, queries, k)
    scale = float(true_d[:, k - 1].median())
    cap = store.table.shape[0]
    recall_min, err_max, bad = 1.0, 0.0, 0
    i = 0
    while i < len(answers):
        j, rows = i, 0
        while j < len(answers) and (rows == 0 or rows + len(answers[j][0]) <= CHUNK_ROWS):
            rows += len(answers[j][0])
            j += 1
        group = answers[i:j]
        qi = torch.from_numpy(np.concatenate([a[0] for a in group]).astype(np.int64)).to(dev)
        ids = torch.from_numpy(np.concatenate([a[1] for a in group]).astype(np.int64)).to(dev)
        got = torch.from_numpy(np.concatenate([a[2] for a in group]).astype(np.float64)).to(dev)
        present = ids >= 0
        live = present & (ids < cap) & store.live[ids.clamp(0, cap - 1)]
        srt = torch.sort(ids, dim=1).values
        repeats = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
        bad += int((present & ~live).sum()) + int(repeats)
        found = (truth[qi][:, :, None] == ids[:, None, :]).any(-1).sum(-1).cpu().numpy()
        starts = np.cumsum([0] + [len(a[0]) for a in group])[:-1]
        per_request = np.add.reduceat(found, starts) / (k * np.diff(np.append(starts, len(found))))
        recall_min = min(recall_min, float(per_request.min()))
        ref = pair_distances(store, queries, qi, ids, live)
        gap = ((got - ref).abs() / scale).masked_fill(~live, 0.0)
        err_max = max(err_max, float(gap.max()) if gap.numel() else 0.0)
        i = j
    return {"recall_min": recall_min, "dist_err_max": err_max, "bad_ids": float(bad)}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Tuple[bool, List[dict]]:
    """Each limited number beside its limit; ``correct`` only if every one
    holds. A number that is missing or not a number fails."""
    checks, ok = [], True
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        if lim["better"] == "lower":
            holds = not math.isnan(value) and value <= lim["limit"]
        else:
            holds = not math.isnan(value) and value >= lim["limit"]
        ok &= holds
        checks.append({"name": name, "value": value, "limit": lim["limit"], "better": lim["better"], "holds": holds})
    return ok, checks
