"""Batched greedy beam search over the device-resident Vamana graph.

Port of ``semadb_tpu/index/vamana/search.py`` for plain f32 vectors. The
walk (:func:`beam_search`) is K10 (``ops/kernels/vamana_search.py``): on a
CUDA graph the kernel, on a CPU graph its plain version. Around it, as in the
JAX package:

  - :func:`search`: the walk at W = 2 without the visited ring (the list is
    not compacted), the start node dropped, the k best by (distance, id);
  - :func:`search_filtered` (search.go:27-51): seeds are the first L filter
    members by id; the walk keeps its ring, and the result pool is the seeds
    and the expanded nodes that pass the filter;
  - :func:`exact_search`: brute force over the live nodes.

A quantized store (binary or product codes, the JAX ``_make_gd``'s other
routes, and the f32 rerank of a quantized walk) is not ported: such a walk
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from semadb_tpu_torch.index.vamana.graph import NIL, START_ID, GraphConfig, GraphState
from semadb_tpu_torch.ops.distance import gather_distance, pairwise_distance
from semadb_tpu_torch.ops.kernels.vamana_search import vamana_beam_search
from semadb_tpu_torch.ops.topk import INF, dedup_by_id, smallest_k_stable, sort_by_distance

QUANTIZED_LATER = ("the quantized Vamana walk (binary or product codes) is not ported to semadb_tpu_torch "
                   "yet: it comes in slice 14")


class BeamResult(NamedTuple):
    cand_dists: torch.Tensor  # f32[B, L] candidate list
    cand_ids: torch.Tensor  # i32[B, L]
    visited_dists: torch.Tensor  # f32[B, V] expanded nodes, sorted
    visited_ids: torch.Tensor  # i32[B, V]
    hops: torch.Tensor  # i32 scalar: the batch's hops (the most any query took)
    query_hops: torch.Tensor  # i32[B]
    counts: torch.Tensor  # i32[B, 2]: nodes expanded, rows scored


def _plain_only(quant) -> None:
    if quant is not None and getattr(quant, "kind", "plain") != "plain":
        raise NotImplementedError(QUANTIZED_LATER)


def beam_search(
    state: GraphState, queries: torch.Tensor, config: GraphConfig, search_size: int, max_hops: int = 0,
    seed_ids: Optional[torch.Tensor] = None, expand_width: int = 8, quant=None, track_visited: bool = True,
) -> BeamResult:
    """Batched greedy search, ``queries`` f32[B, D] → :class:`BeamResult`;
    the merge compacts exactly when ``track_visited`` is on (the JAX
    package's default for ``compact_merge``, which no caller overrides)."""
    _plain_only(quant)
    out = vamana_beam_search(
        state.vectors, state.adjacency, queries, search_size, expand_width, max_hops, config.metric,
        seeds=None if seed_ids is None else seed_ids.to(torch.int32).contiguous(),
        track_visited=track_visited,
    )
    hops = out.hops.max() if out.hops.numel() else out.hops.new_zeros(())
    return BeamResult(out.cand_dists, out.cand_ids, out.visited_dists, out.visited_ids, hops, out.hops,
                      out.counts)


def search(
    state: GraphState, queries: torch.Tensor, config: GraphConfig, search_size: int, k: int, max_hops: int = 0,
    quant=None, seed_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfiltered top-k: (dists f32[B, k], ids i32[B, k]); the start node is
    dropped (vamana.go Search), empty places are (inf, -1)."""
    res = beam_search(state, queries, config, search_size, max_hops, seed_ids=seed_ids, expand_width=2,
                      quant=quant, track_visited=False)
    i = res.cand_ids
    d = res.cand_dists.masked_fill(i == START_ID, INF)
    i = i.masked_fill(i == START_ID, NIL)
    d, i = sort_by_distance(d, i)
    return d[:, :k], i[:, :k]


def search_filtered(
    state: GraphState, queries: torch.Tensor, filter_mask: torch.Tensor, config: GraphConfig, search_size: int,
    k: int, max_hops: int = 0, quant=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Filtered top-k (search.go:27-51): ``filter_mask`` bool[cap] of the
    admissible ids. The first ``search_size`` members (ascending id) seed the
    walk; the seeds and the expanded nodes that pass the filter are the
    result pool."""
    _plain_only(quant)
    cap = state.capacity
    mask = filter_mask & state.exists
    members = torch.nonzero(mask).flatten()[:search_size].to(torch.int32)
    seed_ids = torch.full((search_size,), NIL, dtype=torch.int32, device=mask.device)
    seed_ids[: members.numel()] = members
    B = queries.shape[0]
    seeds = seed_ids[None, :].expand(B, search_size).contiguous()
    res = beam_search(state, queries, config, search_size, max_hops, seed_ids=seeds, expand_width=2,
                      quant=quant, track_visited=True)
    seed_d = gather_distance(state.vectors, seeds.clamp(0, cap - 1), queries, config.metric)
    seed_d = seed_d.masked_fill(seeds == NIL, INF)
    vi = res.visited_ids
    vis_ok = (vi != NIL) & (vi != START_ID) & mask[vi.clamp(0, cap - 1).long()]
    vd = res.visited_dists.masked_fill(~vis_ok, INF)
    vi = vi.masked_fill(~vis_ok, NIL)
    pool_d, pool_i = dedup_by_id(torch.cat([seed_d, vd], dim=-1), torch.cat([seeds, vi], dim=-1))
    pool_d, pool_i = sort_by_distance(pool_d, pool_i)
    return pool_d[:, :k], pool_i[:, :k]


def exact_search(state: GraphState, queries: torch.Tensor, config: GraphConfig, k: int):
    """Brute-force top-k over the live nodes (tests / ground truth): ties in
    index order, as ``lax.top_k``."""
    d = pairwise_distance(queries, state.vectors, config.metric)
    live = state.exists & (torch.arange(state.capacity, device=d.device) != START_ID)
    d = d.masked_fill(~live[None, :], INF)
    vals, idx = smallest_k_stable(d, k)
    return vals, idx.to(torch.int32)
