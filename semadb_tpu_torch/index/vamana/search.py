"""Batched greedy beam search over the device-resident Vamana graph.

Port of ``semadb_tpu/index/vamana/search.py``. The walk
(:func:`beam_search`) is K10 (``ops/kernels/vamana_search.py``): on a CUDA
graph the kernel, on a CPU graph its plain version. It scores by the JAX
``_make_gd``'s routes: the f32 rows, or with a fitted binary or product
quantizer the codes (hamming or jaccard bits, ADC tables). Around it, as in
the JAX package:

  - :func:`search`: the walk at W = 2, the start node dropped, the k best by
    (distance, id). A plain walk keeps no ring (its list is not compacted).
    A quantized walk keeps its ring and is reranked in f32 over the list and
    the ring (the rerank is K4, ``ivf_exact_rerank(..., dedup=True)``; with
    haversine, which K4 does not take, the plain-torch gather), unless the
    user's metric is hamming or jaccard: then the bit distances are the
    answer;
  - :func:`search_filtered` (search.go:27-51): seeds are the first L filter
    members by id; the walk keeps its ring, and the result pool is the seeds
    and the expanded nodes that pass the filter, reranked in f32 (plain
    torch, as the JAX package's) after a quantized walk;
  - :func:`exact_search`: brute force over the live nodes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from semadb_tpu_torch.index.vamana.graph import NIL, START_ID, GraphConfig, GraphState
from semadb_tpu_torch.ops.distance import gather_bit_distance, gather_distance, pairwise_distance
from semadb_tpu_torch.ops.kernels.ivf_rerank import METRIC_FLAGS as K4_METRICS
from semadb_tpu_torch.ops.kernels.ivf_rerank import ivf_exact_rerank
from semadb_tpu_torch.ops.kernels.vamana_search import Codes, vamana_beam_search
from semadb_tpu_torch.ops.topk import INF, dedup_by_id, smallest_k_stable, sort_by_distance
from semadb_tpu_torch.vectorstore.store import pq_gather_distance


class BeamResult(NamedTuple):
    cand_dists: torch.Tensor  # f32[B, L] candidate list
    cand_ids: torch.Tensor  # i32[B, L]
    visited_dists: torch.Tensor  # f32[B, V] expanded nodes, sorted
    visited_ids: torch.Tensor  # i32[B, V]
    hops: torch.Tensor  # i32 scalar: the batch's hops (the most any query took)
    query_hops: torch.Tensor  # i32[B]
    counts: torch.Tensor  # i32[B, 2]: nodes expanded, rows scored


def _quantized(quant, qcodes) -> bool:
    return quant is not None and quant.kind != "plain" and qcodes is not None


def _codes(quant, qcodes, qquery) -> Optional[Codes]:
    """K10's operands for the quantized route, or None for the f32 rows."""
    if not _quantized(quant, qcodes):
        return None
    return Codes(quant.kind, qcodes, qquery.contiguous(), quant.bit_metric)


def _reranked(quant) -> bool:
    """A quantized walk is reranked in f32, unless the user's metric is a bit
    metric (the JAX ``search``'s ``rerank``)."""
    return quant is not None and quant.kind != "plain" and not quant.user_bit_metric


def _make_gd(state: GraphState, queries, config: GraphConfig, quant, qcodes, qquery):
    """Distance evaluator over candidate ids: the f32 gather, packed-bit
    hamming or jaccard (binary quantizer), or the ADC lookup (product
    quantizer), as vecStore.DistanceFromFloat dispatches (vectorstore.go:23-43)."""
    cap = state.capacity
    if not _quantized(quant, qcodes):
        return lambda ids: gather_distance(state.vectors, ids.clamp(0, cap - 1), queries, config.metric)
    if quant.kind == "binary":
        return lambda ids: gather_bit_distance(qcodes, ids.clamp(0, cap - 1), qquery, quant.bit_metric)
    return lambda ids: pq_gather_distance(qcodes, ids.clamp(0, cap - 1), qquery, quant.num_centroids)


def beam_search(
    state: GraphState, queries: torch.Tensor, config: GraphConfig, search_size: int, max_hops: int = 0,
    seed_ids: Optional[torch.Tensor] = None, expand_width: int = 8, quant=None, qcodes=None, qquery=None,
    track_visited: bool = True,
) -> BeamResult:
    """Batched greedy search, ``queries`` f32[B, D] → :class:`BeamResult`;
    the merge compacts exactly when ``track_visited`` is on (the JAX
    package's default for ``compact_merge``, which no caller overrides: so
    the user-bit-metric walk, with no ring, runs uncompacted). ``qcodes``
    (the code table, the graph's capacity rows) and ``qquery`` (the
    prepared queries) score the walk when ``quant`` is a fitted quantizer."""
    out = vamana_beam_search(
        state.vectors, state.adjacency, queries, search_size, expand_width, max_hops, config.metric,
        seeds=None if seed_ids is None else seed_ids.to(torch.int32).contiguous(),
        track_visited=track_visited, codes=_codes(quant, qcodes, qquery),
    )
    hops = out.hops.max() if out.hops.numel() else out.hops.new_zeros(())
    return BeamResult(out.cand_dists, out.cand_ids, out.visited_dists, out.visited_ids, hops, out.hops,
                      out.counts)


def rerank(state: GraphState, queries: torch.Tensor, config: GraphConfig, pool_d: torch.Tensor,
           pool_i: torch.Tensor, k: int):
    """The f32 rerank of a quantized walk's pool (the list and the ring):
    the start node and holes dropped, each id once, the k nearest by exact
    distance → (f32[B, k], i32[B, k]), (inf, -1) empty. K4 for the metrics it
    takes; with haversine the JAX package's gather, in plain torch."""
    pool_i = pool_i.masked_fill(pool_i == START_ID, NIL)
    if config.metric in K4_METRICS:
        return ivf_exact_rerank(state.vectors, queries, pool_i.contiguous(), pool_d.contiguous(), k, config.metric,
                                dedup=True)
    cap = state.capacity
    d = gather_distance(state.vectors, pool_i.clamp(0, cap - 1), queries, config.metric)
    d, i = dedup_by_id(d.masked_fill(pool_i == NIL, INF), pool_i)
    d, i = sort_by_distance(d, i)
    return d[:, :k], i[:, :k]


def search(
    state: GraphState, queries: torch.Tensor, config: GraphConfig, search_size: int, k: int, max_hops: int = 0,
    quant=None, qcodes=None, qquery=None, seed_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfiltered top-k: (dists f32[B, k], ids i32[B, k]); the start node is
    dropped (vamana.go Search), empty places are (inf, -1). A quantized walk
    keeps its ring, which widens the f32 rerank's pool (:func:`rerank`)."""
    rr = _reranked(quant) and qcodes is not None
    res = beam_search(state, queries, config, search_size, max_hops, seed_ids=seed_ids, expand_width=2,
                      quant=quant, qcodes=qcodes, qquery=qquery, track_visited=rr)
    if rr:
        return rerank(state, queries, config, torch.cat([res.cand_dists, res.visited_dists], dim=-1),
                      torch.cat([res.cand_ids, res.visited_ids], dim=-1), k)
    i = res.cand_ids
    d = res.cand_dists.masked_fill(i == START_ID, INF)
    i = i.masked_fill(i == START_ID, NIL)
    d, i = sort_by_distance(d, i)
    return d[:, :k], i[:, :k]


def search_filtered(
    state: GraphState, queries: torch.Tensor, filter_mask: torch.Tensor, config: GraphConfig, search_size: int,
    k: int, max_hops: int = 0, quant=None, qcodes=None, qquery=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Filtered top-k (search.go:27-51): ``filter_mask`` bool[cap] of the
    admissible ids. The first ``search_size`` members (ascending id) seed the
    walk; the seeds and the expanded nodes that pass the filter are the
    result pool, scored as the walk scores (quantized where it is) and
    reranked in f32 after a quantized walk."""
    cap = state.capacity
    mask = filter_mask & state.exists
    members = torch.nonzero(mask).flatten()[:search_size].to(torch.int32)
    seed_ids = torch.full((search_size,), NIL, dtype=torch.int32, device=mask.device)
    seed_ids[: members.numel()] = members
    B = queries.shape[0]
    seeds = seed_ids[None, :].expand(B, search_size).contiguous()
    res = beam_search(state, queries, config, search_size, max_hops, seed_ids=seeds, expand_width=2,
                      quant=quant, qcodes=qcodes, qquery=qquery, track_visited=True)
    gd = _make_gd(state, queries, config, quant, qcodes, qquery)
    seed_d = gd(seeds).masked_fill(seeds == NIL, INF)
    vi = res.visited_ids
    vis_ok = (vi != NIL) & (vi != START_ID) & mask[vi.clamp(0, cap - 1).long()]
    vd = res.visited_dists.masked_fill(~vis_ok, INF)
    vi = vi.masked_fill(~vis_ok, NIL)
    pool_d, pool_i = dedup_by_id(torch.cat([seed_d, vd], dim=-1), torch.cat([seeds, vi], dim=-1))
    if _reranked(quant) and qcodes is not None:
        rr = gather_distance(state.vectors, pool_i.clamp(0, cap - 1), queries, config.metric)
        pool_d = rr.masked_fill(pool_i == NIL, INF)
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

