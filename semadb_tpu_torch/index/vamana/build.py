"""Batched Vamana graph construction, update and delete repair.

Port of ``semadb_tpu/index/vamana/build.py`` (reference algorithm:
shard/index/vamana/insert.go, prune.go). Inserts arrive in batches: one
batched beam search (K10) on the pre-batch graph, one robust prune of every
new row (K11), then the backedges as a conflict-free scatter — each
(target, slot) pair is unique by construction (slot = the target's edge count
+ the rank of the inbound edge among those to the same target) — with the
targets that overflow merged and pruned in chunks. The JAX package's on-device
``while_loop``s are host loops here; a loop's condition is one readback.

The graph's tensors are updated in place; ``insert_batch`` and
``delete_batch`` return the state they were given. JAX's ``mode="drop"``
scatters become writes through explicit masks, and its ``top_k`` selections
stable sorts (ids ascending, or ``ops.topk.smallest_k_stable`` for distances), so ties
fall as they fall there. The JAX ``insert_batch`` pads a batch to a bucket
size for XLA; the padded rows change nothing that a real row sees, so the
port does not pad. A caller's candidate pools (``pool_d``, ``pool_i``: the
pool build of ``fastbuild.py``) replace the walk's visited set.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from semadb_tpu_torch.index.vamana.graph import NIL, START_ID, GraphConfig, GraphState
from semadb_tpu_torch.index.vamana.search import beam_search
from semadb_tpu_torch.ops.distance import gather_distance, pairwise_distance
from semadb_tpu_torch.ops.kernels.vamana_prune import vamana_robust_prune
from semadb_tpu_torch.ops.topk import INF, dedup_by_id, smallest_k_stable, sort_by_distance

# Targets merged and pruned per overflow round
OVERFLOW_CHUNK = 1024
# Forward-edge slack: the prune stops at degree_bound - FWD_SLACK edges,
# leaving row slots for backedges
FWD_SLACK = int(os.environ.get("SEMADB_VAMANA_FWD_SLACK", 0))
# Beam expand width W of the build's searches
BUILD_W = int(os.environ.get("SEMADB_VAMANA_BUILD_W", 8))
DELETE_CHUNK = 256
# Deleted neighbours expanded per node in the delete repair
DELETE_EXPAND_MAX = 8
# Component rescue passes after a delete
MAX_RESCUES = 128

# Build counters: batches, overflow rounds and the host seconds from a
# batch's first overflow readback (which waits for its search and prune) to
# its last
BUILD_TIMERS = {"batches": 0, "overflow_rounds": 0, "overflow_s": 0.0}

_BIG_KEY = 2**30  # sort key of an empty backedge slot


def r_stop(config: GraphConfig) -> int:
    """Edges the prune keeps at most: max(R - FWD_SLACK, 8)."""
    return max(config.degree_bound - FWD_SLACK, 8)


def robust_prune_batch(cand_d, cand_i, self_ids, vectors, config: GraphConfig, alpha=None) -> torch.Tensor:
    """robustPrune (search.go:106-138) over a batch of nodes, K11: pools
    (f32, i32)[B, P] sorted by distance to their node → rows i32[B, R]."""
    return vamana_robust_prune(
        cand_d.contiguous(), cand_i.to(torch.int32).contiguous(), self_ids.to(torch.int32).contiguous(), vectors,
        config.degree_bound, r_stop(config), config.alpha if alpha is None else alpha, config.metric,
    )


def candidate_pools(state: GraphState, new_ids: torch.Tensor, new_vecs: torch.Tensor, config: GraphConfig,
                    search_size: int, intra_k: int, own_edges=None, expand_width: int = 8, seed_own: bool = False,
                    pool_d=None, pool_i=None):
    """The pools the prune takes for a batch whose vectors are written: the
    visited ring of a greedy search on the pre-batch graph (or the caller's
    ``pool_d``/``pool_i``, NIL-padded and in any order, deduplicated), each
    point's ``intra_k`` nearest in-batch peers, and with ``own_edges``
    (keep_current) the node's current out-edges, deduplicated; sorted by
    (distance, id)."""
    cap = state.capacity
    B = new_ids.shape[0]
    if pool_i is not None:
        pi = pool_i.to(torch.int32)
        pd = pool_d.to(torch.float32).masked_fill(pi == NIL, INF)
        cand_d, cand_i = sort_by_distance(*dedup_by_id(pd, pi))
    else:
        seeds = own_edges if seed_own and own_edges is not None else None
        res = beam_search(state, new_vecs, config, search_size, expand_width=expand_width, seed_ids=seeds)
        cand_d, cand_i = res.visited_dists, res.visited_ids  # [B, V] sorted
    # The sequential reference lets later inserts see earlier ones; a batch
    # adds each point's nearest in-batch peers instead
    if intra_k > 0:
        bb = pairwise_distance(new_vecs, new_vecs, config.metric)
        bb = bb.masked_fill(torch.eye(B, dtype=torch.bool, device=bb.device), INF)
        nb_d, nb_j = smallest_k_stable(bb, min(intra_k, B))
        nb_i = torch.where(torch.isfinite(nb_d), new_ids[nb_j], NIL)
        cand_d, cand_i = sort_by_distance(torch.cat([cand_d, nb_d], -1), torch.cat([cand_i, nb_i], -1))
    if own_edges is not None:
        own_ok = own_edges != NIL
        od = gather_distance(state.vectors, own_edges.clamp(0, cap - 1), new_vecs, config.metric)
        od = od.masked_fill(~own_ok, INF)
        oi = own_edges.masked_fill(~own_ok, NIL)
        # Old edges can also be in the visited set: dedup before the prune
        cand_d, cand_i = dedup_by_id(torch.cat([cand_d, od], -1), torch.cat([cand_i, oi], -1))
        cand_d, cand_i = sort_by_distance(cand_d, cand_i)
    return cand_d, cand_i


def _insert_core(state: GraphState, new_ids: torch.Tensor, new_vecs: torch.Tensor, config: GraphConfig,
                 search_size: int, intra_k: int, keep_current: bool = False, alpha=None, expand_width: int = 8,
                 seed_own: bool = False, pool_d=None, pool_i=None):
    """Write, search, prune the new rows, and the phase-A backedge scatter.
    Returns the target-sorted backedge arrays for the overflow rounds:
    (targets i32[E], sources i32[E], pending bool[E])."""
    rows = new_ids.long()
    # Existing rows must be read BEFORE this batch rewrites them
    own_edges = state.adjacency[rows] if keep_current else None  # [B, R]

    # 1. Write vectors; mark existence. New nodes have no inbound edges yet,
    #    so the searches cannot reach them
    state.vectors[rows] = new_vecs
    state.exists[rows] = True

    # 2-3. Candidates: the search on the pre-batch graph, the in-batch peers
    #      and, with keep_current, the current out-edges
    cand_d, cand_i = candidate_pools(state, new_ids, new_vecs, config, search_size, intra_k, own_edges,
                                     expand_width, seed_own, pool_d, pool_i)

    # 4. Robust prune → the new rows
    new_rows = robust_prune_batch(cand_d, cand_i, new_ids, state.vectors, config, alpha)
    state.adjacency[rows] = new_rows
    return backedges(state, new_ids, new_rows, config)


def backedges(state: GraphState, new_ids: torch.Tensor, new_rows: torch.Tensor, config: GraphConfig):
    """Step 5 of an insert, the backedges' phase A: each edge e→t of the new
    rows appends e to t's row where there is room. Returns the target-sorted
    backedge arrays for the overflow rounds: (targets i32[E], sources i32[E],
    pending bool[E])."""
    cap = state.capacity
    R = config.degree_bound
    adjacency = state.adjacency
    # 5. Backedges, phase A (append where there is room): the slot for the
    #    inbound edge e→t is edge_count[t] + rank(e among the edges to t)
    targets = new_rows.reshape(-1)
    sources = new_ids.to(torch.int32).repeat_interleave(R)
    tvalid = targets != NIL
    tsafe = torch.where(tvalid, targets, cap - 1).long()
    E = targets.shape[0]
    sort_key = torch.where(tvalid, targets, _BIG_KEY)
    order = torch.argsort(sort_key, stable=True)
    st = sort_key[order]
    ar = torch.arange(E, device=targets.device)
    seg_new = torch.ones(E, dtype=torch.bool, device=targets.device)
    seg_new[1:] = st[1:] != st[:-1]
    seg_start = torch.cummax(torch.where(seg_new, ar, 0), 0).values
    rank = torch.empty_like(ar)
    rank[order] = ar - seg_start
    # Skip backedges whose source is already in the target's row (intra-batch
    # pairs the prune linked both ways)
    trows = adjacency[tsafe]
    dup_edge = (trows == sources[:, None]).any(-1)
    slot = (trows != NIL).sum(-1) + rank
    fits = tvalid & ~dup_edge & (slot < R)
    adjacency[targets[fits].long(), slot[fits]] = sources[fits]
    pending = (tvalid & ~dup_edge & ~fits)[order]
    return st, sources[order], pending


def _overflow_body(state: GraphState, targets, sources, pending, config: GraphConfig, chunk: int, k_in: int,
                   alpha=None):
    """Merge and prune one chunk of overflowing backedge targets: for each
    target, its edges and its pending inbound sources; a plain append when
    they fit the degree bound, else robustPrune (insert.go:44-63). Returns
    the pending mask with the chunk's targets cleared."""
    cap = state.capacity
    R = config.degree_bound
    dev = targets.device
    pools = overflow_pools(state, targets, sources, pending, config, chunk, k_in)
    if pools is None:
        return pending
    sel, cd, ci = pools
    n_cand = (ci != NIL).sum(-1)
    pruned = robust_prune_batch(cd, ci, sel.to(torch.int32), state.vectors, config, alpha)
    state.adjacency[sel] = torch.where((n_cand <= R)[:, None], ci[:, :R], pruned)
    processed = torch.zeros(cap, dtype=torch.bool, device=dev)
    processed[sel] = True
    return pending & ~processed[targets.clamp(0, cap - 1).long()]


def overflow_pools(state: GraphState, targets, sources, pending, config: GraphConfig, chunk: int, k_in: int):
    """One overflow round's chunk: the first ``chunk`` pending targets by id
    and each one's pool, its edges and its pending inbound sources (at most
    ``k_in``) deduplicated and sorted by (distance, id). Returns (targets
    i64[n], pool distances f32[n, R + k_in], pool ids), or None when nothing
    is pending."""
    cap = state.capacity
    E = targets.shape[0]
    dev = targets.device
    t_mask = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    t_mask[torch.where(pending, targets.clamp(0, cap - 1), cap).long()] = True
    sel = torch.nonzero(t_mask[:cap]).flatten()[:chunk]  # ascending id
    if sel.numel() == 0:
        return None
    sel32 = sel.to(torch.int32)
    # Targets arrive sorted: each one's inbound edges are one segment
    starts = torch.searchsorted(targets, sel32)
    win = (starts[:, None] + torch.arange(k_in, device=dev)[None, :]).clamp(0, E - 1)
    in_seg = (targets[win] == sel32[:, None]) & pending[win]
    inb = torch.where(in_seg, sources[win], NIL)
    cand = torch.cat([state.adjacency[sel], inb], -1)  # [n, R + k_in]
    cvalid = cand != NIL
    cd = gather_distance(state.vectors, cand.clamp(0, cap - 1), state.vectors[sel], config.metric)
    cd, ci = dedup_by_id(cd.masked_fill(~cvalid, INF), cand.masked_fill(~cvalid, NIL))
    cd, ci = sort_by_distance(cd, ci)
    return sel, cd, ci


def _insert_step(state: GraphState, new_ids, new_vecs, config: GraphConfig, search_size: int, intra_k: int,
                 chunk: int, keep_current: bool = False, alpha=None, expand_width: int = 8,
                 seed_own: bool = False, pool_d=None, pool_i=None) -> GraphState:
    """Search, prune, backedges, then overflow rounds until none is pending."""
    targets, sources, pending = _insert_core(state, new_ids, new_vecs, config, search_size, intra_k,
                                             keep_current, alpha, expand_width, seed_own, pool_d, pool_i)
    t0 = None
    while bool(pending.any()):
        if t0 is None:
            t0 = time.perf_counter()
        pending = _overflow_body(state, targets, sources, pending, config, chunk, config.degree_bound, alpha)
        BUILD_TIMERS["overflow_rounds"] += 1
    if t0 is not None:
        BUILD_TIMERS["overflow_s"] += time.perf_counter() - t0
    return state


def insert_batch(state: GraphState, new_ids, new_vecs, config: GraphConfig, search_size: int = 0,
                 intra_k: int = 8, keep_current: bool = False, alpha: float | None = None,
                 pool_d=None, pool_i=None, expand_width: int = 0, seed_own: bool = False) -> GraphState:
    """Insert a batch of points: ``new_ids`` [B] unique, not 0 or 1, within
    capacity; ``new_vecs`` f32[B, D] (numpy or tensors). ``alpha`` overrides
    the prune's alpha (the two-pass schedule). ``pool_d``/``pool_i`` [B, P]
    (numpy or tensors) skip the search and are the candidate pools."""
    search_size = search_size or config.search_size
    expand_width = expand_width or BUILD_W
    B = int(new_ids.shape[0])
    if B == 0:
        return state
    dev = state.device
    ids = torch.as_tensor(np.asarray(new_ids) if not isinstance(new_ids, torch.Tensor) else new_ids)
    ids = ids.to(device=dev, dtype=torch.int32)
    vecs = torch.as_tensor(new_vecs).to(device=dev, dtype=torch.float32).contiguous()
    if pool_i is not None:
        pool_d = torch.as_tensor(pool_d).to(dev)
        pool_i = torch.as_tensor(pool_i).to(dev)
    chunk = min(OVERFLOW_CHUNK, state.capacity)
    _insert_step(state, ids, vecs, config, search_size, intra_k, chunk, keep_current,
                 config.alpha if alpha is None else alpha, expand_width, seed_own, pool_d, pool_i)
    BUILD_TIMERS["batches"] += 1
    return state


# ---------------------------------------------------------------------------
# Delete path
# ---------------------------------------------------------------------------


def _needs_repair(state: GraphState, del_mask, processed):
    adj = state.adjacency
    edge_del = (adj != NIL) & del_mask[adj.clamp(0, state.capacity - 1).long()]
    return state.exists & ~del_mask & edge_del.any(-1) & ~processed


def _delete_repair_chunk(state: GraphState, del_mask, processed, config: GraphConfig, chunk: int,
                         expand_max: int) -> int:
    """Repair one chunk of the nodes that point at deleted nodes
    (pruneDeleteNeighbour, prune.go:12-95): candidates = own surviving edges
    ∪ the surviving edges of up to ``expand_max`` deleted neighbours, the
    nearest 2R kept; append when within the bound, else robustPrune. Marks
    the chunk processed; returns how many nodes still need repair."""
    cap = state.capacity
    R = config.degree_bound
    adj = state.adjacency
    dev = adj.device
    sel = torch.nonzero(_needs_repair(state, del_mask, processed)).flatten()[:chunk]
    if sel.numel():
        n = sel.numel()
        own = adj[sel]
        own_del = (own != NIL) & del_mask[own.clamp(0, cap - 1).long()]
        keep = torch.where((own != NIL) & ~own_del, own, NIL)
        del_rank = torch.cumsum(own_del.to(torch.int32), -1) - 1
        exp_ids = torch.full((n, expand_max), NIL, dtype=torch.int32, device=dev)
        put = own_del & (del_rank < expand_max)
        row_idx = torch.arange(n, device=dev)[:, None].expand(n, R)
        exp_ids[row_idx[put], del_rank[put].long()] = own[put]
        exp_adj = adj[exp_ids.clamp(0, cap - 1).long()]  # [n, expand_max, R]
        exp_ok = (exp_ids != NIL)[:, :, None] & (exp_adj != NIL) & ~del_mask[exp_adj.clamp(0, cap - 1).long()]
        cand = torch.cat([keep, torch.where(exp_ok, exp_adj, NIL).reshape(n, expand_max * R)], -1)
        sel32 = sel.to(torch.int32)
        cand = cand.masked_fill(cand == sel32[:, None], NIL)  # a deleted node may point back at us
        cd = gather_distance(state.vectors, cand.clamp(0, cap - 1), state.vectors[sel], config.metric)
        cd, ci = sort_by_distance(cd.masked_fill(cand == NIL, INF), cand)
        cd, ci = sort_by_distance(*dedup_by_id(cd, ci))
        cd, ci = cd[:, : 2 * R], ci[:, : 2 * R]
        n_cand = (ci != NIL).sum(-1)
        pruned = robust_prune_batch(cd, ci, sel32, state.vectors, config)
        adj[sel] = torch.where((n_cand <= R)[:, None], ci[:, :R], pruned)
        processed[sel] = True
    return int(_needs_repair(state, del_mask, processed).sum())


def _delete_finalize(state: GraphState, del_mask, config: GraphConfig) -> None:
    """Clear the deleted rows, then attach the nodes left with no inbound
    edge to the start node (vamana.go:205-253 toSave)."""
    cap = state.capacity
    R = config.degree_bound
    dev = state.adjacency.device
    state.exists.logical_and_(~del_mask)
    adjacency = state.adjacency
    adjacency[del_mask] = NIL
    safe = torch.where((adjacency != NIL) & state.exists[:, None], adjacency, cap).long()
    has_inbound = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    has_inbound[safe.reshape(-1)] = True
    ids = torch.arange(cap, device=dev)
    to_save = state.exists & ~has_inbound[:cap] & (ids != START_ID)
    start_row = adjacency[START_ID].clone()
    save = torch.nonzero(to_save).flatten()[:R].to(torch.int32)
    save_ids = torch.full((R,), NIL, dtype=torch.int32, device=dev)
    save_ids[: save.numel()] = save
    already = (save_ids[:, None] == start_row[None, :]).any(-1)
    save_ids = save_ids.masked_fill(already, NIL)
    pool = torch.cat([start_row, save_ids])
    svec = state.vectors[START_ID][None, :]
    pd = gather_distance(state.vectors, pool.clamp(0, cap - 1)[None, :], svec, config.metric)[0]
    pd, pool = sort_by_distance(pd.masked_fill(pool == NIL, INF), pool)
    n_pool = int((pool != NIL).sum())
    pruned = robust_prune_batch(pd[None, :], pool[None, :], torch.tensor([START_ID], device=dev), state.vectors,
                                config)[0]
    adjacency[START_ID] = pool[:R] if n_pool <= R else pruned


def reachable_mask(state: GraphState, max_sweeps: int = 128) -> torch.Tensor:
    """BFS reachability from the start node as masked adjacency sweeps."""
    cap = state.capacity
    dev = state.adjacency.device
    reach = torch.zeros(cap, dtype=torch.bool, device=dev)
    reach[START_ID] = True
    for _ in range(max_sweeps):
        edges = torch.where(reach[:, None] & (state.adjacency != NIL), state.adjacency, cap).long()
        new = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        new[edges.reshape(-1)] = True
        new = new[:cap] | reach
        changed = bool((new != reach).any())
        reach = new
        if not changed:
            break
    return reach


def _attach_representatives(state: GraphState, unreach, config: GraphConfig) -> None:
    """Force-attach up to R/2 unreachable nodes (nearest to start), chained:
    rep0 goes into the start row (evicting the farthest incumbent only if
    full) and each further rep is written into the previous rep's last
    adjacency slot."""
    cap = state.capacity
    R = config.degree_bound
    K = max(R // 2, 1)
    dev = state.adjacency.device
    svec = state.vectors[START_ID][None, :]
    d_all = gather_distance(state.vectors, torch.arange(cap, device=dev)[None, :], svec, config.metric)[0]
    rep_d, reps = smallest_k_stable(d_all.masked_fill(~unreach, INF), K)
    rep_ok = torch.isfinite(rep_d)
    reps = torch.where(rep_ok, reps, NIL).to(torch.int32)
    nxt = torch.cat([reps[1:], torch.tensor([NIL], dtype=torch.int32, device=dev)])
    chain_ok = rep_ok & (nxt != NIL)
    adjacency = state.adjacency
    adjacency[reps[chain_ok].long(), R - 1] = nxt[chain_ok]
    start_row = adjacency[START_ID].clone()
    sd = gather_distance(state.vectors, start_row.clamp(0, cap - 1)[None, :], svec, config.metric)[0]
    sd = sd.masked_fill(start_row == NIL, INF)
    # Pool = forced rep0 + incumbents; rep0 always survives the cut
    pool_i = torch.cat([reps[:1], start_row])
    pool_d = torch.cat([torch.where(rep_ok[:1], rep_d[:1], INF), sd])
    prio = torch.cat([torch.full((1,), -1.0, device=dev), torch.zeros_like(sd)])
    order = torch.argsort(pool_d, stable=True)
    order = order[torch.argsort(prio[order], stable=True)]
    adjacency[START_ID] = pool_i[order][:R]


def _delete_step(state: GraphState, del_mask, config: GraphConfig, chunk: int, expand_max: int) -> int:
    """Repair every affected node in chunks, clear the rows and rescue
    stragglers, then reconnect lost components until the whole graph is
    reachable (at most MAX_RESCUES passes). Returns the nodes left
    unreachable."""
    cap = state.capacity
    processed = torch.zeros(cap, dtype=torch.bool, device=del_mask.device)
    while _delete_repair_chunk(state, del_mask, processed, config, chunk, expand_max) > 0:
        pass
    _delete_finalize(state, del_mask, config)
    ids = torch.arange(cap, device=del_mask.device)

    def unreach_of():
        return state.exists & ~reachable_mask(state) & (ids != START_ID)

    unreach = unreach_of()
    for _ in range(MAX_RESCUES):
        if not bool(unreach.any()):
            break
        _attach_representatives(state, unreach, config)
        unreach = unreach_of()
    return int(unreach.sum())


def delete_batch(state: GraphState, del_ids, config: GraphConfig) -> GraphState:
    """Delete points and repair the graph."""
    if len(del_ids) == 0:
        return state
    cap = state.capacity
    del_mask = torch.zeros(cap, dtype=torch.bool, device=state.device)
    del_mask[torch.as_tensor(np.asarray(del_ids, np.int64), device=state.device)] = True
    unrescued = _delete_step(state, del_mask, config, min(DELETE_CHUNK, cap), DELETE_EXPAND_MAX)
    if unrescued > 0:
        _logger().warn(
            "delete repair hit the rescue iteration cap; some nodes remain unreachable until the next write",
            unreachable=unrescued,
        )
    return state


@functools.lru_cache(maxsize=1)
def _logger():
    from semadb_tpu_torch.utils.logging import get_logger

    return get_logger("vamana")
