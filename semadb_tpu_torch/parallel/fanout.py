"""Scatter-gather search and batched writes over the shard mesh.

Port of ``semadb_tpu/parallel/fanout.py``. Reference behaviour being
replaced (cluster/actions.go): SearchPoints fans the query out to every
shard, shrinks the per-shard limit with a Poisson approximation
(``limit/numShards*1.42 + 10``, actions.go:291-299), merges and truncates.
Here every shard of a stack runs its own search on its slot and one merge
gives the exact global top-k.

A stack is a list with one entry a slot: a **copy** of that shard's view
(a ``GraphState`` for Vamana, a dict of tensors for IVF and fused) on the
slot's device. The JAX package stacks the views along a sharded axis and
runs one ``shard_map``; the port launches the port's own functions on each
slot in turn from the calling thread (``vamana.search.search`` /
``search_filtered``, ``_ivf_query``, ``_ivf_query_pq``, ``_insert_core``
with one overflow round, ``_delete_step``), so every hand-written kernel runs
where it runs for one shard: K10, K3, K9 and K4 for searches, K11 and K10 for
the write steps. Nothing on a search reads back to the host, so slots on
different cards overlap. The slots' ``[B, k]`` triples are copied to the first
slot's device and merged there (:func:`_allgather_topk`).

Where the port differs from the JAX package:
  - no padding to a fleet geometry: a slot launches alone, so each keeps its
    own shapes (``pad_ivf_view`` builds the view unpadded, and a fleet whose
    slab sizes differ stacks, where the JAX code asserts);
    ``ivf_stack_geometry`` and ``ivf_view_fits`` keep the JAX rules, so the
    refusals and the incremental-restack test are the JAX package's;
  - a stack may hold fewer views than the mesh has slots (a partial stack):
    the empty slots launch nothing, where the JAX package pads them with
    inert views whose hits it drops;
  - the write steps update the slots' states in place and return the stack
    they were given (the port's Vamana writers work in place);
  - an IVF-PQ view probes in the full space, as the port's IVF-PQ search
    does; an IVF view scans no overflow when the shard has none live, as
    the shard's own search skips it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from semadb_tpu_torch.index.ivf import NIL as IVF_NIL
from semadb_tpu_torch.index.ivf import _ivf_query, _ivf_query_pq
from semadb_tpu_torch.index.vamana.build import (
    DELETE_CHUNK,
    DELETE_EXPAND_MAX,
    _delete_step,
    _insert_core,
    _overflow_body,
)
from semadb_tpu_torch.index.vamana.graph import NIL as GRAPH_NIL
from semadb_tpu_torch.index.vamana.graph import GraphConfig, GraphState
from semadb_tpu_torch.index.vamana.search import search as local_search
from semadb_tpu_torch.index.vamana.search import search_filtered
from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.ops.topk import sort_by_distance
from semadb_tpu_torch.parallel.mesh import ShardMesh
from semadb_tpu_torch.vectorstore.store import pq_query_table


def poisson_shard_limit(limit: int, num_shards: int) -> int:
    """Per-shard limit shrink (actions.go:272-299 linear Poisson approx)."""
    if num_shards <= 1:
        return limit
    return min(limit, int(limit / num_shards * 1.42) + 10)


def _to(x, dev: torch.device, copy: bool):
    """``x`` on ``dev``; a copy even on the same device when ``copy``."""
    return x.to(dev, copy=copy) if isinstance(x, torch.Tensor) else x


def _place_state(state: GraphState, dev: torch.device, copy: bool) -> GraphState:
    return GraphState(*(_to(t, dev, copy) for t in state))


def _place_view(view: dict, dev: torch.device, copy: bool) -> dict:
    return {key: _to(v, dev, copy) for key, v in view.items()}


def _check_fits(n: int, mesh: ShardMesh) -> None:
    if n > mesh.size:
        raise ValueError(f"{n} shard views for a mesh of {mesh.size} slots")


def stack_states(states: List[GraphState], mesh: ShardMesh) -> List[GraphState]:
    """One copy of each shard's graph on its slot's device (slot i holds
    ``states[i]``). Capacities may differ: nothing is padded."""
    _check_fits(len(states), mesh)
    return [_place_state(s, dev, copy=True) for s, dev in zip(states, mesh.slots)]


def _allgather_topk(d: Sequence[torch.Tensor], i: Sequence[torch.Tensor], extra: Sequence[torch.Tensor], k: int):
    """Merge the slots' top-k lists into the global top-k on the first slot's
    device (the device-side analog of actions.go:352-378). ``d``, ``i`` and
    ``extra`` (the shard index of each hit) hold one [B, k] tensor a slot.
    The lists are laid shard-major, as the JAX package's
    ``moveaxis(all_gather(...), 0, 1).reshape(B, S*k)``, and sorted by
    distance then id with two stable sorts (its ``jnp.lexsort((im, dm))``):
    equal (distance, id) pairs from different shards keep shard order."""
    dev = d[0].device
    dm = torch.cat([x.to(dev, non_blocking=True) for x in d], dim=1)
    im = torch.cat([x.to(dev, non_blocking=True) for x in i], dim=1)
    sm = torch.cat([x.to(dev, non_blocking=True) for x in extra], dim=1)
    dm, im, sm = sort_by_distance(dm, im, sm)
    return dm[:, :k], im[:, :k], sm[:, :k]


def _queries_on(queries):
    """A per-device cache of the batch: ``on(dev)`` is the f32 queries on
    ``dev``, moved there once."""
    base = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(np.asarray(queries, np.float32))
    base = base.to(torch.float32)
    cache: dict = {}

    def on(dev: torch.device) -> torch.Tensor:
        if dev not in cache:
            cache[dev] = base.to(dev).contiguous()
        return cache[dev]

    return on


def _slot_rows(a, si: int, dev: torch.device, dtype=None) -> torch.Tensor:
    """Slot ``si``'s rows of a per-shard operand ([S, ...] array or tensor,
    or a sequence with one entry a slot) on ``dev``."""
    row = a[si]
    t = row if isinstance(row, torch.Tensor) else torch.as_tensor(np.asarray(row))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def _mask_for(masks, si: int, dev: torch.device, n: int) -> torch.Tensor:
    """Slot ``si``'s bool mask cut or zero-padded to ``n`` rows (the JAX
    masks have the fleet's padded capacity; a slot's own may be smaller)."""
    m = _slot_rows(masks, si, dev, torch.bool)
    if m.shape[0] >= n:
        return m[:n].contiguous()
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[: m.shape[0]] = m
    return out


def _merged(results, k: int):
    """(d, i) a slot → the merged (d, i, shard idx)."""
    ds = [r[0] for r in results]
    ids = [r[1] for r in results]
    sh = [torch.full_like(r[1], si) for si, r in enumerate(results)]
    return _allgather_topk(ds, ids, sh, k)


def sharded_search(
    stacked: List[GraphState], queries, config: GraphConfig, search_size: int, k: int, mesh: ShardMesh,
):
    """Fan-out search: (dists f32[B, k], node ids i32[B, k], shard idx
    i32[B, k]) on the first slot's device. Node ids are shard-local; the
    shard index says which shard each hit came from. Each slot walks its
    graph in f32 (K10), as the JAX mesh does whatever the shard's quantizer."""
    _check_fits(len(stacked), mesh)
    on = _queries_on(queries)
    res = [local_search(st, on(st.vectors.device), config, search_size, k) for st in stacked]
    return _merged(res, k)


def sharded_insert_step(
    stacked: List[GraphState], new_ids, new_vecs, valid, config: GraphConfig, search_size: int,
    mesh: ShardMesh, intra_k: int = 8,
) -> List[GraphState]:
    """One batched insert step on every slot: ``new_ids`` i32[S, B]
    shard-local ids (0 = padding), ``new_vecs`` f32[S, B, D], ``valid``
    bool[S, B]. Each slot runs search + prune + backedges (``_insert_core``)
    and a single overflow round, as the JAX step does. Padding rows are left
    out, which is what the JAX step's masks amount to. Updates the states in
    place and returns the stack."""
    _check_fits(len(stacked), mesh)
    chunk = min(1024, max(st.capacity for st in stacked))
    valid_np = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, bool)
    for si, st in enumerate(stacked):
        keep = np.nonzero(valid_np[si])[0]
        if not len(keep):
            continue
        dev = st.vectors.device
        sel = torch.from_numpy(keep).to(dev)
        ids = _slot_rows(new_ids, si, dev, torch.int32)[sel].contiguous()
        vecs = _slot_rows(new_vecs, si, dev, torch.float32)[sel].contiguous()
        targets, sources, pending = _insert_core(st, ids, vecs, config, search_size, intra_k)
        _overflow_body(st, targets, sources, pending, config, chunk, config.degree_bound)
    return stacked


def sharded_delete_step(stacked: List[GraphState], del_masks, config: GraphConfig, mesh: ShardMesh):
    """Batched delete + graph repair on every slot (prune.go:88-154):
    ``del_masks`` bool[S, cap]. Each slot runs the whole delete step
    (``_delete_step``: the repair sweeps, the row clearing, the straggler
    rescue and the re-attachment). Updates in place and returns the stack."""
    _check_fits(len(stacked), mesh)
    chunk = min(DELETE_CHUNK, max(st.capacity for st in stacked))
    for si, st in enumerate(stacked):
        mask = _mask_for(del_masks, si, st.vectors.device, st.capacity)
        _delete_step(st, mask, config, chunk, DELETE_EXPAND_MAX)
    return stacked


def sharded_search_filtered(
    stacked: List[GraphState], queries, masks, config: GraphConfig, search_size: int, k: int, mesh: ShardMesh,
):
    """Filtered fan-out search (search.go:27-51, shard-parallel): ``masks``
    bool[S, cap] (or one mask a slot) of each shard's admissible ids; each
    slot seeds from its own members and admits only members."""
    _check_fits(len(stacked), mesh)
    on = _queries_on(queries)
    res = []
    for si, st in enumerate(stacked):
        dev = st.vectors.device
        res.append(search_filtered(st, on(dev), _mask_for(masks, si, dev, st.capacity), config, search_size, k))
    return _merged(res, k)


def ivf_stack_geometry(indices) -> dict:
    """The fleet geometry the JAX package pads to, and its refusals: shards in
    MIXED PQ / full-precision modes (the quantizer trigger fires per shard, so
    a half-fitted fleet has no common scoring space) and PQ shards with
    different (M, K) raise ``NotImplementedError``; the caller falls back to
    the host fan-out. The port pads nothing; ``ivf_view_fits`` reads the
    geometry to decide an incremental restack as the JAX package does."""
    pq_flags = [bool(getattr(i, "pq_active", False)) for i in indices]
    if any(pq_flags) and not all(pq_flags):
        raise NotImplementedError(
            "IVF shards in mixed PQ/full-precision modes cannot share one "
            "mesh dispatch; use host fan-out until every shard's quantizer "
            "trigger has fired"
        )
    geom = {
        "max_c": max(i.centroids.shape[0] for i in indices),
        "max_o": max(i.ovf_ids.shape[0] for i in indices),
        "max_cap": max(i.vectors.shape[0] for i in indices),
        "S": indices[0].slab_ids.shape[1],
        "D": indices[0].params.vector_size,
        "tdim": indices[0].slabs.shape[-1],
        "slab_dtype": str(indices[0].slabs.dtype).replace("torch.", ""),
        "has_proj": indices[0]._proj is not None,
        "pq": all(pq_flags),
    }
    if geom["pq"]:
        M = indices[0].pq_codebook.shape[0]
        K = indices[0].pq_codebook.shape[1]
        if any(i.pq_codebook.shape[0] != M or i.pq_codebook.shape[1] != K for i in indices):
            raise NotImplementedError(
                "PQ shards with differing (num_subvectors, num_centroids) "
                "cannot share one mesh dispatch"
            )
        geom["M"], geom["K"] = int(M), int(K)
    return geom


def ivf_view_fits(idx, geom: dict) -> bool:
    """True when ``idx`` fits ``geom``: the incremental restack precondition
    (cluster/meshsearch.py replaces one shard's copy instead of rebuilding
    the whole stack), the JAX package's rule."""
    if bool(getattr(idx, "pq_active", False)) != bool(geom.get("pq")):
        return False
    if geom.get("pq") and (idx.pq_codebook.shape[0] != geom["M"] or idx.pq_codebook.shape[1] != geom["K"]):
        return False
    return (
        idx.slab_ids.shape[1] == geom["S"]
        and idx.slabs.shape[-1] == geom["tdim"]
        and (idx._proj is not None) == geom["has_proj"]
        and idx.centroids.shape[0] <= geom["max_c"]
        and idx.ovf_ids.shape[0] <= geom["max_o"]
        and idx.vectors.shape[0] <= geom["max_cap"]
    )


def _sq(arr: torch.Tensor, metric: str) -> torch.Tensor:
    """The engine's stored-side norm term (``IndexIVF._sq``)."""
    if metric == C.DISTANCE_EUCLIDEAN:
        return (arr.float() * arr.float()).sum(-1)
    return torch.zeros(arr.shape[:-1], dtype=torch.float32, device=arr.device)


def pad_ivf_view(idx, geom: dict) -> dict:
    """One shard's stack view: the arrays its own search scores, with the
    probe centroids in the slab space and their norms, unpadded (see the
    module docstring). ``idx`` is an ``IndexIVF`` or its
    ``capture_stack_view()``; the view holds its tensors, not copies."""
    metric = idx.metric
    live_ovf = getattr(idx, "live_ovf", True)
    if geom.get("pq"):
        o = idx.ovf_ids.shape[0] if live_ovf else 0
        return {
            "centroids": idx.centroids,
            "cent_sq": _sq(idx.centroids, metric),
            "slab_codes": idx.slab_codes,
            "slab_ids": idx.slab_ids,
            "ovf_codes": idx.ovf_codes[:o],
            "ovf_ids": idx.ovf_ids[:o],
            "vectors": idx.vectors,
            "codebook": idx.pq_codebook,
        }
    cents = idx.centroids @ idx._proj if idx._proj is not None else idx.centroids
    ov, ov_ids = (idx.ovf_vecs, idx.ovf_ids) if live_ovf else (idx.ovf_vecs[:0], idx.ovf_ids[:0])
    out = {
        "centroids": cents,
        "cent_sq": _sq(cents, metric),
        "slabs": idx.slabs,
        "slab_sq": idx.slab_sq,
        "slab_ids": idx.slab_ids,
        "ovf_vecs": ov,
        "ovf_sq": _sq(ov, metric),
        "ovf_ids": ov_ids,
        "vectors": idx.vectors,
    }
    if idx._proj is not None:
        # Each shard's own basis: a refit derives it from the shard's sample
        out["proj"] = idx._proj
    return out


def stack_ivf_states(indices, mesh: ShardMesh) -> List[dict]:
    """One copy of each shard's IVF view on its slot's device: the stack
    :func:`sharded_ivf_search` and its kin take. Raises
    ``NotImplementedError`` on the fleets :func:`ivf_stack_geometry` refuses."""
    _check_fits(len(indices), mesh)
    geom = ivf_stack_geometry(indices)
    return [_place_view(pad_ivf_view(i, geom), dev, copy=True) for i, dev in zip(indices, mesh.slots)]


def update_stacked_shard(stacked: List[dict], si: int, view: dict, mesh: ShardMesh, copy: bool = True) -> List[dict]:
    """Incremental restack: a new stack whose slot ``si`` holds ``view`` on
    its device (a copy unless ``copy`` is False, for a view that is already
    private), every other slot's copy kept as it is. A write to one shard
    otherwise rebuilds every shard's copy."""
    out = list(stacked)
    out[si] = _place_view(view, mesh.slots[si], copy=copy)
    return out


def _ivf_slot(st: dict, q: torch.Tensor, mask, p: int, k: int, metric: str):
    return _ivf_query(
        st["centroids"], st["cent_sq"], st["slabs"], st["slab_sq"], st["slab_ids"], st["ovf_vecs"], st["ovf_sq"],
        st["ovf_ids"], q, st["vectors"], mask, st.get("proj"), p, k, metric, dedup=True,
    )


def _with_const(d: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The fused rank constant added to the finite scores only."""
    return torch.where(torch.isfinite(d), d + c[:, None], d)


def sharded_ivf_search(stacked: List[dict], queries, p: int, k: int, mesh: ShardMesh, metric: str = "euclidean"):
    """IVF fan-out: each slot probes its own clusters (K3, K4), then one merge.
    Returns (dists f32[B, k], local node ids i32[B, k], shard idx i32[B, k])."""
    _check_fits(len(stacked), mesh)
    on = _queries_on(queries)
    return _merged([_ivf_slot(st, on(st["vectors"].device), None, p, k, metric) for st in stacked], k)


def sharded_ivf_search_filtered(
    stacked: List[dict], queries, masks, p: int, k: int, mesh: ShardMesh, metric: str = "euclidean",
):
    """Filtered IVF fan-out: each slot's member mask gates candidate
    admission inside its probe scan (``_ivf_query``'s filter)."""
    _check_fits(len(stacked), mesh)
    on = _queries_on(queries)
    res = []
    for si, st in enumerate(stacked):
        dev = st["vectors"].device
        res.append(_ivf_slot(st, on(dev), _mask_for(masks, si, dev, st["vectors"].shape[0]), p, k, metric))
    return _merged(res, k)


def sharded_fused_search(stacked: List[dict], psi, const, p: int, k: int, mesh: ShardMesh, metric: str = "dot"):
    """Fused-hybrid fan-out (index/fused.py served shard-parallel): ``psi``
    f32[S, B, aug] holds the queries mapped into each shard's own psi space,
    ``const`` f32[S, B] each shard's rank constants, added to the finite raw
    scores of that shard before the merge (raw engine scores of different
    shards are not comparable)."""
    _check_fits(len(stacked), mesh)
    res = []
    for si, st in enumerate(stacked):
        dev = st["vectors"].device
        d, i = _ivf_slot(st, _slot_rows(psi, si, dev, torch.float32).contiguous(), None, p, k, metric)
        res.append((_with_const(d, _slot_rows(const, si, dev, torch.float32)), i))
    return _merged(res, k)


def sharded_fused_search_filtered(
    stacked: List[dict], psi, const, masks, p: int, k: int, mesh: ShardMesh, metric: str = "dot",
):
    """Filtered fused fan-out: :func:`sharded_fused_search` with each slot's
    member mask gating candidate admission inside its probe scan."""
    _check_fits(len(stacked), mesh)
    res = []
    for si, st in enumerate(stacked):
        dev = st["vectors"].device
        q = _slot_rows(psi, si, dev, torch.float32).contiguous()
        d, i = _ivf_slot(st, q, _mask_for(masks, si, dev, st["vectors"].shape[0]), p, k, metric)
        res.append((_with_const(d, _slot_rows(const, si, dev, torch.float32)), i))
    return _merged(res, k)


def sharded_ivf_pq_search(
    stacked: List[dict], queries, p: int, k: int, kq: int, mesh: ShardMesh, metric: str = "euclidean",
):
    """IVF-PQ fan-out: each slot builds its queries' ADC tables from ITS
    codebook, scans its codes (K9) and reranks with exact f32 rows (K4); the
    exact distances make the shards' lists comparable, so one merge follows.
    ``kq``: PQ centroids per subvector."""
    _check_fits(len(stacked), mesh)
    on = _queries_on(queries)
    res = []
    for st in stacked:
        q = on(st["vectors"].device)
        cb = st["codebook"]
        table = pq_query_table(q, cb, cb.shape[0], kq, metric)
        res.append(_ivf_query_pq(
            st["centroids"], st["cent_sq"], st["slab_codes"], st["slab_ids"], st["ovf_codes"], st["ovf_ids"],
            table, q, st["vectors"], None, p, k, metric, dedup=True,
        ))
    return _merged(res, k)


def inert_ivf_view(geom: dict, device: torch.device = torch.device("cpu")) -> dict:
    """A view that can never produce a finite hit (centroids at 1e15 norm,
    every id slot NIL): the JAX package pads a partial stack with these. The
    port's mesh searcher leaves such slots empty instead; a stack that holds
    one launches it all the same."""
    C_, S, O = geom["max_c"], geom["S"], geom["max_o"]
    tdim, cap, D = geom["tdim"], geom["max_cap"], geom["D"]
    f32 = dict(dtype=torch.float32, device=device)
    out = {
        "centroids": torch.full((C_, tdim), 1e15, **f32),
        "cent_sq": torch.full((C_,), 1e30, **f32),
        "slab_ids": torch.full((C_, S), IVF_NIL, dtype=torch.int32, device=device),
        "ovf_ids": torch.full((O,), IVF_NIL, dtype=torch.int32, device=device),
        "vectors": torch.zeros((cap, D), **f32),
    }
    if geom.get("pq"):
        out["slab_codes"] = torch.zeros((C_, S, geom["M"]), dtype=torch.uint8, device=device)
        out["ovf_codes"] = torch.zeros((O, geom["M"]), dtype=torch.uint8, device=device)
        out["codebook"] = torch.zeros((geom["M"], geom["K"], D // geom["M"]), **f32)
    else:
        sdt = getattr(torch, geom.get("slab_dtype", "float32"))
        out["slabs"] = torch.zeros((C_, S, tdim), dtype=sdt, device=device)
        out["slab_sq"] = torch.zeros((C_, S), **f32)
        out["ovf_vecs"] = torch.zeros((O, tdim), **f32)
        out["ovf_sq"] = torch.zeros((O,), **f32)
    if geom.get("has_proj"):
        out["proj"] = torch.zeros((D, tdim), **f32)
    return out


def inert_graph_state(capacity: int, dim: int, degree: int, device: torch.device = torch.device("cpu")) -> GraphState:
    """A Vamana view where nothing exists and no edge leads anywhere: the
    walk returns (inf, NIL) rows only."""
    return GraphState(
        vectors=torch.zeros((capacity, dim), dtype=torch.float32, device=device),
        adjacency=torch.full((capacity, degree), GRAPH_NIL, dtype=torch.int32, device=device),
        exists=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
