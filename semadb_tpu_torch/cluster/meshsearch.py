"""Device-mesh serving path: one fan-out over the shard mesh per query batch.

Port of ``semadb_tpu/cluster/meshsearch.py``. The reference's only data
plane is host RPC fan-out: SearchPoints spawns one goroutine per shard, each
walking its own index, results merged on the coordinator
(cluster/actions.go:274-378). Here a collection can opt into
``shardPlacement: "device"``: this node stacks copies of its LOCAL shards'
indices, one a slot of its :class:`~semadb_tpu_torch.parallel.mesh.ShardMesh`,
and serves eligible vector queries with one ``sharded_*_search`` whose merge
gives the EXACT global top-k, with no Poisson per-shard limit shrink.

Eligibility (everything else falls back to the host fan-out):
  - a vectorVamana, vectorIVF or vectorFused query, filtered or not, no
    _and/_or/_id
  - not a vectorVamana property of the hamming or jaccard metric: the slots
    walk a Vamana graph in f32, so the mesh would answer another metric
    than the host plane (F13; the JAX mesh serves it, in f32). BQ and PQ
    stores stay on the mesh: their reranked distances are in the
    collection's metric
  - no more shards than the mesh has slots
  - not a fleet ``ivf_stack_geometry`` refuses (mixed PQ / f32 modes, PQ
    shards with different (M, K)), not PQ with a filter, not a PQ fused
    inner index

Staleness: stacks are copies, taken under the shard lock and the engine's
locks. Each search compares the shards' ``write_version`` counters (host
ints) with the cached stack's and replaces the copies of the shards that
changed (or rebuilds the stack), so a read-heavy node restacks only after
writes (the shared cache's read/write interlock, cache/manager.go:116-303).

Where the port differs from the JAX package: bit-metric Vamana queries go to
the host plane (above); the captures are copies (the
port's engines write in place, so a stack of references would be torn by the
next write while its versions still match); a partial stack (a collection
whose shards several nodes own) holds only this node's shards and leaves
the other slots empty instead of padding them with inert views; nothing is
padded (queries, states, masks), since a slot launches alone.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from semadb_tpu_torch.index.fused import FusedHybridIVF
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.index.manager import IndexManager
from semadb_tpu_torch.index.vamana import IndexVamana
from semadb_tpu_torch.index.vamana.graph import GraphState
from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.collection import Collection
from semadb_tpu_torch.models.query import Query
from semadb_tpu_torch.ops.distance import BIT_METRICS
from semadb_tpu_torch.parallel import fanout
from semadb_tpu_torch.parallel.mesh import ShardMesh, shard_mesh
from semadb_tpu_torch.utils.logging import get_logger

LOG = get_logger("meshsearch")


def maybe_mesh(device) -> Optional[ShardMesh]:
    """A 1-D shard mesh over every visible card, or None on ``cpu`` and on a
    node with fewer than two cards (the JAX node's rule on one device)."""
    if torch.device(device).type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return shard_mesh()


@dataclass
class _Stacked:
    kind: str  # "vamana" | "ivf" | "fused"
    stacked: list  # one copy a slot (GraphState or dict of tensors)
    shard_ids: List[str]
    versions: Tuple[int, ...]
    config: object = None  # GraphConfig (vamana)
    probes: int = 0  # default probe count (ivf/fused)
    psi_views: Optional[list] = None  # per-shard psi mappers (fused)
    metric: str = ""  # inner engine metric (fused)
    geom: Optional[dict] = None  # fleet geometry (ivf/fused)


def _capture_graph(idx: IndexVamana):
    """A private copy of a Vamana index's graph (its writers update the
    tensors in place), taken under its write lock."""
    with idx._write_lock:
        return GraphState(*(t.clone() for t in idx.state)), idx.config


class MeshSearcher:
    def __init__(self, shard_manager, mesh: Optional[ShardMesh] = None):
        self.shard_manager = shard_manager
        self.mesh = mesh
        self._cache: Dict[Tuple[str, str, str], _Stacked] = {}
        self._mu = threading.Lock()

    # -- eligibility ---------------------------------------------------------
    def eligible_query(self, col: Collection, query: Query) -> Optional[str]:
        """The queried property when the mesh path can serve this query, else
        None (the caller falls back to the host fan-out)."""
        if self.mesh is None or col.shard_placement != "device":
            return None
        if not col.shard_ids or len(col.shard_ids) > self.mesh.size:
            return None
        if query.property in ("_and", "_or", "_id"):
            return None
        params = col.index_schema.get(query.property)
        if params is None:
            return None
        if params.type == C.INDEX_TYPE_VECTOR_VAMANA:
            if params.vector_vamana.distance_metric in BIT_METRICS:
                return None  # the slots walk in f32: the host plane answers in the user's bit metric
            opts = query.vector_vamana
        elif params.type == C.INDEX_TYPE_VECTOR_IVF:
            opts = query.vector_ivf
        elif params.type == C.INDEX_TYPE_VECTOR_FUSED:
            opts = query.vector_fused
        else:
            return None
        if opts is None:
            return None
        # Filtered queries are mesh-servable for every kind: the filter
        # sub-query evaluates per shard on the host (Shard.filter_node_ids)
        # and the masks go to the slots (sharded_*_search_filtered).
        return query.property

    # -- stacking --------------------------------------------------------------
    def _collect(self, col: Collection, prop: str, shard_ids: List[str]):
        """Capture a consistent copy of each shard's index under its shard
        lock (writes routed through the shard manager hold it too) and the
        engine's own locks; a capture read after the lock is released could
        be torn, e.g. new slab_ids with old slabs."""
        params = col.index_schema.get(prop)
        bucket = IndexManager.bucket_name(params.type, prop)
        out = []
        for sid in shard_ids:
            def fn(shard):
                idx = shard.device_indices.get(bucket)
                if isinstance(idx, IndexVamana):
                    state, config = _capture_graph(idx)
                    cap = ("vamana", state, config)
                elif isinstance(idx, FusedHybridIVF):
                    cap = ("fused", idx.capture_stack_view(), None)
                elif isinstance(idx, IndexIVF):
                    cap = ("ivf", idx.capture_stack_view(), None)
                else:
                    cap = None
                return cap, shard.write_version

            cap, ver = self.shard_manager.do_with_shard(col, sid, fn)
            if cap is None:
                return None
            out.append((cap, ver))
        return out

    def _build_from(self, col: Collection, caps, versions, shard_ids: List[str]) -> Optional[_Stacked]:
        """Stack the given shards' captures, slot i for shard i. A partial
        stack (this node owns only some of the collection's shards) leaves
        the remaining slots empty."""
        slots = self.mesh.slots
        if all(c[0] == "vamana" for c in caps):
            states = [c[1] for c in caps]
            cap = max(s.capacity for s in states)
            stacked = [fanout._place_state(_pad_state(s, cap), dev, copy=False) for s, dev in zip(states, slots)]
            return _Stacked(kind="vamana", stacked=stacked, shard_ids=list(shard_ids), versions=versions,
                            config=caps[0][2])
        if all(c[0] == "ivf" for c in caps) or all(c[0] == "fused" for c in caps):
            fused = caps[0][0] == "fused"
            views = [c[1][0] if fused else c[1] for c in caps]
            geom = fanout.ivf_stack_geometry(views)  # raises on mixed PQ
            if fused and geom.get("pq"):
                return None  # PQ-mode fused inner: host fan-out
            stacked = [fanout._place_view(fanout.pad_ivf_view(v, geom), dev, copy=False)
                       for v, dev in zip(views, slots)]
            if fused:
                return _Stacked(kind="fused", stacked=stacked, shard_ids=list(shard_ids), versions=versions,
                                probes=views[0]._num_probes(0), psi_views=[c[1][1] for c in caps],
                                metric=views[0].metric, geom=geom)
            return _Stacked(kind="ivf", stacked=stacked, shard_ids=list(shard_ids), versions=versions,
                            probes=views[0]._num_probes(0), geom=geom)
        return None

    def _try_incremental(self, cached: _Stacked, caps, versions) -> Optional[_Stacked]:
        """Replace only the CHANGED shards' copies in the cached stack: a
        write to one shard must not rebuild every other shard's copy.
        ``caps`` holds a capture for each changed shard (None elsewhere). Returns
        None when the changed shard outgrew the stack geometry (the JAX
        package's rule, ``ivf_view_fits`` / the Vamana capacity)."""
        changed = [i for i, v in enumerate(versions) if v != cached.versions[i]]
        if any(caps[i] is None or caps[i][0] != cached.kind for i in changed):
            return None
        stacked = list(cached.stacked)
        psi_views = list(cached.psi_views) if cached.psi_views else None
        slots = self.mesh.slots
        if cached.kind == "vamana":
            cap0 = stacked[0].capacity
            for i in changed:
                state = caps[i][1]
                if state.capacity > cap0:
                    return None
                stacked[i] = fanout._place_state(_pad_state(state, cap0), slots[i], copy=False)
        else:
            geom = cached.geom
            for i in changed:
                view = caps[i][1] if cached.kind == "ivf" else caps[i][1][0]
                if geom is None or not fanout.ivf_view_fits(view, geom):
                    return None
                stacked = fanout.update_stacked_shard(stacked, i, fanout.pad_ivf_view(view, geom), self.mesh,
                                                      copy=False)
                if psi_views is not None:
                    psi_views[i] = caps[i][1][1]
        return replace(cached, stacked=stacked, versions=versions, psi_views=psi_views)

    def _versions(self, col: Collection, shard_ids: List[str]) -> Tuple[int, ...]:
        return tuple(self.shard_manager.do_with_shard(col, sid, lambda s: s.write_version) for sid in shard_ids)

    def _get(self, col: Collection, prop: str, shard_ids: Optional[List[str]] = None) -> Optional[_Stacked]:
        """The stack for ``prop`` over ``shard_ids``: the cached one while no
        shard's ``write_version`` moved, else the cached one with the changed
        shards' copies replaced, else a new one. Only the shards that changed
        are copied (a capture is a device copy, where the JAX package's is a
        reference)."""
        shard_ids = list(shard_ids if shard_ids is not None else col.shard_ids)
        if not shard_ids or len(shard_ids) > self.mesh.size:
            return None
        key = (col.user_id, col.id, prop)
        with self._mu:
            cached = self._cache.get(key)
        if cached is not None and cached.shard_ids == shard_ids:
            versions = self._versions(col, shard_ids)
            if versions == cached.versions:
                return cached
            changed = [i for i, v in enumerate(versions) if v != cached.versions[i]]
            pairs = self._collect(col, prop, [shard_ids[i] for i in changed])
            if pairs is None:
                return None
            caps = [None] * len(shard_ids)
            versions = list(cached.versions)
            for i, (cap, ver) in zip(changed, pairs):
                caps[i], versions[i] = cap, ver
            try:
                upd = self._try_incremental(cached, caps, tuple(versions))
            except NotImplementedError:
                upd = None  # e.g. a shard flipped to PQ mode
            if upd is not None:
                with self._mu:
                    self._cache[key] = upd
                LOG.debug("mesh stack updated incrementally", collection=col.id, prop=prop)
                return upd
        pairs = self._collect(col, prop, shard_ids)
        if pairs is None:
            return None
        caps = [p[0] for p in pairs]
        versions = tuple(p[1] for p in pairs)
        built = self._build_from(col, caps, versions, shard_ids)  # raises on PQ
        if built is None:
            return None
        with self._mu:
            self._cache[key] = built
        LOG.debug("mesh stack rebuilt", collection=col.id, prop=prop)
        return built

    # -- search -----------------------------------------------------------------
    def search_batch(
        self,
        col: Collection,
        prop: str,
        queries: np.ndarray,  # f32[B, D]
        k: int,
        search_size: int = 0,
        num_probes: int = 0,
        filter_query=None,  # shared filter Query for the whole batch
        shard_ids: Optional[List[str]] = None,  # subset (multi-node)
    ) -> Optional[List[List[Tuple[float, str, int]]]]:
        """→ per query: [(distance, shard_id, local node id), ...] best-k
        across the shards, or None when the mesh path can't serve it.

        ``filter_query``: one filter shared by every request in the batch
        (node.py requires structural equality before routing here), evaluated
        per shard ON HOST (the inverted/text indices are host structures,
        index/search.go:58-65's bitmap precompute); the masks go to the slots."""
        try:
            st = self._get(col, prop, shard_ids)
        except NotImplementedError as e:
            LOG.warn("mesh path unsupported, host fan-out", reason=str(e))
            return None
        if st is None or st.kind == "fused":
            return None
        B = queries.shape[0]
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        masks = None
        if filter_query is not None:
            if st.geom is not None and st.geom.get("pq"):
                return None  # filtered PQ: host fan-out
            masks = self._filter_masks(col, st, filter_query)
        if st.kind == "vamana":
            L = max(search_size or st.config.search_size, k)
            if masks is not None:
                d, i, s = fanout.sharded_search_filtered(st.stacked, q, masks, st.config, L, k, self.mesh)
            else:
                d, i, s = fanout.sharded_search(st.stacked, q, st.config, L, k, self.mesh)
        else:
            p = num_probes or st.probes
            metric = col.index_schema.get(prop).vector_ivf.distance_metric
            if masks is not None:
                d, i, s = fanout.sharded_ivf_search_filtered(st.stacked, q, masks, p, k, self.mesh, metric=metric)
            elif st.geom is not None and st.geom.get("pq"):
                d, i, s = fanout.sharded_ivf_pq_search(st.stacked, q, p, k, st.geom["K"], self.mesh, metric=metric)
            else:
                d, i, s = fanout.sharded_ivf_search(st.stacked, q, p, k, self.mesh, metric=metric)
        return self._rows_from(d, i, s, B, st)

    def _filter_masks(self, col: Collection, st: _Stacked, filter_query) -> List[torch.Tensor]:
        """One admissible-id mask a shard for a shared batch filter, over the
        capacity of its copy, on its slot: the sub-query evaluates per shard
        ON HOST (index/search.go:58-65's bitmap precompute)."""
        out = []
        for si, sid in enumerate(st.shard_ids):
            view = st.stacked[si]
            vec = view.vectors if st.kind == "vamana" else view["vectors"]
            cap = vec.shape[0]
            allowed = self.shard_manager.do_with_shard(col, sid, lambda s: s.filter_node_ids(filter_query))
            m = np.zeros(cap, bool)
            if allowed:
                ids = np.fromiter(allowed, np.int64, len(allowed))
                m[ids[ids < cap]] = True
            out.append(torch.from_numpy(m).to(vec.device))
        return out

    def search_batch_fused(
        self,
        col: Collection,
        prop: str,
        qviews: List[np.ndarray],  # one f32[B, d_i] per view
        weights: Optional[List[Optional[list]]],  # per-request overrides
        k: int,
        num_probes: int = 0,
        shard_ids: Optional[List[str]] = None,  # subset (multi-node)
        filter_query=None,  # shared filter for the whole batch
    ) -> Optional[List[List[Tuple[float, str, int]]]]:
        """Fused-hybrid mesh serving: maps each request into every shard's
        OWN psi space (per-shard fitted norm scales) and runs one fan-out
        whose per-shard rank constants are added on each slot before the
        merge (parallel/fanout.py sharded_fused_search)."""
        try:
            st = self._get(col, prop, shard_ids)
        except NotImplementedError as e:
            LOG.warn("mesh path unsupported, host fan-out", reason=str(e))
            return None
        if st is None or st.kind != "fused":
            return None
        masks = None
        if filter_query is not None:
            if st.geom is not None and st.geom.get("pq"):
                return None  # filtered PQ: host fan-out
            masks = self._filter_masks(col, st, filter_query)
        B = qviews[0].shape[0]
        uniform = weights is None or all(w == weights[0] for w in weights)
        psi_rows, const_rows = [], []
        for ps in st.psi_views:
            if uniform:
                w0 = weights[0] if weights else None
                psi, const = ps.psi(qviews, w0)
            else:
                parts = [ps.psi([qv[b : b + 1] for qv in qviews], weights[b]) for b in range(B)]
                psi = np.concatenate([p[0] for p in parts])
                const = np.concatenate([p[1] for p in parts])
            psi_rows.append(np.asarray(psi, np.float32))
            const_rows.append(np.asarray(const, np.float32))
        p = num_probes or st.probes
        if masks is not None:
            d, i, s = fanout.sharded_fused_search_filtered(st.stacked, psi_rows, const_rows, masks, p, k, self.mesh,
                                                           metric=st.metric)
        else:
            d, i, s = fanout.sharded_fused_search(st.stacked, psi_rows, const_rows, p, k, self.mesh,
                                                  metric=st.metric)
        return self._rows_from(d, i, s, B, st)

    def _rows_from(self, d, i, s, B, st) -> List[List[Tuple[float, str, int]]]:
        d = d.cpu().numpy()[:B]
        i = i.cpu().numpy()[:B]
        s = s.cpu().numpy()[:B]
        n_real = len(st.shard_ids)
        out: List[List[Tuple[float, str, int]]] = []
        for b in range(B):
            row = []
            for dist, nid, sh in zip(d[b], i[b], s[b]):
                if nid < 0 or int(sh) >= n_real or not np.isfinite(dist):
                    continue
                row.append((float(dist), st.shard_ids[int(sh)], int(nid)))
            out.append(row)
        return out


def _pad_state(state: GraphState, capacity: int) -> GraphState:
    """A GraphState grown to ``capacity`` rows (padded rows do not exist, so
    no walk changes): the fleet's largest capacity, as the JAX stack needs."""
    from semadb_tpu_torch.index.vamana.graph import grow_graph

    return grow_graph(state, capacity)
