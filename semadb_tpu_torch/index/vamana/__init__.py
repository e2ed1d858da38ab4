"""Vamana (DiskANN-style) graph ANN index on one device.

Port of ``semadb_tpu/index/vamana/__init__.py`` (reference:
shard/index/vamana/vamana.go): ``insert_update_delete`` over
(id, vector|None) changes, the two-pass ``insert_bulk`` or the pool build
(``build_mode="pool"``, ``fastbuild.py``), ``search_batch`` with an
optional filter, and persistence through the JAX package's array layout
(``to_arrays`` / ``from_arrays``, routing arrays and the quantizer's store
included, so a graph the JAX package built and saved searches the same way
here). The walk is K10 and the prune K11 (``ops/kernels/vamana_search.py``,
``ops/kernels/vamana_prune.py``), the rerank of a quantized walk K4.

A binary or product quantizer (vectorstore.go:47-96) fits at the end of the
write that reaches its trigger; from then on the walk scores codes and the
results are reranked in f32. The hamming and jaccard metrics build the graph
in euclidean (on 0/1 vectors squared euclidean is hamming) over a binary
store with a fixed threshold, and a search returns the bit distances.
Capacity grows along one chain (``graph.required_capacity``) live and on
reload, and the code table grows with it (``VectorStore.ensure_rows``), so
a reopened index has the capacity the live one had and a search copies no
codes.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from semadb_tpu_torch.index.vamana import build, graph
from semadb_tpu_torch.index.vamana import search as search_mod
from semadb_tpu_torch.index.vamana.build import delete_batch, insert_batch, robust_prune_batch  # noqa: F401
from semadb_tpu_torch.index.vamana.graph import (  # noqa: F401
    NIL,
    START_ID,
    GraphConfig,
    GraphState,
    grow_graph,
    init_graph,
    required_capacity,
)
from semadb_tpu_torch.index.vamana.search import (  # noqa: F401
    beam_search,
    exact_search,
    search,
    search_filtered,
)
from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.schema import VectorVamanaParams
from semadb_tpu_torch.ops.distance import pairwise_distance
from semadb_tpu_torch.ops.topk import smallest_k_stable
from semadb_tpu_torch.utils.dirty import DirtyTracker
from semadb_tpu_torch.utils.upload import upload_queries
from semadb_tpu_torch.vectorstore import QuantConfig, VectorStore
from semadb_tpu_torch.vectorstore.store import host_tensor

# Insert chunk size: the parallel-batch approximation of sequential
# insertion stays benign while a batch is no larger than the graph
INSERT_CHUNK = 512

# Two-pass bulk build (DiskANN's schedule): pass 1 builds the whole graph
# incrementally at alpha=1.0; pass 2 re-inserts every point against the
# complete graph at the configured alpha, its pool = the fresh visited set
# ∪ the node's current out-edges
TWO_PASS = os.environ.get("SEMADB_VAMANA_TWO_PASS", "1") != "0"
# Below this corpus size the single pass reaches the recall ceiling
TWO_PASS_MIN = int(os.environ.get("SEMADB_VAMANA_TWO_PASS_MIN", 4096))
# Pass-2 batches: every point already exists, so they can be larger
PASS2_CHUNK = int(os.environ.get("SEMADB_VAMANA_PASS2_CHUNK", 4096))
# Per-pass search-list overrides (0 = the index's searchSize)
PASS1_L = int(os.environ.get("SEMADB_VAMANA_PASS1_L", 0))
PASS2_L = int(os.environ.get("SEMADB_VAMANA_PASS2_L", 0))
# Bulk-build strategy: "search" (the two passes above) or "pool", the
# per-cluster kNN pool build (fastbuild.py) for fresh graphs
BUILD_MODE = os.environ.get("SEMADB_VAMANA_BUILD", "search")


def _route_seeds(cents, reps, exists, q, metric: str, s: int):
    """Per-query entry seeds: the live representatives of the ``s`` nearest
    pool-build clusters (one [B, C] product and a top-s). Dead
    representatives become NIL seeds, which the walk ignores."""
    d = pairwise_distance(q, cents, metric)  # [B, C]
    _, top = smallest_k_stable(d, min(s, cents.shape[0]))
    seeds = reps[top]  # [B, s] — or [B, s, m] with several reps a cluster
    if seeds.dim() == 3:
        seeds = seeds.reshape(seeds.shape[0], -1)
    ok = exists[seeds.clamp(0, exists.shape[0] - 1).long()] & (seeds >= 0)
    return torch.where(ok, seeds, NIL).to(torch.int32)


class IndexVamana:
    """Stateful handle on a Vamana graph held on ``device``."""

    N_ENTRY_SEEDS = 16
    N_ROUTE_SEEDS = 8

    def __init__(self, params: VectorVamanaParams, device: torch.device, capacity: int = graph.MIN_CAPACITY):
        self.params = params
        self.device = torch.device(device)
        # Bit metrics build the graph in euclidean: on 0/1 vectors squared
        # euclidean equals hamming; search distances come from the forced
        # binary store (vectorstore.go:56-67)
        internal_metric = params.distance_metric
        if internal_metric in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
            internal_metric = C.DISTANCE_EUCLIDEAN
        self.config = GraphConfig(
            dim=params.vector_size, metric=internal_metric, degree_bound=params.degree_bound,
            search_size=params.search_size, alpha=params.alpha,
        )
        self.state = init_graph(self.config, self.device, capacity)
        # The quantizer (vectorstore.go:47-96): plain unless params.quantizer
        # is set or the metric is a bit metric; its code table keeps the
        # graph's capacity
        self.store = VectorStore(
            QuantConfig.from_params(params.quantizer, params.vector_size, params.distance_metric), self.device
        )
        self.store.ensure_rows(self.state.capacity)
        # Entry seeds: a spread of live nodes beside the start node
        self._entry_seeds: Optional[np.ndarray] = None
        self._entry_seeds_dev: Optional[torch.Tensor] = None  # the same seeds on the device
        # Query-routed entry (graphs the pool build made): cluster centroids
        # f32[C, D] and one live representative a cluster i32[C]
        self._route: Optional[tuple] = None
        self.dirty = DirtyTracker()
        # Highest node id ever written: the snapshot row bound
        self._max_seen = graph.START_ID
        # Writers (and the snapshot writer) hold it; a search holds it while
        # it enqueues, so it never reads a graph half written
        self._write_lock = threading.RLock()
        self.build_seconds: dict = {}

    # -- tensors ------------------------------------------------------------
    @property
    def vectors(self) -> torch.Tensor:
        return self.state.vectors

    @property
    def adjacency(self) -> torch.Tensor:
        return self.state.adjacency

    @property
    def exists(self) -> torch.Tensor:
        return self.state.exists

    @property
    def capacity(self) -> int:
        return self.state.capacity

    # -- persistence -------------------------------------------------------
    def to_arrays(self) -> dict:
        """Host arrays in the JAX package's ``IndexVamana.to_arrays`` layout."""
        with self._write_lock:
            out = {
                "vectors": self.state.vectors.cpu().numpy(),
                "adjacency": self.state.adjacency.cpu().numpy(),
                "exists": self.state.exists.cpu().numpy(),
            }
            if self._route is not None:
                out["route_cents"] = self._route[0].cpu().numpy()
                out["route_reps"] = self._route[1].cpu().numpy()
            out["store"] = self.store.to_arrays()
            return out

    def device_arrays(self) -> dict:
        """Device-resident view (no readback) for the snapshot writer."""
        out = {
            "vectors": self.state.vectors,
            "adjacency": self.state.adjacency,
            "exists": self.state.exists,
            "store": self.store.device_arrays(),
        }
        if self._route is not None:
            out["route_cents"] = self._route[0]
            out["route_reps"] = self._route[1]
        return out

    @classmethod
    def from_arrays(cls, params: VectorVamanaParams, arrays: dict, device: torch.device) -> "IndexVamana":
        """Load what either package's ``to_arrays`` (or a snapshot) holds.
        Row-bounded snapshots hold only the used rows; they are re-padded to
        the growth chain's point for the highest row."""
        rows = int(arrays["vectors"].shape[0])
        idx = cls(params, device)
        target = max(required_capacity(max(rows - 1, 0), idx.config), rows)
        dev = idx.device
        state = GraphState(
            vectors=host_tensor(arrays["vectors"], np.float32).to(dev),
            adjacency=host_tensor(arrays["adjacency"], np.int32).to(dev),
            exists=host_tensor(arrays["exists"], bool).to(dev),
        )
        idx.state = grow_graph(state, target)
        idx._max_seen = max(rows - 1, graph.START_ID)
        if "route_cents" in arrays:
            idx._route = (host_tensor(arrays["route_cents"], np.float32).to(dev),
                          host_tensor(arrays["route_reps"], np.int32).to(dev))
        if "store" in arrays:
            idx.store.load_arrays(arrays["store"])
        idx.store.ensure_rows(idx.state.capacity)
        # Loaded state matches the snapshot it came from: nothing dirty.
        idx.dirty.clear()
        return idx

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return graph.live_count(self.state)

    def exists_id(self, node_id: int) -> bool:
        if not (0 <= node_id < self.state.capacity):
            return False
        return bool(self.state.exists[node_id]) and node_id != START_ID

    def snapshot_row_bounds(self) -> dict:
        """Used-row bounds for the snapshot writer: rows past the highest id
        ever written are capacity padding."""
        b = min(self.state.capacity, int(self._max_seen) + 1)
        return {"vectors": b, "adjacency": b, "exists": b, "store/codes": b}

    def _ensure_capacity(self, max_id: int) -> None:
        self._max_seen = max(self._max_seen, int(max_id))
        if max_id >= self.state.capacity:
            self.state = grow_graph(self.state, required_capacity(max_id, self.config, self.state.capacity))
            self.store.ensure_rows(self.state.capacity)
            # Shape change: every capacity-shaped array rewrites in full
            for name in ("vectors", "adjacency", "exists", "store/codes"):
                self.dirty.all(name)

    def _mark_write(self, ids: np.ndarray) -> None:
        """Mark the rows one insert batch touched: its own rows and its
        backedge targets, the entries of its fresh adjacency rows."""
        self.dirty.rows("vectors", ids)
        self.dirty.rows("exists", ids)
        self.dirty.rows("store/codes", ids)
        rows = self.state.adjacency[torch.as_tensor(ids, device=self.device).long()].cpu().numpy()
        self.dirty.rows("adjacency", np.concatenate([ids, rows[rows != NIL]]))

    # -- writes ------------------------------------------------------------
    def insert_update_delete(self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]) -> None:
        """Apply (id, vector|None) changes (vamana.go insertUpdateDelete):
        unknown id + vector → insert; known id + vector → update (remove,
        repair, re-insert); known id + None → delete; unknown id + None →
        skip."""
        with self._write_lock:
            inserts: list = []
            updates: list = []
            deletes: list = []
            max_id = 0
            exists_np = self.state.exists.cpu().numpy()
            for node_id, vec in changes:
                if node_id in (0, START_ID):
                    raise ValueError(f"cannot modify point with reserved id: {node_id}")
                max_id = max(max_id, node_id)
                known = 0 <= node_id < exists_np.shape[0] and bool(exists_np[node_id])
                if not known and vec is None:
                    continue
                if not known:
                    inserts.append((node_id, vec))
                elif vec is not None:
                    updates.append((node_id, vec))
                else:
                    deletes.append(node_id)
            self._ensure_capacity(max_id)
            if inserts:
                with build._logger().timed("vamana insert batch", count=len(inserts)):
                    self._insert_chunked(inserts)
            # Updates re-insert with fresh neighbourhoods: delete + insert
            if updates or deletes:
                repair_ids = np.array([i for i, _ in updates] + deletes, dtype=np.int32)
                with build._logger().timed("vamana delete repair", count=len(repair_ids)):
                    delete_batch(self.state, repair_ids, self.config)
                # The repair re-prunes rows anywhere, the rescue the start row
                self.dirty.all("adjacency")
                self.dirty.rows("exists", repair_ids)
            if updates:
                self._insert_chunked(updates)
            # The quantizer's fit trigger at the end of the write
            # (vamana.go:255-276: vecStore.Fit() before the flush)
            self._maybe_fit()
            self._entry_seeds = self._entry_seeds_dev = None  # recomputed after any write

    def _maybe_fit(self) -> bool:
        """Fit the quantizer once the live count reaches its trigger; the fit
        encodes every row, so the whole store is dirty."""
        if not self.store.maybe_fit(self.state.vectors, self.state.exists):
            return False
        for name in ("store/codes", "store/aux", "store/rot"):
            self.dirty.all(name)
        return True

    def _encode_after_build(self, ids: np.ndarray) -> None:
        """The end of a bulk build: the fit trigger, or where the store was
        fitted already the batch's rows encoded."""
        if not self._maybe_fit() and self.store.fitted:
            self.store.encode_rows(self.state.vectors, ids)

    def _insert_chunked(self, items: Sequence[Tuple[int, np.ndarray]]) -> None:
        """Insert in growing rounds, each no larger than the graph (doubling,
        capped at INSERT_CHUNK)."""
        i = 0
        live = max(len(self), 32)
        while i < len(items):
            step = min(INSERT_CHUNK, max(32, live))
            chunk = items[i : i + step]
            i += step
            live += len(chunk)
            ids = np.array([c[0] for c in chunk], dtype=np.int32)
            vecs = np.stack([np.asarray(c[1], dtype=np.float32) for c in chunk])
            insert_batch(self.state, ids, vecs, self.config, self.params.search_size)
            if self.dirty.active:
                self._mark_write(ids)
            # Rows written after the fit are encoded (binary.go/product.go Set)
            if self.store.fitted:
                self.store.encode_rows(self.state.vectors, ids)

    def insert_bulk(self, ids, vecs, defer_fit: bool = False, build_mode: str | None = None) -> None:
        """Array bulk build. ``build_mode`` (default SEMADB_VAMANA_BUILD)
        "search": the two-pass alpha schedule, pass 1 inserting in doubling
        rounds at alpha = 1.0, pass 2 re-inserting every point in batches of
        PASS2_CHUNK against the complete graph at the configured alpha with
        the node's current out-edges in its pool; "pool": the per-cluster kNN
        pool build (``fastbuild.bulk_build_pools``) where the graph is empty,
        the batch holds at least TWO_PASS_MIN points and the metric has a
        dense product (euclidean, cosine, dot), else the two passes. The
        quantizer's fit trigger runs at the end (or, fitted already, the rows
        are encoded). ``defer_fit`` is taken for IndexIVF's signature and
        ignored. A batch with existing or repeated ids goes through
        :meth:`insert_update_delete`. The seconds of each pass (or stage) and
        of the fit land in ``build_seconds``."""
        ids_np = np.asarray(ids, np.int64)
        n = len(ids_np)
        if n == 0:
            return
        if (ids_np <= 1).any():
            raise ValueError("cannot modify point with reserved id")
        with self._write_lock:
            exists_np = self.state.exists.cpu().numpy()
            in_cap = ids_np[ids_np < exists_np.shape[0]]
            if len(np.unique(ids_np)) != n or exists_np[in_cap].any():
                host = vecs.cpu().numpy() if isinstance(vecs, torch.Tensor) else np.asarray(vecs)
                self.insert_update_delete(zip(ids_np.tolist(), host))
                return
            pool_mode = (
                (build_mode or BUILD_MODE) == "pool" and len(self) == 0 and n >= TWO_PASS_MIN
                and self.config.metric in (C.DISTANCE_EUCLIDEAN, C.DISTANCE_COSINE, C.DISTANCE_DOT)
            )
            self._ensure_capacity(int(ids_np.max()))
            # A bulk build's searches roam the whole graph: the next snapshot is full
            self.dirty.everything()
            ids32 = ids_np.astype(np.int32)
            l2 = PASS2_L or self.params.search_size
            if pool_mode:
                from semadb_tpu_torch.index.vamana import fastbuild

                # The corpus goes in without a name here, so that the lean
                # flow can drop the only reference once the graph holds it
                self.build_seconds = fastbuild.bulk_build_pools(
                    self, ids32, torch.as_tensor(vecs).to(self.device, torch.float32), l2)
            else:
                self.build_seconds = self._two_pass(ids32, torch.as_tensor(vecs).to(self.device, torch.float32),
                                                    l2)
            t0 = time.perf_counter()
            self._encode_after_build(ids32)
            self.sync()
            self.build_seconds["fit_s"] = time.perf_counter() - t0
            self._entry_seeds = self._entry_seeds_dev = None

    def _two_pass(self, ids32: np.ndarray, vec_t: torch.Tensor, l2: int) -> dict:
        """The two-pass schedule of :meth:`insert_bulk`; returns its seconds."""
        n = len(ids32)
        two_pass = TWO_PASS and n >= TWO_PASS_MIN
        a1 = 1.0 if two_pass else None
        l1 = (PASS1_L if two_pass else 0) or self.params.search_size
        timers0 = dict(build.BUILD_TIMERS)
        t0 = time.perf_counter()
        live = max(len(self), 32)
        i = 0
        while i < n:
            step = min(INSERT_CHUNK, max(32, live))
            insert_batch(self.state, ids32[i : i + step], vec_t[i : i + step], self.config, l1, alpha=a1)
            live += step
            i += step
        self.sync()
        t1 = time.perf_counter()
        timers1 = dict(build.BUILD_TIMERS)
        if two_pass:
            for i in range(0, n, PASS2_CHUNK):
                insert_batch(self.state, ids32[i : i + PASS2_CHUNK], vec_t[i : i + PASS2_CHUNK], self.config,
                             l2, keep_current=True)
            self.sync()
        t2 = time.perf_counter()
        timers2 = dict(build.BUILD_TIMERS)
        return {
            "pass1_s": t1 - t0, "pass2_s": t2 - t1,
            "pass1_batches": timers1["batches"] - timers0["batches"],
            "pass2_batches": timers2["batches"] - timers1["batches"],
            "pass1_overflow_rounds": timers1["overflow_rounds"] - timers0["overflow_rounds"],
            "pass2_overflow_rounds": timers2["overflow_rounds"] - timers1["overflow_rounds"],
            "pass1_overflow_s": timers1["overflow_s"] - timers0["overflow_s"],
            "pass2_overflow_s": timers2["overflow_s"] - timers1["overflow_s"],
        }

    def flush_pending(self) -> None:
        """Interface parity with IndexIVF's deferred refit — no-op here."""

    def sync(self) -> None:
        """Wait for every queued device write of this index."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def refine(self, passes: int = 1, batch: int = PASS2_CHUNK, search_size: int = 0,
               seed_own: bool = False) -> None:
        """Re-run the insert procedure for every live node on the current
        graph, each node's current out-edges kept in its pool (DiskANN's
        second-pass rule; :meth:`insert_bulk` runs it as pass 2)."""
        with self._write_lock:
            ids = torch.nonzero(self.state.exists).flatten()
            ids = ids[ids != START_ID]
            if not len(ids):
                return
            self.dirty.all("adjacency")  # re-prunes every live row + backedges
            vecs = self.state.vectors[ids].clone()
            ids = ids.to(torch.int32)
            for _ in range(passes):
                for i in range(0, len(ids), batch):
                    insert_batch(self.state, ids[i : i + batch], vecs[i : i + batch], self.config,
                                 search_size or self.params.search_size, keep_current=True, seed_own=seed_own)
            self._entry_seeds = self._entry_seeds_dev = None

    # -- reads -------------------------------------------------------------
    def _quant_args(self, q: torch.Tensor) -> dict:
        """The quantized walk's arguments once the store is fitted: its
        config, the code table (the graph's capacity rows) and the prepared
        queries (vectorstore dispatch, vectorstore.go:23-43); else none."""
        if not self.store.fitted or self.store.config.kind == "plain":
            return {}
        return {"quant": self.store.config, "qcodes": self.store.state.codes,
                "qquery": self.store.prepare_queries(q)}

    def search_batch_async(self, queries, k: int, search_size: int = 0):
        """Enqueue a search without waiting: device tensors (dists f32[B, k],
        ids i32[B, k]). ``queries`` is a numpy array or a tensor."""
        search_size = max(search_size or self.params.search_size, k)
        return self._search_async(upload_queries(queries, self.device), k, search_size)

    def _search_async(self, q: torch.Tensor, k: int, search_size: int):
        with self._write_lock:
            return search_mod.search(self.state, q, self.config, search_size, k, seed_ids=self._seeds_for(q),
                                     **self._quant_args(q))

    def query_walk(self, queries, search_size: int) -> search_mod.BeamResult:
        """The walk that :meth:`search_batch_async` runs (W = 2, its seeds,
        its route, the ring where it reranks), with its hops and counts, for
        the bench's hops per query."""
        q = upload_queries(queries, self.device)
        with self._write_lock:
            qa = self._quant_args(q)
            track = bool(qa) and not qa["quant"].user_bit_metric
            return search_mod.beam_search(self.state, q, self.config, search_size, seed_ids=self._seeds_for(q),
                                          expand_width=2, track_visited=track, **qa)

    def _seeds_for(self, q: torch.Tensor) -> Optional[torch.Tensor]:
        """The walk's entry seeds: routed by the query where the graph has
        routing, else the spread of live nodes for every query."""
        seed_arr = self._routed_seed_arr(q)
        if seed_arr is None:
            if self._entry_seeds_dev is None and self._get_entry_seeds() is not None:
                self._entry_seeds_dev = torch.as_tensor(self._entry_seeds, device=self.device)
            seeds = self._entry_seeds_dev
            if seeds is not None:
                seed_arr = seeds[None, :].expand(q.shape[0], len(seeds)).contiguous()
        return seed_arr

    def search_batch(self, queries, k: int, search_size: int = 0,
                     filter_mask: Optional[np.ndarray] = None) -> tuple[np.ndarray, np.ndarray]:
        """Top-k ids and distances for a batch of queries: (dists f32[B, k],
        ids i32[B, k]); empty places are (inf, -1)."""
        search_size = max(search_size or self.params.search_size, k)
        q = upload_queries(queries, self.device)
        if filter_mask is None:
            d, i = self._search_async(q, k, search_size)
        else:
            with self._write_lock:
                cap = self.state.capacity
                fm = np.zeros(cap, bool)
                given = np.asarray(filter_mask, bool)[:cap]
                fm[: given.shape[0]] = given
                d, i = search_filtered(self.state, q, torch.from_numpy(fm).to(self.device), self.config,
                                       search_size, k, **self._quant_args(q))
        return d.cpu().numpy(), i.cpu().numpy()

    def set_query_routing(self, cents, reps) -> None:
        """Install query-routed entry: ``cents`` f32[C, D] cluster centroids
        and ``reps`` i32[C] (or [C, m]) live node ids. Stale representatives
        are masked by the exists bits at query time."""
        self._route = (torch.as_tensor(np.asarray(cents, np.float32)).to(self.device),
                       torch.as_tensor(np.asarray(reps, np.int32)).to(self.device))
        self.dirty.all("route_cents")
        self.dirty.all("route_reps")

    def _routed_seed_arr(self, q) -> Optional[torch.Tensor]:
        if self._route is None:
            return None
        cents, reps = self._route
        return _route_seeds(cents, reps, self.state.exists, q, self.config.metric, self.N_ROUTE_SEEDS)

    def _get_entry_seeds(self) -> Optional[np.ndarray]:
        if self._entry_seeds is None:
            live = np.nonzero(self.state.exists.cpu().numpy())[0]
            live = live[live != START_ID]
            if len(live) == 0:
                return None
            sel = live[np.linspace(0, len(live) - 1, min(self.N_ENTRY_SEEDS, len(live))).astype(int)]
            self._entry_seeds = sel.astype(np.int32)
        return self._entry_seeds
