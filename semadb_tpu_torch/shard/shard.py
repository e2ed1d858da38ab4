"""Shard: the per-shard storage + index engine.

Port of ``semadb_tpu/shard/shard.py`` over the port's engines
(``vectorFlat``, ``vectorIVF``, ``vectorFused`` and ``vectorVamana`` on an
explicit torch device, and the text and inverted indices on the host); the journal and
snapshot formats are the JAX package's, so its shard files open here.

Parity reference: shard/shard.go — CRUD over points inside one store
transaction with index dispatch, update-merge semantics with the
``"_delete"`` tombstone value (shard.go:41, 276-281), node-id recycling,
point-count bookkeeping, and search post-processing (select with nested
re-expansion, multi-key sort, offset+limit; shard.go:384-471).

Device-index state (index tensors on the device) persists across
transactions in a registry (the reference's shared cache manager analog).
Durability matches bbolt's per-txn guarantee through a delta journal: every
write txn logs the (node_id, vector) changes it applied to each device
index into that index's bucket (same store txn, so atomic with the point
data); reopening replays journal entries on top of the last full snapshot,
and ``flush`` (periodic + close/backup) writes a fresh snapshot and clears
the journal. A failed write txn rolls back the store (overlay discard) and
scraps + reloads the device indices (cache/manager.go:207-235 semantics).
"""

from __future__ import annotations

import os
import uuid as uuid_mod
from typing import Dict, List, Optional, Set

import msgpack
import numpy as np
import torch

from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.index.fused import FusedHybridIVF
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.index.vamana import IndexVamana
from semadb_tpu_torch.index.manager import (
    VECTOR_INDEX_TYPES,
    IndexManager,
    IndexPointChange,
    check_supported,
)
from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.collection import Collection
from semadb_tpu_torch.models.errors import ExistsError, NotFoundError, ValidationError
from semadb_tpu_torch.models.point import Point, SearchResult, decode_point_data
from semadb_tpu_torch.models.query import SearchRequest
from semadb_tpu_torch.shard import pointstore
from semadb_tpu_torch.shard import snapshot as snap
from semadb_tpu_torch.shard.idcounter import IdCounter
from semadb_tpu_torch.shard.registry import DeviceRegistry, HBMBudget
from semadb_tpu_torch.store.diskstore import DiskStore
from semadb_tpu_torch.utils.compare import sort_search_results
from semadb_tpu_torch.utils.logging import get_logger

LOG = get_logger("shard")

INTERNAL_BUCKET_NAME = "internal"
POINT_COUNT_KEY = b"pointCount"
DELETE_VALUE = C.DELETE_VALUE
DELTA_PREFIX = b"_dlog/"  # journal records: _dlog/<8B big-endian seq>
DELTA_SEQ_KEY = b"_dlogN"
# Snapshot cadence. The per-txn DELTA JOURNAL is the durability story —
# O(delta) bytes per write txn, bbolt's per-txn contract
# (diskstore/diskstore.go:45-95) — and `flush()` is COMPACTION: a
# consistent full cut of the device state that lets the journal truncate.
# It runs off the hot path by default, at close/unload/backup (the
# reference's backup-on-unload lifecycle, shardmgr.go:134-138), with two
# opt-in hot-path triggers for bounded-journal deployments:
#   SEMADB_FLUSH_EVERY_TXNS  — flush after N journaled txns (0 = never)
#   SEMADB_FLUSH_JOURNAL_MB  — flush when retained journal bytes exceed
#                              this (0 = never)
# Crash recovery never depends on the cadence: load = last consistent
# snapshot + ordered journal replay (see _read_index_from).
FLUSH_EVERY_TXNS = int(os.environ.get("SEMADB_FLUSH_EVERY_TXNS", 0))
FLUSH_JOURNAL_MB = float(os.environ.get("SEMADB_FLUSH_JOURNAL_MB", 0))


class Shard:
    def __init__(
        self,
        db: DiskStore,
        collection: Collection,
        device: torch.device,
        hbm_budget: Optional["HBMBudget"] = None,
    ):
        check_supported(collection.index_schema)
        self.db = db
        self.collection = collection
        self.device = torch.device(device)
        # bucket name → device index object; survives transactions. The
        # registry LRU-evicts past the shared device-memory budget (cache
        # manager maxCacheSize parity) and lazily reloads snapshot+journal
        # on miss.
        self.device_indices = DeviceRegistry(
            loader=self._load_one_index, budget=hbm_budget
        )
        self._delta_txns = 0
        # Retained journal size; _load_device_indices seeds it from the
        # records already on disk so the SEMADB_FLUSH_JOURNAL_MB trigger
        # counts a journal carried across reopens, not just this process's
        # writes.
        self._journal_bytes = 0
        # Monotonic write counter, seeded per open with random bits: the
        # mesh-serving cache (cluster/meshsearch.py) compares versions by
        # equality, so a counter restarting at 0 after an unload and reopen
        # could match a stack built against the previous Shard instance
        # after the same number of writes.
        self.write_version = int.from_bytes(os.urandom(7), "big") << 24
        # node-id → uuid-string cache for the id-only serving path;
        # delete_points invalidates freed ids (see UuidStrCache docstring).
        self._uuid_strs = pointstore.UuidStrCache()
        # bucket name → PostingsCache | TextCaches: decoded postings of the
        # host indices surviving txns (cache/manager.go:116-303); scrapped
        # on txn failure.
        self._host_caches: Dict[str, object] = {}
        self._load_device_indices()

    def _index_manager(self, bm) -> IndexManager:
        return IndexManager(
            bm, self.collection.index_schema, self.device_indices, self.device, self._host_caches
        )

    # -- device index persistence -----------------------------------------
    def _read_index_from(self, bm, name: str, params):
        """Reconstruct one device index: last snapshot + journal replay (in
        key order — big-endian seq, so iteration order IS commit order).
        Returns (index|None, journal_record_count, journal_bytes)."""
        bucket = bm.get(name)
        # Chunked incremental snapshot first; fall back to the legacy
        # single-blob `_deviceState` for old shard files.
        arrays = snap.read_snapshot(bucket)
        if arrays is None:
            raw = bucket.get(snap.LEGACY_STATE_KEY)
            if raw is not None:
                arrays = _unpack_arrays(raw)
        deltas = list(bucket.prefix_scan(DELTA_PREFIX))
        delta_bytes = sum(len(rec) for _, rec in deltas)
        if arrays is None and not deltas:
            return None, 0, 0
        if params.type == C.INDEX_TYPE_VECTOR_IVF:
            idx = (
                IndexIVF(params.vector_ivf, self.device) if arrays is None
                else IndexIVF.from_arrays(params.vector_ivf, arrays, self.device)
            )
        elif params.type == C.INDEX_TYPE_VECTOR_FUSED:
            idx = (
                FusedHybridIVF.from_params(params.vector_fused, self.device) if arrays is None
                else FusedHybridIVF.from_arrays(arrays, params.vector_fused, self.device)
            )
        elif params.type == C.INDEX_TYPE_VECTOR_VAMANA:
            idx = (
                IndexVamana(params.vector_vamana, self.device) if arrays is None
                else IndexVamana.from_arrays(params.vector_vamana, arrays, self.device)
            )
        elif arrays is None:
            idx = IndexFlat(params.vector_flat, self.device)
        else:
            idx = IndexFlat.from_arrays(params.vector_flat, arrays, self.device)
        # Coalesced replay: consecutive journal records go to the engine as
        # one call. Within one call ids must be DISTINCT (two ops for the
        # same id in one batch have no defined order), so a repeated id
        # cuts the group — replay order across groups is preserved exactly.
        group: list = []
        group_ids: set = set()
        for _, rec in deltas:
            for item in _unpack_delta(rec):
                if item[0] in group_ids:
                    idx.insert_update_delete(group)
                    group, group_ids = [], set()
                group.append(item)
                group_ids.add(item[0])
        if group:
            idx.insert_update_delete(group)
        return idx, len(deltas), delta_bytes

    def _params_for_bucket(self, name: str):
        for prop, params in self.collection.index_schema.items():
            if IndexManager.bucket_name(params.type, prop) == name:
                return params
        return None

    def _load_one_index(self, name: str):
        """Registry miss handler: reload a (possibly evicted) index."""
        params = self._params_for_bucket(name)
        if params is None or params.type not in VECTOR_INDEX_TYPES:
            return None
        out = [None]

        def reader(bm):
            out[0], _, _ = self._read_index_from(bm, name, params)

        self.db.read(reader)
        return out[0]

    def _load_device_indices(self) -> None:
        def reader(bm):
            self._delta_txns = 0
            self._journal_bytes = 0
            for prop, params in self.collection.index_schema.items():
                if params.type not in VECTOR_INDEX_TYPES:
                    continue
                name = IndexManager.bucket_name(params.type, prop)
                idx, n_deltas, n_bytes = self._read_index_from(bm, name, params)
                if idx is None:
                    continue
                self._delta_txns = max(self._delta_txns, n_deltas)
                self._journal_bytes += n_bytes
                self.device_indices[name] = idx

        self.db.read(reader)

    def _log_device_deltas(self, bm, deltas: Dict[str, list]) -> None:
        """Journal device-index changes inside the current store txn."""
        logged = False
        for name, items in deltas.items():
            if not items:
                continue
            bucket = bm.get(name)
            raw = bucket.get(DELTA_SEQ_KEY)
            seq = int.from_bytes(raw, "big") if raw else 0
            rec = _pack_delta(items)
            bucket.put(DELTA_PREFIX + seq.to_bytes(8, "big"), rec)
            bucket.put(DELTA_SEQ_KEY, (seq + 1).to_bytes(8, "big"))
            self._journal_bytes += len(rec)
            logged = True
        if logged:
            self._delta_txns += 1

    def _write_with_scrap(self, writer) -> None:
        """Run a write txn; on failure scrap device indices (which may hold
        partial mutations from a failed dispatch) and rebuild them from the
        last committed snapshot + journal."""
        try:
            self.db.write(writer)
        except BaseException:
            self.device_indices.clear()
            self._load_device_indices()
            # The host postings caches may hold the rolled-back mutations
            for c in self._host_caches.values():
                c.scrap()
            self.write_version += 1
            raise
        self.write_version += 1
        if (FLUSH_EVERY_TXNS and self._delta_txns >= FLUSH_EVERY_TXNS) or (
            FLUSH_JOURNAL_MB and self._journal_bytes >= FLUSH_JOURNAL_MB * 2**20
        ):
            self.flush()

    def flush(self) -> int:
        """COMPACTION: snapshot device-index state into the store as one
        consistent cut and clear the journal. Per-txn durability does NOT
        depend on this method: every write txn journals its deltas and
        recovery replays them over the last cut."""
        chunks_written = [0]

        def writer(bm):
            for name, idx in self.device_indices.items():
                bucket = bm.get(name)
                chunks_written[0] += snap.write_snapshot(bucket, idx)
                for k, _ in list(bucket.prefix_scan(DELTA_PREFIX)):
                    bucket.delete(k)
                bucket.delete(DELTA_SEQ_KEY)

        try:
            self.db.write(writer)
        except BaseException:
            # The overlay rollback discarded our puts but write_snapshot
            # already drained the dirty trackers: re-mark so the next flush
            # rewrites everything rather than losing the drained rows.
            for idx in self.device_indices.values():
                tracker = getattr(idx, "dirty", None)
                if tracker is not None:
                    tracker.everything()
            raise
        self._delta_txns = 0
        self._journal_bytes = 0
        LOG.debug("flush", chunks=chunks_written[0])
        return chunks_written[0]

    # -- info --------------------------------------------------------------
    def point_count(self) -> int:
        out = [0]

        def reader(bm):
            b = bm.get(INTERNAL_BUCKET_NAME)
            raw = b.get(POINT_COUNT_KEY)
            out[0] = int.from_bytes(raw, "little") if raw else 0

        self.db.read(reader)
        return out[0]

    def _change_point_count(self, bm, delta: int) -> None:
        b = bm.get(INTERNAL_BUCKET_NAME)
        raw = b.get(POINT_COUNT_KEY)
        count = int.from_bytes(raw, "little") if raw else 0
        b.put(POINT_COUNT_KEY, max(count + delta, 0).to_bytes(8, "little"))

    # -- CRUD --------------------------------------------------------------
    def insert_points(self, points: List[Point]) -> None:
        """shard.go InsertPoints: duplicate request ids are an error; points
        that already exist are an error (must use update)."""
        seen: Set[uuid_mod.UUID] = set()
        for p in points:
            if p.id in seen:
                raise ValidationError(f"duplicate point id: {p.id}")
            seen.add(p.id)

        def writer(bm):
            b_points = bm.get(pointstore.POINTS_BUCKET_NAME)
            b_internal = bm.get(INTERNAL_BUCKET_NAME)
            counter = IdCounter(b_internal)
            changes = []
            for p in points:
                if pointstore.check_point_exists(b_points, p.id):
                    raise ExistsError(f"point already exists: {p.id}")
                node_id = counter.next_id()
                pointstore.set_point(b_points, pointstore.ShardPoint(p, node_id))
                changes.append(IndexPointChange(node_id, None, p.data))
            im = self._index_manager(bm)
            self._log_device_deltas(bm, im.dispatch(changes))
            self._change_point_count(bm, len(points))
            counter.flush()

        # Stage-duration parity: shard.go:218 logs write txn duration.
        with LOG.timed("insert points", count=len(points)):
            self._write_with_scrap(writer)

    def update_points(self, points: List[Point]) -> List[uuid_mod.UUID]:
        """shard.go UpdatePoints: merge incoming map into the existing data,
        ``"_delete"`` values remove keys, missing points skipped, node id
        kept."""
        updated: List[uuid_mod.UUID] = []

        def writer(bm):
            b_points = bm.get(pointstore.POINTS_BUCKET_NAME)
            changes = []
            for p in points:
                if not pointstore.check_point_exists(b_points, p.id):
                    continue
                sp = pointstore.get_point_by_uuid(b_points, p.id)
                existing = decode_point_data(sp.point.data)
                incoming = decode_point_data(p.data)
                for k, v in incoming.items():
                    if isinstance(v, str) and v == DELETE_VALUE:
                        existing.pop(k, None)
                    else:
                        existing[k] = v
                final = msgpack.packb(existing, use_bin_type=True)
                if len(final) > self.collection.user_plan.max_point_size:
                    raise ValidationError(
                        f"point size exceeds limit: {self.collection.user_plan.max_point_size}"
                    )
                new_point = Point(id=p.id, data=final)
                pointstore.set_point(
                    b_points, pointstore.ShardPoint(new_point, sp.node_id)
                )
                changes.append(IndexPointChange(sp.node_id, sp.point.data, final))
                updated.append(p.id)
            im = self._index_manager(bm)
            self._log_device_deltas(bm, im.dispatch(changes))

        with LOG.timed("update points", count=len(points)):
            self._write_with_scrap(writer)
        return updated

    def delete_points(self, delete_set: Set[uuid_mod.UUID]) -> List[uuid_mod.UUID]:
        """shard.go DeletePoints: free node ids, remove from pointstore,
        dispatch with PreviousData only; missing ids silently skipped."""
        deleted: List[uuid_mod.UUID] = []
        freed_ids: List[int] = []

        def writer(bm):
            b_points = bm.get(pointstore.POINTS_BUCKET_NAME)
            b_internal = bm.get(INTERNAL_BUCKET_NAME)
            counter = IdCounter(b_internal)
            changes = []
            for pid in delete_set:
                if not pointstore.check_point_exists(b_points, pid):
                    continue
                sp = pointstore.get_point_by_uuid(b_points, pid)
                pointstore.delete_point(b_points, sp)
                counter.free_id(sp.node_id)
                freed_ids.append(sp.node_id)
                changes.append(IndexPointChange(sp.node_id, sp.point.data, None))
                deleted.append(pid)
            im = self._index_manager(bm)
            self._log_device_deltas(bm, im.dispatch(changes))
            self._change_point_count(bm, -len(deleted))
            counter.flush()

        with LOG.timed("delete points", count=len(delete_set)):
            try:
                self._write_with_scrap(writer)
            finally:
                # Freed ids may be reused by later inserts under new
                # UUIDs; dropping on failure too is conservative-safe.
                self._uuid_strs.invalidate(freed_ids)
        return deleted

    # -- search ------------------------------------------------------------
    def filter_node_ids(self, filter_query) -> set:
        """Evaluate a filter sub-query to this shard's admissible node-id
        set in ONE read txn: the host half of the mesh filtered search
        (cluster/meshsearch.py), whose masks go to the slots
        (index/search.go:58-65 computes the same bitmap before the walk)."""
        out = [set()]

        def reader(bm):
            s, _ = self._index_manager(bm).search(filter_query)
            out[0] = s

        self.db.read(reader)
        return out[0]

    def resolve_node_ids(self, node_ids: List[int], with_data: bool = True) -> Dict[int, Point]:
        """Map shard-local node ids to points in ONE read txn (the mesh
        fan-out's UUID backfill). Unknown ids are skipped: a concurrent
        writer can surface a node id whose point record has not committed
        yet (see search_points_batch's tolerant resolution)."""
        out: Dict[int, Point] = {}

        def reader(bm):
            b_points = bm.get(pointstore.POINTS_BUCKET_NAME)
            for nid in node_ids:
                try:
                    sp = pointstore.get_point_by_node_id(b_points, nid, with_data)
                except NotFoundError:
                    continue
                out[nid] = sp.point

        self.db.read(reader)
        return out

    def search_points(self, request: SearchRequest) -> List[SearchResult]:
        return self.search_points_batch([request])[0]

    def search_points_batch(
        self, requests: List[SearchRequest]
    ) -> List[List[SearchResult]]:
        """Execute many search requests in ONE read transaction, letting
        the index manager collapse a homogeneous vector batch into a
        single [B, D] device dispatch (IndexManager.search_batch). The
        per-request post-processing (backfill, select, sort, paging) is
        identical to the single-request path — search_points IS the
        batch of one. Beyond-reference: the reference handles one query
        per request end to end (shard.go:323-380)."""
        batched: List[List[SearchResult]] = [[] for _ in requests]

        def reader(bm):
            b_points = bm.get(pointstore.POINTS_BUCKET_NAME)
            im = self._index_manager(bm)
            pairs = im.search_batch([r.query for r in requests])
            # Reference parity (shard.go:352): point DATA is fetched only
            # when the request selects fields (we also fetch it for sort,
            # which needs data values — a conservative superset). Requests
            # without select get _id/_distance/_score only, which is also
            # what makes the id-only ANN serving shape cheap.
            wd = [bool(req.select) or bool(req.sort) for req in requests]
            # Flatten (request, ranked-result|None, node id) preserving
            # per-request order: ranked results first, then anything left
            # in the result set appended unranked (shard.go:350-371).
            flat: List[tuple] = []
            for oi, (rset, results) in enumerate(pairs):
                covered = set()
                for r in results:
                    flat.append((oi, r, r.node_id))
                    covered.add(r.node_id)
                for nid in sorted(rset - covered):
                    flat.append((oi, None, nid))
            # Batched backfill: one multi_get for all id records (+ one
            # for data) instead of 2 bucket gets per result.
            id_raws = b_points.multi_get(
                [pointstore.node_key(nid, b"i") for (_, _, nid) in flat]
            )
            data_keys = [
                pointstore.node_key(nid, b"d")
                for (oi, _, nid) in flat
                if wd[oi]
            ]
            data_raws = iter(b_points.multi_get(data_keys))
            # Tolerant resolution: the device index is shared and mutated
            # in place by write transactions, so a search can
            # surface a node id whose point record hasn't committed to
            # the store yet (the reference can't hit this — its index and
            # pointstore share one bbolt snapshot). Such ids are dropped
            # from this result set; they become visible the moment the
            # writer commits. Deletes are the mirror case (index entry
            # gone first) and already invisible to search.
            for (oi, r, nid), raw in zip(flat, id_raws):
                data = (next(data_raws) or b"") if wd[oi] else b""
                if raw is None:
                    continue
                point = Point(id=pointstore._uuid_from_bytes(raw), data=data)
                if r is not None:
                    r.point = point
                    batched[oi].append(r)
                else:
                    batched[oi].append(SearchResult(point=point, node_id=nid))

        # shard.go:460 logs search duration
        with LOG.timed("search points", n=len(requests)):
            self.db.read(reader)
        return [
            postprocess_results(req, res) for req, res in zip(requests, batched)
        ]

    def search_points_batch_wire(self, requests: List[SearchRequest]) -> List[list]:
        """Id-only ANN serving fast path: wire documents straight from
        the device result arrays — no SearchResult/Point/UUID objects.

        Qualifying shape: every request has no select, no sort and offset
        0 (the common ANN serving request), and the whole batch is a
        homogeneous vector query (IndexManager.search_batch_arrays). The
        per-result work is then one bulk multi_get for the uuid records,
        one hex-slice per id and one small dict. Output documents are
        bit-identical to
        the object path's (models.point.result_doc shape, which is the
        reference's handlers.go:461-487 response contract).

        Non-qualifying batches fall back to :meth:`search_points_batch`
        + result_doc — same documents, object-path cost."""
        fast = all(
            not r.select and not r.sort and not r.offset for r in requests
        )
        out_docs: Optional[List[list]] = None
        if fast:

            def reader(bm):
                nonlocal out_docs
                im = self._index_manager(bm)
                arrs = im.search_batch_arrays([r.query for r in requests])
                if arrs is None:
                    return
                d, i, v, w = arrs
                b_points = bm.get(pointstore.POINTS_BUCKET_NAME)
                d_list = d.tolist()
                h_list = (d * -w).tolist()  # hybrid scores, one vec op
                i_list = i.tolist()
                v_list = v.tolist()
                flat_ids: List[int] = []
                for ib, vb in zip(i_list, v_list):
                    flat_ids.extend(nid for nid, ok in zip(ib, vb) if ok)
                id_strs = iter(self._uuid_strs.lookup(b_points, flat_ids))
                docs: List[list] = []
                for db, hb, vb, req in zip(d_list, h_list, v_list, requests):
                    row = []
                    for dist, hs, ok in zip(db, hb, vb):
                        if not ok:
                            continue
                        s = next(id_strs)
                        if s is None:
                            # Tolerant resolution: id from a concurrent
                            # uncommitted write txn (see the object path)
                            continue
                        row.append(
                            {"_id": s, "_distance": dist, "_hybridScore": hs}
                        )
                    docs.append(row[: req.limit or None])
                out_docs = docs

            with LOG.timed("search points wire", n=len(requests)):
                self.db.read(reader)
            if out_docs is not None:
                return out_docs
        from semadb_tpu_torch.models.point import result_doc

        return [
            [result_doc(r) for r in row]
            for row in self.search_points_batch(requests)
        ]

    # -- lifecycle ---------------------------------------------------------
    def backup(self, dest_path: str) -> None:
        self.flush()
        self.db.backup_to_file(dest_path)

    def close(self) -> None:
        self.flush()
        self.db.close()


def postprocess_results(
    request: SearchRequest, final_results: List[SearchResult]
) -> List[SearchResult]:
    """Select / sort / offset / limit post-processing (shard.go:384-471)."""
    # Select / sort (shard.go:384-460)
    select = request.select
    if (select and select[0] != "*") or request.sort:
        for r in final_results:
            r.decoded_data = {}
            if r.point is None or not r.point.data:
                continue
            full = r.point.as_map()
            for p in select:
                if p == "*":
                    r.decoded_data = full
                    break
                # nested re-expansion: "a.b" → {"a": {"b": value}}
                segments = p.split(".")
                src = full
                ok = True
                for s in segments:
                    if not isinstance(src, dict) or s not in src:
                        ok = False
                        break
                    src = src[s]
                if not ok:
                    continue
                cur = r.decoded_data
                for s in segments[:-1]:
                    cur = cur.setdefault(s, {})
                cur[segments[-1]] = src
            if request.sort and not select:
                # sorting may reference properties outside the selection
                r.decoded_data = full
            r.point = Point(id=r.point.id, data=b"")
        if request.sort:
            sort_search_results(final_results, request.sort)
    # Offset + limit (shard.go:463-468)
    limit = request.limit or len(final_results)
    lo = min(request.offset, len(final_results))
    hi = min(request.offset + limit, len(final_results))
    return final_results[lo:hi]


def _pack_delta(items: list) -> bytes:
    """Pack a [(node_id, vector|None), ...] change list for the journal."""
    ids = np.array([nid for nid, _ in items], np.int64)
    dels = np.array([v is None for _, v in items], bool)
    ups = [v for _, v in items if v is not None]
    vecs = np.stack(ups) if ups else np.zeros((0, 0), np.float32)
    return _pack_arrays({"ids": ids, "del": dels, "vecs": vecs})


def _unpack_delta(raw: bytes) -> list:
    d = _unpack_arrays(raw)
    out = []
    vi = 0
    for nid, isdel in zip(d["ids"], d["del"]):
        if isdel:
            out.append((int(nid), None))
        else:
            out.append((int(nid), d["vecs"][vi]))
            vi += 1
    return out


def _pack_arrays(arrays: dict) -> bytes:
    """Serialise a dict of numpy arrays (+ scalars/nested) to msgpack."""

    def enc(v):
        if isinstance(v, np.ndarray):
            return {
                b"__nd": True,
                b"dtype": str(v.dtype),
                b"shape": list(v.shape),
                b"data": v.tobytes(),
            }
        if isinstance(v, dict):
            return {k: enc(x) for k, x in v.items()}
        return v

    return msgpack.packb(enc(arrays), use_bin_type=True)


def _unpack_arrays(raw: bytes) -> dict:
    def dec(v):
        if isinstance(v, dict):
            if v.get(b"__nd") or v.get("__nd"):
                dtype = v.get(b"dtype", v.get("dtype"))
                shape = v.get(b"shape", v.get("shape"))
                data = v.get(b"data", v.get("data"))
                return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()
            return {k: dec(x) for k, x in v.items()}
        return v

    return dec(msgpack.unpackb(raw, raw=False, strict_map_key=False))
