"""Cluster node: identity, nodedb, RPC handlers, and public actions.

Port of ``semadb_tpu/cluster/node.py``. The node's shards put their
indices on its ``device``. A node given a shard ``mesh`` (or on a host with
two cards or more, every card) spreads a ``shardPlacement: "device"``
collection over one shard a mesh slot and serves its eligible vector queries
through the mesh searcher (cluster/meshsearch.py); every other query takes
the host fan-out over shards. Unlike the JAX node, a mesh searcher that
fails to build raises: only the fleet refusals and the eligibility rules
send a query to the host fan-out.

Parity reference: cluster/clusternode.go (node identity, nodedb, serve,
backup ticker, close), cluster/rpchandlers.go (12 self-routing handlers)
and cluster/actions.go (public collection/point actions with rendezvous
routing, parallel shard fan-out, Poisson limit shrink, offset division,
result merge/sort/truncate, failed-point curation).
"""

from __future__ import annotations

import os
import threading
import uuid as uuid_mod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import msgpack
import numpy as np
import torch

from semadb_tpu_torch.cluster.hashing import rendezvous_hash
from semadb_tpu_torch.cluster.meshsearch import MeshSearcher, maybe_mesh
from semadb_tpu_torch.cluster.metrics import count_point_op, observe_rpc
from semadb_tpu_torch.cluster.placement import (
    ShardInfo,
    distribute_points,
    distribute_points_spread,
)
from semadb_tpu_torch.cluster.rpc import RPCClientPool, RPCError, RPCServer
from semadb_tpu_torch.cluster.shardmgr import ShardManager
from semadb_tpu_torch.index.manager import _filters_equal
from semadb_tpu_torch.models.collection import Collection
from semadb_tpu_torch.models.errors import (
    ExistsError,
    NotFoundError,
    QuotaReachedError,
    ShardUnavailableError,
)
from semadb_tpu_torch.models.point import Point, SearchResult, result_doc
from semadb_tpu_torch.models.query import SearchRequest
from semadb_tpu_torch.parallel.mesh import ShardMesh
from semadb_tpu_torch.shard.shard import postprocess_results
from semadb_tpu_torch.store.diskstore import open_store
from semadb_tpu_torch.utils.compare import sort_search_results
from semadb_tpu_torch.utils.logging import get_logger

LOG = get_logger("cluster")

DB_DELIMITER = "/"
USER_COLLECTIONS_BUCKET = "userCollections"

# Poisson CDF-inverse linear approximation (actions.go:271-272)
POISSON_APPROX_A = 1.42
POISSON_APPROX_B = 10.0


@dataclass
class ClusterNodeConfig:
    """Reference: ClusterNodeConfig (clusternode.go:28-58) +
    ShardManagerConfig (shardmgr.go:25-32)."""

    root_dir: str = ""
    rpc_host: str = "localhost"
    rpc_port: int = 0  # 0 = ephemeral
    rpc_timeout: float = 30.0
    rpc_retries: int = 2
    servers: List[str] = field(default_factory=list)
    max_shard_size: int = 2**31  # bytes
    max_shard_point_count: int = 250_000
    max_search_limit: int = 75
    shard_timeout: float = 300.0
    max_cache_size: int = 0  # device-memory budget for indices, 0 = unlimited
    backup_frequency: float = 0.0  # nodedb backup cadence, 0 = off
    backup_count: int = 3

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterNodeConfig":
        return cls(
            root_dir=d.get("rootDir", ""),
            rpc_host=d.get("rpcHost", "localhost"),
            rpc_port=int(d.get("rpcPort", 0)),
            rpc_timeout=float(d.get("rpcTimeout", 30)),
            rpc_retries=int(d.get("rpcRetries", 2)),
            servers=list(d.get("servers", [])),
            max_shard_size=int(d.get("maxShardSize", 2**31)),
            max_shard_point_count=int(d.get("maxShardPointCount", 250_000)),
            max_search_limit=int(d.get("maxSearchLimit", 75)),
            shard_timeout=float(d.get("shardTimeout", 300)),
            max_cache_size=int(d.get("maxCacheSize", 0)),
            backup_frequency=float(d.get("backupFrequency", 0)),
            backup_count=int(d.get("backupCount", 3)),
        )


@dataclass
class FailedRange:
    shard_id: str
    start: int
    end: int
    error: str

    def to_dict(self) -> dict:
        return {"shardId": self.shard_id, "start": self.start, "end": self.end, "error": self.error}


@dataclass
class FailedPoint:
    id: uuid_mod.UUID
    error: str

    def to_dict(self) -> dict:
        return {"id": str(self.id), "error": self.error}


def _point_to_wire(p: Point) -> dict:
    return {"id": p.id.bytes, "data": p.data}


def _point_from_wire(d: dict) -> Point:
    return Point(id=uuid_mod.UUID(bytes=d["id"]), data=d["data"])


def _result_to_wire(r: SearchResult) -> dict:
    return {
        "id": r.point.id.bytes if r.point else b"",
        "data": r.point.data if r.point else b"",
        "decoded": r.decoded_data,
        "distance": r.distance,
        "score": r.score,
        "hybridScore": r.hybrid_score,
    }


def _result_from_wire(d: dict) -> SearchResult:
    p = Point(id=uuid_mod.UUID(bytes=d["id"]), data=d["data"]) if d.get("id") else None
    return SearchResult(
        point=p,
        decoded_data=d.get("decoded"),
        distance=d.get("distance"),
        score=d.get("score"),
        hybrid_score=d.get("hybridScore", 0.0),
    )


class ClusterNode:
    def __init__(self, cfg: ClusterNodeConfig, device: torch.device, mesh: Optional[ShardMesh] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.my_hostname = f"{cfg.rpc_host}:{cfg.rpc_port}"
        self.servers = list(cfg.servers) or [self.my_hostname]
        nodedb_path = (
            os.path.join(cfg.root_dir, "nodedb.sdb") if cfg.root_dir else ""
        )
        if cfg.root_dir:
            os.makedirs(cfg.root_dir, exist_ok=True)
        self.nodedb = open_store(nodedb_path)
        self.shard_manager = ShardManager(
            cfg.root_dir,
            self.device,
            cfg.shard_timeout,
            backup_fn=self._shard_backup,
            max_cache_size=cfg.max_cache_size,
        )
        self.rpc = RPCClientPool(cfg.rpc_timeout, cfg.rpc_retries)
        # Device-mesh data plane for shardPlacement="device" collections
        # (cluster/meshsearch.py): the caller's mesh, else every card of a
        # host with two or more; none on cpu or one card
        if mesh is None:
            mesh = maybe_mesh(self.device)
        self._mesh_searcher = MeshSearcher(self.shard_manager, mesh) if mesh is not None else None
        self._server: Optional[RPCServer] = None
        self._backup_timer: Optional[threading.Timer] = None
        self._handlers: Dict[str, Callable[[dict], dict]] = {
            "SetNodeKeyValue": self._rpc_set_node_key_value,
            "CreateCollection": self._rpc_create_collection,
            "ListCollections": self._rpc_list_collections,
            "GetCollection": self._rpc_get_collection,
            "DeleteCollection": self._rpc_delete_collection,
            "CreateShard": self._rpc_create_shard,
            "GetShardInfo": self._rpc_get_shard_info,
            "DeleteCollectionShards": self._rpc_delete_collection_shards,
            "InsertPoints": self._rpc_insert_points,
            "UpdatePoints": self._rpc_update_points,
            "DeletePoints": self._rpc_delete_points,
            "SearchPoints": self._rpc_search_points,
            "SearchPointsBatch": self._rpc_search_points_batch,
            "SearchPointsBatchWire": self._rpc_search_points_batch_wire,
            "SendShard": self._rpc_send_shard,
        }

    # -- lifecycle ---------------------------------------------------------
    def serve(self) -> None:
        """Start the RPC server (clusternode.go Serve) + backup ticker."""
        self._server = RPCServer(self.cfg.rpc_host, self.cfg.rpc_port, self._handlers)
        if self.cfg.rpc_port == 0:
            # Ephemeral port: fix up identity and server list
            port = self._server.port
            old = self.my_hostname
            self.my_hostname = f"{self.cfg.rpc_host}:{port}"
            self.servers = [
                self.my_hostname if s == old else s for s in self.servers
            ]
        self._server.serve_background()
        if self.cfg.backup_frequency > 0:
            self._schedule_backup()

    def _schedule_backup(self) -> None:
        def tick():
            try:
                self.backup_nodedb()
            finally:
                self._schedule_backup()

        self._backup_timer = threading.Timer(self.cfg.backup_frequency, tick)
        self._backup_timer.daemon = True
        self._backup_timer.start()

    def backup_nodedb(self) -> None:
        """Timestamped nodedb backup with retention (clusternode.go:171-196,
        utils/backup.go)."""
        if not self.cfg.root_dir:
            return
        from semadb_tpu_torch.utils.backup import backup_with_retention

        backup_with_retention(
            self.nodedb,
            os.path.join(self.cfg.root_dir, "nodedb.sdb"),
            self.cfg.backup_count,
        )

    def _shard_backup(self, shard, col: Collection) -> None:
        """Per-shard timestamped backup on unload, gated by the user plan
        (shardmgr.go:134-138, userplan.go shardBackupFrequency/Count)."""
        freq = col.user_plan.shard_backup_frequency
        if freq <= 0 or not self.cfg.root_dir:
            return
        from semadb_tpu_torch.utils.backup import backup_with_retention

        path = os.path.join(self.cfg.root_dir, col.user_id, col.id)
        # find this shard's dir by matching its db path
        backup_with_retention(
            shard.db, shard.db.path, col.user_plan.shard_backup_count, min_interval=freq
        )

    def close(self) -> None:
        if self._backup_timer is not None:
            self._backup_timer.cancel()
        if self._server is not None:
            self._server.shutdown()
        self.shard_manager.unload_all()
        self.nodedb.close()

    # -- routing -----------------------------------------------------------
    def _call(self, dest: str, method: str, payload: dict) -> dict:
        """Self-route or go over the wire (rpchandlers.go:49-51 pattern);
        per-handler Prometheus count/duration (cluster/metrics.go)."""
        with observe_rpc(method):
            if dest == self.my_hostname:
                return self._handlers[method](payload)
            payload = dict(payload)
            payload["__dest"] = dest
            return self.rpc.call(dest, method, payload)

    def _owner(self, key: str) -> str:
        return rendezvous_hash(key, self.servers, 1)[0]

    # -- nodedb helpers ----------------------------------------------------
    def _collection_key(self, user_id: str, collection_id: str) -> bytes:
        return (user_id + DB_DELIMITER + collection_id).encode()

    # =====================================================================
    # RPC handlers (rpchandlers.go parity)
    # =====================================================================
    def _rpc_set_node_key_value(self, req: dict) -> dict:
        def writer(bm):
            b = bm.get(req["bucket"])
            for k, v in req["keyValues"].items():
                key = k.encode() if isinstance(k, str) else k
                b.put(key, v)

        self.nodedb.write(writer)
        return {}

    def _rpc_create_collection(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        max_collections = req.get("maxCollections", col.user_plan.max_collections)
        out = {"alreadyExists": False, "quotaReached": False}

        def writer(bm):
            b = bm.get(USER_COLLECTIONS_BUCKET)
            key = self._collection_key(col.user_id, col.id)
            if b.get(key) is not None:
                out["alreadyExists"] = True
                return
            count = sum(1 for _ in b.prefix_scan((col.user_id + DB_DELIMITER).encode()))
            if count >= max_collections:
                out["quotaReached"] = True
                return
            b.put(key, msgpack.packb(col.to_dict(), use_bin_type=True))

        self.nodedb.write(writer)
        return out

    def _rpc_list_collections(self, req: dict) -> dict:
        cols = []

        def reader(bm):
            b = bm.get(USER_COLLECTIONS_BUCKET)
            for _, v in b.prefix_scan((req["userId"] + DB_DELIMITER).encode()):
                cols.append(msgpack.unpackb(v, raw=False))

        self.nodedb.read(reader)
        return {"collections": cols}

    def _rpc_get_collection(self, req: dict) -> dict:
        out = {"notFound": False, "collection": None}

        def reader(bm):
            b = bm.get(USER_COLLECTIONS_BUCKET)
            raw = b.get(self._collection_key(req["userId"], req["collectionId"]))
            if raw is None:
                out["notFound"] = True
            else:
                out["collection"] = msgpack.unpackb(raw, raw=False)

        self.nodedb.read(reader)
        return out

    def _rpc_delete_collection(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])

        def writer(bm):
            b = bm.get(USER_COLLECTIONS_BUCKET)
            b.delete(self._collection_key(col.user_id, col.id))

        self.nodedb.write(writer)
        return {}

    def _rpc_create_shard(self, req: dict) -> dict:
        """Mint a shard id and append it to the collection entry
        (rpchandlers.go RPCCreateShard)."""
        shard_id = str(uuid_mod.uuid4())
        out = {"shardId": shard_id}

        def writer(bm):
            b = bm.get(USER_COLLECTIONS_BUCKET)
            key = self._collection_key(req["userId"], req["collectionId"])
            raw = b.get(key)
            if raw is None:
                raise NotFoundError(f"collection not found: {req['collectionId']}")
            col = msgpack.unpackb(raw, raw=False)
            col["shardIds"] = list(col.get("shardIds", [])) + [shard_id]
            b.put(key, msgpack.packb(col, use_bin_type=True))

        self.nodedb.write(writer)
        return out

    def _rpc_get_shard_info(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        out = {}

        def fn(shard):
            out["pointCount"] = shard.point_count()
            path = self.shard_manager.shard_path(col, req["shardId"])
            out["size"] = os.path.getsize(path) if os.path.exists(path) else 0
            return None

        self.shard_manager.do_with_shard(col, req["shardId"], fn)
        return out

    def _rpc_delete_collection_shards(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        deleted = self.shard_manager.delete_collection_shards(col)
        return {"deletedShardIds": deleted}

    def _rpc_insert_points(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        points = [_point_from_wire(p) for p in req["points"]]
        self.shard_manager.do_with_shard(
            col, req["shardId"], lambda s: s.insert_points(points)
        )
        return {}

    def _rpc_update_points(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        points = [_point_from_wire(p) for p in req["points"]]
        updated = self.shard_manager.do_with_shard(
            col, req["shardId"], lambda s: s.update_points(points)
        )
        return {"updatedIds": [u.bytes for u in updated]}

    def _rpc_delete_points(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        ids = {uuid_mod.UUID(bytes=b) for b in req["pointIds"]}
        deleted = self.shard_manager.do_with_shard(
            col, req["shardId"], lambda s: s.delete_points(ids)
        )
        return {"deletedIds": [u.bytes for u in deleted]}

    def _rpc_search_points(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        sr = SearchRequest.from_dict(req["searchRequest"])
        results = self.shard_manager.do_with_shard(
            col, req["shardId"], lambda s: s.search_points(sr)
        )
        return {"points": [_result_to_wire(r) for r in results]}

    def _rpc_search_points_batch_wire(self, req: dict) -> dict:
        """Wire-document batch search: the shard emits final user docs
        (id-only fast path when the batch qualifies), so the caller
        merges and returns them without any re-materialisation."""
        col = Collection.from_dict(req["collection"])
        srs = [SearchRequest.from_dict(d) for d in req["searchRequests"]]
        results = self.shard_manager.do_with_shard(
            col, req["shardId"], lambda s: s.search_points_batch_wire(srs)
        )
        return {"results": results}

    def _rpc_search_points_batch(self, req: dict) -> dict:
        col = Collection.from_dict(req["collection"])
        srs = [SearchRequest.from_dict(d) for d in req["searchRequests"]]
        batched = self.shard_manager.do_with_shard(
            col, req["shardId"], lambda s: s.search_points_batch(srs)
        )
        return {
            "results": [[_result_to_wire(r) for r in one] for one in batched]
        }

    def _rpc_send_shard(self, req: dict) -> dict:
        """Chunked shard file transfer (rpchandlers.go RPCSendShard:86-124):
        append chunks at offset; on final chunk verify the xxhash checksum."""
        import xxhash

        dest_dir = os.path.join(
            self.cfg.root_dir, req["userId"], req["collectionId"], req["shardId"]
        )
        os.makedirs(dest_dir, exist_ok=True)
        path = os.path.join(dest_dir, "sharddb.sdb")
        mode = "r+b" if os.path.exists(path) else "wb"
        with open(path, mode) as f:
            f.seek(req["offset"])
            f.write(req["chunk"])
        if req.get("final"):
            h = xxhash.xxh64()
            with open(path, "rb") as f:
                while True:
                    c = f.read(1 << 20)
                    if not c:
                        break
                    h.update(c)
            if h.intdigest() != req["checksum"]:
                os.remove(path)
                raise RPCError(f"shard file checksum mismatch for {req['shardId']}")
        return {}

    # =====================================================================
    # Public actions (actions.go parity)
    # =====================================================================
    def create_collection(self, col: Collection) -> None:
        resp = self._call(
            self._owner(col.user_id),
            "CreateCollection",
            {
                "collection": col.to_dict(),
                "maxCollections": col.user_plan.max_collections,
            },
        )
        if resp.get("alreadyExists"):
            raise ExistsError(f"collection already exists: {col.id}")
        if resp.get("quotaReached"):
            raise QuotaReachedError("collection quota reached")

    def list_collections(self, user_id: str) -> List[Collection]:
        resp = self._call(self._owner(user_id), "ListCollections", {"userId": user_id})
        return [Collection.from_dict(c) for c in resp["collections"]]

    def get_collection(self, user_id: str, collection_id: str) -> Collection:
        resp = self._call(
            self._owner(user_id),
            "GetCollection",
            {"userId": user_id, "collectionId": collection_id},
        )
        if resp.get("notFound"):
            raise NotFoundError(f"collection not found: {collection_id}")
        return Collection.from_dict(resp["collection"])

    def delete_collection(self, col: Collection) -> List[str]:
        self._call(
            self._owner(col.user_id), "DeleteCollection", {"collection": col.to_dict()}
        )
        # Best-effort shard deletion across owning servers (actions.go:133-169)
        target_servers = {self._owner(sid) for sid in col.shard_ids}
        deleted: List[str] = []
        with ThreadPoolExecutor(max_workers=max(len(target_servers), 1)) as ex:
            futs = [
                ex.submit(
                    self._call, ts, "DeleteCollectionShards", {"collection": col.to_dict()}
                )
                for ts in target_servers
            ]
            for f in futs:
                try:
                    deleted.extend(f.result().get("deletedShardIds", []))
                except Exception:
                    continue
        return deleted

    def get_shards_info(self, col: Collection) -> List[ShardInfo]:
        """Parallel per-shard fan-out (actions.go:85-113 goroutine parity) —
        every insert pays this latency, so it must not be serial."""
        if not col.shard_ids:
            return []

        def one(sid: str) -> ShardInfo:
            resp = self._call(
                self._owner(sid),
                "GetShardInfo",
                {"collection": col.to_dict(), "shardId": sid},
            )
            return ShardInfo(id=sid, size=resp["size"], point_count=resp["pointCount"])

        with ThreadPoolExecutor(max_workers=len(col.shard_ids)) as ex:
            futs = {sid: ex.submit(one, sid) for sid in col.shard_ids}
            infos = []
            err = None
            for sid, f in futs.items():
                try:
                    infos.append(f.result())
                except Exception as e:
                    err = err or e
            if err is not None:
                raise ShardUnavailableError(f"could not get shard info: {err}") from err
        return infos

    def insert_points(self, col: Collection, points: List[Point]) -> List[FailedRange]:
        shards = self.get_shards_info(col)
        total = sum(s.point_count for s in shards)
        if total + len(points) > col.user_plan.max_collection_point_count:
            raise QuotaReachedError("collection point quota reached")
        # Sort by UUID for ordered B+tree inserts downstream (actions.go:197-200)
        points = sorted(points, key=lambda p: p.id.bytes)

        def create_shard() -> str:
            resp = self._call(
                self._owner(col.user_id),
                "CreateShard",
                {"userId": col.user_id, "collectionId": col.id},
            )
            sid = resp["shardId"]
            col.shard_ids.append(sid)
            return sid

        count_point_op("insert", len(points))
        if col.shard_placement == "device":
            ms = self._mesh()
            n_targets = ms.mesh.size if ms is not None else 1
            assignments = distribute_points_spread(shards, points, n_targets, create_shard)
        else:
            assignments = distribute_points(
                shards, points, self.cfg.max_shard_size,
                self.cfg.max_shard_point_count, create_shard,
            )
        failed: List[FailedRange] = []
        lock = threading.Lock()

        def do_insert(sid: str, rng: Tuple[int, int]):
            try:
                self._call(
                    self._owner(sid),
                    "InsertPoints",
                    {
                        "collection": col.to_dict(),
                        "shardId": sid,
                        "points": [_point_to_wire(p) for p in points[rng[0]:rng[1]]],
                    },
                )
            except Exception as e:
                with lock:
                    failed.append(FailedRange(sid, rng[0], rng[1], str(e)))

        with ThreadPoolExecutor(max_workers=max(len(assignments), 1)) as ex:
            list(ex.map(lambda kv: do_insert(*kv), assignments.items()))
        return failed

    def _mesh(self) -> Optional[MeshSearcher]:
        """The device-mesh searcher, or None without a mesh."""
        return self._mesh_searcher

    def _try_mesh_search(
        self, col: Collection, srs: List[SearchRequest]
    ) -> Optional[List[List[SearchResult]]]:
        """Serve a batch through the device mesh when eligible, else None.

        Replaces the reference's per-shard goroutine fan-out
        (actions.go:274-378) with ONE sharded_*_search fan-out over the
        mesh's slots, merged on its first slot; the result is the EXACT
        global top-k, so no Poisson per-shard-limit shrink is needed.

        Multi-node composition: when the collection spans several nodes,
        THIS node mesh-serves the shards it owns (a partial stack) and fans
        the rest out over RPC — the two data planes merge per request. The
        reference has only the RPC plane (rpc.go:42-109).
        """
        ms = self._mesh()
        if ms is None or col.shard_placement != "device" or not col.shard_ids:
            return None
        local_sids = [
            sid for sid in col.shard_ids
            if self._owner(sid) == self.my_hostname
        ]
        remote_sids = [
            sid for sid in col.shard_ids if sid not in set(local_sids)
        ]
        if not local_sids:
            return None
        if remote_sids and any(sr.offset for sr in srs):
            return None  # offset division semantics: host path handles it
        prop = None
        vecs, ks, weights, filters = [], [], [], []
        fused_views, fused_weights = [], []
        search_size = probes = 0
        for sr in srs:
            p = ms.eligible_query(col, sr.query)
            if p is None or (prop is not None and p != prop):
                return None
            prop = p
            fopts = sr.query.vector_fused
            if fopts is not None:
                fused_views.append(
                    [np.asarray(v, np.float32) for v in fopts.vectors]
                )
                fused_weights.append(fopts.weights)
                opts = fopts
            else:
                opts = sr.query.vector_vamana or sr.query.vector_ivf
                vecs.append(np.asarray(opts.vector, np.float32))
            filters.append(opts.filter)
            ks.append(opts.limit)
            weights.append(opts.weight if opts.weight is not None else 1.0)
            search_size = max(search_size, getattr(opts, "search_size", 0))
            probes = max(probes, getattr(opts, "num_probes", 0))
        # One mask set serves the whole batch, so every request must carry
        # the SAME filter (structurally); mixed-filter batches fall back.
        filter_query = filters[0]
        if any(not _filters_equal(f, filter_query) for f in filters[1:]):
            return None
        if fused_views and len(fused_views) != len(srs):
            return None  # mixed fused / plain batches: host fan-out
        if fused_views:
            nviews = len(fused_views[0])
            qviews = [
                np.stack([fv[i] for fv in fused_views]) for i in range(nviews)
            ]
            hits = ms.search_batch_fused(
                col, prop, qviews, fused_weights, max(ks), probes,
                shard_ids=local_sids, filter_query=filter_query,
            )
        else:
            hits = ms.search_batch(
                col, prop, np.stack(vecs), max(ks), search_size, probes,
                filter_query=filter_query, shard_ids=local_sids,
            )
        if hits is None:
            return None
        # UUID/data backfill: one read txn per shard that contributed hits
        need: Dict[str, set] = {}
        for row in hits:
            for _, sid, nid in row:
                need.setdefault(sid, set()).add(nid)
        # Match the host path's with-data gate (shard.py wd logic and the
        # reference's withData = len(Select)>0, shard.go:352): no select
        # and no sort → results carry _id/_distance/_hybridScore only, so
        # both data planes answer identically.
        with_data = any(bool(sr.select) or bool(sr.sort) for sr in srs)
        resolved = {}
        for sid, nids in need.items():
            ordered = sorted(nids)
            resolved[sid] = self.shard_manager.do_with_shard(
                col, sid, lambda s: s.resolve_node_ids(ordered, with_data)
            )
        out: List[List[SearchResult]] = []
        for sr, row, kq, w in zip(srs, hits, ks, weights):
            results = []
            for dist, sid, nid in row[:kq]:
                pt = resolved[sid].get(nid)
                if pt is None:
                    continue  # uncommitted/deleted id: tolerant resolution
                results.append(
                    SearchResult(
                        point=pt, node_id=nid, distance=dist,
                        hybrid_score=-dist * w,
                    )
                )
            out.append(postprocess_results(sr, results))
        if remote_sids:
            self._merge_remote_shards(col, srs, remote_sids, out)
        return out

    def _merge_remote_shards(
        self,
        col: Collection,
        srs: List[SearchRequest],
        remote_sids: List[str],
        out: List[List[SearchResult]],
    ) -> None:
        """Fan the batch to remote shards over RPC (SearchPointsBatch,
        Poisson-shrunk per-shard limits as in actions.go:291-299) and
        merge each request's remote hits into the mesh-served results —
        the RPC plane × device-mesh plane composition."""
        n_shards = max(len(col.shard_ids), 1)
        shard_srs = []
        for sr in srs:
            target = int(sr.limit / n_shards * POISSON_APPROX_A + POISSON_APPROX_B)
            target = min(target, self.cfg.max_search_limit, sr.limit)
            shard_srs.append(
                SearchRequest(
                    query=sr.query, select=sr.select, sort=sr.sort,
                    offset=0, limit=target,
                )
            )
        lock = threading.Lock()
        errors: List[Exception] = []

        def do_remote(sid: str):
            try:
                resp = self._call(
                    self._owner(sid),
                    "SearchPointsBatch",
                    {
                        "collection": col.to_dict(),
                        "shardId": sid,
                        "searchRequests": [
                            _search_request_to_dict(s) for s in shard_srs
                        ],
                    },
                )
                with lock:
                    for qi, pts in enumerate(resp["results"]):
                        out[qi].extend(_result_from_wire(r) for r in pts)
            except Exception as e:
                with lock:
                    errors.append(e)

        with ThreadPoolExecutor(max_workers=len(remote_sids)) as ex:
            list(ex.map(do_remote, remote_sids))
        if errors:
            raise ShardUnavailableError(
                f"shard could not search points: {errors[0]}"
            )
        for qi, sr in enumerate(srs):
            if not sr.sort:
                out[qi].sort(key=lambda r: -r.hybrid_score)
            else:
                sort_search_results(out[qi], sr.sort)
            out[qi][:] = out[qi][: sr.limit]

    def search_points(
        self, col: Collection, sr: SearchRequest
    ) -> List[SearchResult]:
        """Scatter-gather search (actions.go:274-378)."""
        mesh_out = self._try_mesh_search(col, [sr])
        if mesh_out is not None:
            count_point_op("search")
            return mesh_out[0]
        original_limit = sr.limit
        n_shards = max(len(col.shard_ids), 1)
        target = int(sr.limit / n_shards * POISSON_APPROX_A + POISSON_APPROX_B)
        target = min(target, self.cfg.max_search_limit, sr.limit)
        shard_sr = SearchRequest(
            query=sr.query, select=sr.select, sort=sr.sort,
            offset=sr.offset, limit=target,
        )
        if n_shards > 1 and sr.offset % n_shards == 0:
            shard_sr.offset = sr.offset // n_shards

        count_point_op("search")
        results: List[SearchResult] = []
        lock = threading.Lock()
        errors: List[Exception] = []

        def do_search(sid: str):
            try:
                owner = self._owner(sid)
                if owner == self.my_hostname:
                    # Self-route without the wire codec (rpchandlers.go:49-51:
                    # local handlers receive the structs directly — only
                    # remote calls pay serialization).
                    with observe_rpc("SearchPoints"):
                        out = self.shard_manager.do_with_shard(
                            col, sid, lambda s: s.search_points(shard_sr)
                        )
                    with lock:
                        results.extend(out)
                    return
                resp = self._call(
                    owner,
                    "SearchPoints",
                    {
                        "collection": col.to_dict(),
                        "shardId": sid,
                        "searchRequest": _search_request_to_dict(shard_sr),
                    },
                )
                with lock:
                    results.extend(_result_from_wire(r) for r in resp["points"])
            except Exception as e:
                with lock:
                    errors.append(e)

        with LOG.timed("search fan-out", shards=n_shards):
            with ThreadPoolExecutor(max_workers=n_shards) as ex:
                list(ex.map(do_search, col.shard_ids))
        if errors:
            raise ShardUnavailableError(f"shard could not search points: {errors[0]}")
        if len(col.shard_ids) > 1:
            if not sr.sort:
                results.sort(key=lambda r: -r.hybrid_score)
            else:
                sort_search_results(results, sr.sort)
        return results[:original_limit]

    def search_points_batch(
        self, col: Collection, srs: List[SearchRequest]
    ) -> List[List[SearchResult]]:
        """Scatter-gather BATCH search: ONE RPC per shard carries the
        whole request list, each shard executes it in one read
        transaction (Shard.search_points_batch collapses a homogeneous
        vector batch into a single [B, D] device dispatch), and results
        merge per request. RPC count is per-shard, not per-query —
        beyond-reference; the reference's network cost scales with
        queries × shards (actions.go:274-378)."""
        mesh_out = self._try_mesh_search(col, srs)
        if mesh_out is not None:
            count_point_op("search", len(srs))
            return mesh_out
        n_shards = max(len(col.shard_ids), 1)
        shard_srs = []
        for sr in srs:
            target = int(sr.limit / n_shards * POISSON_APPROX_A + POISSON_APPROX_B)
            target = min(target, self.cfg.max_search_limit, sr.limit)
            ssr = SearchRequest(
                query=sr.query, select=sr.select, sort=sr.sort,
                offset=sr.offset, limit=target,
            )
            if n_shards > 1 and sr.offset % n_shards == 0:
                ssr.offset = sr.offset // n_shards
            shard_srs.append(ssr)

        count_point_op("search", len(srs))
        merged: List[List[SearchResult]] = [[] for _ in srs]
        lock = threading.Lock()
        errors: List[Exception] = []

        def do_search(sid: str):
            try:
                owner = self._owner(sid)
                if owner == self.my_hostname:
                    # Self-route without the wire codec (rpchandlers.go:49-51)
                    with observe_rpc("SearchPointsBatch"):
                        out = self.shard_manager.do_with_shard(
                            col, sid, lambda s: s.search_points_batch(shard_srs)
                        )
                    with lock:
                        for qi, pts in enumerate(out):
                            merged[qi].extend(pts)
                    return
                resp = self._call(
                    owner,
                    "SearchPointsBatch",
                    {
                        "collection": col.to_dict(),
                        "shardId": sid,
                        "searchRequests": [
                            _search_request_to_dict(s) for s in shard_srs
                        ],
                    },
                )
                with lock:
                    for qi, pts in enumerate(resp["results"]):
                        merged[qi].extend(_result_from_wire(r) for r in pts)
            except Exception as e:
                with lock:
                    errors.append(e)

        with LOG.timed("batch search fan-out", shards=n_shards, queries=len(srs)):
            with ThreadPoolExecutor(max_workers=n_shards) as ex:
                list(ex.map(do_search, col.shard_ids))
        if errors:
            raise ShardUnavailableError(f"shard could not search points: {errors[0]}")
        out: List[List[SearchResult]] = []
        for sr, results in zip(srs, merged):
            if len(col.shard_ids) > 1:
                if not sr.sort:
                    results.sort(key=lambda r: -r.hybrid_score)
                else:
                    sort_search_results(results, sr.sort)
            out.append(results[: sr.limit])
        return out

    def search_points_batch_wire(
        self, col: Collection, srs: List[SearchRequest]
    ) -> List[list]:
        """Batch search returning final WIRE documents per query.

        The id-only ANN shape (no select/sort/offset) rides
        Shard.search_points_batch_wire end to end: device arrays → uuid
        strings → response dicts, with cross-shard merging on the
        ``_hybridScore`` key — no SearchResult/Point objects anywhere on
        the path. Anything else delegates to :meth:`search_points_batch`
        and converts once at the end (identical documents)."""
        fast = all(not sr.select and not sr.sort and not sr.offset for sr in srs)
        if not fast:
            return [
                [result_doc(r) for r in row]
                for row in self.search_points_batch(col, srs)
            ]
        mesh_out = self._try_mesh_search(col, srs)
        if mesh_out is not None:
            count_point_op("search", len(srs))
            return [[result_doc(r) for r in row] for row in mesh_out]
        n_shards = max(len(col.shard_ids), 1)
        shard_srs = []
        for sr in srs:
            target = int(sr.limit / n_shards * POISSON_APPROX_A + POISSON_APPROX_B)
            target = min(target, self.cfg.max_search_limit, sr.limit)
            shard_srs.append(
                SearchRequest(
                    query=sr.query, select=sr.select, sort=sr.sort,
                    offset=0, limit=target,
                )
            )

        count_point_op("search", len(srs))
        if len(col.shard_ids) == 1 and self._owner(col.shard_ids[0]) == self.my_hostname:
            # Single local shard (the common single-node serving layout):
            # no fan-out thread, no merge — per-shard results ARE final
            # (targets above equal the caller limits when n_shards == 1).
            with observe_rpc("SearchPointsBatchWire"):
                return self.shard_manager.do_with_shard(
                    col, col.shard_ids[0],
                    lambda s: s.search_points_batch_wire(shard_srs),
                )
        merged: List[list] = [[] for _ in srs]
        lock = threading.Lock()
        errors: List[Exception] = []

        def do_search(sid: str):
            try:
                owner = self._owner(sid)
                if owner == self.my_hostname:
                    with observe_rpc("SearchPointsBatchWire"):
                        out = self.shard_manager.do_with_shard(
                            col, sid,
                            lambda s: s.search_points_batch_wire(shard_srs),
                        )
                else:
                    out = self._call(
                        owner,
                        "SearchPointsBatchWire",
                        {
                            "collection": col.to_dict(),
                            "shardId": sid,
                            "searchRequests": [
                                _search_request_to_dict(s) for s in shard_srs
                            ],
                        },
                    )["results"]
                with lock:
                    for qi, docs in enumerate(out):
                        merged[qi].extend(docs)
            except Exception as e:
                with lock:
                    errors.append(e)

        with LOG.timed("batch search fan-out", shards=n_shards, queries=len(srs)):
            with ThreadPoolExecutor(max_workers=n_shards) as ex:
                list(ex.map(do_search, col.shard_ids))
        if errors:
            raise ShardUnavailableError(f"shard could not search points: {errors[0]}")
        out: List[list] = []
        for sr, docs in zip(srs, merged):
            if len(col.shard_ids) > 1:
                docs.sort(key=lambda d: -d["_hybridScore"])
            out.append(docs[: sr.limit])
        return out

    def update_points(self, col: Collection, points: List[Point]) -> List[FailedPoint]:
        """Broadcast update to all shards (actions.go:388-436)."""
        count_point_op("update", len(points))
        return self._broadcast_points(
            col, "UpdatePoints",
            {"points": [_point_to_wire(p) for p in points]},
            [p.id for p in points], "updatedIds",
        )

    def delete_points(
        self, col: Collection, point_ids: List[uuid_mod.UUID]
    ) -> List[FailedPoint]:
        """Broadcast delete to all shards (actions.go:476-521)."""
        count_point_op("delete", len(point_ids))
        return self._broadcast_points(
            col, "DeletePoints",
            {"pointIds": [p.bytes for p in point_ids]},
            point_ids, "deletedIds",
        )

    def _broadcast_points(self, col, method, payload, all_ids, result_key):
        success: Set[uuid_mod.UUID] = set()
        lock = threading.Lock()
        success_count = [0]

        def do(sid: str):
            try:
                resp = self._call(
                    self._owner(sid), method,
                    {"collection": col.to_dict(), "shardId": sid, **payload},
                )
                with lock:
                    success.update(uuid_mod.UUID(bytes=b) for b in resp[result_key])
                    success_count[0] += 1
            except Exception:
                pass

        with ThreadPoolExecutor(max_workers=max(len(col.shard_ids), 1)) as ex:
            list(ex.map(do, col.shard_ids))
        return curate_failed_points(
            all_ids, success, success_count[0] == len(col.shard_ids)
        )


def curate_failed_points(
    all_ids: List[uuid_mod.UUID], success: Set[uuid_mod.UUID], complete: bool
) -> List[FailedPoint]:
    """actions.go curateFailedPoints:438-474 — internal protocol transmits
    successes; failures reconstructed for the client."""
    err = "not found" if complete else "shard unavailable"
    return [FailedPoint(id=i, error=err) for i in all_ids if i not in success]


def _vec_wire(v) -> bytes:
    """Wire encoding of a query vector: packed little-endian f32 bytes.
    ``decode_vector`` on the receiving side accepts this form natively,
    and it is both smaller (4 B/component vs a msgpack float box) and
    decode-free (one frombuffer)."""
    return np.asarray(v, dtype="<f4").tobytes()


def _search_request_to_dict(sr: SearchRequest) -> dict:
    """Wire encoding of a SearchRequest (query AST round-trip)."""

    def q_to_dict(q) -> dict:
        out: dict = {"property": q.property}
        if q.vector_vamana is not None:
            o = q.vector_vamana
            out["vectorVamana"] = {
                "vector": _vec_wire(o.vector), "operator": o.operator,
                "searchSize": o.search_size, "limit": o.limit,
                **({"filter": q_to_dict(o.filter)} if o.filter else {}),
                **({"weight": o.weight} if o.weight is not None else {}),
            }
        if q.vector_flat is not None:
            o = q.vector_flat
            out["vectorFlat"] = {
                "vector": _vec_wire(o.vector), "operator": o.operator, "limit": o.limit,
                **({"filter": q_to_dict(o.filter)} if o.filter else {}),
                **({"weight": o.weight} if o.weight is not None else {}),
            }
        if q.vector_ivf is not None:
            o = q.vector_ivf
            out["vectorIVF"] = {
                "vector": _vec_wire(o.vector), "operator": o.operator, "limit": o.limit,
                **({"numProbes": o.num_probes} if o.num_probes else {}),
                **({"filter": q_to_dict(o.filter)} if o.filter else {}),
                **({"weight": o.weight} if o.weight is not None else {}),
            }
        if q.vector_fused is not None:
            o = q.vector_fused
            out["vectorFused"] = {
                "vectors": [_vec_wire(v) for v in o.vectors], "operator": o.operator,
                "limit": o.limit,
                **({"weights": [float(w) for w in o.weights]} if o.weights else {}),
                **({"numProbes": o.num_probes} if o.num_probes else {}),
                **({"filter": q_to_dict(o.filter)} if o.filter else {}),
                **({"weight": o.weight} if o.weight is not None else {}),
            }
        if q.text is not None:
            o = q.text
            out["text"] = {
                "value": o.value, "operator": o.operator, "limit": o.limit,
                **({"filter": q_to_dict(o.filter)} if o.filter else {}),
                **({"weight": o.weight} if o.weight is not None else {}),
            }
        if q.string is not None:
            out["string"] = {
                "value": q.string.value, "operator": q.string.operator,
                "endValue": q.string.end_value,
            }
        if q.integer is not None:
            out["integer"] = {
                "value": q.integer.value, "operator": q.integer.operator,
                "endValue": q.integer.end_value,
            }
        if q.float_ is not None:
            out["float"] = {
                "value": q.float_.value, "operator": q.float_.operator,
                "endValue": q.float_.end_value,
            }
        if q.string_array is not None:
            out["stringArray"] = {
                "value": q.string_array.value, "operator": q.string_array.operator,
            }
        if q.and_:
            out["_and"] = [q_to_dict(s) for s in q.and_]
        if q.or_:
            out["_or"] = [q_to_dict(s) for s in q.or_]
        return out

    return {
        "query": q_to_dict(sr.query),
        "select": sr.select,
        "sort": [{"property": s.property, "descending": s.descending} for s in sr.sort],
        "offset": sr.offset,
        "limit": sr.limit,
    }
