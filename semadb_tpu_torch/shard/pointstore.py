"""Point store: UUID ↔ node-id mapping + msgpack point data.

Parity reference: shard/pointstore/pointstore.go with the same key layout:
``n<8B id>i`` → uuid bytes, ``n<8B id>d`` → msgpack data,
``p<uuid 16B>i`` → node id (pointstore.go:40-53).
"""

from __future__ import annotations

import struct
import threading
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Optional

from semadb_tpu_torch.models.errors import NotFoundError
from semadb_tpu_torch.models.point import Point
from semadb_tpu_torch.store.diskstore import Bucket

POINTS_BUCKET_NAME = "points"


def node_key(node_id: int, suffix: bytes) -> bytes:
    return b"n" + struct.pack("<Q", node_id) + suffix


def point_key(point_id: uuid_mod.UUID) -> bytes:
    return b"p" + point_id.bytes + b"i"


@dataclass
class ShardPoint:
    point: Point
    node_id: int


def set_point(bucket: Bucket, sp: ShardPoint) -> None:
    bucket.put(node_key(sp.node_id, b"i"), sp.point.id.bytes)
    bucket.put(node_key(sp.node_id, b"d"), sp.point.data or b"")
    bucket.put(point_key(sp.point.id), struct.pack("<Q", sp.node_id))


def check_point_exists(bucket: Bucket, point_id: uuid_mod.UUID) -> bool:
    return bucket.get(point_key(point_id)) is not None


def get_point_node_id_by_uuid(bucket: Bucket, point_id: uuid_mod.UUID) -> int:
    raw = bucket.get(point_key(point_id))
    if raw is None:
        raise NotFoundError(f"point not found: {point_id}")
    return struct.unpack("<Q", raw)[0]


def get_point_by_uuid(bucket: Bucket, point_id: uuid_mod.UUID) -> ShardPoint:
    node_id = get_point_node_id_by_uuid(bucket, point_id)
    data = bucket.get(node_key(node_id, b"d")) or b""
    return ShardPoint(point=Point(id=point_id, data=data), node_id=node_id)


def get_point_by_node_id(
    bucket: Bucket, node_id: int, with_data: bool = True
) -> ShardPoint:
    raw = bucket.get(node_key(node_id, b"i"))
    if raw is None:
        raise NotFoundError(f"node not found: {node_id}")
    pid = uuid_mod.UUID(bytes=raw)
    data = (bucket.get(node_key(node_id, b"d")) or b"") if with_data else b""
    return ShardPoint(point=Point(id=pid, data=data), node_id=node_id)


def _uuid_from_bytes(raw: bytes) -> uuid_mod.UUID:
    """UUID constructed without ``UUID.__init__``'s kwarg dispatch and
    validation (~7us -> ~1us): the bytes come straight from our own
    ``n<id>i`` records, which ``set_point`` only ever writes from a valid
    UUID. The search backfill constructs tens of thousands per batch."""
    u = uuid_mod.UUID.__new__(uuid_mod.UUID)
    object.__setattr__(u, "int", int.from_bytes(raw, "big"))
    object.__setattr__(u, "is_safe", uuid_mod.SafeUUID.unknown)
    return u


def get_uuid_strs_by_node_ids(bucket: Bucket, node_ids) -> list:
    """Bulk node-id → canonical UUID string: one ``multi_get`` plus one
    hex conversion per record, skipping UUID object construction entirely
    (~3 µs → ~0.4 µs per id). Entries are ``None`` for ids with no
    committed point record (tolerant resolution — see
    Shard.search_points_batch). The id-only ANN serving shape resolves
    tens of thousands of these per batch."""
    raws = bucket.multi_get([node_key(nid, b"i") for nid in node_ids])
    out = []
    for raw in raws:
        if raw is None:
            out.append(None)
            continue
        h = raw.hex()
        out.append(f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}")
    return out


class UuidStrCache:
    """Lazily-filled node-id → canonical UUID string cache for the
    id-only serving path.

    Safety argument: a node id's UUID is immutable for its lifetime —
    updates keep the node id (shard.go:231-325 semantics), and only a
    delete frees an id for reuse by a later insert. Write transactions
    stage in a per-txn overlay (store/overlay.py), so concurrent readers
    only ever observe committed records: every entry filled here came
    from committed state and stays valid until a committed delete frees
    the id. ``Shard.delete_points`` invalidates the freed ids (even on
    txn failure — a spurious drop only costs a refetch). ``None``
    resolutions (tolerant-resolution misses from concurrent uncommitted
    writes) are never cached.

    Generation guard: ``lookup`` fetches from committed state and only
    then inserts into the dict — if a delete txn commits AND invalidates
    in between, the just-fetched (pre-delete) strings would land AFTER
    the invalidate and, because freed node ids are reused LIFO, would
    serve the deleted point's UUID for a brand-new point until the
    wholesale clear. A generation counter bumped by every
    ``invalidate``/``clear`` closes the window: ``lookup`` snapshots the
    generation before the fetch and skips caching when any invalidation
    ran concurrently (results are still returned — only the cache insert
    is dropped, costing one refetch).

    Bounded: past ``max_entries`` the cache clears wholesale — at 10M
    points an unbounded dict of 36-char strings would cost ~2 GB of host
    RAM for a tail of ids that are rarely re-requested."""

    def __init__(self, max_entries: int = 4_000_000):
        self._strs: dict = {}
        self._max = max_entries
        self._gen = 0
        self._lock = threading.Lock()

    def lookup(self, bucket: Bucket, node_ids) -> list:
        strs = self._strs
        missing = [nid for nid in node_ids if nid not in strs]
        if missing:
            with self._lock:
                if len(strs) + len(missing) > self._max:
                    self._gen += 1
                    strs.clear()
                gen = self._gen
            # Fetch outside the lock (store I/O); the insert below is
            # discarded if any invalidate ran since the gen snapshot.
            fetched = get_uuid_strs_by_node_ids(bucket, missing)
            with self._lock:
                if self._gen == gen:
                    for nid, s in zip(missing, fetched):
                        if s is not None:
                            strs[nid] = s
            if len(missing) == len(node_ids):
                return fetched
        return [strs.get(nid) for nid in node_ids]

    def invalidate(self, node_ids) -> None:
        with self._lock:
            self._gen += 1
            strs = self._strs
            for nid in node_ids:
                strs.pop(nid, None)

    def clear(self) -> None:
        with self._lock:
            self._gen += 1
            self._strs.clear()


def get_points_by_node_ids(
    bucket: Bucket, node_ids, with_data: bool = True
) -> list:
    """Batched ``get_point_by_node_id``: one ``multi_get`` for all the id
    records (+ one for data when requested) instead of 2 bucket gets per
    point. Returns a list aligned with ``node_ids`` whose entries are
    ``ShardPoint`` or ``None`` for ids with no committed point record
    (the tolerant-resolution case in Shard.search_points_batch).
    Reference analog: the per-result GetPointByNodeId loop of
    shard.go:350-371 — batched here because Python per-call overhead is
    ~10us where Go's is nanoseconds."""
    id_keys = [node_key(nid, b"i") for nid in node_ids]
    raws = bucket.multi_get(id_keys)
    datas = None
    if with_data:
        datas = bucket.multi_get([node_key(nid, b"d") for nid in node_ids])
    out = []
    for i, (nid, raw) in enumerate(zip(node_ids, raws)):
        if raw is None:
            out.append(None)
            continue
        data = (datas[i] or b"") if with_data else b""
        out.append(
            ShardPoint(point=Point(id=_uuid_from_bytes(raw), data=data), node_id=nid)
        )
    return out


def delete_point(bucket: Bucket, sp: ShardPoint) -> None:
    bucket.delete(node_key(sp.node_id, b"i"))
    bucket.delete(node_key(sp.node_id, b"d"))
    bucket.delete(point_key(sp.point.id))
