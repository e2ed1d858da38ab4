"""Generic write-back object cache over a store bucket.

Parity reference: shard/cache/itemcache.go — ``ItemCache[K, V]`` with the
``Storable`` protocol (IdFromKey/ReadFrom/WriteTo/DeleteFrom/
CheckAndClearDirty, itemcache.go:14-255): objects decode once on first
access, mutate in memory under dirty/deleted flags, and persist in one
pass on ``flush``. The reference instantiates it twice in the text index
(text.go:400-535 setCacheItem/docCacheItem) and once for vamana graph
nodes; here the vamana graph is a dense device array (no object cache
needed), so the users are the host-side indices (index/text.py).

Python reformulation of the Go generics: a ``Codec`` bundles the four
Storable operations as plain callables — key↔bytes mapping and
value encode/decode. ``encode`` returning ``None`` deletes the key on
flush (empty postings sets vanish, matching text.go's delete-on-empty).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Generic, Iterator, Optional, Set, Tuple, TypeVar

from semadb_tpu_torch.store.diskstore import Bucket

K = TypeVar("K")
V = TypeVar("V")


@dataclasses.dataclass(frozen=True)
class Codec(Generic[K, V]):
    """Storable protocol (itemcache.go:14-38) as data: how a cached item
    maps onto bucket bytes."""

    key_bytes: Callable[[K], bytes]  # K → bucket key
    key_from: Callable[[bytes], Optional[K]]  # bucket key → K (None = not ours)
    encode: Callable[[V], Optional[bytes]]  # value → bytes (None = delete)
    decode: Callable[[bytes], V]  # bytes → value


class ItemCache(Generic[K, V]):
    """Write-back cache: get/put/delete against memory, ``flush`` persists
    every dirty item in one pass (itemcache.go Flush, 204-255).

    Several caches may share one bucket when their key spaces are disjoint
    (text.go keeps ``t<term>s`` postings and ``d<docId>`` docs in the same
    bucket); ``key_from`` filters foreign keys during ``for_each``.
    """

    def __init__(self, bucket: Bucket, codec: Codec[K, V]):
        self.bucket = bucket
        self.codec = codec
        self._items: Dict[K, Optional[V]] = {}  # None = known-absent/deleted
        self._dirty: Set[K] = set()

    def rebind(self, bucket: Bucket) -> None:
        """Attach the current txn's bucket — a cache surviving across
        transactions (the shard's host_caches, cache/manager.go:116-303)
        keeps its decoded items but must read/write through the live txn."""
        self.bucket = bucket

    def scrap(self) -> None:
        """Drop everything (scrapped-on-failure: the store rolled back
        but the cache may hold the discarded mutations)."""
        self._items = {}
        self._dirty = set()

    # -- reads ---------------------------------------------------------------
    def get(self, key: K) -> Optional[V]:
        if key in self._items:
            return self._items[key]
        raw = self.bucket.get(self.codec.key_bytes(key))
        val = self.codec.decode(raw) if raw is not None else None
        self._items[key] = val
        return val

    def get_or_create(self, key: K, factory: Callable[[], V]) -> V:
        """Fetch-and-mark-dirty: the caller mutates the returned object in
        place (the dominant text-index access pattern, text.go:441-470)."""
        val = self.get(key)
        if val is None:
            val = factory()
        self._items[key] = val
        self._dirty.add(key)
        return val

    def for_each(self) -> Iterator[Tuple[K, V]]:
        """All items, loading the whole bucket (itemcache.go ForEach,
        162-199): bucket entries first (skipping ones shadowed by cached
        state), then cache-only entries."""
        seen = set()
        pairs = []

        def visit(kb: bytes, raw: bytes):
            k = self.codec.key_from(kb)
            if k is None:
                return
            seen.add(k)
            if k not in self._items:
                self._items[k] = self.codec.decode(raw)
            pairs.append(k)

        self.bucket.for_each(visit)
        for k, v in list(self._items.items()):
            if v is not None and k not in seen:
                pairs.append(k)
        for k in pairs:
            v = self._items.get(k)
            if v is not None:
                yield k, v

    # -- writes ----------------------------------------------------------------
    def put(self, key: K, value: V) -> None:
        self._items[key] = value
        self._dirty.add(key)

    def delete(self, key: K) -> None:
        self._items[key] = None
        self._dirty.add(key)

    def flush(self) -> None:
        """Persist dirty items; encode()→None and deleted items remove the
        key (CheckAndClearDirty semantics: flags reset after the pass)."""
        for key in self._dirty:
            val = self._items.get(key)
            raw = None if val is None else self.codec.encode(val)
            kb = self.codec.key_bytes(key)
            if raw is None:
                self.bucket.delete(kb)
            else:
                self.bucket.put(kb, raw)
        self._dirty.clear()
