"""Copy-on-write transaction staging for the disk stores.

Parity reference: diskstore/diskstore.go:45-95 — a bbolt write transaction
is atomic: if the closure returns an error the whole txn rolls back and no
partial state survives. Both Python and native backends stage every
mutation in a per-transaction overlay (read-your-writes) and apply it to
the base store only after the closure returns cleanly; an exception
discards the overlay, leaving base state untouched (the analog of bbolt
rollback + the cache manager's scrap-on-failure, cache/manager.go:207-235).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

_TOMBSTONE = object()  # staged delete marker


class OverlayBucket:
    """Bucket view merging a read-only base with a staged overlay.

    ``base_get(key) -> value|None`` and ``base_iter_from(start)`` (sorted
    (key, value) pairs from ``start``) abstract over the Python dict
    backend and the native cursor backend.
    """

    def __init__(
        self,
        base_get: Callable[[bytes], Optional[bytes]],
        base_iter_from: Callable[[bytes], Iterator[Tuple[bytes, bytes]]],
        base_len: Callable[[], int],
        overlay: Dict[bytes, object],
        read_only: bool = False,
    ):
        self._base_get = base_get
        self._base_iter_from = base_iter_from
        self._base_len = base_len
        self._overlay = overlay
        self._read_only = read_only

    def get(self, key: bytes) -> Optional[bytes]:
        v = self._overlay.get(key, None)
        if v is _TOMBSTONE:
            return None
        if v is not None:
            return v  # type: ignore[return-value]
        return self._base_get(key)

    def multi_get(self, keys) -> list:
        """Batched get honoring staged overlay state."""
        out = []
        for k in keys:
            v = self._overlay.get(k, None)
            if v is _TOMBSTONE:
                out.append(None)
            elif v is not None:
                out.append(v)
            else:
                out.append(self._base_get(k))
        return out

    def put(self, key: bytes, value: bytes) -> None:
        if self._read_only:
            raise RuntimeError("bucket is read-only")
        self._overlay[key] = value

    def delete(self, key: bytes) -> None:
        if self._read_only:
            raise RuntimeError("bucket is read-only")
        self._overlay[key] = _TOMBSTONE

    def _iter_from(self, start: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered merge of base and overlay; overlay wins, tombstones skip.

        Overlay keys are snapshotted at iteration start so the closure may
        mutate while iterating (same guarantee the dict backend's
        sorted()-snapshot gave)."""
        ov_keys = sorted(k for k in self._overlay if k >= start)
        oi = 0
        for bk, bv in self._base_iter_from(start):
            while oi < len(ov_keys) and ov_keys[oi] < bk:
                k = ov_keys[oi]
                oi += 1
                v = self._overlay.get(k, _TOMBSTONE)
                if v is not _TOMBSTONE:
                    yield k, v  # type: ignore[misc]
            if oi < len(ov_keys) and ov_keys[oi] == bk:
                k = ov_keys[oi]
                oi += 1
                v = self._overlay.get(k, _TOMBSTONE)
                if v is not _TOMBSTONE:
                    yield k, v  # type: ignore[misc]
                continue  # overlay shadows (or tombstones) the base entry
            yield bk, bv
        while oi < len(ov_keys):
            k = ov_keys[oi]
            oi += 1
            v = self._overlay.get(k, _TOMBSTONE)
            if v is not _TOMBSTONE:
                yield k, v  # type: ignore[misc]

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        yield from self._iter_from(b"")

    def for_each(self, fn: Callable[[bytes, bytes], "bool | None"]) -> None:
        for k, v in self.items():
            if fn(k, v) is False:
                return

    def prefix_scan(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        for k, v in self._iter_from(prefix):
            if not k.startswith(prefix):
                return
            yield k, v

    def range_scan(self, start: bytes, end: bytes) -> Iterator[Tuple[bytes, bytes]]:
        for k, v in self._iter_from(start):
            if k > end:
                return
            yield k, v

    def __len__(self) -> int:
        n = self._base_len()
        for k, v in self._overlay.items():
            in_base = self._base_get(k) is not None
            if v is _TOMBSTONE:
                n -= 1 if in_base else 0
            elif not in_base:
                n += 1
        return n


class WriteTxn:
    """BucketManager handed to write closures: stages everything.

    ``apply(apply_fn)`` replays the staged state through backend-specific
    callbacks after the closure succeeds.
    """

    def __init__(self, base_bucket_factory, base_bucket_names):
        # base_bucket_factory(name) -> (get, iter_from, len) over base state
        self._factory = base_bucket_factory
        self._base_names = base_bucket_names
        self._overlays: Dict[str, Dict[bytes, object]] = {}
        self._deleted_buckets: set[str] = set()
        self._read_only = False

    def get(self, name: str) -> OverlayBucket:
        ov = self._overlays.setdefault(name, {})
        if name in self._deleted_buckets:
            # recreated after delete within the txn: base is invisible
            return OverlayBucket(lambda k: None, lambda s: iter(()), lambda: 0, ov)
        g, it, ln = self._factory(name)
        return OverlayBucket(g, it, ln, ov)

    def delete(self, name: str) -> None:
        self._deleted_buckets.add(name)
        self._overlays.pop(name, None)

    def bucket_names(self):
        names = [n for n in self._base_names() if n not in self._deleted_buckets]
        for n, ov in self._overlays.items():
            if n not in names and any(v is not _TOMBSTONE for v in ov.values()):
                names.append(n)
        return names

    @property
    def touched_buckets(self) -> set:
        return set(self._overlays) | self._deleted_buckets

    def apply(self, delete_bucket, put, delete_key) -> None:
        for name in self._deleted_buckets:
            delete_bucket(name)
        for name, ov in self._overlays.items():
            for k, v in ov.items():
                if v is _TOMBSTONE:
                    delete_key(name, k)
                else:
                    put(name, k, v)
