"""Key-value disk store abstraction: transactions over named buckets.

Parity reference: diskstore/ (diskstore.go Read/Write txn closures over a
BucketManager; bbolt.go file backend with a single writer and many readers;
memstore.go map backend selected by empty path). The Python file backend
snapshots all buckets to one file with an atomic rename on write-commit —
the same "one portable file per shard" property the cluster sync relies on
(cluster/sync.go ships whole shard files). A C++ mmap backend can slot in
behind the same interface (store/native.py).
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import msgpack


class Bucket:
    """Ordered byte-key bucket (diskstore.go:45-65 Bucket interface).

    ``sorted_keys`` (optional) supplies a cached sorted key list so ordered
    scans seek with bisect instead of re-sorting the whole dict — the
    in-memory analog of bbolt's B+tree cursors.
    """

    def __init__(
        self,
        data: Optional[Dict[bytes, bytes]] = None,
        read_only: bool = False,
        sorted_keys: Optional[Callable[[], List[bytes]]] = None,
    ):
        self._data: Dict[bytes, bytes] = data if data is not None else {}
        self._read_only = read_only
        self._sorted_keys = sorted_keys

    def _keys(self) -> List[bytes]:
        if self._sorted_keys is not None:
            return self._sorted_keys()
        return sorted(self._data)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def multi_get(self, keys) -> list:
        """Batched get (native backend does this in one C call)."""
        g = self._data.get
        return [g(k) for k in keys]

    def put(self, key: bytes, value: bytes) -> None:
        if self._read_only:
            raise RuntimeError("bucket is read-only")
        self._data[key] = value

    def delete(self, key: bytes) -> None:
        if self._read_only:
            raise RuntimeError("bucket is read-only")
        self._data.pop(key, None)

    def for_each(self, fn: Callable[[bytes, bytes], bool | None]) -> None:
        """Iterate in key order; fn returning False stops early."""
        for k in self._keys():
            if fn(k, self._data[k]) is False:
                return

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for k in self._keys():
            yield k, self._data[k]

    def iter_from(self, start: bytes) -> Iterator[Tuple[bytes, bytes]]:
        keys = self._keys()
        for i in range(bisect.bisect_left(keys, start), len(keys)):
            yield keys[i], self._data[keys[i]]

    def prefix_scan(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        for k, v in self.iter_from(prefix):
            if not k.startswith(prefix):
                return
            yield k, v

    def range_scan(self, start: bytes, end: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Keys in [start, end] inclusive (inverted.go range semantics)."""
        for k, v in self.iter_from(start):
            if k > end:
                return
            yield k, v

    def __len__(self) -> int:
        return len(self._data)


class BucketManager:
    """Named-bucket accessor handed to transaction closures."""

    def __init__(
        self,
        buckets: Dict[str, Dict[bytes, bytes]],
        read_only: bool,
        store: Optional["DiskStore"] = None,
    ):
        self._buckets = buckets
        self._read_only = read_only
        self._store = store

    def get(self, name: str) -> Bucket:
        if name not in self._buckets:
            if self._read_only:
                # Read-only txns get an empty throwaway bucket (bbolt returns
                # bucket-not-found; the reference's callers treat it as empty)
                return Bucket({}, read_only=True)
            self._buckets[name] = {}
        sk = None
        if self._store is not None:
            sk = lambda n=name: self._store._sorted_keys(n)
        return Bucket(self._buckets[name], read_only=self._read_only, sorted_keys=sk)

    def delete(self, name: str) -> None:
        if self._read_only:
            raise RuntimeError("read-only transaction")
        self._buckets.pop(name, None)

    def bucket_names(self):
        return list(self._buckets.keys())


class DiskStore:
    """Single-writer transactional store over named buckets.

    ``path == ""`` → pure in-memory (memstore.go); otherwise file-backed
    with load-on-open and atomic snapshot-on-commit.
    """

    MAGIC = b"SDBT1"

    def __init__(self, path: str = ""):
        self.path = path
        self._buckets: Dict[str, Dict[bytes, bytes]] = {}
        self._key_cache: Dict[str, List[bytes]] = {}  # per-bucket sorted keys
        self._write_lock = threading.Lock()
        if path and os.path.exists(path):
            self._load()

    def _sorted_keys(self, name: str) -> List[bytes]:
        keys = self._key_cache.get(name)
        if keys is None:
            keys = sorted(self._buckets.get(name, ()))
            self._key_cache[name] = keys
        return keys

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        with open(self.path, "rb") as f:
            blob = f.read()
        if not blob:
            return
        if not blob.startswith(self.MAGIC):
            raise ValueError(f"not a semadb store file: {self.path}")
        raw = msgpack.unpackb(blob[len(self.MAGIC):], raw=True, strict_map_key=False)
        self._buckets = {
            name.decode() if isinstance(name, bytes) else name: dict(kv)
            for name, kv in raw.items()
        }

    def _flush(self) -> None:
        if not self.path:
            return
        blob = self.MAGIC + msgpack.packb(self._buckets, use_bin_type=True)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- transactions ------------------------------------------------------
    def read(self, fn: Callable[[BucketManager], None]):
        return fn(BucketManager(self._buckets, read_only=True, store=self))

    def write(self, fn: Callable[[BucketManager], None]):
        """Atomic write txn (diskstore.go:45-95 / bbolt rollback semantics):
        the closure stages all mutations in an overlay; an exception
        discards them, leaving memory AND disk state untouched."""
        from semadb_tpu_torch.store.overlay import WriteTxn

        with self._write_lock:

            def factory(name: str):
                data = self._buckets.get(name, {})
                base = Bucket(
                    data, read_only=True, sorted_keys=lambda n=name: self._sorted_keys(n)
                )
                return base.get, base.iter_from, base.__len__

            txn = WriteTxn(factory, lambda: list(self._buckets.keys()))
            out = fn(txn)
            txn.apply(
                delete_bucket=lambda n: self._buckets.pop(n, None),
                put=lambda n, k, v: self._buckets.setdefault(n, {}).__setitem__(k, v),
                delete_key=lambda n, k: self._buckets.get(n, {}).pop(k, None),
            )
            for n in txn.touched_buckets:
                self._key_cache.pop(n, None)
            self._flush()
            return out

    def backup_to_file(self, dest: str) -> None:
        """bbolt.BackupToFile analog: atomic full snapshot copy."""
        blob = self.MAGIC + msgpack.packb(self._buckets, use_bin_type=True)
        tmp = dest + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, dest)

    def close(self) -> None:
        self._flush()


def open_store(path: str = "", backend: str = "auto"):
    """diskstore.Open parity: empty path → in-memory map backend
    (memstore.go); file path → the native C++ append-log engine when
    available (bbolt.go's role), falling back to the Python snapshot store.

    Existing files are dispatched by magic so either backend's files open
    correctly.
    """
    if backend == "python" or not path:
        return DiskStore(path)
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            magic = f.read(5)
        if magic == DiskStore.MAGIC:
            return DiskStore(path)
    if backend in ("auto", "native"):
        try:
            from semadb_tpu_torch.store.native import NativeDiskStore

            return NativeDiskStore(path)
        except Exception:
            if backend == "native":
                raise
    return DiskStore(path)
