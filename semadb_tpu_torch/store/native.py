"""ctypes bindings for the native C++ KV store engine (``csrc/kvstore.cpp``).

Provides ``NativeDiskStore`` with the same transactional interface as the
Python :class:`~semadb_tpu_torch.store.diskstore.DiskStore` (read/write
closures over a BucketManager), backed by the append-log engine: writes are
O(delta) log appends instead of whole-store snapshots, reads come from
native ordered maps, and compaction/backup produce the same single portable
file the cluster sync ships around.

The engine is ``native/kvstore.cpp`` of the JAX package, copied byte for
byte, so a store file written by either package opens in the other. It is
built at first use with ``g++`` and the flags of ``native/Makefile`` into
``semadb_tpu_torch/_build/`` (:func:`semadb_tpu_torch.utils.build.build_library`).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Callable, Iterator, Optional, Tuple

from semadb_tpu_torch.utils.build import CSRC_DIR, build_library

_LIB = None
_LIB_LOCK = threading.Lock()

SOURCE = os.path.join(CSRC_DIR, "kvstore.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]


def load_library():
    """Load (building if necessary) the native engine; None if unavailable."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        try:
            path, _ = build_library("kvstore", SOURCE, "g++", CXX_FLAGS)
        except (OSError, RuntimeError):
            return None
        lib = ctypes.CDLL(path)
        lib.sdb_open.restype = ctypes.c_void_p
        lib.sdb_open.argtypes = [ctypes.c_char_p]
        lib.sdb_close.argtypes = [ctypes.c_void_p]
        lib.sdb_put.restype = ctypes.c_int
        lib.sdb_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.sdb_delete.restype = ctypes.c_int
        lib.sdb_delete.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.sdb_get.restype = ctypes.c_int64
        lib.sdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.sdb_free.restype = None
        lib.sdb_free.argtypes = [ctypes.c_void_p]
        lib.sdb_multi_get.restype = ctypes.c_int64
        lib.sdb_multi_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sdb_commit.argtypes = [ctypes.c_void_p]
        lib.sdb_compact.restype = ctypes.c_int
        lib.sdb_compact.argtypes = [ctypes.c_void_p]
        lib.sdb_dirty_ops.restype = ctypes.c_uint64
        lib.sdb_dirty_ops.argtypes = [ctypes.c_void_p]
        lib.sdb_backup.restype = ctypes.c_int
        lib.sdb_backup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sdb_delete_bucket.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sdb_cursor.restype = ctypes.c_void_p
        lib.sdb_cursor.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.sdb_cursor_next.restype = ctypes.c_int
        lib.sdb_cursor_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.sdb_cursor_free.argtypes = [ctypes.c_void_p]
        lib.sdb_bucket_count.restype = ctypes.c_uint64
        lib.sdb_bucket_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sdb_bucket_names.restype = ctypes.c_uint64
        lib.sdb_bucket_names.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64
        ]
        _LIB = lib
        return _LIB


COMPACT_THRESHOLD = 100_000  # log records before auto-compaction


class NativeBucket:
    """Bucket view with the same surface as diskstore.Bucket."""

    def __init__(self, store: "NativeDiskStore", name: str, read_only: bool):
        self._s = store
        self._name = name.encode()
        self._read_only = read_only

    def get(self, key: bytes) -> Optional[bytes]:
        # sdb_get copies the value under the store mutex into a malloc'd
        # buffer we own (and must free) — safe vs concurrent writers.
        out = ctypes.c_void_p()
        n = self._s.lib.sdb_get(self._s.handle, self._name, key, len(key), ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._s.lib.sdb_free(out)

    def multi_get(self, keys) -> list:
        """Batched get: ONE C call (and one store-mutex acquisition) for
        many same-length keys — the search backfill reads 2 keys per
        result x thousands of results per batch, where per-call ctypes
        overhead dominates (measured ~10us/get on the 1-vCPU host)."""
        if not keys:
            return []
        klen = len(keys[0])
        if any(len(k) != klen for k in keys):
            return [self.get(k) for k in keys]
        lens = (ctypes.c_int64 * len(keys))()
        out = ctypes.c_void_p()
        total = self._s.lib.sdb_multi_get(
            self._s.handle, self._name, b"".join(keys), klen, len(keys),
            ctypes.byref(out), lens,
        )
        if total < 0:
            raise MemoryError("sdb_multi_get allocation failed")
        try:
            raw = ctypes.string_at(out, total)
        finally:
            self._s.lib.sdb_free(out)
        vals, off = [], 0
        for n in lens:
            if n < 0:
                vals.append(None)
            else:
                vals.append(raw[off : off + n])
                off += n
        return vals

    def put(self, key: bytes, value: bytes) -> None:
        if self._read_only:
            raise RuntimeError("bucket is read-only")
        self._s.lib.sdb_put(self._s.handle, self._name, key, len(key), value, len(value))

    def delete(self, key: bytes) -> None:
        if self._read_only:
            raise RuntimeError("bucket is read-only")
        self._s.lib.sdb_delete(self._s.handle, self._name, key, len(key))

    def _iter_from(self, start: bytes) -> Iterator[Tuple[bytes, bytes]]:
        lib = self._s.lib
        cur = lib.sdb_cursor(self._s.handle, self._name, start, len(start))
        if not cur:
            return
        try:
            k = ctypes.c_char_p()
            kl = ctypes.c_uint32()
            v = ctypes.c_char_p()
            vl = ctypes.c_uint32()
            while lib.sdb_cursor_next(cur, ctypes.byref(k), ctypes.byref(kl),
                                      ctypes.byref(v), ctypes.byref(vl)):
                yield ctypes.string_at(k, kl.value), ctypes.string_at(v, vl.value)
        finally:
            lib.sdb_cursor_free(cur)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        yield from self._iter_from(b"")

    def for_each(self, fn: Callable[[bytes, bytes], bool | None]) -> None:
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
        return int(self._s.lib.sdb_bucket_count(self._s.handle, self._name))


class NativeBucketManager:
    def __init__(self, store: "NativeDiskStore", read_only: bool):
        self._s = store
        self._read_only = read_only

    def get(self, name: str) -> NativeBucket:
        return NativeBucket(self._s, name, self._read_only)

    def delete(self, name: str) -> None:
        if self._read_only:
            raise RuntimeError("read-only transaction")
        self._s.lib.sdb_delete_bucket(self._s.handle, name.encode())

    def bucket_names(self):
        n = self._s.lib.sdb_bucket_names(self._s.handle, None, 0)
        buf = ctypes.create_string_buffer(int(n))
        self._s.lib.sdb_bucket_names(self._s.handle, buf, n)
        raw = buf.raw[: int(n)].decode()
        return [x for x in raw.split("\n") if x]


class NativeDiskStore:
    """Transactional store backed by the C++ engine."""

    def __init__(self, path: str = ""):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native kv engine unavailable (build failed)")
        self.path = path
        self.handle = self.lib.sdb_open(path.encode() if path else b"")
        if not self.handle:
            raise ValueError(f"could not open native store: {path}")
        self._write_lock = threading.Lock()

    def read(self, fn):
        return fn(NativeBucketManager(self, read_only=True))

    def write(self, fn):
        """Atomic write txn: mutations stage in a Python-side overlay and
        replay into the WAL engine only after the closure succeeds — an
        exception rolls back with no partial appends (bbolt txn parity)."""
        from semadb_tpu_torch.store.overlay import WriteTxn

        with self._write_lock:

            def factory(name: str):
                base = NativeBucket(self, name, read_only=True)
                return base.get, base._iter_from, base.__len__

            mgr = NativeBucketManager(self, read_only=True)
            txn = WriteTxn(factory, mgr.bucket_names)
            out = fn(txn)
            txn.apply(
                delete_bucket=lambda n: self.lib.sdb_delete_bucket(
                    self.handle, n.encode()
                ),
                put=lambda n, k, v: self.lib.sdb_put(
                    self.handle, n.encode(), k, len(k), v, len(v)
                ),
                delete_key=lambda n, k: self.lib.sdb_delete(
                    self.handle, n.encode(), k, len(k)
                ),
            )
            self.lib.sdb_commit(self.handle)
            if self.path and self.lib.sdb_dirty_ops(self.handle) > COMPACT_THRESHOLD:
                self.lib.sdb_compact(self.handle)
            return out

    def backup_to_file(self, dest: str) -> None:
        if self.lib.sdb_backup(self.handle, dest.encode()) != 0:
            raise IOError(f"backup failed: {dest}")

    def compact(self) -> None:
        self.lib.sdb_compact(self.handle)

    def close(self) -> None:
        if self.handle:
            # Compact on close so the on-disk file is a clean snapshot
            if self.path:
                self.lib.sdb_compact(self.handle)
            self.lib.sdb_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
