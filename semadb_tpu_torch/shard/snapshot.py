"""Chunked device-state snapshots.

Port of ``semadb_tpu/shard/snapshot.py``; the on-disk format is the same, so
shard files written by either package open in the other. Layout per index
bucket:

  ``_dsMeta``                      msgpack: { "v": 1,
                                     "arrays": {path: {dtype, shape, chunk}},
                                     "small":  {path: packed small values} }
  ``_dsChunk/<path>/<8B BE idx>``  raw bytes of rows [idx*chunk, ...)

Arrays are flattened to "/"-joined paths (the nested ``store`` dict becomes
``store/codes`` etc.) and chunked along axis 0 into ~4 MiB pieces. An engine
with a dirty-row tracker (``utils/dirty.DirtyTracker``: the Vamana, IVF and
fused indices) has only its dirty chunks read back and rewritten, as the JAX
package's writer does; an engine without one (the flat index), or whose
tracker says "everything", gets every chunk of its used rows. Rows
past the engine's ``snapshot_row_bounds`` are never copied off the device.
The engine hands over tensors (``device_arrays``, read under its
``_write_lock`` when it has one); their dtype names in the meta are numpy's,
so a uint32 view of the codes is recorded as ``uint32`` as the JAX package
records it. The IVF index hands over no slabs: they are derived state, which
its ``from_arrays`` rebuilds from ``vectors``; an IVF-PQ index hands over its
u8 ``slab_codes`` and ``ovf_codes`` and its ``pq_codebook`` (with the shrunk
f32 placeholders), as the JAX package's does.

Invariants:
  - the store write txn is atomic (overlay rollback), so a crashed flush
    leaves the PREVIOUS meta + chunks + journal intact;
  - shape, dtype and chunk changes rewrite that array in full; chunk keys
    past the new grid, and those of arrays that vanished, are deleted.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import msgpack
import numpy as np
import torch

from semadb_tpu_torch.utils.dirty import ALL

_CLEAN = object()  # sentinel: an array with no marks at all
DS_META_KEY = b"_dsMeta"
DS_CHUNK_PREFIX = b"_dsChunk/"
LEGACY_STATE_KEY = b"_deviceState"
CHUNK_TARGET_BYTES = 1 << 22  # ~4 MiB per chunk
SMALL_MAX_BYTES = 1 << 16  # arrays up to 64 KiB ride in the meta blob

SEP = "/"


def _flatten(d: dict, prefix: str = "", out: Optional[dict] = None) -> dict:
    out = {} if out is None else out
    for k, v in d.items():
        assert SEP not in str(k), f"array name may not contain '{SEP}': {k}"
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, path + SEP, out)
        else:
            out[path] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        parts = path.split(SEP)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _chunk_rows(shape: tuple, dtype: np.dtype) -> int:
    row_bytes = int(np.dtype(dtype).itemsize) * int(np.prod(shape[1:], dtype=np.int64))
    return max(1, CHUNK_TARGET_BYTES // max(row_bytes, 1))


def _n_chunks(n_rows: int, chunk: int) -> int:
    return max(1, -(-n_rows // chunk)) if n_rows else 0


def _chunk_key(path: str, idx: int) -> bytes:
    return DS_CHUNK_PREFIX + path.encode() + b"/" + int(idx).to_bytes(8, "big")


def _is_arraylike(v) -> bool:
    return hasattr(v, "shape") and hasattr(v, "dtype")


def _np_dtype(arr) -> np.dtype:
    """numpy dtype of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        return torch.empty(0, dtype=arr.dtype).numpy().dtype
    return np.dtype(arr.dtype)


def _to_host(arr) -> np.ndarray:
    """numpy copy of a tensor (from any device) or a numpy array. uint32
    tensors cross as int32 and are viewed back: the same bits."""
    if not isinstance(arr, torch.Tensor):
        return np.asarray(arr)
    if arr.dtype == torch.uint32:
        return arr.view(torch.int32).cpu().numpy().view(np.uint32)
    return arr.cpu().numpy()


def _pack_small(small: dict) -> dict:
    def enc(v):
        if _is_arraylike(v):
            a = _to_host(v)
            return {
                b"__nd": True, b"dtype": str(a.dtype),
                b"shape": list(a.shape), b"data": a.tobytes(),
            }
        return v

    return {k: enc(v) for k, v in small.items()}


def _unpack_small(small: dict) -> dict:
    def dec(v):
        if isinstance(v, dict) and (v.get(b"__nd") or v.get("__nd")):
            dtype = v.get(b"dtype", v.get("dtype"))
            shape = v.get(b"shape", v.get("shape"))
            data = v.get(b"data", v.get("data"))
            return np.frombuffer(data, np.dtype(dtype)).reshape(shape).copy()
        return v

    return {k: dec(v) for k, v in small.items()}


def _read_rows(arr, n_rows: int) -> np.ndarray:
    """Host copy of rows [0, n_rows) of ``arr`` (tensor or numpy), read back
    in ≤256 MiB contiguous slices so the transfer buffers stay bounded."""
    if isinstance(arr, np.ndarray):
        return arr[:n_rows]
    dtype = _np_dtype(arr)
    row_bytes = int(dtype.itemsize) * int(np.prod(arr.shape[1:], dtype=np.int64))
    blk_rows = max(1, (1 << 28) // max(row_bytes, 1))
    host = np.empty((n_rows,) + tuple(arr.shape[1:]), dtype)
    for lo in range(0, n_rows, blk_rows):
        hi = min(lo + blk_rows, n_rows)
        host[lo:hi] = _to_host(arr[lo:hi])
    return host


def _fetch_chunks(arr, chunks: np.ndarray, chunk: int, n_rows: int) -> list:
    """Host copies of the given chunk indices of ``arr`` (tensor or numpy):
    past half the grid one blocked readback of the used rows, else one
    gather of the chunks' rows (in ≤256 MiB batches)."""
    if len(chunks) == 0:
        return []
    if isinstance(arr, np.ndarray) or len(chunks) * 2 >= _n_chunks(n_rows, chunk):
        host = _read_rows(arr, n_rows)
        return [host[c * chunk : min((c + 1) * chunk, n_rows)] for c in chunks]
    rows = np.concatenate([np.arange(c * chunk, min((c + 1) * chunk, n_rows)) for c in chunks])
    row_bytes = int(_np_dtype(arr).itemsize) * int(np.prod(arr.shape[1:], dtype=np.int64))
    batch_rows = max(1, (1 << 28) // max(row_bytes, 1))
    parts = [
        _to_host(arr[torch.as_tensor(rows[lo : lo + batch_rows], device=arr.device)])
        for lo in range(0, len(rows), batch_rows)
    ]
    gathered = parts[0] if len(parts) == 1 else np.concatenate(parts)
    out, off = [], 0
    for c in chunks:
        ln = min((c + 1) * chunk, n_rows) - c * chunk
        out.append(gathered[off : off + ln])
        off += ln
    return out


def write_snapshot(bucket, idx) -> int:
    """Persist ``idx``'s device state into ``bucket``. Must run inside a
    store write txn. Returns the number of chunk records written. Drains the
    engine's dirty tracker; the caller re-marks ``everything()`` if the
    surrounding txn later fails (the rollback discards these puts)."""
    # Writers are excluded while the arrays are read, so the cut is
    # consistent (IndexIVF also materialises deferred-fit placeholders here)
    with getattr(idx, "_write_lock", None) or contextlib.nullcontext():
        # The arrays first: handing them over may refit (placeholders) or
        # redo the fused centroid surgery, which marks the tracker
        arrays = _flatten(idx.device_arrays())
        tracker = getattr(idx, "dirty", None)
        if tracker is not None:
            everything, marks = tracker.collect()
            tracker.clear()
        else:
            everything, marks = True, {}
        return _write_arrays(bucket, arrays, idx, everything, marks)


def _write_arrays(bucket, arrays: dict, idx, everything: bool, marks: dict) -> int:
    # Row bounds: engines whose big arrays are capacity-padded report the
    # USED row count per path — chunks past it are never written (or read
    # back), so the zero-padded tail of a grown array stays on the device.
    bounds_fn = getattr(idx, "snapshot_row_bounds", None)
    bounds = bounds_fn() if bounds_fn is not None else {}

    raw_meta = bucket.get(DS_META_KEY)
    prev = (
        msgpack.unpackb(raw_meta, raw=False, strict_map_key=False)
        if raw_meta is not None
        else {"arrays": {}, "small": {}}
    )
    prev_arrays = prev.get("arrays", {})

    meta_arrays: Dict[str, dict] = {}
    small: Dict[str, object] = {}
    written = 0
    for path, arr in arrays.items():
        if not _is_arraylike(arr) or len(getattr(arr, "shape", ())) == 0:
            small[path] = arr
            continue
        shape = tuple(int(s) for s in arr.shape)
        n_rows = max(0, min(int(bounds.get(path, shape[0])), shape[0]))
        dtype = _np_dtype(arr)
        nbytes = int(dtype.itemsize) * int(np.prod((n_rows,) + shape[1:], dtype=np.int64))
        if nbytes <= SMALL_MAX_BYTES:
            small[path] = _to_host(arr[:n_rows] if n_rows < shape[0] else arr)
            continue
        chunk = _chunk_rows(shape, dtype)
        meta_arrays[path] = {"dtype": str(dtype), "shape": [n_rows, *shape[1:]], "chunk": chunk}
        p = prev_arrays.get(path)
        prev_rows = int(p.get("shape", [0])[0]) if p is not None else 0
        layout_ok = (
            p is not None
            and p.get("dtype") == str(dtype)
            and list(p.get("shape", []))[1:] == list(shape[1:])
            and p.get("chunk") == chunk
            and prev_rows <= n_rows  # row growth is compatible
        )
        n_total = _n_chunks(n_rows, chunk)
        mark = marks.get(path, _CLEAN)
        if everything or not layout_ok or mark is ALL:
            dirty = np.arange(n_total)
        elif mark is _CLEAN:
            dirty = np.empty(0, np.int64)  # a clean array keeps its chunks
        else:
            rows = mark[(mark >= 0) & (mark < n_rows)]
            dirty = np.unique(rows // chunk)
        if layout_ok and prev_rows < n_rows:
            # The previous last chunk may have been partial: rewrite it (and
            # everything after) so record lengths match the grid
            first_new = max(0, _n_chunks(prev_rows, chunk) - 1)
            dirty = np.union1d(dirty, np.arange(first_new, n_total))
        for blk, c in zip(_fetch_chunks(arr, dirty, chunk, n_rows), dirty):
            bucket.put(_chunk_key(path, int(c)), np.ascontiguousarray(blk).tobytes())
            written += 1
        # Stale chunks past the new grid (shape shrink or layout change)
        if p is not None:
            prev_total = _n_chunks(prev_rows, int(p.get("chunk", 1)))
            for c in range(n_total, prev_total):
                bucket.delete(_chunk_key(path, c))
    # Arrays that vanished since the last snapshot (or moved to small)
    for path, p in prev_arrays.items():
        if path in meta_arrays:
            continue
        for c in range(_n_chunks(int(p.get("shape", [0])[0]), int(p.get("chunk", 1)))):
            bucket.delete(_chunk_key(path, c))
    bucket.put(
        DS_META_KEY,
        msgpack.packb(
            {"v": 1, "arrays": meta_arrays, "small": _pack_small(small)},
            use_bin_type=True,
        ),
    )
    bucket.delete(LEGACY_STATE_KEY)
    return written


def read_snapshot(bucket) -> Optional[dict]:
    """Reconstruct the nested array dict from a chunked snapshot, or None
    when the bucket holds no ``_dsMeta`` (caller falls back to the legacy
    ``_deviceState`` blob)."""
    raw_meta = bucket.get(DS_META_KEY)
    if raw_meta is None:
        return None
    meta = msgpack.unpackb(raw_meta, raw=False, strict_map_key=False)
    flat: dict = dict(_unpack_small(meta.get("small", {})))
    for path, p in meta.get("arrays", {}).items():
        shape = tuple(int(s) for s in p["shape"])
        dtype = np.dtype(p["dtype"])
        chunk = int(p["chunk"])
        arr = np.empty(shape, dtype)
        for c in range(_n_chunks(shape[0], chunk)):
            raw = bucket.get(_chunk_key(path, c))
            if raw is None:
                raise ValueError(
                    f"snapshot corrupt: missing chunk {c} of {path}"
                )
            lo = c * chunk
            hi = min(lo + chunk, shape[0])
            arr[lo:hi] = np.frombuffer(raw, dtype).reshape((hi - lo,) + shape[1:])
        flat[path] = arr
    return _unflatten(flat)
