"""Store / collection migration tools.

Parity reference: internal/migratev1-v2 (store format migration). Two
migrations here:

  1. ``migrate_store``: convert a shard/node store file between the Python
     snapshot format (SDBT1) and the native C++ log format (SDBL1).
  2. ``migrate_v1_collection``: wrap a legacy v1 pure-vector collection
     (fixed "vector" vamana schema) into an explicit v2 index schema — the
     moral equivalent of the reference's v1→v2 point/schema migration.

Usage: python -m semadb_tpu.tools.migrate <src-store> <dest-store>
"""

from __future__ import annotations

import os
import sys

from semadb_tpu_torch.store.diskstore import DiskStore, open_store


def migrate_store(src_path: str, dest_path: str, dest_backend: str = "auto") -> int:
    """Copy every bucket/key from src to dest (format decided by backend).

    Returns number of keys copied.
    """
    src = open_store(src_path)
    if dest_backend == "python":
        dest = DiskStore(dest_path)
    else:
        from semadb_tpu_torch.store.native import NativeDiskStore

        dest = NativeDiskStore(dest_path)
    copied = 0

    def reader(bm):
        nonlocal copied
        names = bm.bucket_names()

        def writer(dbm):
            nonlocal copied
            for name in names:
                sb = bm.get(name)
                db = dbm.get(name)
                for k, v in sb.items():
                    db.put(k, v)
                    copied += 1

        dest.write(writer)

    src.read(reader)
    dest.close()
    src.close()
    return copied


def migrate_v1_collection(col_dict: dict) -> dict:
    """Rewrite a v1 collection record {vectorSize, distanceMetric} into a v2
    indexSchema record (httpapi/v1/handlers.go:545-556 wrap, made durable)."""
    if "indexSchema" in col_dict and col_dict["indexSchema"]:
        return col_dict  # already v2
    out = dict(col_dict)
    out["indexSchema"] = {
        "vector": {
            "type": "vectorVamana",
            "vectorVamana": {
                "vectorSize": col_dict["vectorSize"],
                "distanceMetric": col_dict["distanceMetric"],
                "searchSize": 75,
                "degreeBound": 64,
                "alpha": 1.2,
            },
        }
    }
    out.pop("vectorSize", None)
    out.pop("distanceMetric", None)
    return out


if __name__ == "__main__":
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    n = migrate_store(sys.argv[1], sys.argv[2])
    print(f"migrated {n} keys: {sys.argv[1]} -> {sys.argv[2]}", file=sys.stderr)
