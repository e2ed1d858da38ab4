"""Dump a Vamana graph's edges as CSV for inspection.

Parity reference: internal/dumpGraph.go (dumpGraph.go:31-50) — one line per
node: ``nodeId,edge1,edge2,...``.

Usage: python -m semadb_tpu.tools.dumpgraph <sharddb-file> <property> [out.csv]
"""

from __future__ import annotations

import sys

import numpy as np

from semadb_tpu_torch.index.manager import IndexManager
from semadb_tpu_torch.shard import snapshot as snap
from semadb_tpu_torch.shard.shard import _unpack_arrays
from semadb_tpu_torch.store.diskstore import open_store


def dump_graph(store_path: str, prop: str, out_path: str = "") -> int:
    store = open_store(store_path)
    name = IndexManager.bucket_name("vectorVamana", prop)
    rows = []

    def reader(bm):
        bucket = bm.get(name)
        # Chunked incremental snapshot (current format), falling back to
        # the legacy single-blob `_deviceState` key for old shard files.
        arrays = snap.read_snapshot(bucket)
        if arrays is None:
            raw = bucket.get(b"_deviceState")
            if raw is None:
                raise SystemExit(
                    f"no vamana state for property {prop} in {store_path}"
                )
            arrays = _unpack_arrays(raw)
        adj = arrays["adjacency"]
        exists = arrays["exists"]
        for nid in np.nonzero(exists)[0]:
            edges = adj[nid]
            edges = edges[edges >= 0]
            rows.append(f"{nid}," + ",".join(str(int(e)) for e in edges))

    store.read(reader)
    text = "\n".join(rows) + "\n"
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return len(rows)


if __name__ == "__main__":
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    n = dump_graph(sys.argv[1], sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "")
    print(f"dumped {n} nodes", file=sys.stderr)
