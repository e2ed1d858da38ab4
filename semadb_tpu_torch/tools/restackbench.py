"""Measure the incremental against the full mesh restack on an IVF fleet.

Port of ``semadb_tpu/tools/restackbench.py``. The mesh serving path keeps a
copy of every shard's IVF arrays, one a slot of the shard mesh; after a
write to one shard, ``update_stacked_shard`` replaces that shard's copy
instead of rebuilding every shard's (``stack_ivf_states``). This tool builds
an 8-shard fleet and times both:

    python -m semadb_tpu_torch.tools.restackbench --n 1000000 --dim 128

Prints one JSON line with full_restack_s / incremental_s (seconds, one a
repeat). The mesh's slots are ``--shards`` slots on ``--device`` (cuda by
default), or with ``--spread`` the visible cards in turn. ``--data
embedding`` builds the fleet from ``embedding_like`` rows where the default
draws standard normal rows as the JAX tool does; ``main(argv, keep)`` hands
the fleet, the stack and the mesh to a caller in ``keep``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch


def main(argv=None, keep: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000, help="total points")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spread", action="store_true", help="slots over every visible card in turn")
    ap.add_argument("--data", choices=("normal", "embedding"), default="normal")
    ap.add_argument("--queries", type=int, default=0, help="queries kept beside an embedding fleet")
    args = ap.parse_args(argv)

    from semadb_tpu_torch.index.ivf import IndexIVF
    from semadb_tpu_torch.models.schema import VectorIVFParams
    from semadb_tpu_torch.parallel.fanout import (
        ivf_stack_geometry,
        pad_ivf_view,
        stack_ivf_states,
        update_stacked_shard,
    )
    from semadb_tpu_torch.parallel.mesh import shard_mesh

    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if args.spread:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        slots = [cards[s % len(cards)] for s in range(args.shards)]
    else:
        slots = [device] * args.shards
    mesh = shard_mesh(devices=slots)
    per = args.n // args.shards
    rng = np.random.default_rng(0)
    test = None
    if args.data == "embedding":
        from semadb_tpu_torch.tools.datasets import embedding_like

        ds = embedding_like(per * args.shards, args.dim, max(args.queries, 1), seed=0)
        corpus, test = ds.train, ds.test
    params = VectorIVFParams(vector_size=args.dim, distance_metric="euclidean", assign_copies=2)

    def sync():
        for dev in set(mesh.slots) | {device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    indices = []
    t0 = time.time()
    for s in range(args.shards):
        idx = IndexIVF(params, device)
        if args.data == "embedding":
            vecs = corpus[s * per : (s + 1) * per]
        else:
            vecs = rng.standard_normal((per, args.dim)).astype(np.float32)
        idx.insert_bulk(np.arange(2, per + 2, dtype=np.int64), vecs)
        idx.sync()
        indices.append(idx)
    build_s = time.time() - t0

    # Full restack: a copy of every shard's arrays on its slot
    fulls = []
    stacked = None
    for _ in range(args.repeat):
        sync()
        t0 = time.time()
        stacked = stack_ivf_states([i.capture_stack_view() for i in indices], mesh)
        sync()
        fulls.append(time.time() - t0)

    # One-shard write + the incremental update of that shard's copy
    geom = ivf_stack_geometry(indices)
    incs = []
    for r in range(args.repeat):
        v = rng.standard_normal(args.dim).astype(np.float32)
        indices[0].insert_update_delete([(per + 10 + r, v)])
        sync()
        t0 = time.time()
        view = pad_ivf_view(indices[0].capture_stack_view(), geom)
        stacked = update_stacked_shard(stacked, 0, view, mesh, copy=False)
        sync()
        incs.append(time.time() - t0)

    print(
        json.dumps(
            {
                "metric": f"restack{args.n // 1000}k_x{args.shards}",
                "build_s": round(build_s, 1),
                "full_restack_s": [round(x, 3) for x in fulls],
                "incremental_s": [round(x, 3) for x in incs],
                "speedup": round(min(fulls) / max(min(incs), 1e-9), 1),
                "platform": mesh.first.type,
            }
        )
    )
    if keep is not None:
        keep.update(indices=indices, stacked=stacked, mesh=mesh, test=test, build_s=build_s,
                    full_restack_s=fulls, incremental_s=incs)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
