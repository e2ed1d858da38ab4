"""Where the slice's time goes on one CUDA card, layer by layer.

Serves the slice's deployment (:mod:`semadb_tpu_torch.tools.dbpedia_bq`:
100,000 × 1536-d points, binary quantizer, ``config/singleServer.yaml``)
with the port on ``cuda``, then measures:

- the ingest split: the first 1,000 points over HTTP JSON, then
  ``Point.from_map`` and ``ClusterNode.insert_points`` for the rest;
- the p50 over 30 queries (host wall clock, after a warm-up) of one query
  at each layer, from the HTTP client down to the kernel: an HTTP single
  search; ``ClusterNode.search_points_batch_wire``; the largest shard's
  ``Shard.search_points_batch_wire``; its ``IndexFlat.search_batch`` (B=1,
  readback included); ``VectorStore.scan_distances`` plus a synchronize;
  and the client's ``json.dumps`` of one search body;
- under ``torch.profiler``, 10 HTTP single searches: the device's busy
  share (the sum of device-side event times over the wall time), the
  ``cudaLaunchKernel`` calls, K1's device time per launch and the device
  time by kernel.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m semadb_tpu_torch.tools.profile_slice [--seed 0]

It prints one line per measurement and, last, one JSON object with all of
them. It exits non-zero without a CUDA device or when the profiler records
no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from semadb_tpu_torch.models import SearchRequest
from semadb_tpu_torch.ops.kernels import hamming
from semadb_tpu_torch.tools import dbpedia_bq as bq

LIMIT = 10
RUNS = 30
PROFILED_SEARCHES = 10
K1_KERNEL = "bit_distance_kernel"  # the name nvcc gives K1's template instances contains this


def log(*parts) -> None:
    print(*parts, flush=True)


def p50_ms(fn, args_list) -> float:
    """Median host wall time of ``fn(a)`` over ``args_list``, after one warm-up call."""
    fn(args_list[0])
    times = []
    for a in args_list:
        t0 = time.perf_counter()
        fn(a)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def layer_times(srv: bq.Server, queries: np.ndarray) -> dict:
    col = srv.collection()
    bodies = [bq.search_body(q, LIMIT) for q in queries]
    requests = [SearchRequest.from_dict(b) for b in bodies]
    largest_sid, largest = max(zip(col.shard_ids, srv.shard_indices()), key=lambda p: len(p[1]))
    qt = [torch.from_numpy(q[None, :]).to(srv.device) for q in queries]

    def shard_search(sr):
        return srv.node.shard_manager.do_with_shard(
            col, largest_sid, lambda s: s.search_points_batch_wire([sr]))

    def scan(q):
        largest.store.scan_distances(q, largest.vectors, largest.exists)
        torch.cuda.synchronize(srv.device)

    search_path = f"/{bq.COLLECTION}/points/search"
    return {
        "http_search": p50_ms(lambda b: bq.http_json(srv.base, "POST", search_path, b), bodies),
        "node_search_points_batch_wire": p50_ms(
            lambda sr: srv.node.search_points_batch_wire(col, [sr]), requests),
        "shard_search_points_batch_wire": p50_ms(shard_search, requests),
        "index_flat_search_batch_b1": p50_ms(lambda q: largest.search_batch(q, LIMIT), list(queries)),
        "scan_distances_b1": p50_ms(scan, qt),
        "client_json_dumps": p50_ms(json.dumps, bodies),
        "shards": len(col.shard_ids),
        "largest_shard_points": int(largest.exists.sum().item()),
        "largest_shard_capacity": largest.capacity,
    }


def device_profile(srv: bq.Server, queries: np.ndarray) -> dict:
    """Profile ``PROFILED_SEARCHES`` HTTP single searches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bodies = [bq.search_body(q, LIMIT) for q in queries[:PROFILED_SEARCHES]]
    search_path = f"/{bq.COLLECTION}/points/search"
    torch.cuda.synchronize(srv.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in bodies:
            bq.http_json(srv.base, "POST", search_path, b)
        torch.cuda.synchronize(srv.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    k1 = [e for e in dev if K1_KERNEL in e.key]
    k1_launches = sum(e.count for e in k1)
    if k1_launches == 0:
        raise RuntimeError("the profiled searches launched no K1 kernel")
    return {
        "searches": len(bodies),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "cuda_launch_kernel_calls": sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")),
        "k1_launches": k1_launches,
        "k1_device_ms_per_launch": sum(e.self_device_time_total for e in k1) / 1e3 / k1_launches,
        "device_ms_by_kernel": [
            {"name": e.key[:80], "calls": e.count, "ms": e.self_device_time_total / 1e3,
             "share": e.self_device_time_total / 1e3 / busy_ms}
            for e in dev[:8]
        ],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; this profile runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    hamming._library()
    queries = bq.queries(args.seed, RUNS)
    with tempfile.TemporaryDirectory(prefix="semadb_profile_") as root:
        with bq.serving(bq.slice_config(root), device) as srv:
            data = bq.load(srv, args.seed, bq.N_POINTS)
            ingest = {
                "points": bq.N_POINTS, "seconds": data.seconds, "points_per_s": data.rate,
                "http_points": bq.HTTP_POINTS, "http_seconds": data.http_seconds,
                "point_from_map_seconds": data.encode_seconds,
                "node_insert_points_seconds": data.insert_seconds,
                "shard_counts": sorted(data.shard_counts),
            }
            log(f"[ingest] {json.dumps(ingest)}")
            layers = layer_times(srv, queries)
            for k, v in layers.items():
                log(f"[layer] {k}: {v:.4f} ms p50" if isinstance(v, float) else f"[layer] {k}: {v}")
            prof = device_profile(srv, queries)
            log(f"[profile] {PROFILED_SEARCHES} HTTP searches: device busy {prof['device_busy_ms']:.3f} ms "
                f"of {prof['wall_ms']:.1f} ms wall ({prof['device_busy_share']:.2%}); "
                f"{prof['cuda_launch_kernel_calls']} cudaLaunchKernel calls; K1 "
                f"{prof['k1_device_ms_per_launch']:.4f} ms per launch over {prof['k1_launches']} launches")
            for e in prof["device_ms_by_kernel"]:
                log(f"[profile]   {e['share']:6.1%} {e['ms']:.3f} ms {e['calls']:5d}x {e['name']}")
    print(json.dumps({"card": smi, "ingest": ingest, "layers_p50_ms": layers, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
