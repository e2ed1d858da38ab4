"""ann-benchmarks-style harness driving the port's IVF index directly.

Port of ``semadb_tpu/tools/annbench.py`` for the IVF engine, the JAX
package's main bench path (``python bench.py`` with no environment runs it:
``BENCH_MODE=ivf``). Protocol as there: exact ground truth first, then the
build (``insert_bulk(defer_fit=True)`` → ``flush_pending``), a warm-up batch,
best-of-3 pipelined query passes (batches dispatched through
``utils.pipeline.AsyncDispatcher``, up to 8 in flight), recall@10, epsilon
recall and the dataset's margin. The Vamana engine is not ported yet.

Usage (the defaults are ``bench.py``'s: 1,000,000 x 128, 32,768 queries in
batches of 4,096, spread 0.5, euclidean, assignCopies 2, k = 10):

    python3 -m semadb_tpu_torch.tools.annbench [--device cuda] [--n 1000000] ...

It prints one JSON line: ``qps``, ``recall@10``, ``build_s`` and its split
(upload, k-means, packing, slab build), ``peak_mem_gib``, the device and, on
a CUDA device, the card's name and power limit and one ``torch.profiler``
pass over one batch (device time by kernel and op, busy share, launches).
A ``cuda`` run without a CUDA device is an error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from semadb_tpu_torch.models.schema import VectorIVFParams
from semadb_tpu_torch.tools.datasets import (
    AnnDataset,
    compute_ground_truth,
    compute_ground_truth_device,
    embedding_like,
)
from semadb_tpu_torch.utils.pipeline import AsyncDispatcher


class AnnBench:
    """init/fit/query protocol over one index (the JAX tool's ``VamanaBench``
    with ``engine="ivf"``)."""

    def __init__(self, dim: int, device, metric: str = "euclidean", engine: str = "ivf",
                 assign_copies: int = 2):
        if engine != "ivf":
            raise NotImplementedError(f"engine {engine!r}: the Vamana engine is not ported to semadb_tpu_torch yet")
        from semadb_tpu_torch.index.ivf import IndexIVF

        self.device = torch.device(device)
        self.index = IndexIVF(
            VectorIVFParams(vector_size=dim, distance_metric=metric, assign_copies=assign_copies),
            self.device,
        )

    def fit_dataset(self, ds: AnnDataset) -> dict:
        """Bulk load that takes ownership of ``ds.train`` (dropped before the
        deferred refit runs). Returns the build's seconds, split."""
        n = len(ds.train)
        ids = np.arange(2, n + 2, dtype=np.int32)
        t0 = time.perf_counter()
        self.index.insert_bulk(ids, ds.train, defer_fit=True)
        self.index.sync()
        t1 = time.perf_counter()
        ds.train = None
        self.index.flush_pending()
        self.index.sync()
        t2 = time.perf_counter()
        split = {"upload_s": t1 - t0, **self.index.refit_seconds}
        return {"build_s": t2 - t0, "refit_s": t2 - t1, "split": split}

    def query_batch(self, test: np.ndarray, k: int, batch: int = 1024, num_probes: int = 0):
        """Pipelined throughput pass: every batch is enqueued without waiting,
        at most 8 in flight (AsyncDispatcher), results read back in order."""
        out = np.empty((len(test), k), np.int32)
        t0 = time.perf_counter()
        pipe = AsyncDispatcher(depth=8)
        for i in range(0, len(test), batch):
            pipe.submit(self.index.search_batch_async, test[i : i + batch], k, num_probes)
        for j, (_, ids) in enumerate(pipe.results()):
            i = j * batch
            n = min(batch, len(test) - i)
            out[i : i + n] = ids[:n] - 2  # node id → train index
        return out, time.perf_counter() - t0


PRIME_KERNEL = "spin_kernel"  # the kernel torch.cuda._sleep launches
PRIME_LAUNCHES = 4


def prime_profiler() -> None:
    """Open a profiler window with untimed spin kernels of ~50 µs each and
    wait for them: in a process that has profiled before, the profiler can
    miss the first device events of a window (measured on the H100: the
    first two or three). Callers leave ``PRIME_KERNEL`` out of their sums."""
    for _ in range(PRIME_LAUNCHES):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def profile_batch(index, queries: np.ndarray, k: int, num_probes: int = 0) -> dict:
    """One ``torch.profiler`` pass over one search batch on a CUDA device:
    device time by kernel and op, the busy share of the wall time, and the
    number of kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        t0 = time.perf_counter()
        index.search_batch_async(queries, k, num_probes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    by_kernel = {
        e.key: e.self_device_time_total / 1e3 for e in events
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and PRIME_KERNEL not in e.key
    }
    busy_ms = sum(by_kernel.values())
    launches = sum(
        e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    ) - PRIME_LAUNCHES
    if busy_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the search batch")
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "launches": launches, "device_ms_by_kernel": top}


def card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run(
    ds: AnnDataset, k: int = 10, batch: int = 1024, num_probes: int = 0, device="cuda",
    profile: bool = False, keep: Optional[dict] = None, **index_kw,
) -> dict:
    """The JAX tool's ``run`` for the IVF engine on ``device``, recall over
    every query. ``num_probes`` 0 = the engine's default. ``keep``, when
    given, receives the built ``index`` and the ``queries`` (for callers
    that go on to time the kernels on the cell's own operands)."""
    device = torch.device(device)

    def stage(msg: str) -> None:
        print(f"# annbench {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    nq = len(ds.test)
    t0 = time.perf_counter()
    if len(ds.train) * ds.train.shape[1] >= 4 * 10**6 and device.type == "cuda":
        gt = compute_ground_truth_device(ds, k, device)
    else:
        gt = compute_ground_truth(ds, k)
    gt_s = time.perf_counter() - t0
    stage(f"ground truth done ({nq} queries, {gt_s:.1f} s)")
    # Difficulty: mean distance to the k-th true neighbour over the mean
    # random-pair distance (SIFT ≈ 0.45-0.5; higher is harder)
    d_gt_k = np.linalg.norm(ds.test - ds.train[gt[:, k - 1]], axis=1).astype(np.float64)
    rng_m = np.random.default_rng(0)
    ra = rng_m.integers(0, len(ds.train), 4096)
    rb = rng_m.integers(0, len(ds.train), 4096)
    drand = np.linalg.norm(ds.train[ra] - ds.train[rb], axis=1).mean()
    margin = float(d_gt_k[:2048].mean() / max(drand, 1e-12))
    n_train = len(ds.train)
    train = ds.train  # fit_dataset drops ds.train; eps-recall still reads it
    bench = AnnBench(dim=ds.train.shape[1], device=device, metric=ds.metric, **index_kw)
    stage(f"fit start n={n_train}")
    build = bench.fit_dataset(ds)
    stage(f"fit done {build['build_s']:.1f}s {build['split']}")
    bench.query_batch(ds.test[:batch], k, batch, num_probes)  # warm-up
    ids, wall = bench.query_batch(ds.test, k, batch, num_probes)
    walls = [wall]
    for _ in range(2):
        ids2, w2 = bench.query_batch(ds.test, k, batch, num_probes)
        walls.append(w2)
        if w2 < wall:
            ids, wall = ids2, w2
    walls.sort()
    stage(f"query done {wall:.3f}s (best of 3; spread {walls})")
    recall = float(np.mean([len(set(ids[i]) & set(gt[i])) / k for i in range(nq)]))
    # eps-recall: returned points within (1 + 1e-3) of the k-th true distance count
    d_ret = np.linalg.norm(
        ds.test[:, None, :].astype(np.float64) - train[np.clip(ids, 0, n_train - 1)].astype(np.float64), axis=2
    )
    recall_eps = float(np.mean(np.sum((ids >= 0) & (d_ret <= d_gt_k[:, None] * (1.0 + 1e-3) + 1e-9), axis=1) / k))
    idx = bench.index
    out = {
        "dataset": ds.name,
        "metric": ds.metric,
        "n": n_train,
        "queries": nq,
        "batch": batch,
        "recall@10": recall,
        "recall_eps@10": recall_eps,
        "qps": nq / wall,
        "qps_spread": [nq / w for w in reversed(walls)],
        "build_s": build["build_s"],
        "build_split_s": build["split"],
        "ground_truth_s": gt_s,
        "margin": margin,
        "clusters": int(idx.centroids.shape[0]),
        "slab": int(idx.slab),
        "slab_dtype": str(idx.slabs.dtype).replace("torch.", ""),
        "probes": idx._num_probes(num_probes),
        "overflow_rows": int(idx.ovf_ids.shape[0] - len(idx._ovf_free)),
        "device": str(device),
    }
    if device.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out["resident_gib"] = torch.cuda.memory_allocated(device) / 2**30
        out["card"] = card()
        if profile:
            out["profile"] = profile_batch(idx, ds.test[:batch], k, num_probes)
    if keep is not None:
        keep.update(index=idx, queries=ds.test)
    return out


def main(argv=None, keep: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser(description="ann-benchmarks-style run of the port's IVF index")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--spread", type=float, default=0.5)
    ap.add_argument("--metric", default="euclidean", choices=["euclidean", "cosine"])
    ap.add_argument("--copies", type=int, default=2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--probes", type=int, default=0, help="0 = the engine's default")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("annbench: --device cuda needs a CUDA device (pass --device cpu to run the plain versions)")
    ds = embedding_like(args.n, args.dim, args.queries, spread=args.spread, metric=args.metric, seed=args.seed)
    out = run(
        ds, k=args.k, batch=args.batch, num_probes=args.probes, device=device,
        profile=device.type == "cuda", keep=keep, assign_copies=args.copies,
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
