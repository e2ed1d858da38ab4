"""ann-benchmarks-style harness driving the port's IVF index directly.

Port of ``semadb_tpu/tools/annbench.py`` for the IVF engine, the JAX
package's main bench path (``python bench.py`` with no environment runs it:
``BENCH_MODE=ivf``). Protocol as there: exact ground truth first, then the
build (``insert_bulk(defer_fit=True)`` → ``flush_pending``), a warm-up batch,
best-of-3 pipelined query passes (batches dispatched through
``utils.pipeline.AsyncDispatcher``, up to 8 in flight), recall@10, epsilon
recall and the dataset's margin; ``--sweep`` adds operating points (probe
counts) on the same build, as ``BENCH_SWEEP`` does. The Vamana engine is not
ported yet.

Usage (the defaults are ``bench.py``'s: 1,000,000 x 128, 32,768 queries in
batches of 4,096, spread 0.5, euclidean, assignCopies 2, k = 10):

    python3 -m semadb_tpu_torch.tools.annbench [--device cuda] [--n 1000000] [--sweep 48,96] ...

From N x D >= 2^28 on a CUDA device the data come from the device generator
(``embedding_like_device``) and stay on the card, as ``bench.py`` does; the
build then adopts the corpus tensor and the margin reads rows on the device.
Eps-recall reads the index's own copy of the corpus on every path.

It prints one JSON line: ``qps``, ``recall@10``, ``build_s`` and its split
(upload, k-means and its two-level steps, packing, slab build, host maps),
``peak_mem_gib``, the device and, on a CUDA device, the card's name and
power limit and one ``torch.profiler`` pass over one batch (device time by
kernel and op and by stage, busy share, launches).
A ``cuda`` run without a CUDA device is an error.
"""

from __future__ import annotations

import argparse
import functools
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
    embedding_like_device,
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


# The stages of one search batch, by the names of their device events: the
# first stage whose patterns a name holds. K3's memset zeroes its work area;
# no other stage of the query sets memory. The top-k passes of the overflow
# scan would count under probe_topk (the cells have no overflow rows). The
# probe scores' −2× and + |c|² passes are elementwise kernels; the chunked
# probe selection (C·B past PROBE_CHUNK_BYTES) adds each chunk's id offset,
# concatenates the chunks' top-p and gathers the winners. Anything else is
# "other", listed by name in the profile.
STAGES = (
    ("k3_probed_slab_scan", ("ivf_scan_", "Memset")),
    ("k4_dedup_rerank", ("rerank_kernel",)),
    ("probe_gemm", ("gemm",)),
    ("probe_topk", ("topk", "Sort")),
    ("probe_scale_shift", ("MulFunctor", "CUDAFunctor_add", "CUDAFunctorOnSelf_add", "CUDAFunctorOnOther_add")),
    ("probe_chunk_merge", ("CatArrayBatchedCopy", "scatter_gather", "copy_kernel")),
    ("upload", ("Memcpy HtoD",)),
)


def stage_of(kernel: str) -> str:
    """The stage of ``STAGES`` a device event belongs to, else ``other``."""
    return next((stage for stage, pats in STAGES if any(pat in kernel for pat in pats)), "other")


def profile_batch(index, queries: np.ndarray, k: int, num_probes: int = 0) -> dict:
    """One ``torch.profiler`` pass over one search batch on a CUDA device:
    device time by kernel and op and by stage (``STAGES``), the busy share of
    the wall time, and the number of kernel launches."""
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
    by_stage: dict = {}
    for name, ms in by_kernel.items():
        by_stage[stage_of(name)] = by_stage.get(stage_of(name), 0.0) + ms
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    other = {name: ms for name, ms in by_kernel.items() if stage_of(name) == "other"}
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "launches": launches, "device_ms_by_stage": by_stage, "device_ms_by_kernel": top,
            "other_kernels_ms": other}


def card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _rows(a, idx: np.ndarray) -> torch.Tensor:
    """``a[idx]`` in f64 where ``a`` lies (a numpy array is viewed as a host
    tensor)."""
    t = torch.as_tensor(a)
    return t[torch.as_tensor(np.asarray(idx, np.int64), device=t.device)].double()


def run(
    ds: AnnDataset, k: int = 10, batch: int = 1024, num_probes: int = 0, device="cuda",
    profile: bool = False, keep: Optional[dict] = None, sweep=(), **index_kw,
) -> dict:
    """The JAX tool's ``run`` for the IVF engine on ``device``, recall over
    every query. ``num_probes`` 0 = the engine's default; each probe count
    in ``sweep`` is one more operating point on the same build (best of two
    passes). ``ds`` may hold numpy arrays or tensors (the device generator's;
    then nothing of the corpus visits the host). ``keep``, when given,
    receives the built ``index`` and the ``queries`` (for callers that go on
    to time the kernels on the cell's own operands), the ``bench`` and the
    ``ground_truth``."""
    device = torch.device(device)

    def stage(msg: str) -> None:
        print(f"# annbench {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    on_device = isinstance(ds.train, torch.Tensor)
    nq = len(ds.test)
    t0 = time.perf_counter()
    if on_device or (len(ds.train) * ds.train.shape[1] >= 4 * 10**6 and device.type == "cuda"):
        gt = compute_ground_truth_device(ds, k, device)
    else:
        gt = compute_ground_truth(ds, k)
    gt_s = time.perf_counter() - t0
    stage(f"ground truth done ({nq} queries, {gt_s:.1f} s)")
    # Difficulty: mean distance to the k-th true neighbour over the mean
    # random-pair distance (SIFT ≈ 0.45-0.5; higher is harder)
    test = _rows(ds.test, np.arange(nq))
    d_gt_k = (test - _rows(ds.train, gt[:, k - 1])).norm(dim=1).cpu().numpy()
    rng_m = np.random.default_rng(0)
    ra = rng_m.integers(0, len(ds.train), 4096)
    rb = rng_m.integers(0, len(ds.train), 4096)
    drand = float((_rows(ds.train, ra) - _rows(ds.train, rb)).norm(dim=1).mean())
    margin = float(d_gt_k[:2048].mean() / max(drand, 1e-12))
    n_train = len(ds.train)
    bench = AnnBench(dim=ds.train.shape[1], device=device, metric=ds.metric, **index_kw)
    stage(f"fit start n={n_train}")
    build = bench.fit_dataset(ds)
    stage(f"fit done {build['build_s']:.1f}s {build['split']}")
    idx = bench.index

    def eps_recall(ids: np.ndarray) -> float:
        """Returned points within (1 + 1e-3) of the k-th true distance count."""
        # From the index's copy of the corpus (fit_dataset drops ds.train):
        # the row of train point i is its node id, i + 2
        rows = _rows(idx.vectors, np.clip(ids, 0, n_train - 1) + 2)
        d_ret = (test.to(rows.device)[:, None, :] - rows).norm(dim=2).cpu().numpy()
        return float(np.mean(np.sum((ids >= 0) & (d_ret <= d_gt_k[:, None] * (1.0 + 1e-3) + 1e-9), axis=1) / k))

    def recall_of(ids: np.ndarray) -> float:
        return float(np.mean([len(set(ids[i]) & set(gt[i])) / k for i in range(nq)]))

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
    recall = recall_of(ids)
    recall_eps = eps_recall(ids)
    probes = idx._num_probes(num_probes)
    sweep_rows = []
    for p in sweep:
        if idx._num_probes(p) == probes:
            continue
        ids2, w2 = bench.query_batch(ds.test, k, batch, p)
        ids3, w3 = bench.query_batch(ds.test, k, batch, p)
        if w3 < w2:
            ids2, w2 = ids3, w3
        row = {"probes": idx._num_probes(p), "recall@10": recall_of(ids2), "recall_eps@10": eps_recall(ids2),
               "qps": nq / w2, "qps_spread": sorted([nq / w2, nq / w3])}
        stage(f"sweep {row}")
        sweep_rows.append(row)
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
        "two_level": idx._sup_cents is not None,
        "probes": probes,
        "sweep": sweep_rows,
        "overflow_rows": int(idx.ovf_ids.shape[0] - len(idx._ovf_free)),
        "generator": "device" if on_device else "host",
        "device": str(device),
    }
    if device.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out["resident_gib"] = torch.cuda.memory_allocated(device) / 2**30
        out["card"] = card()
        if profile:
            out["profile"] = profile_batch(idx, ds.test[:batch], k, num_probes)
    if keep is not None:
        keep.update(index=idx, queries=ds.test, bench=bench, ground_truth=gt)
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
    ap.add_argument("--sweep", default="", help="comma-separated probe counts, each run on the same build")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("annbench: --device cuda needs a CUDA device (pass --device cpu to run the plain versions)")
    # bench.py's switch: the host generator takes minutes past 2^28 values
    on_card = args.n * args.dim >= 2**28 and device.type == "cuda"
    make = functools.partial(embedding_like_device, device=device) if on_card else embedding_like
    t0 = time.perf_counter()
    ds = make(args.n, args.dim, args.queries, spread=args.spread, metric=args.metric, seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    data_s = time.perf_counter() - t0
    out = run(
        ds, k=args.k, batch=args.batch, num_probes=args.probes, device=device,
        profile=device.type == "cuda", keep=keep, assign_copies=args.copies,
        sweep=[int(p) for p in args.sweep.split(",") if p],
    )
    out["data_s"] = data_s
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
