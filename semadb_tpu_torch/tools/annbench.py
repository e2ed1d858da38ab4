"""ann-benchmarks-style harness driving the port's IVF index directly.

Port of ``semadb_tpu/tools/annbench.py`` for the IVF engine, the JAX
package's main bench path (``python bench.py`` with no environment runs it:
``BENCH_MODE=ivf``). Protocol as there: exact ground truth first, then the
build (``insert_bulk(defer_fit=True)`` → ``flush_pending``), a warm-up batch,
best-of-3 pipelined query passes (batches dispatched through
``utils.pipeline.AsyncDispatcher``, up to 8 in flight), recall@10, epsilon
recall and the dataset's margin; ``--sweep`` adds operating points (probe
counts) on the same build, as ``BENCH_SWEEP`` does. ``--quantizer product``
is ``BENCH_MODE=ivfpq`` (IVF-PQ, M = max(D // 16, 4) subvectors of 256
centroids, fit at 10,000 points, as ``bench.py:_quantizer``), and
``--fused`` is ``BENCH_MODE=fused`` (``bench.py:_run_fused``: the fused
two-view engine over ``embedding_like_views``, below, with 4 copies unless
``--copies`` says otherwise; it refuses the options it has no use for).
``--engine vamana`` is ``BENCH_MODE=plain`` (the JAX tool's ``VamanaBench``):
the Vamana graph at searchSize 75, degreeBound 64, alpha 1.2 (the reference's
v1 settings) built by the two-pass ``insert_bulk``, then queries at L = 40
(``--search-size``), W = 2, in batches of 8,192; it prints the build's seconds
by pass and overflow rounds, and the walk's hops per query. With
``--quantizer binary`` it is ``BENCH_MODE=bq`` (a binary quantizer, hamming,
fit at 10,000 points) and with ``--quantizer product`` ``BENCH_MODE=pq`` (M =
max(D // 16, 4), K = 256, OPQ on, fit at 10,000 points): the walk scores the
codes and the results are reranked in f32, at L = 75 unless
``--search-size`` says otherwise (``bench.py:58-60``). ``--build pool`` is
``SEMADB_VAMANA_BUILD=pool``: the per-cluster kNN pool build, its seconds by
stage. ``--adversarial`` is ``BENCH_ADVERSARIAL``: ``embedding_like_adversarial``
data (Zipf clusters, a 10x density imbalance, near-duplicates, boundary
queries), made on the host at any size; with ``--fused`` one sample of
dim + max(dim // 2, 16) columns split into the two views.

Usage (the defaults are ``bench.py``'s: 1,000,000 x 128, 32,768 queries in
batches of 4,096, spread 0.5, euclidean, assignCopies 2, k = 10):

    python3 -m semadb_tpu_torch.tools.annbench [--device cuda] [--n 1000000] [--sweep 48,96] ...
    python3 -m semadb_tpu_torch.tools.annbench --engine vamana [--device cuda] [--n 1000000] ...
    python3 -m semadb_tpu_torch.tools.annbench --engine vamana --quantizer binary|product [--build pool] ...

From N x D >= 2^28 on a CUDA device the data come from the device generator
(``embedding_like_device``) and stay on the card, as ``bench.py`` does; the
build then adopts the corpus tensor and the margin reads rows on the device.
Eps-recall reads the index's own copy of the corpus on every path.

It prints one JSON line: ``qps``, ``recall@10``, ``build_s`` and its split
(upload, k-means and its two-level steps, packing, slab build or the PQ
codebook fit and encode, host maps),
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

from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, ProductQuantizerParams, Quantizer
from semadb_tpu_torch.models.schema import VectorIVFParams, VectorVamanaParams
from semadb_tpu_torch.tools.datasets import (
    AnnDataset,
    compute_ground_truth,
    compute_ground_truth_device,
    embedding_like,
    embedding_like_adversarial,
    embedding_like_device,
    embedding_like_views,
)
from semadb_tpu_torch.utils.pipeline import AsyncDispatcher


class AnnBench:
    """init/fit/query protocol over one index (the JAX tool's ``VamanaBench``):
    ``engine="ivf"`` or ``"vamana"``."""

    def __init__(self, dim: int, device, metric: str = "euclidean", engine: str = "ivf",
                 assign_copies: int = 2, quantizer: Optional[Quantizer] = None, search_size: int = 75,
                 degree_bound: int = 64, alpha: float = 1.2):
        self.device = torch.device(device)
        self.engine = engine
        if engine == "vamana":
            from semadb_tpu_torch.index.vamana import IndexVamana

            self.index = IndexVamana(
                VectorVamanaParams(vector_size=dim, distance_metric=metric, search_size=search_size,
                                   degree_bound=degree_bound, alpha=alpha, quantizer=quantizer),
                self.device,
            )
            return
        if engine != "ivf":
            raise ValueError(f"engine {engine!r}: the bench runs 'ivf' or 'vamana'")
        from semadb_tpu_torch.index.ivf import IndexIVF

        self.index = IndexIVF(
            VectorIVFParams(vector_size=dim, distance_metric=metric, assign_copies=assign_copies,
                            quantizer=quantizer),
            self.device,
        )

    def fit_dataset(self, ds: AnnDataset, build_mode: Optional[str] = None) -> dict:
        """Bulk load that takes ownership of ``ds.train`` (dropped before the
        deferred refit runs). Returns the build's seconds, split.
        ``build_mode`` is the Vamana engine's ("search" or "pool")."""
        n = len(ds.train)
        ids = np.arange(2, n + 2, dtype=np.int32)
        t0 = time.perf_counter()
        if self.engine == "vamana":
            self.index.insert_bulk(ids, ds.train, build_mode=build_mode)
        else:
            self.index.insert_bulk(ids, ds.train, defer_fit=True)
        self.index.sync()
        t1 = time.perf_counter()
        ds.train = None
        self.index.flush_pending()
        self.index.sync()
        t2 = time.perf_counter()
        if self.engine == "vamana":
            return {"build_s": t2 - t0, "split": dict(self.index.build_seconds)}
        split = {"upload_s": t1 - t0, **self.index.refit_seconds}
        return {"build_s": t2 - t0, "refit_s": t2 - t1, "split": split}

    def query_batch(self, test: np.ndarray, k: int, batch: int = 1024, num_probes: int = 0):
        """Pipelined throughput pass: every batch is enqueued without waiting,
        at most 8 in flight (AsyncDispatcher), results read back in order.
        ``num_probes`` is the IVF probe count, or the Vamana walk's L."""
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
PRIME_CYCLES = 5_000_000  # a spin kernel's clock cycles, ~2.5 ms on the H100
PROFILE_WINDOWS = 3  # windows profile_batch opens before it reports the device time lost


def prime_profiler() -> None:
    """Open a profiler window with untimed spin kernels of ~2.5 ms each and
    wait for them: in a process that has profiled before, the profiler can
    miss the first device events of a window (measured on the H100: from one
    to 39 of them, up to about a millisecond of launches past a prime of
    4 x 50 µs). Callers leave ``PRIME_KERNEL`` out of their sums."""
    for _ in range(PRIME_LAUNCHES):
        torch.cuda._sleep(PRIME_CYCLES)
    torch.cuda.synchronize()


# The stages of one search batch, by the names of their device events: the
# first stage whose patterns a name holds. K3's memset zeroes its work area;
# no other stage of the query sets memory. The top-k passes of the overflow
# scan would count under probe_topk (the cells have no overflow rows). The
# probe scores' −2× and + |c|² passes are elementwise kernels; the chunked
# probe selection (C·B past PROBE_CHUNK_BYTES) adds each chunk's id offset,
# concatenates the chunks' top-p and gathers the winners. IVF-PQ's ADC tables
# are a batched product and elementwise passes, so they count under
# probe_gemm and probe_scale_shift. Anything else is "other", listed by name
# in the profile.
STAGES = (
    ("k10_beam_search", ("vamana_beam_search_kernel",)),
    ("k9_adc_scan", ("pq_probe_scan_kernel", "pq_scan_dense_kernel")),
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


def profile_batch(index, queries: np.ndarray, k: int, num_probes: int = 0, search_size: Optional[int] = None) -> dict:
    """One ``torch.profiler`` pass over one search batch on a CUDA device
    (``num_probes`` for the IVF and fused engines, ``search_size``, the
    walk's L, for the Vamana engine):
    device time by kernel and op and by stage (``STAGES``), the busy share of
    the wall time, and the number of kernel launches. A window that recorded
    no device event at all (in a process that has profiled much, the
    profiler can lose a whole window) is opened again, up to
    ``PROFILE_WINDOWS`` times; if every one was lost the profile says so
    (``lost_windows``) and holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(PROFILE_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime_profiler()
            t0 = time.perf_counter()
            if search_size is None:
                index.search_batch_async(queries, k, num_probes=num_probes)
            else:
                index.search_batch_async(queries, k, search_size=search_size)
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
        if busy_ms > 0:
            break
    else:
        return {"wall_ms": wall_ms, "device_ms": None, "lost_windows": PROFILE_WINDOWS, "launches": launches}
    by_stage: dict = {}
    for name, ms in by_kernel.items():
        by_stage[stage_of(name)] = by_stage.get(stage_of(name), 0.0) + ms
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    other = {name: ms for name, ms in by_kernel.items() if stage_of(name) == "other"}
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "launches": launches, "device_ms_by_stage": by_stage, "device_ms_by_kernel": top,
            "other_kernels_ms": other, "lost_windows": window}


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
    profile: bool = False, keep: Optional[dict] = None, sweep=(), engine: str = "ivf", search_size: int = 0,
    build_mode: Optional[str] = None, **index_kw,
) -> dict:
    """The JAX tool's ``run`` on ``device``, recall over every query.
    ``engine="ivf"``: ``num_probes`` 0 = the engine's default, and each probe
    count in ``sweep`` is one more operating point on the same build (best of
    two passes). ``engine="vamana"``: ``search_size`` is the query walk's L
    (0 = the index's searchSize), ``build_mode`` the bulk build's. ``ds`` may hold numpy arrays or tensors
    (the device generator's; then nothing of the corpus visits the host).
    ``keep``, when given, receives the built ``index`` and the ``queries``
    (for callers that go on to time the kernels on the cell's own operands),
    the ``bench`` and the ``ground_truth``."""
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
    bench = AnnBench(dim=ds.train.shape[1], device=device, metric=ds.metric, engine=engine, **index_kw)
    vamana = engine == "vamana"
    # The query pass's operating point: the probe count, or the walk's L
    op = search_size if vamana else num_probes
    stage(f"fit start n={n_train}")
    build = bench.fit_dataset(ds, build_mode)
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

    bench.query_batch(ds.test[:batch], k, batch, op)  # warm-up
    ids, wall = bench.query_batch(ds.test, k, batch, op)
    walls = [wall]
    for _ in range(2):
        ids2, w2 = bench.query_batch(ds.test, k, batch, op)
        walls.append(w2)
        if w2 < wall:
            ids, wall = ids2, w2
    walls.sort()
    stage(f"query done {wall:.3f}s (best of 3; spread {walls})")
    recall = recall_of(ids)
    recall_eps = eps_recall(ids)
    out = {
        "engine": engine,
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
        "generator": "device" if on_device else "host",
        "device": str(device),
    }
    if vamana:
        L = max(op or idx.params.search_size, k)
        walk = idx.query_walk(ds.test[:batch], L)
        out.update({
            "search_size": L, "expand_width": 2, "degree_bound": idx.params.degree_bound,
            "build_search_size": idx.params.search_size, "alpha": idx.params.alpha,
            "hops_per_query": float(walk.query_hops.float().mean()), "hops_max": int(walk.hops),
            "expanded_per_query": float(walk.counts[:, 0].float().mean()),
            "rows_scored_per_query": float(walk.counts[:, 1].float().mean()),
            "build_mode": build_mode or "search",
        })
        store = idx.store.config
        if store.kind != "plain":
            out["quantizer"] = {"kind": store.kind, "fitted": idx.store.fitted, "trigger": store.trigger,
                                "fit_s": idx.build_seconds.get("fit_s")}
            if store.kind == "product":
                out["quantizer"].update(m=store.num_subvectors, k=store.num_centroids, opq=store.opq)
            else:
                out["quantizer"]["bit_metric"] = store.bit_metric
    else:
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
        out.update({
            "clusters": int(idx.centroids.shape[0]),
            "slab": int(idx.slab),
            "slab_dtype": "u8 PQ codes" if idx.pq_active else str(idx.slabs.dtype).replace("torch.", ""),
            "two_level": idx._sup_cents is not None,
            "probes": probes,
            "sweep": sweep_rows,
            "overflow_rows": int(idx.ovf_ids.shape[0] - len(idx._ovf_free)),
        })
        if idx.pq_config is not None:
            out["pq"] = {"m": idx.pq_config.num_subvectors, "k": idx.pq_config.num_centroids,
                         "trigger": idx.pq_config.trigger, "active": idx.pq_active}
    if device.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out["resident_gib"] = torch.cuda.memory_allocated(device) / 2**30
        out["card"] = card()
        if profile:
            out["profile"] = (profile_batch(idx, ds.test[:batch], k, search_size=op) if vamana
                              else profile_batch(idx, ds.test[:batch], k, num_probes=op))
    if keep is not None:
        keep.update(index=idx, queries=ds.test, bench=bench, ground_truth=gt)
    return out


FUSED_WEIGHTS = (0.7, 0.3)
FUSED_COPIES = 4  # bench.py's BENCH_FUSED_COPIES default
FUSED_GT_CHUNK = 512  # queries a step of the fused ground truth
# Options of the IVF bench that the fused mode does not take
FUSED_REFUSES = ("quantizer", "sweep", "spread", "metric")
# bench.py:_quantizer's product quantizer (M = max(D // 16, 4) subvectors)
PQ_CENTROIDS = 256
PQ_TRIGGER = 10_000
BQ_TRIGGER = 10_000  # bench.py:_quantizer's binary quantizer (hamming)


def fused_ground_truth(train, test, weights, k: int, device) -> np.ndarray:
    """Exact top-k of the weighted sum of the views' squared euclidean
    distances (``bench.py:_run_fused``'s ground truth), on ``device``, f32 →
    train rows i64[Q, k]."""
    xs = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in train]
    sqs = [(x * x).sum(-1) for x in xs]
    out = np.empty((len(test[0]), k), np.int64)
    for lo in range(0, len(test[0]), FUSED_GT_CHUNK):
        total = None
        for w, x, sq, q in zip(weights, xs, sqs, test):
            qd = torch.from_numpy(np.ascontiguousarray(q[lo : lo + FUSED_GT_CHUNK])).to(device)
            d = w * (sq[None, :] - 2.0 * (qd @ x.T))
            total = d if total is None else total + d
        out[lo : lo + FUSED_GT_CHUNK] = torch.topk(total, k, dim=1, largest=False).indices.cpu().numpy()
    return out


def adversarial_views(n: int, dims, n_queries: int, seed: int = 42) -> list:
    """Views of one ``embedding_like_adversarial`` sample of sum(dims)
    columns, split by columns (``bench.py:_run_fused`` under
    ``BENCH_ADVERSARIAL``): with euclidean views the weighted fused distance
    over the split is a distance in the full space, so the adversarial
    structure carries over to the combined-score ground truth."""
    full = embedding_like_adversarial(n, sum(dims), n_queries, seed=seed)
    cuts = np.cumsum([0, *dims])
    return [AnnDataset(f"adv-view{i + 1}", "euclidean", np.ascontiguousarray(full.train[:, lo:hi]),
                       np.ascontiguousarray(full.test[:, lo:hi]))
            for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:]))]


def run_fused(n: int, dim: int, n_queries: int, k: int = 10, batch: int = 4096, copies: int = FUSED_COPIES,
              num_probes: int = 0, device="cuda", profile: bool = False, keep: Optional[dict] = None,
              seed: int = 42, adversarial: bool = False, num_clusters: int = 0, sweep=()) -> dict:
    """``BENCH_MODE=fused`` on the port: two views of ``dim`` and
    max(dim // 2, 16) from ``embedding_like_views(seed=42)`` (or, with
    ``adversarial``, from :func:`adversarial_views`), euclidean,
    weights 0.7 and 0.3, ``copies`` copies a point, ``num_clusters`` clusters
    (0 = automatic) and automatic probes, one ``insert_bulk``; recall@10
    against the exact combined-score ground truth over every query; QPS best
    of 3 pipelined passes. Each probe count in ``sweep`` is one more operating
    point on the same build (best of two passes, ``BENCH_FUSED_SWEEP``).
    ``keep`` receives the ``index`` and the query ``views``."""
    from semadb_tpu_torch.index.fused import FusedHybridIVF

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d2 = max(dim // 2, 16)
    t0 = time.perf_counter()
    if adversarial:
        ds1, ds2 = adversarial_views(n, [dim, d2], n_queries, seed=seed)
    else:
        ds1, ds2 = embedding_like_views(n, [dim, d2], n_queries, seed=seed)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt = fused_ground_truth([ds1.train, ds2.train], [ds1.test, ds2.test], FUSED_WEIGHTS, k, device)
    gt_s = time.perf_counter() - t0
    idx = FusedHybridIVF([dim, d2], ["euclidean", "euclidean"], list(FUSED_WEIGHTS), assign_copies=copies,
                         num_clusters=num_clusters, device=device)
    t0 = time.perf_counter()
    idx.insert_bulk(np.arange(2, n + 2, dtype=np.int32), [ds1.train, ds2.train])
    idx.sync()
    build_s = time.perf_counter() - t0
    ds1.train = ds2.train = None
    views = [ds1.test, ds2.test]

    def query_all(probes: int):
        out = np.empty((n_queries, k), np.int64)
        t1 = time.perf_counter()
        pipe = AsyncDispatcher(depth=8)
        for i in range(0, n_queries, batch):
            pipe.submit(idx.search_batch_async, [v[i : i + batch] for v in views], k, None, probes)
        for j, (_, ids) in enumerate(pipe.results()):
            out[j * batch : j * batch + len(ids)] = ids - 2  # node id → train row
        return out, time.perf_counter() - t1

    def recall_of(got: np.ndarray) -> float:
        return float(np.mean([len(set(got[i]) & set(gt[i])) / k for i in range(n_queries)]))

    query_all(num_probes)  # warm-up
    walls = []
    best = None
    for _ in range(3):
        got, wall = query_all(num_probes)
        walls.append(wall)
        if best is None or wall < best[1]:
            best = (got, wall)
    got, wall = best
    recall = recall_of(got)
    sweep_rows = []
    for p in sweep:
        query_all(p)  # warm-up
        (o2, w2), (o3, w3) = query_all(p), query_all(p)
        if w3 < w2:
            o2, w2 = o3, w3
        sweep_rows.append({"probes": p, "recall@10": recall_of(o2), "qps": n_queries / w2})
        print(f"# fused sweep p={p}: recall {sweep_rows[-1]['recall@10']:.4f} qps {n_queries / w2:.0f}",
              file=sys.stderr, flush=True)
    inner = idx.index
    out = {
        "dataset": f"{'adversarial' if adversarial else 'embedding'}-views-{n}x{dim}+{d2}", "n": n, "queries": n_queries, "batch": batch,
        "recall@10": recall, "qps": n_queries / wall, "qps_spread": sorted(n_queries / w for w in walls),
        "build_s": build_s, "build_split_s": dict(inner.refit_seconds), "ground_truth_s": gt_s, "data_s": data_s,
        "aug_dim": idx.aug_dim, "copies": copies, "weights": list(FUSED_WEIGHTS),
        "clusters": int(inner.centroids.shape[0]), "slab": int(inner.slab),
        "slab_dtype": str(inner.slabs.dtype).replace("torch.", ""), "projected": inner._proj is not None,
        "probes": inner._num_probes(num_probes), "device": str(device),
        "overflow_rows": int(inner.ovf_ids.shape[0] - len(inner._ovf_free)),
        **({"sweep": sweep_rows} if sweep_rows else {}),
    }
    if device.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out["resident_gib"] = torch.cuda.memory_allocated(device) / 2**30
        out["card"] = card()
        if profile:
            out["profile"] = profile_batch(idx, [v[:batch] for v in views], k, num_probes)
    if keep is not None:
        keep.update(index=idx, views=views, ground_truth=gt)
    return out


def main(argv=None, keep: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser(description="ann-benchmarks-style run of the port's IVF or Vamana index")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=None, help="4096, or 8192 with --engine vamana")
    ap.add_argument("--spread", type=float, default=0.5)
    ap.add_argument("--metric", default="euclidean", choices=["euclidean", "cosine"])
    ap.add_argument("--copies", type=int, default=None,
                    help=f"assignCopies; default 2, and {FUSED_COPIES} with --fused")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--probes", type=int, default=0, help="0 = the engine's default")
    ap.add_argument("--sweep", default="", help="comma-separated probe counts, each run on the same build")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantizer", default="none", choices=["none", "product", "binary"],
                    help="product: IVF-PQ (BENCH_MODE=ivfpq), or with --engine vamana BENCH_MODE=pq; binary: "
                         "BENCH_MODE=bq (--engine vamana)")
    ap.add_argument("--engine", default="ivf", choices=["ivf", "vamana"],
                    help="vamana: bench.py's BENCH_MODE=plain (the graph at L 75, R 64, alpha 1.2)")
    ap.add_argument("--search-size", type=int, default=None,
                    help="the Vamana query walk's L (bench.py: 40 for BENCH_MODE=plain, 75 with a quantizer)")
    ap.add_argument("--build", default=None, choices=["search", "pool"],
                    help="the Vamana bulk build (SEMADB_VAMANA_BUILD): two passes of walks, or the kNN pool build")
    ap.add_argument("--fused", action="store_true",
                    help="bench.py's BENCH_MODE=fused: two views (dim, max(dim // 2, 16)), the fused engine")
    ap.add_argument("--adversarial", action="store_true",
                    help="bench.py's BENCH_ADVERSARIAL: embedding_like_adversarial data (with --fused, one "
                         "sample split into the two views)")
    args = ap.parse_args(argv)
    vamana = args.engine == "vamana"
    if args.batch is None:
        args.batch = 8192 if vamana else 4096
    if vamana and (args.fused or args.sweep or args.probes or args.copies):
        ap.error("--engine vamana takes none of --fused, --sweep, --probes, --copies")
    if not vamana and (args.quantizer == "binary" or args.build or args.search_size is not None):
        ap.error("--quantizer binary, --build and --search-size take --engine vamana")
    if args.search_size is None:
        args.search_size = 40 if args.quantizer == "none" else 75
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("annbench: --device cuda needs a CUDA device (pass --device cpu to run the plain versions)")
    if args.fused:
        taken = [name for name in FUSED_REFUSES if getattr(args, name) != ap.get_default(name)]
        if taken:
            ap.error(f"--fused takes none of {', '.join('--' + name for name in taken)}")
        out = run_fused(args.n, args.dim, args.queries, k=args.k, batch=args.batch,
                        copies=FUSED_COPIES if args.copies is None else args.copies, num_probes=args.probes,
                        device=device, profile=device.type == "cuda", keep=keep, seed=args.seed,
                        adversarial=args.adversarial)
        print(json.dumps(out))
        return 0
    quantizer = None
    if args.quantizer == "product":
        quantizer = Quantizer(type="product", product=ProductQuantizerParams(
            num_centroids=PQ_CENTROIDS, num_subvectors=max(args.dim // 16, 4), trigger_threshold=PQ_TRIGGER))
    elif args.quantizer == "binary":
        quantizer = Quantizer(type="binary", binary=BinaryQuantizerParams(
            distance_metric="hamming", trigger_threshold=BQ_TRIGGER))
    # bench.py's switch: the host generator takes minutes past 2^28 values
    on_card = args.n * args.dim >= 2**28 and device.type == "cuda"
    make = functools.partial(embedding_like_device, device=device) if on_card else embedding_like
    t0 = time.perf_counter()
    if args.adversarial:  # bench.py:1221-1224: the adversarial corpus is made on the host at any size
        ds = embedding_like_adversarial(args.n, args.dim, args.queries, metric=args.metric, seed=args.seed)
    else:
        ds = make(args.n, args.dim, args.queries, spread=args.spread, metric=args.metric, seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    data_s = time.perf_counter() - t0
    out = run(
        ds, k=args.k, batch=args.batch, num_probes=args.probes, device=device,
        profile=device.type == "cuda", keep=keep, quantizer=quantizer,
        sweep=[int(p) for p in args.sweep.split(",") if p], engine=args.engine,
        **({"search_size": args.search_size, "build_mode": args.build} if vamana else
           {"assign_copies": 2 if args.copies is None else args.copies}),
    )
    out["data_s"] = data_s
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
