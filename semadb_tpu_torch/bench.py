"""Headline benchmark of the port: every mode of the JAX package's root
``bench.py``, on one card.

    BENCH_MODE=<mode> [BENCH_N=...] python -m semadb_tpu_torch.bench [--device cuda]

It reads the same ``BENCH_*`` environment (``bench.py:29-80``) with the same
defaults and prints the same single JSON line: the same ``metric`` name and
keys, ``platform`` the torch device's type, and ``device`` the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them (or
``cpu``). Numbers are not rounded.

Modes:

- ``ivf``, ``ivfpq``, ``plain``, ``bq``, ``pq``: ``tools.annbench.run``
  (``bench.py:1215-1273``); ``fused``: ``tools.annbench.run_fused``.
- ``hybrid``: two ``IndexIVF`` over the 128-d and 64-d views of
  ``embedding_like_views``, a pool of ``BENCH_HYBRID_POOL`` from each at
  ``BENCH_HYBRID_PROBES`` probes, then the union reranked exactly in both
  spaces with weights 0.7 / 0.3 (:func:`hybrid_rerank`), against the exact
  combined-score ground truth.
- ``filtered``: a random filter over 10% and 0.5% of the points
  (``BENCH_FILTER_SELS``), the exact filtered ground truth made before the
  build; the engine takes the exact member scan up to ``FILTER_EXACT_CAP``
  members and the widened probes past it (each row says which).
- ``http``: the port's ``ClusterNode`` and ``HttpServer`` in this process,
  insert over msgpack ``POST /points`` in batches of 10,000, then
  ``points/search/batch`` at ``BENCH_HTTP_BATCH``; every distance is held to
  the exact one.
- ``write``: 1,000-point ``insert_update_delete`` transactions into a fitted
  ``IndexIVF``, each followed by a search batch that is not waited for;
  recall@10 after the writes.
- ``text``: 100,000 Zipf documents over 20,000 words through a ``Shard``
  with the host text index (no device), and three kinds of query.
- ``shardwrite``: the durable shard path: an engine built in bulk and handed
  to a ``Shard`` on a disk store, the full snapshot, timed insert
  transactions (store txn and delta journal each), a crash (the store closed
  without the shard's flush) and a reopen from the snapshot and the
  journal's coalesced replay, then the close compaction. Every acknowledged
  point must find itself after the reopen. Unlike ``bench.py``, the warmup
  transactions take the first rows and ids of the run, so they lie inside
  the index's initial capacity and a capacity growth falls in the timed
  loop where the run reaches one.

``BENCH_ADVERSARIAL`` switches the annbench modes and ``fused`` to
``embedding_like_adversarial`` and adds ``_adv`` to the metric's name.
``BENCH_DEBUG_TIMERS`` sets the port's stage loggers to DEBUG on stderr.
``--device cuda`` (the default) is an error without a CUDA device; the tests
pass ``cpu``. Each mode is a function of its sizes and a ``torch.device``.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import os
import shutil
import struct
import sys
import tempfile
import time
import uuid as uuid_mod
from typing import Optional

import numpy as np
import torch

from semadb_tpu_torch.tools.datasets import AnnDataset

# bench.py:62-80: the reference's published rows each mode is set against
BASELINES = {
    "ivf": 1537.7, "ivfpq": 967.4, "plain": 1537.7, "bq": 2369.7, "pq": 967.4,
    "hybrid": 519.9, "fused": 519.9,
}
BASELINES_COSINE = {
    "ivf": 973.6, "ivfpq": 628.6, "plain": 973.6, "bq": 978.6, "pq": 628.6,
    "hybrid": 519.9, "fused": 519.9,
}
ANN_NAMES = {"ivf": "ivf", "ivfpq": "ivfpq", "plain": "vamana", "bq": "vamana_bq", "pq": "vamana_pq"}
MODES = (*ANN_NAMES, "fused", "hybrid", "filtered", "http", "write", "text", "shardwrite")
HYBRID_WEIGHTS = (0.7, 0.3)
HYBRID_CHUNK = 1024  # queries a step of the hybrid rerank's gather
HTTP_INSERT = 10_000  # points a POST /points
HTTP_QUERIES = 8192  # bench.py:639
WRITE_GT_QUERIES = 2048  # bench.py:725
TEXT_DOCS = 100_000  # bench.py:830: the text mode's default corpus
TEXT_VOCAB = 20_000
TEXT_TERMS = 12
TEXT_TXN = 10_000
SELF_BATCH = 4096  # the shardwrite self-searches a batch
DEBUG_LOGGERS = ("ivf", "vamana", "fused", "shard", "kmeans")


def stage(mode: str, msg: str) -> None:
    print(f"# {mode} {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def settings(env=None) -> dict:
    """The ``BENCH_*`` knobs with ``bench.py``'s defaults."""
    env = os.environ if env is None else env
    mode = env.get("BENCH_MODE", "ivf")
    n_queries = int(env.get("BENCH_QUERIES", 32768))
    batch_default = 4096 if mode.startswith("ivf") or mode in ("hybrid", "fused", "filtered", "write") else 8192
    return {
        "mode": mode,
        "n": int(env.get("BENCH_N", 1_000_000)),
        "dim": int(env.get("BENCH_DIM", 128)),
        "n_queries": n_queries,
        "spread": float(env.get("BENCH_SPREAD", 0.5)),
        "gt_queries": int(env.get("BENCH_GT_QUERIES", n_queries)),
        "metric": env.get("BENCH_METRIC", "euclidean"),
        "batch": int(env.get("BENCH_QUERY_BATCH", batch_default)),
        "search_size": int(env.get("BENCH_SEARCH_SIZE", 0 if mode.startswith("ivf") else (40 if mode == "plain"
                                                                                          else 75))),
        "probes": int(env.get("BENCH_PROBES", 0)),
        "copies": int(env.get("BENCH_COPIES", 2)),
        "sweep": [int(x) for x in env.get("BENCH_SWEEP", "").split(",") if x],
        "adversarial": bool(env.get("BENCH_ADVERSARIAL")),
        "txns": int(env.get("BENCH_WRITE_TXNS", 64 if mode == "shardwrite" else 100)),
        "txn_points": int(env.get("BENCH_WRITE_TXN_POINTS", 1000)),
        "warmup_txns": int(env.get("BENCH_WRITE_WARMUP_TXNS", 1)),
        "flush_every": int(env.get("BENCH_FLUSH_EVERY", 0)),
        "sels": tuple(float(x) for x in env.get("BENCH_FILTER_SELS", "0.10,0.005").split(",") if x.strip()),
        "hybrid_pool": int(env.get("BENCH_HYBRID_POOL", 256)),
        "hybrid_probes": int(env.get("BENCH_HYBRID_PROBES", 48)),
        "http_batch": int(env.get("BENCH_HTTP_BATCH", 1024)),
        "fused_copies": int(env.get("BENCH_FUSED_COPIES", 4)),
        "fused_clusters": int(env.get("BENCH_FUSED_CLUSTERS", 0)),
        "fused_probes": int(env.get("BENCH_FUSED_PROBES", 0)),
        "fused_sweep": [int(x) for x in env.get("BENCH_FUSED_SWEEP", "").split(",") if x.strip()],
    }


def baseline_qps(mode: str, metric: str) -> float:
    return (BASELINES_COSINE if metric == "cosine" else BASELINES).get(mode, 1537.7)


def card(device: torch.device) -> str:
    """The card's ``name, power.limit`` (nvidia-smi), or the device's type."""
    if device.type != "cuda":
        return device.type
    from semadb_tpu_torch.tools.annbench import card as smi

    return smi()


def memory(device: torch.device) -> Optional[dict]:
    """Device memory in use and its peak, GiB (``bench.py``'s ``hbm()``
    points); None off CUDA."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return {"allocated_gib": torch.cuda.memory_allocated(device) / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}


def _big(n: int, dim: int, device: torch.device) -> bool:
    """``bench.py``'s switch to the device generator (N x D >= 2^28), on a card."""
    return n * dim >= 2**28 and device.type == "cuda"


def _generate(n: int, dim: int, n_queries: int, device: torch.device, **kw) -> AnnDataset:
    from semadb_tpu_torch.tools.datasets import embedding_like, embedding_like_device

    if _big(n, dim, device):
        return embedding_like_device(n, dim, n_queries, device=device, **kw)
    return embedding_like(n, dim, n_queries, **kw)


def _recall(got: np.ndarray, gt: np.ndarray, k: int = 10) -> float:
    return float(np.mean([len(set(got[i].tolist()) & set(gt[i].tolist())) / k for i in range(len(gt))]))


def _ivf(dim: int, metric: str, copies: int, device: torch.device):
    from semadb_tpu_torch.index.ivf import IndexIVF
    from semadb_tpu_torch.models.schema import VectorIVFParams

    return IndexIVF(VectorIVFParams(vector_size=dim, distance_metric=metric, assign_copies=copies), device)


# -- the annbench modes (bench.py:1215-1273) -----------------------------------


def run_ann(mode: str, n: int, dim: int, n_queries: int, device, *, batch: int = 0, search_size: Optional[int] = None,
            probes: int = 0, spread: float = 0.5, metric: str = "euclidean", copies: int = 2, sweep=(),
            adversarial: bool = False, gt_queries: int = 0) -> dict:
    """``ivf``, ``ivfpq``, ``plain``, ``bq`` or ``pq`` through ``annbench.run``.
    Recall is over every query (the port's annbench scores them all), so
    ``gt_queries`` may only be 0 or ``n_queries``."""
    from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, ProductQuantizerParams, Quantizer
    from semadb_tpu_torch.tools import annbench
    from semadb_tpu_torch.tools.datasets import embedding_like, embedding_like_adversarial, embedding_like_device
    from semadb_tpu_torch.utils import build

    device = torch.device(device)
    if gt_queries not in (0, n_queries):
        raise ValueError("the annbench modes score every query: BENCH_GT_QUERIES must equal BENCH_QUERIES")
    batch = batch or (4096 if mode.startswith("ivf") else 8192)
    if search_size is None:
        search_size = 0 if mode.startswith("ivf") else (40 if mode == "plain" else 75)
    t0 = time.perf_counter()
    if adversarial:
        ds = embedding_like_adversarial(n, dim, n_queries, metric=metric)
    elif _big(n, dim, device) and (mode.startswith("ivf") or mode == "plain"):
        ds = embedding_like_device(n, dim, n_queries, spread=spread, metric=metric, device=device)
    else:
        ds = embedding_like(n, dim, n_queries, spread=spread, metric=metric)
    stage("bench", f"dataset ready {time.perf_counter() - t0:.1f}s")
    quantizer = None
    if mode == "bq":
        quantizer = Quantizer(type="binary", binary=BinaryQuantizerParams(
            distance_metric="hamming", trigger_threshold=annbench.BQ_TRIGGER))
    elif mode in ("pq", "ivfpq"):
        quantizer = Quantizer(type="product", product=ProductQuantizerParams(
            num_centroids=annbench.PQ_CENTROIDS, num_subvectors=max(dim // 16, 4),
            trigger_threshold=annbench.PQ_TRIGGER))
    vamana = not mode.startswith("ivf")
    compile0 = build.BUILD_SECONDS
    out = annbench.run(
        ds, k=10, batch=batch, num_probes=probes, device=device, quantizer=quantizer,
        engine="vamana" if vamana else "ivf", sweep=sweep,
        **({"search_size": search_size} if vamana else {"assign_copies": copies}),
    )
    compile_s = build.BUILD_SECONDS - compile0
    name = ANN_NAMES[mode] + ("_cos" if metric == "cosine" else "") + ("_adv" if adversarial else "")
    return {
        "metric": f"embed{n // 1000}k_d{dim}_{name}_qps",
        "value": out["qps"],
        "unit": "qps",
        "vs_baseline": out["qps"] / baseline_qps(mode, metric),
        "recall@10": out["recall@10"],
        "recall_eps@10": out["recall_eps@10"],
        "build_s": out["build_s"],
        "build_compile_s": compile_s,
        "build_exec_s": out["build_s"] - compile_s,
        "qps_spread": out["qps_spread"],
        "n": n,
        "query_batch": batch,
        "gt_queries": n_queries,
        "margin_d10_over_drand": out["margin"],
        "platform": device.type,
        "device": card(device),
        **({"sweep": out["sweep"]} if out.get("sweep") else {}),
        "peak_mem_gib": out.get("peak_mem_gib"),
    }


def run_fused(n: int, dim: int, n_queries: int, device, *, batch: int = 4096, copies: int = 4, clusters: int = 0,
              probes: int = 0, sweep=(), adversarial: bool = False) -> dict:
    """``fused`` through ``annbench.run_fused`` (``bench.py:268-400``)."""
    from semadb_tpu_torch.tools import annbench

    device = torch.device(device)
    out = annbench.run_fused(n, dim, n_queries, batch=batch, copies=copies, num_probes=probes, device=device,
                             adversarial=adversarial, num_clusters=clusters, sweep=sweep)
    d2 = max(dim // 2, 16)
    return {
        "metric": f"embed{n // 1000}k_d{dim}+{d2}_fused" + ("_adv" if adversarial else "") + "_qps",
        "value": out["qps"],
        "unit": "qps",
        "vs_baseline": out["qps"] / baseline_qps("fused", "euclidean"),
        "recall@10": out["recall@10"],
        "build_s": out["build_s"],
        "n": n,
        "query_batch": batch,
        "gt_queries": n_queries,
        "platform": device.type,
        "device": card(device),
        **({"sweep": out["sweep"]} if out.get("sweep") else {}),
        "peak_mem_gib": out.get("peak_mem_gib"),
    }


# -- hybrid (bench.py:135-267) ---------------------------------------------------


def hybrid_rerank(v1: torch.Tensor, v2: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor, q1: torch.Tensor,
                  q2: torch.Tensor, weights=HYBRID_WEIGHTS, k: int = 10) -> torch.Tensor:
    """The union of two candidate pools (node ids i32[B, P] each) reranked by
    the exact weighted sum of both spaces' squared euclidean distances
    (``bench.py``'s ``hybrid_rerank``): each id once, empty slots (-1)
    never chosen; the best ``k`` ids, i64[B, k]."""
    w1, w2 = weights
    cand = torch.sort(torch.cat([i1, i2], 1).long(), 1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    ok = (cand >= 0) & ~dup
    out = []
    for lo in range(0, cand.shape[0], HYBRID_CHUNK):
        c = cand[lo : lo + HYBRID_CHUNK]
        d1 = ((v1[c.clamp(0, v1.shape[0] - 1)] - q1[lo : lo + HYBRID_CHUNK, None, :]) ** 2).sum(-1)
        d2 = ((v2[c.clamp(0, v2.shape[0] - 1)] - q2[lo : lo + HYBRID_CHUNK, None, :]) ** 2).sum(-1)
        s = (-(w1 * d1) - (w2 * d2)).masked_fill(~ok[lo : lo + HYBRID_CHUNK], float("-inf"))
        out.append(torch.gather(c, 1, torch.topk(s, k, dim=1).indices))
    return torch.cat(out)


def run_hybrid(n: int, dim: int, n_queries: int, device, *, batch: int = 4096, pool: int = 256, probes: int = 48,
               gt_queries: int = 0, seed: int = 42, keep: Optional[dict] = None) -> dict:
    """Two IVF indices over two views of one corpus, searched in batches
    (``pool`` candidates each at ``probes`` probes), then
    :func:`hybrid_rerank`; recall@10 against the exact combined score over
    the first ``gt_queries`` queries (0 = all). ``keep`` receives both
    indices and the query views."""
    from semadb_tpu_torch.tools.annbench import fused_ground_truth
    from semadb_tpu_torch.tools.datasets import embedding_like_views

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d2 = max(dim // 2, 16)
    ds1, ds2 = embedding_like_views(n, [dim, d2], n_queries, seed=seed)
    ids = np.arange(2, n + 2, dtype=np.int32)
    t0 = time.perf_counter()
    idx1, idx2 = _ivf(dim, "euclidean", 2, device), _ivf(d2, "euclidean", 2, device)
    idx1.insert_bulk(ids, ds1.train)
    idx2.insert_bulk(ids, ds2.train)
    idx1.sync()
    build_s = time.perf_counter() - t0
    stage("hybrid", f"build done {build_s:.1f}s")
    n_gt = min(gt_queries or n_queries, n_queries)
    t0 = time.perf_counter()
    gt = fused_ground_truth([ds1.train, ds2.train], [ds1.test[:n_gt], ds2.test[:n_gt]], HYBRID_WEIGHTS, 10, device)
    gt_s = time.perf_counter() - t0
    ds1.train = ds2.train = None

    def query_all():
        hits = []
        t1 = time.perf_counter()
        for i in range(0, n_queries, batch):
            q1 = torch.from_numpy(np.ascontiguousarray(ds1.test[i : i + batch])).to(device)
            q2 = torch.from_numpy(np.ascontiguousarray(ds2.test[i : i + batch])).to(device)
            _, i1 = idx1.search_batch_async(q1, pool, probes)
            _, i2 = idx2.search_batch_async(q2, pool, probes)
            hits.append(hybrid_rerank(idx1.vectors, idx2.vectors, i1, i2, q1, q2))
        out = torch.cat(hits).cpu().numpy() - 2  # node id → train row
        return out, time.perf_counter() - t1

    query_all()  # warm-up
    out, wall = query_all()
    recall = _recall(out[:n_gt], gt)
    if keep is not None:
        keep.update(indices=(idx1, idx2), views=(ds1.test, ds2.test), ground_truth=gt)
    return {
        "metric": f"embed{n // 1000}k_d{dim}+{d2}_hybrid_qps",
        "value": n_queries / wall,
        "unit": "qps",
        "vs_baseline": n_queries / wall / baseline_qps("hybrid", "euclidean"),
        "recall@10": recall,
        "build_s": build_s,
        "n": n,
        "query_batch": batch,
        "gt_queries": n_gt,
        "platform": device.type,
        "device": card(device),
        "pool": pool,
        "probes": probes,
        "ground_truth_s": gt_s,
        "memory": memory(device),
    }


# -- filtered (bench.py:402-558) ---------------------------------------------------


def filter_members(n: int, sels, seed: int = 7) -> dict:
    """``bench.py``'s filter draws: selectivity → bool[n] over train rows,
    one ``default_rng(7)`` stream in the order of ``sels``."""
    rng = np.random.default_rng(seed)
    return {sel: rng.random(n) < sel for sel in sels}


def filtered_ground_truth(train, test, member: np.ndarray, metric: str, device, k: int = 10) -> np.ndarray:
    """Exact top-k train rows among the members, on ``device``: the member
    rows gathered, then ``compute_ground_truth_device``'s blockwise scan."""
    from semadb_tpu_torch.tools.datasets import _as_tensor, compute_ground_truth_device

    rows = np.nonzero(member)[0]
    corpus = _as_tensor(train, device)
    sub = corpus[torch.from_numpy(rows).to(corpus.device)]
    gt = compute_ground_truth_device(AnnDataset("members", metric, sub, test), k, device)
    return rows[gt]


def run_filtered(n: int, dim: int, n_queries: int, device, *, batch: int = 4096, sels=(0.10, 0.005),
                 gt_queries: int = 0, spread: float = 0.5, metric: str = "euclidean", prebuilt=None,
                 keep: Optional[dict] = None) -> dict:
    """Filtered search at each selectivity of ``sels``; recall@10 against the
    exact filtered ground truth over the first ``gt_queries`` queries (0 =
    all). ``prebuilt``: (an ``IndexIVF`` holding the rows of
    ``embedding_like(n, dim, n_queries, spread=spread, metric=metric)`` at
    node ids 2..n+1, those queries), used instead of a build of its own.
    ``keep`` receives the ``members`` by selectivity."""
    from semadb_tpu_torch.index.ivf import FILTER_EXACT_CAP

    device = torch.device(device)
    if prebuilt is None:
        ds = _generate(n, dim, n_queries, device, spread=spread, metric=metric)
        train = ds.train if isinstance(ds.train, torch.Tensor) else torch.from_numpy(ds.train).to(device)
        ds.train = None
        test = ds.test
        idx = None
    else:
        idx, test = prebuilt
        train = idx.vectors[2 : n + 2]
    n_gt = min(gt_queries or n_queries, n_queries)
    members = filter_members(n, sels)
    gts = {}
    t0 = time.perf_counter()
    for sel in sels:
        gts[sel] = filtered_ground_truth(train, test[:n_gt], members[sel], metric, device)
        stage("filtered", f"ground truth done sel={sel}")
    gt_s = time.perf_counter() - t0
    build_s = None
    if idx is None:
        idx = _ivf(dim, metric, 2, device)
        t0 = time.perf_counter()
        idx.insert_bulk(np.arange(2, n + 2, dtype=np.int64), train, defer_fit=True)
        del train
        idx.flush_pending()
        idx.sync()
        build_s = time.perf_counter() - t0
        stage("filtered", f"build done {build_s:.1f}s")
    else:
        del train
    ids = np.arange(2, n + 2, dtype=np.int64)
    rows = {}
    for sel in sels:
        mask = np.zeros(idx.capacity, bool)
        mask[ids[members[sel]]] = True
        count = int(members[sel].sum())

        def query_all():
            outs = []
            t1 = time.perf_counter()
            for i in range(0, n_queries, batch):
                outs.append(idx.search_batch_async(test[i : i + batch], 10, filter_mask=mask)[1])
            return torch.cat(outs).cpu().numpy() - 2, time.perf_counter() - t1

        query_all()  # warm-up
        out, wall = query_all()
        out2, wall2 = query_all()
        if wall2 < wall:
            out, wall = out2, wall2
        exact = count <= max(idx._num_probes() * idx.slab, FILTER_EXACT_CAP)
        rows[f"sel_{sel}"] = {"recall@10": _recall(out[:n_gt], gts[sel]), "qps": n_queries / wall, "members": count,
                              "path": "exact member scan" if exact else "widened probes"}
        stage("filtered", f"sel={sel}: {rows[f'sel_{sel}']}")
    if keep is not None:
        keep.update(members=members, index=idx)
    main_row = rows.get("sel_0.1") or rows[f"sel_{sels[0]}"]
    return {
        "metric": f"embed{n // 1000}k_d{dim}_filtered_qps",
        "value": main_row["qps"],
        "unit": "qps",
        "vs_baseline": main_row["qps"] / baseline_qps("filtered", metric),
        "recall@10": main_row["recall@10"],
        "selective": rows.get("sel_0.005"),
        "build_s": build_s,
        "n": n,
        "query_batch": batch,
        "gt_queries": n_gt,
        "platform": device.type,
        "device": card(device),
        "by_selectivity": rows,
        "ground_truth_s": gt_s,
        "memory": memory(device),
    }


# -- http (bench.py:559-693) -------------------------------------------------------


class _Client:
    """One keep-alive msgpack connection to the v2 API."""

    HEADERS = {"X-User-Id": "bench", "X-Plan-Id": "BASIC", "Content-Type": "application/msgpack",
               "Accept": "application/msgpack"}

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def post(self, path: str, body) -> dict:
        import msgpack

        self.conn.request("POST", "/v2/collections" + path, body=msgpack.packb(body), headers=self.HEADERS)
        r = self.conn.getresponse()
        raw = r.read()
        if r.status != 200:
            raise RuntimeError(f"POST {path}: HTTP {r.status} {raw[:500]!r}")
        return msgpack.unpackb(raw, raw=False)


def run_http(n: int, dim: int, n_queries: int, device, *, http_batch: int = 1024, gt_queries: int = 0,
             spread: float = 0.5, metric: str = "euclidean") -> dict:
    """The serving path over a real socket: a ``vectorIVF`` collection, the
    corpus over msgpack ``POST /points`` in batches of 10,000, then
    min(n_queries, 8,192) queries through ``points/search/batch`` in requests
    of ``http_batch`` (best of two passes after a warm-up). Recall@10 over the
    first ``gt_queries`` queries (0 = all), and every returned distance
    against the exact f64 one (``max_distance_rel_err``)."""
    from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
    from semadb_tpu_torch.httpapi.server import HttpApiConfig, HttpServer
    from semadb_tpu_torch.models.collection import UserPlan
    from semadb_tpu_torch.tools.datasets import compute_ground_truth_device, embedding_like

    device = torch.device(device)
    ds = embedding_like(n, dim, n_queries, spread=spread, metric=metric)
    n_gt = min(gt_queries or n_queries, n_queries)
    gt = compute_ground_truth_device(AnnDataset(ds.name, ds.metric, ds.train, ds.test[:n_gt]), 10, device)
    stage("http", f"dataset + ground truth ready ({n_gt} queries)")
    root = tempfile.mkdtemp(prefix="httpbench")
    node = ClusterNode(ClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0), device)
    node.serve()
    srv = HttpServer(node, HttpApiConfig(http_host="127.0.0.1", http_port=0,
                                         user_plans={"BASIC": UserPlan(name="BASIC", max_collections=2)}))
    srv.serve_background()
    try:
        client = _Client(srv.port)
        client.post("", {"id": "bench1", "indexSchema": {"emb": {
            "type": "vectorIVF", "vectorIVF": {"vectorSize": dim, "distanceMetric": metric}}}})
        # uuid5 of the row: a stable _id → row map whatever the node ids
        uid = [str(uuid_mod.uuid5(uuid_mod.NAMESPACE_URL, str(i))) for i in range(n)]
        row_of = {u: i for i, u in enumerate(uid)}
        t0 = time.perf_counter()
        for lo in range(0, n, HTTP_INSERT):
            hi = min(lo + HTTP_INSERT, n)
            client.post("/bench1/points", {"points": [{"_id": uid[i], "emb": ds.train[i].tolist()}
                                                      for i in range(lo, hi)]})
        ingest_s = time.perf_counter() - t0
        stage("http", f"ingest done {ingest_s:.1f}s ({n / ingest_s:.0f} pts/s)")
        n_q = min(n_queries, HTTP_QUERIES)

        def run_queries():
            hits = []
            t1 = time.perf_counter()
            for lo in range(0, n_q, http_batch):
                qs = [{"query": {"property": "emb", "vectorIVF": {
                    "vector": np.asarray(ds.test[i], np.float32).tobytes(), "limit": 10}}, "limit": 10}
                    for i in range(lo, min(lo + http_batch, n_q))]
                hits.extend(client.post("/bench1/points/search/batch", {"queries": qs})["results"])
            return hits, time.perf_counter() - t1

        run_queries()  # warm-up
        hits, wall = run_queries()
        hits2, wall2 = run_queries()
        if wall2 < wall:
            hits, wall = hits2, wall2
    finally:
        srv.shutdown()
        node.close()
        shutil.rmtree(root, ignore_errors=True)
    m = min(n_gt, n_q)
    got = np.array([[row_of[p["_id"]] for p in hits[i]["points"]] + [-1] * (10 - len(hits[i]["points"]))
                    for i in range(m)])
    recall = _recall(got, gt[:m])
    err = 0.0
    for i in range(len(hits)):
        pts = hits[i]["points"]
        rows = np.array([row_of[p["_id"]] for p in pts])
        x, q = ds.train[rows].astype(np.float64), ds.test[i].astype(np.float64)
        want = ((x - q) ** 2).sum(1) if metric == "euclidean" else 1.0 - x @ q
        have = np.array([p["_distance"] for p in pts])
        err = max(err, float(np.max(np.abs(have - want) / np.maximum(np.abs(want), 1.0), initial=0.0)))
    stage("http", f"queries done {wall:.2f}s")
    return {
        "metric": f"embed{n // 1000}k_d{dim}_http_qps",
        "value": n_q / wall,
        "unit": "qps",
        "vs_baseline": n_q / wall / baseline_qps("http", metric),
        "recall@10": recall,
        "http_batch": http_batch,
        "ingest_pts_per_s": n / ingest_s,
        "n": n,
        "gt_queries": m,
        "platform": device.type,
        "device": card(device),
        "max_distance_rel_err": err,
        "memory": memory(device),
    }


# -- write (bench.py:694-805) -------------------------------------------------------


def run_write(n: int, dim: int, n_queries: int, device, *, txns: int = 100, txn_points: int = 1000, batch: int = 4096,
              spread: float = 0.5, metric: str = "euclidean") -> dict:
    """Sustained 1k-point writes into a fitted ``IndexIVF``
    (``_place_fitted``), each followed by a search batch that is not waited
    for; recall@10 of the final index over its first 2,048 queries against
    the ground truth of the whole corpus (made before the build)."""
    from semadb_tpu_torch.tools.datasets import compute_ground_truth_device

    device = torch.device(device)
    big = _big(n, dim, device)
    ds = _generate(n + txns * txn_points, dim, n_queries, device, spread=spread, metric=metric)
    stage("write", "dataset ready")
    n_gt = min(WRITE_GT_QUERIES, len(ds.test))
    gt = compute_ground_truth_device(AnnDataset(ds.name, ds.metric, ds.train, ds.test[:n_gt]), 10, device)
    stage("write", "ground truth done")
    extra = ds.train[n:].cpu().numpy() if big else ds.train[n:]
    base = ds.train[:n]
    ds.train = None
    test = ds.test
    idx = _ivf(dim, metric, 2, device)
    t0 = time.perf_counter()
    idx.insert_bulk(np.arange(2, n + 2, dtype=np.int32), base, defer_fit=big)
    del base
    idx.flush_pending()
    idx.sync()
    build_s = time.perf_counter() - t0
    stage("write", f"build done {build_s:.1f}s")
    # Warm both paths (txn 0 rewrites these two ids), and grow the capacity
    # past the loop's largest id up front, as bench.py does
    idx.search_batch(test[:batch], 10)
    idx.insert_update_delete(zip(range(n + 2, n + 4), extra[:2]))
    idx.insert_update_delete([(n + 2 + txns * txn_points + 1, extra[-1])])
    idx.search_batch(test[:batch], 10)
    stage("write", "warmup done")
    t0 = time.perf_counter()
    searches = 0
    for t in range(txns):
        lo = t * txn_points
        idx.insert_update_delete(zip(range(n + 2 + lo, n + 2 + lo + txn_points), extra[lo : lo + txn_points]))
        q = test[(t * batch) % max(len(test) - batch, 1) :][:batch]
        idx.search_batch_async(q, 10)
        searches += len(q)
    idx.search_batch(test[:8], 10)  # waits for the queued searches
    wall = time.perf_counter() - t0
    _, got = idx.search_batch(test[:n_gt], 10)
    return {
        "metric": f"embed{n // 1000}k_d{dim}_sustained_write_pts_per_s",
        "value": txns * txn_points / wall,
        "unit": "points/s",
        "vs_baseline": txns * txn_points / wall / 1537.7,
        "write_txns": txns,
        "txn_points": txn_points,
        "interleaved_search_qps": searches / wall,
        "recall@10_after_writes": _recall(got - 2, gt),
        "build_s": build_s,
        "n": n,
        "platform": device.type,
        "device": card(device),
        "memory": memory(device),
    }


# -- text (bench.py:806-911) --------------------------------------------------------


def text_corpus(n: int, seed: int = 7):
    """``bench.py``'s text corpus: Zipf(1.1) ranks i64[n, 12] over a
    20,000-word vocabulary, and the generator, whose next draw is the
    queries' (:func:`text_queries`)."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.1, size=(n, TEXT_TERMS)).astype(np.int64) - 1, TEXT_VOCAB - 1)
    return ranks, rng


def text_queries(rng) -> dict:
    """The three kinds of query, in ``bench.py``'s order and draws: two common
    terms (ranks 0-9, wide postings) with containsAny, and 400 pairs of mid
    terms (ranks 100-999) with containsAny and with containsAll."""
    w = [f"w{i}" for i in range(TEXT_VOCAB)]
    common = [{"value": f"{w[a]} {w[b]}", "operator": "containsAny", "limit": 10}
              for a in range(4) for b in range(4, 8)]
    pairs = rng.integers(100, 1000, size=(400, 2))
    return {
        "common": common,
        "mid_any": [{"value": f"{w[a]} {w[b]}", "operator": "containsAny", "limit": 10} for a, b in pairs],
        "mid_all": [{"value": f"{w[a]} {w[b]}", "operator": "containsAll", "limit": 10} for a, b in pairs],
    }


def run_text(n: int, keep: Optional[dict] = None) -> dict:
    """TF-IDF ingest and search through a ``Shard`` with the host text index,
    10,000 documents a write transaction; queries per second of each kind.
    The shard is given the CPU: it holds no vector index, so nothing reaches
    a card. ``keep`` receives each query's answer as (ids, scores) by kind."""
    from semadb_tpu_torch.models.collection import Collection, UserPlan
    from semadb_tpu_torch.models.point import Point
    from semadb_tpu_torch.models.query import SearchRequest
    from semadb_tpu_torch.models.schema import IndexSchema
    from semadb_tpu_torch.shard.shard import Shard
    from semadb_tpu_torch.store.diskstore import open_store

    ranks, rng = text_corpus(n)
    stage("text", f"corpus drawn ({n} docs x {TEXT_TERMS} terms, vocab {TEXT_VOCAB})")
    schema = IndexSchema.from_dict({"body": {"type": "text", "text": {"analyser": "standard"}}})
    col = Collection(user_id="bench", id="textb", index_schema=schema, user_plan=UserPlan())
    root = tempfile.mkdtemp(prefix="textbench")
    words = [f"w{i}" for i in range(TEXT_VOCAB)]
    answers: dict = {}
    try:
        shard = Shard(open_store(os.path.join(root, "sharddb")), col, torch.device("cpu"))
        t0 = time.perf_counter()
        for lo in range(0, n, TEXT_TXN):
            shard.insert_points([Point.from_map({"body": " ".join(words[r] for r in ranks[i])}, uuid_mod.UUID(int=i + 1))
                                 for i in range(lo, min(lo + TEXT_TXN, n))])
        ingest_s = time.perf_counter() - t0
        stage("text", f"ingest done {ingest_s:.1f}s ({n / ingest_s:.0f} docs/s, {n // TEXT_TXN} txns)")
        qps = {}
        for kind, qs in text_queries(rng).items():
            t0 = time.perf_counter()
            got = [shard.search_points(SearchRequest.from_dict({"query": {"property": "body", "text": q}, "limit": 10}))
                   for q in qs]
            qps[kind] = len(qs) / (time.perf_counter() - t0)
            answers[kind] = [([str(r.point.id) for r in res], [r.score for r in res]) for res in got]
            stage("text", f"{kind}: {qps[kind]:.1f} qps ({sum(len(r) for r in got)} results)")
        shard.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if keep is not None:
        keep["answers"] = answers
    return {
        "metric": f"text{n // 1000}k_v{TEXT_VOCAB // 1000}k_search_qps",
        "value": qps["mid_any"],
        "unit": "qps",
        "vs_baseline": 0,
        "ingest_docs_per_s": n / ingest_s,
        "qps_containsAny_common": qps["common"],
        "qps_containsAny_mid": qps["mid_any"],
        "qps_containsAll_mid": qps["mid_all"],
        "n_docs": n,
        "platform": "host",
        "device": "cpu",
    }


# -- shardwrite (bench.py:912-1169) ----------------------------------------------------


def _self_search(idx, vectors: np.ndarray, node_ids: np.ndarray) -> int:
    """How many of ``vectors`` come back under their own node id at distance 0."""
    found = 0
    for lo in range(0, len(vectors), SELF_BATCH):
        d, i = idx.search_batch(vectors[lo : lo + SELF_BATCH], 10)
        hit = (i == node_ids[lo : lo + SELF_BATCH, None]) & (d <= 0.0)
        found += int(hit.any(1).sum())
    return found


def _next_node_id(shard) -> int:
    out = [0]

    def reader(bm):
        out[0] = struct.unpack("<Q", bm.get("internal").get(b"nextFreeNodeId"))[0]

    shard.db.read(reader)
    return out[0]


def run_shardwrite(n: int, dim: int, device, *, txns: int = 64, txn_points: int = 1000, warmup_txns: int = 1,
                   flush_every: int = 0, copies: int = 2, spread: float = 0.5, metric: str = "euclidean") -> dict:
    """Durable writes through a ``Shard`` on a disk store (``bench.py``'s
    protocol; the warmup takes the run's first ids): an ``IndexIVF`` of ``n``
    points built in bulk and adopted by the shard, ``nextFreeNodeId``
    reserved past it, the full snapshot, ``warmup_txns`` untimed and ``txns``
    timed insert transactions of ``txn_points`` (with an incremental flush
    every ``flush_every`` journaled txns when > 0), then a crash: the store
    closed without the shard's flush, the engine dropped, and a reopen from
    the snapshot and the journal's coalesced replay. The reopened engine
    answers 64 probes (top-10 overlap with the engine before the crash) and
    every acknowledged point's own search; then the close compaction."""
    import msgpack

    import semadb_tpu_torch.shard.shard as shardmod
    from semadb_tpu_torch.index.manager import IndexManager
    from semadb_tpu_torch.models import Collection, IndexSchema, Point, UserPlan
    from semadb_tpu_torch.models import constants as C
    from semadb_tpu_torch.store.diskstore import open_store

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    big = _big(n, dim, device)
    ds = _generate(n + (txns + warmup_txns) * txn_points, dim, 128, device, spread=spread, metric=metric)
    extra = ds.train[n:].cpu().numpy() if big else ds.train[n:]
    base = ds.train[:n]
    probes = ds.test[:64].cpu().numpy() if big else np.asarray(ds.test[:64], np.float32)
    ds.train = None
    stage("shardwrite", "dataset ready")
    idx = _ivf(dim, metric, copies, device)
    t0 = time.perf_counter()
    idx.insert_bulk(np.arange(2, n + 2, dtype=np.int64), base, defer_fit=big)
    del base
    idx.flush_pending()
    idx.sync()
    build_s = time.perf_counter() - t0
    initial_capacity = idx.capacity
    stage("shardwrite", f"engine build done {build_s:.1f}s (capacity {initial_capacity})")
    mem = {"post-build": memory(device)}
    root = tempfile.mkdtemp(prefix="shardwrite")
    path = os.path.join(root, "sharddb.sdb")
    # assignCopies must match the engine's: the schema configures the reload
    schema = IndexSchema.from_dict({"emb": {"type": "vectorIVF", "vectorIVF": {
        "vectorSize": dim, "distanceMetric": metric, "assignCopies": copies}}})
    col = Collection(user_id="b", id="c", index_schema=schema, user_plan=UserPlan())
    bucket = IndexManager.bucket_name(C.INDEX_TYPE_VECTOR_IVF, "emb")
    saved_every = shardmod.FLUSH_EVERY_TXNS
    shardmod.FLUSH_EVERY_TXNS = flush_every
    try:
        shard = shardmod.Shard(open_store(path), col, device)
        shard.device_indices[bucket] = idx
        # Fresh node ids for the writes, past the bulk-built rows 2..n+1
        shard.db.write(lambda bm: bm.get("internal").put(b"nextFreeNodeId", struct.pack("<Q", n + 2)))
        t0 = time.perf_counter()
        full_chunks = shard.flush()
        full_flush_s = time.perf_counter() - t0
        stage("shardwrite", f"full snapshot: {full_flush_s:.1f}s ({full_chunks} chunks)")
        inc_flushes = []
        orig_flush = shard.flush

        def timed_flush():
            f0 = time.perf_counter()
            chunks = orig_flush()
            inc_flushes.append((time.perf_counter() - f0, chunks))
            return chunks

        shard.flush = timed_flush

        def one_txn(lo: int, count: int) -> float:
            """Insert rows lo..lo+count-1 of ``extra`` as one transaction."""
            pts = [Point(id=uuid_mod.UUID(int=n + 10 + lo + j),
                         data=msgpack.packb({"emb": extra[lo + j].tolist()}, use_bin_type=True))
                   for j in range(count)]
            w0 = time.perf_counter()
            shard.insert_points(pts)
            return time.perf_counter() - w0

        first_id = _next_node_id(shard)
        # The warmup's ids stay below the initial capacity, so a capacity
        # growth is never hidden in it: cut to the room left there
        room = max(1, min(warmup_txns * txn_points, initial_capacity - first_id))
        warmup_s = [one_txn(lo, min(txn_points, room - lo)) for lo in range(0, room if warmup_txns else 0, txn_points)]
        warm = _next_node_id(shard) - first_id
        warmup_ids = [first_id, first_id + warm - 1]
        t_loop = time.perf_counter()
        lat = []
        for t in range(txns):
            lat.append(one_txn(warm + t * txn_points, txn_points))
            if t % 16 == 15:
                stage("shardwrite", f"txn {t + 1}/{txns} elapsed {time.perf_counter() - t_loop:.1f}s")
        wall = time.perf_counter() - t_loop
        acked = warm + txns * txn_points
        acked_ids = np.arange(first_id, first_id + acked)
        if _next_node_id(shard) != first_id + acked:
            raise AssertionError(f"{acked} inserts took node ids {first_id}..{_next_node_id(shard) - 1}")
        mem["post-txns"] = memory(device)
        lat_ms = np.sort(np.array(lat) * 1000.0)
        slow = sorted(enumerate(lat), key=lambda x: -x[1])[:3]
        _, want_ids = idx.search_batch(probes, 10)
        journal_txns = shard._delta_txns
        shard.db.close()  # the store's file released; no flush of the shard: a crash
        shard.flush = orig_flush  # the wrapper's closure holds the shard and its engine
        del shard, idx, orig_flush, timed_flush
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        mem["pre-reopen"] = memory(device)
        t0 = time.perf_counter()
        shard = shardmod.Shard(open_store(path), col, device)
        idx = shard.device_indices[bucket]
        _, got_ids = idx.search_batch(probes, 10)
        reopen_s = time.perf_counter() - t0
        replayed = shard._delta_txns
        mem["post-reopen"] = memory(device)
        # Overlap, not order: the replay coalesces txns into larger writes,
        # whose packing may place the replayed points in other slots
        parity = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10.0 for a, b in zip(want_ids, got_ids)]))
        found = _self_search(idx, extra[:acked], acked_ids)
        stage("shardwrite", f"crash reopen {reopen_s:.1f}s ({replayed} journaled txns, probe parity {parity:.3f}, "
              f"{found} of {acked} acknowledged points found)")
        t0 = time.perf_counter()
        shard.close()  # the compaction: the full cut off the hot path
        close_flush_s = time.perf_counter() - t0
    finally:
        shardmod.FLUSH_EVERY_TXNS = saved_every
        shutil.rmtree(root, ignore_errors=True)
    return {
        "metric": f"embed{n // 1000}k_d{dim}_shard_write_p99_ms",
        "value": float(lat_ms[min(int(len(lat_ms) * 0.99), len(lat_ms) - 1)]),
        "unit": "ms",
        "vs_baseline": float(lat_ms[min(int(len(lat_ms) * 0.99), len(lat_ms) - 1)]) / 1000.0,
        "write_p50_ms": float(lat_ms[len(lat_ms) // 2]),
        "write_max_ms": float(lat_ms[-1]),
        "slow_txns": [(i, s * 1000.0) for i, s in slow],
        "warmup_txn_s": warmup_s,
        "points_per_s": txns * txn_points / wall,
        "txns": txns,
        "txn_points": txn_points,
        "flush_every_txns": flush_every,
        "incremental_flushes": len(inc_flushes),
        "inc_flush_s": [f for f, _ in inc_flushes],
        "inc_flush_chunks": [c for _, c in inc_flushes],
        "full_snapshot_s": full_flush_s,
        "full_snapshot_chunks": full_chunks,
        "crash_reopen_s": reopen_s,
        "reopen_probe_parity": parity,
        "close_compaction_s": close_flush_s,
        "journal_txns_replayed": replayed,
        "journal_txns_written": journal_txns,
        "acknowledged": acked,
        "acknowledged_found": found,
        "warmup_node_ids": warmup_ids if warm else [],
        "initial_capacity": initial_capacity,
        "build_s": build_s,
        "n": n,
        "platform": device.type,
        "device": card(device),
        "memory": mem,
    }


# -- dispatch (bench.py:1170-1277) --------------------------------------------------


def run_mode(s: dict, device) -> dict:
    """The JSON line of mode ``s["mode"]`` at the sizes of ``s`` (:func:`settings`)."""
    device = torch.device(device)
    mode, n, dim, nq = s["mode"], s["n"], s["dim"], s["n_queries"]
    if mode == "text":
        return run_text(n if n != 1_000_000 else TEXT_DOCS)
    if mode in ANN_NAMES:
        return run_ann(mode, n, dim, nq, device, batch=s["batch"], search_size=s["search_size"], probes=s["probes"],
                       spread=s["spread"], metric=s["metric"], copies=s["copies"], sweep=s["sweep"],
                       adversarial=s["adversarial"], gt_queries=s["gt_queries"])
    if mode == "fused":
        return run_fused(n, dim, nq, device, batch=s["batch"], copies=s["fused_copies"], clusters=s["fused_clusters"],
                         probes=s["probes"] or s["fused_probes"], sweep=s["fused_sweep"],
                         adversarial=s["adversarial"])
    if mode == "hybrid":
        return run_hybrid(n, dim, nq, device, batch=s["batch"], pool=s["hybrid_pool"],
                          probes=s["probes"] or s["hybrid_probes"], gt_queries=s["gt_queries"])
    if mode == "filtered":
        return run_filtered(n, dim, nq, device, batch=s["batch"], sels=s["sels"], gt_queries=s["gt_queries"],
                            spread=s["spread"], metric=s["metric"])
    if mode == "http":
        return run_http(n, dim, nq, device, http_batch=s["http_batch"], gt_queries=s["gt_queries"],
                        spread=s["spread"], metric=s["metric"])
    if mode == "write":
        return run_write(n, dim, nq, device, txns=s["txns"], txn_points=s["txn_points"], batch=s["batch"],
                         spread=s["spread"], metric=s["metric"])
    if mode == "shardwrite":
        return run_shardwrite(n, dim, device, txns=s["txns"], txn_points=s["txn_points"],
                              warmup_txns=s["warmup_txns"], flush_every=s["flush_every"], copies=s["copies"],
                              spread=s["spread"], metric=s["metric"])
    raise ValueError(f"BENCH_MODE={mode!r}: the modes are {', '.join(MODES)}")


def main(argv=None, env=None) -> int:
    ap = argparse.ArgumentParser(description="bench.py's modes on the port (BENCH_* environment)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    s = settings(env)
    device = torch.device(args.device)
    if s["mode"] != "text" and device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: --device cuda needs a CUDA device (pass --device cpu to run the plain versions)")
    if (os.environ if env is None else env).get("BENCH_DEBUG_TIMERS"):
        import logging

        from semadb_tpu_torch.utils.logging import setup_logging

        setup_logging(debug=False, pretty=True)
        for name in DEBUG_LOGGERS:
            logging.getLogger(name).setLevel(logging.DEBUG)
    print(json.dumps(run_mode(s, device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
