#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (semadb_tpu_torch) starts and is
right on one NVIDIA GPU.

Usage, from the root of a checkout (one CUDA card, no network):

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run (non-zero exit, no result line):

1. Environment and build: the card (``nvidia-smi``), torch and CUDA versions,
   the codecs, then K1 (``semadb_tpu_torch/csrc/hamming.cu``), K2
   (``csrc/gather.cu``), K3 (``csrc/ivf_scan.cu``) and K4
   (``csrc/ivf_rerank.cu``) built with ``nvcc`` and the key-value store
   (``csrc/kvstore.cpp``) with ``g++`` from the checkout's sources, all five
   at once, timed.
2. Kernel: K1 against its plain PyTorch version on the card, hamming and
   jaccard, on both of its routes (tensor cores and CUDA cores), at B in
   {1, 2, 7, 8, 15, 16, 17, 33, 64, 1000} (both sides of the route
   threshold), N in {1, 511, 100003}, W in {1, 5, 8, 9, 48, 128}, and at
   B = 4096 over N = 32,768, W = 48 and B = 65,537 (two launches) over
   N = 511, W = 5. Both metrics must be exactly equal (integer counts and
   one IEEE f32 division on both sides).
3. The slice (``semadb_tpu_torch/tools/dbpedia_bq.py``): the port's
   ClusterNode and HTTP v2 server, in-process on ``cuda``, with
   ``config/singleServer.yaml`` (the root dir a temporary directory; the
   RPC and HTTP ports 0, i.e. ephemeral). A 1536-d cosine ``vectorFlat``
   collection with a binary quantizer (hamming, threshold 0.0) — the
   reference's dbpedia-openai-100k-angular v2-BQ deployment — takes
   100,000 points: 1,000 over HTTP and the rest through
   ``ClusterNode.insert_points`` (the call the v2 insert handler makes) in
   batches of 10,000. Then 10 single searches and one batch of 64 over
   HTTP; every result is checked against a numpy brute-force hamming scan
   over the sign bits by the tie rule. K1's launch counts are zeroed
   before this phase; after it there must be launches at B = 1 and at
   B > 1, and on each route.
4. Kernel timing at the slice's shapes: B = 1, 64 and 4096 over the
   largest shard's own code table (W = 48), the queries being
   ``dbpedia_bq.queries`` encoded with the shard's threshold. K1 must
   first equal its plain version on these operands, both metrics, both
   routes, exactly (at B = 4096 the plain version is compared, not timed).
   Then each route's device time per call (torch.profiler over 30 calls,
   K1's own events) twice: warm, back to back, and L2-cold, with 128 MB
   written and another 128 MB read between calls (the read leaves clean
   lines, so the kernel pays no write-back of the flush); the cold time is
   the one set against the bound. Also the plain version's device time
   and a call's time with its host launch work (median of 30, CUDA
   events) at B = 1 and 64, and both routes cold at B in {2, 4, 8, 16, 32},
   where the route threshold lies.
5. K2 kernel: the gather against its plain PyTorch version on the card,
   exactly (``torch.equal``), through the checked path, at D in {1, 3, 128,
   1536}, n in {1, 1023, 1024, 100003}, cap in {1, 70001}, ids holding 0,
   cap - 1 and repeats; once more with a base pointer off the 16-byte grid.
   ``gather_rows`` must refuse n % 1024 != 0 and the checked path ids of
   cap and -1.
6. The gather path: ``semadb_tpu_torch.tools.gatherbench.main`` at its
   defaults on ``cuda`` (1,000,000 x 128 f32 vectors, 1,048,576 ids): K2,
   ``torch.index_select`` and the plain version timed; the whole kernel
   output must equal ``index_select``'s. K2's launch count is zeroed before
   this phase and must be > 0 after it.

7. K3 and K4 (``csrc/ivf_scan.cu``, ``csrc/ivf_rerank.cu``, the IVF query's
   probed-slab scan and exact rerank) against their plain PyTorch versions on
   the card: K3 at B in {1, 7, 64, 4096}, p in {1, 5, 24, 96}, S in {64, 128, 192}, r in {3,
   100, 128}, rr in {20, 64, 256}, f32 and bf16 slabs, 30% NIL slots, with
   and without a filter mask (every value of each parameter, in 20
   combinations), the bench cell's shape, and the layouts a batch meets:
   every query on the same 24 probes (B = 4096, the load imbalance), ids
   stored in two clusters, live prefixes with holes (a refit's packing, then
   deletes), and a scratch budget patched small so that B runs in chunks;
   K4 at D in {3, 128, 1536}, k in {1, 10, 100}, all three metrics (27
   combinations), pools that hold ids two or three times, deduplicated by
   the kernel (9 more), and both routes of its design (bulk copies at D in
   {4, 128, 1536, 4096}; element loads at D = 3 and on a base off the
   16-byte grid) across k in {1, 10, 32, 33, 100}, rr in {20, 64, 256,
   2048} and B in {1, 7, 4096}, pools with every id 2-3 times and a pool
   that is all empty (33 more). K3 also at the 10M cell's widths over one
   slab set made on the card: C = 131,072 (32 tiles of the offsets scan),
   S = 192, r = 128, bf16, 30% NIL slots, at B in {1, 4096} x p in {24, 96},
   with and without a mask. Distances must agree within 1e-5 of the
   summed terms' magnitude (the sums run in another order), ids by the tie
   rule at that tolerance, pools as multisets.
8. The IVF bench cell: ``semadb_tpu_torch.tools.annbench.main`` at its
   defaults on ``cuda`` (the JAX package's default ``python bench.py``:
   1,000,000 x 128 ``embedding_like(spread=0.5, seed=42)``, euclidean,
   assignCopies 2, 32,768 queries in batches of 4,096, k = 10): recall@10
   against the exact f32 ground truth must be >= 0.99 and K3 and K4 must
   have launched; it prints the build's split, QPS, peak device memory and
   a torch.profiler pass over one batch, stage by stage. Then K3 and K4 on
   the cell's own operands (4,096 queries): checked against their plain
   versions, timed (torch.profiler, mean of 20 calls; K3's time is every
   device event of its calls, its five kernels and its memset, and each must
   have recorded one launch a call), the plain versions timed, and set
   against their byte bounds; K3 also at B from 1 to 4,096 (the cell's first
   B queries), K4 also at B = 1, on the device and as a call with its host
   work. Then K4 at the projected traversal's shape (D = 1536, rr = 256,
   k = 10, B = 4,096 and 1) over a seeded f32[400,000, 1536] table and random
   pools: checked, timed, its bound from the distinct rows the pools hold.
   With ``--k4-baseline SOURCE`` (another K4 source with the same C
   interface, such as the parent commit's) that library is built and timed
   beside the tree's K4 at each of these shapes.
8b. ``vectorIVF`` over HTTP v2: the port's node and server with
   ``config/singleServer.yaml``, a 128-d euclidean ``vectorIVF`` collection
   of 20,000 points (``embedding_like``, the bench cell's generator and
   spread) inserted through ``ClusterNode.insert_points``, 10 HTTP searches
   with held-out queries checked against numpy brute force (recall@10 >=
   0.95, every returned distance exact); K3 and K4 must have launched in
   this phase.
9. A hybrid collection over HTTP v2, as in 8b, on one shard
   (``shardPlacement: device``): a 128-d ``vectorIVF`` property beside
   ``body`` (text), ``category`` (string), ``year`` (integer) and ``tags``
   (stringArray), 100,000 documents (the reference text bench's corpus, Zipf
   over 20,000 words) ingested 10,000 a write transaction. Every query is
   checked against a plain evaluation over the generated documents: string,
   integer and stringArray filters (the first page over HTTP, and the whole
   set as the shard's index manager finds it);
   ``vectorIVF`` filtered by each (numpy's brute force over the members, the
   tie rule, distances exact); text ``containsAny`` and ``containsAll`` over
   common and mid-rank terms (the TF-IDF formula recomputed in numpy; scores
   within 1e-5 relative, descending, ids by the tie rule); a hybrid ``_or``
   of an unfiltered ``vectorIVF`` arm and a text arm (each hybrid score the
   arms' weighted sum; K3 and K4 must have launched). Then the widened-probe
   path on phase 8's index: a random filter over half its 1,000,000 points
   (past ``FILTER_EXACT_CAP``, so p = 4 x 24 and K3 skips masked slots),
   256 queries, recall@10 against numpy's exact search over the members
   >= 0.95, K3 and K4 launched. Then phase 8's index is dropped.
10. The 10M cell: ``BENCH_N=10000000 python bench.py`` on the port,
   ``annbench.main(["--n", "10000000", "--sweep", "48,96"])``: 10,000,000 x
   128 from ``embedding_like_device(spread=0.5, seed=42)`` on the card,
   euclidean, assignCopies 2, 32,768 queries in batches of 4,096, k = 10,
   the engine's default probes (24), exact f32 ground truth on the card. The
   refit must take the two-level path with the C, S and slab type the code
   predicts (131,072, 192, bf16); recall@10 >= 0.97 (the JAX package read
   0.9790 here); K3 and K4 must have launched; the sweep rows at p = 48 and
   96 are printed, and the build's split, QPS, memory and one batch under
   torch.profiler. Then K3 and K4 on the cell's own operands (checked,
   timed, their byte bounds), K3 and the recall on f32 slabs rebuilt from
   the same ``slab_ids`` (the slab memory budgets' evidence), and two write
   transactions of 10,000 new points each (ids past the corpus: the cell's
   last 10,000 queries, held-out rows of the corpus's mixture, then rows the
   generator draws seeded 43) through ``insert_update_delete``: each
   placement must go through the two-level assignment without a refit, and
   every new point must come back as its own nearest neighbour; the
   assignment's and the write repair's seconds and the rows the repair
   moved are printed. K3's times in this phase are held to a call's
   CUDA-event time, since the profiler loses some of its launches here (P2).

Each kernel's bound is its bytes (each input read once, each output
written once; for K2 each distinct row once; for K3 each distinct probed
cluster once, for K4 each distinct live pool row once) over 3.35 TB/s, from
this run's inputs. K2 does no arithmetic. K1's work is bit operations, and the
card's data sheet gives no rate for the tensor cores' single-bit MMA, so
no operations term can be a least time for it; the term at the int8 rate
(2 B N 32W / 1.979e15 s) is printed beside the bound for information.

The data are unit-norm 1536-d vectors with an embedding-like spectrum,
made from ``--seed`` with numpy. Output: progress lines, then the card's
name and power limit, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

KERNEL_SHAPES = [
    (b, n, w)
    for b in (1, 2, 7, 8, 15, 16, 17, 33, 64, 1000)
    for n in (1, 511, 100003)
    for w in (1, 5, 8, 9, 48, 128)
] + [(4096, 32768, 48), (65537, 511, 5)]
TIMED_B = (1, 64, 4096)
THRESHOLD_B = (2, 4, 8, 16, 32)
LIMIT = 10
GATHER_SHAPES = [(d, n, cap) for d in (1, 3, 128, 1536) for n in (1, 1023, 1024, 100003) for cap in (1, 70001)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15  # H100 SXM tensor cores, int8 dense
FLUSH_BYTES = 128 << 20  # written, and as much read, between L2-cold calls
PROFILER_WINDOWS = 3  # windows a time may take before a lost window fails the run
# Least share of a K3 call's CUDA-event time (host launch work included) that
# its profiler time may read where the profiler lost launches; the 10M cell
# read 86.8% on the H100
K3_EVENT_SHARE = 0.75
K1_KERNEL = "bit_distance_kernel"  # in the names of both of K1's routes


def log(*parts) -> None:
    print(*parts, flush=True)


# -- phases -------------------------------------------------------------------


def phase_environment(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] card: {smi}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    import msgpack

    try:
        import yaml  # noqa: F401
        have_yaml = True
    except ImportError:
        have_yaml = False
    log(f"[env] msgpack {msgpack.version}, yaml importable: {have_yaml}")
    return {"smi": smi, "have_yaml": have_yaml}


def phase_build():
    """Build K1-K4 and the key-value store at once, one compiler each."""
    from semadb_tpu_torch.ops.kernels import gather, hamming, ivf_rerank, ivf_scan
    from semadb_tpu_torch.store import native
    from semadb_tpu_torch.utils.build import BUILD_DIR

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    kernels = (("K1", hamming), ("K2", gather), ("K3", ivf_scan), ("K4", ivf_rerank))
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        jobs = {name: pool.submit(timed, mod._library) for name, mod in kernels}
        jobs["kvstore"] = pool.submit(timed, native.load_library)
        took = {name: job.result() for name, job in jobs.items()}
    if native.load_library() is None:
        raise RuntimeError(f"the key-value store {native.SOURCE} did not build")
    log(f"[build] into {BUILD_DIR}, all at once in {time.perf_counter() - t0:.2f} s")
    for name, mod in kernels:
        built = "built now" if mod.BUILD_LOG else "found built from this source hash"
        log(f"[build] {name} {mod.SOURCE}: {built} in {took[name]:.2f} s")
        for line in mod.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] kvstore {native.SOURCE}: loaded in {took['kvstore']:.2f} s")
    return hamming, gather, ivf_scan, ivf_rerank


def _check_k1(torch, hamming, q, x, what: str) -> float:
    """K1 on every route against its plain version, both metrics, exactly;
    returns the largest |error| (0.0 when it passes)."""
    worst = 0.0
    for metric in hamming.METRIC_FLAGS:
        want = hamming.pairwise_bit_distance_plain(q, x, metric)
        for route in hamming.ROUTES:
            got = hamming.pairwise_bit_distance_kernel(q, x, metric, route=route)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"K1 {route} {metric} {what}: bad output {tuple(got.shape)}")
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {route} {metric} {what}: differs from plain, max |err| {err}")
    return worst


def phase_kernel(torch, hamming, device) -> float:
    gen = torch.Generator(device="cpu").manual_seed(1234)
    worst = 0.0
    for b, n, w in KERNEL_SHAPES:
        q = torch.randint(-2**31, 2**31 - 1, (b, w), generator=gen, dtype=torch.int64).to(torch.int32)
        x = torch.randint(-2**31, 2**31 - 1, (n, w), generator=gen, dtype=torch.int64).to(torch.int32)
        q[0] = 0  # a zero query row: jaccard's empty union against zero codes
        x[0] = 0
        worst = max(worst, _check_k1(torch, hamming, q.to(device), x.to(device), f"B={b} N={n} W={w}"))
    log(f"[kernel] K1 == plain (torch.equal) at {len(KERNEL_SHAPES)} shapes x 2 metrics x "
        f"routes {'/'.join(hamming.ROUTES)}; max |err| {worst}")
    return worst


def phase_slice(torch, hamming, gather, device, seed: int):
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.vectorstore import bq_encode

    queries = bq.queries(seed, max(10 + 64, *TIMED_B))
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_") as root:
        cfg = bq.slice_config(root)
        hamming.LAUNCHES = gather.LAUNCHES = 0  # counts from here on are the slice's
        hamming.LAUNCHES_BY.clear()
        with bq.serving(cfg, device) as srv:
            data = bq.load(srv, seed, bq.N_POINTS)
            counts = data.shard_counts
            assert len(counts) >= 2, f"expected a multi-shard collection, got {counts}"
            log(f"[slice] store backend of the shards: {data.store_backend}")
            log(f"[slice] ingest: {bq.N_POINTS} points in {data.seconds:.2f} s = {data.rate:.1f} points/s "
                f"(first {bq.HTTP_POINTS} over HTTP JSON in {data.http_seconds:.2f} s; then "
                f"Point.from_map {data.encode_seconds:.2f} s, ClusterNode.insert_points "
                f"{data.insert_seconds:.2f} s); {len(counts)} shards, points per shard {sorted(counts)}")

            def check(q, points, what):
                errs = bq.brute_force_errors(q, points, data, LIMIT)
                if errs:
                    raise AssertionError(f"{what}: {errs}")

            lat = []
            for i in range(10):
                t1 = time.perf_counter()
                res = bq.http_json(srv.base, "POST", f"/{bq.COLLECTION}/points/search",
                                   bq.search_body(queries[i], LIMIT))
                lat.append(time.perf_counter() - t1)
                check(queries[i], res["points"], f"single search {i}")
            t1 = time.perf_counter()
            res = bq.http_json(srv.base, "POST", f"/{bq.COLLECTION}/points/search/batch",
                               {"queries": [bq.search_body(q, LIMIT) for q in queries[10:10 + 64]]})
            t_batch = time.perf_counter() - t1
            assert len(res["results"]) == 64
            for i, row in enumerate(res["results"]):
                check(queries[10 + i], row["points"], f"batch search {i}")
            launches = hamming.LAUNCHES
            by = dict(hamming.LAUNCHES_BY)
            split = {"b1": sum(v for (_, one), v in by.items() if one),
                     "b_gt1": sum(v for (_, one), v in by.items() if not one)}
            routes = {r: sum(v for (rr, _), v in by.items() if rr == r) for r in hamming.ROUTES}
            if split["b1"] <= 0 or split["b_gt1"] <= 0 or min(routes.values()) <= 0:
                raise AssertionError(f"K1 was not launched at B = 1 and B > 1 on both routes "
                                     f"by the slice's searches: {by}")
            log(f"[slice] K2 launches during the slice: {gather.LAUNCHES} (no search path gathers through it)")
            p50 = float(np.median(lat)) * 1e3
            log(f"[slice] 10 single searches over HTTP: p50 {p50:.2f} ms (min {min(lat) * 1e3:.2f}, "
                f"max {max(lat) * 1e3:.2f}); batch of 64: {t_batch * 1e3:.2f} ms; "
                f"all {10 + 64} match numpy brute force by the tie rule")
            log(f"[slice] K1 launches during the slice: {launches} ({split['b1']} at B = 1, "
                f"{split['b_gt1']} at B > 1; by route {routes}); "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            # The largest shard's own code table, for the timing phase
            largest = max(srv.shard_indices(), key=len)
            qcodes = bq_encode(torch.from_numpy(queries).to(device), largest.store.state.aux, bq.DIM)
            return {"launches": launches, "split": split, "routes": routes,
                    "codes": largest.store.state.codes, "qcodes": qcodes}


def _median_call_ms(torch, fn, runs: int = 30) -> float:
    """Median wall time of one call, host launch work included (CUDA events
    around each call, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_events(torch, fn, runs: int = 30, before=None) -> dict:
    """``{name: (launches, device us)}`` of the device events the profiler
    recorded over ``runs`` calls of ``fn`` (a CPU op's device time repeats
    its kernels', so only device-side events count). ``before`` runs ahead of
    each call, outside the count. The window opens with untimed spin kernels
    (``annbench.prime_profiler``): in this script's process the profiler
    missed the first two or three device events of a window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semadb_tpu_torch.tools.annbench import PRIME_KERNEL, prime_profiler

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        for _ in range(runs):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and PRIME_KERNEL not in e.key}


def _device_ms(torch, fn, runs: int = 30, before=None, kernel=None):
    """Device time per call: the time of the device events over ``runs``
    calls of ``fn`` (only events whose name holds ``kernel``, when given,
    averaged over the launches recorded). A window that recorded none of
    them is logged and opened again (P2: in this script's process the
    profiler has lost device events); raises after PROFILER_WINDOWS such
    windows."""
    for window in range(PROFILER_WINDOWS):
        recorded = _device_events(torch, fn, runs, before)
        events = {k: v for k, v in recorded.items() if kernel is None or kernel in k}
        total_us = sum(us for _, us in events.values())
        if total_us > 0:
            break
        log(f"[profiler] window {window + 1} of {PROFILER_WINDOWS} recorded no device time of "
            f"{kernel or 'any kernel'} in {runs} calls (recorded: {sorted(recorded)})")
    else:
        raise RuntimeError(f"torch.profiler recorded no device time of {kernel or 'any kernel'} in "
                           f"{PROFILER_WINDOWS} windows; the kernel times cannot be measured")
    calls = sum(n for n, _ in events.values()) if kernel is not None else runs
    return total_us / 1e3 / calls


def _k3_device_ms(torch, ivf_scan, ops, chunks: int = 1, runs: int = 20, call_ms=None) -> dict:
    """K3's device time per call: every device event of the calls (its
    kernels and the memset of its work area) over the calls. Each event must
    record one launch a call and chunk; a window that lost launches (P2: in
    this script's process the profiler drops events) is logged and opened
    again, at most PROFILER_WINDOWS times. Given ``call_ms`` (the CUDA-event
    time of a call, which the profiler cannot lose), a window that kept at
    least half of each event's launches is taken, each event's time divided
    by the launches it kept; the time a call must then lie between
    K3_EVENT_SHARE of ``call_ms`` and ``call_ms``."""
    names = ivf_scan.KERNELS + ("Memset",)
    want = runs * chunks
    for window in range(PROFILER_WINDOWS):
        events = _device_events(torch, functools.partial(ivf_scan.ivf_probe_scan, *ops), runs)
        hits = {name: [(n, us) for key, (n, us) in events.items() if name in key] for name in names}
        got = {name: sum(n for n, _ in h) for name, h in hits.items()}
        if all(n == want for n in got.values()):
            break
        log(f"[profiler] window {window + 1} of {PROFILER_WINDOWS} recorded {got} launches of K3's events in "
            f"{runs} calls of {chunks} chunk(s), not {want} each")
        if call_ms is not None and all(2 * n >= want for n in got.values()):
            break
    else:
        raise AssertionError(f"K3: {PROFILER_WINDOWS} profiler windows lost launches: {got}")
    by = {name: sum(us for _, us in h) / 1e3 / got[name] * chunks for name, h in hits.items()}
    other = {k for k in events if not any(name in k for name in names)}
    if other:
        raise AssertionError(f"K3: device events that are not K3's: {sorted(other)}")
    ms = sum(by.values())
    if call_ms is not None and not K3_EVENT_SHARE * call_ms <= ms <= call_ms:
        raise AssertionError(f"K3: the profiler's {ms:.4f} ms a call is not within {K3_EVENT_SHARE:.0%}-100% "
                             f"of a call's CUDA-event time, {call_ms:.4f} ms")
    return {"ms": ms, "by_kernel_ms": by, "kernels_per_call": len(names) * chunks, "launches_recorded": got}


def _l2_flush(torch):
    """A call that writes FLUSH_BYTES and reads as many more, so that the
    50 MB L2 holds none of the next kernel's operands and no dirty lines."""
    written = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    read = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flush():
        written.zero_()
        read.sum()

    return flush


def phase_timing(torch, hamming, codes, qcodes) -> dict:
    """K1's routes and its plain version at the slice's shapes, on the
    largest shard's own code table. First every route must equal the plain
    version on these operands; then each route's device time, warm and
    L2-cold, against the byte bound; the plain version's device time and a
    call's time with its host launch work at B = 1 and 64; and both routes
    cold across the route threshold."""
    n, w = codes.shape
    flush = _l2_flush(torch)
    out = {}
    for b in TIMED_B:
        q = qcodes[:b].contiguous()
        err = _check_k1(torch, hamming, q, codes, f"on the shard's codes B={b} N={n} W={w}")
        row = {"n": n, "w": w, "max_abs_err": err, "route": hamming.route_for(b, w)}
        for route in hamming.ROUTES:
            call = functools.partial(hamming.pairwise_bit_distance_kernel, q, codes, "hamming", route=route)
            call()
            row[route] = {"warm": _device_ms(torch, call, kernel=K1_KERNEL),
                          "cold": _device_ms(torch, call, before=flush, kernel=K1_KERNEL)}
        kernel = functools.partial(hamming.pairwise_bit_distance_kernel, q, codes, "hamming")
        plain = functools.partial(hamming.pairwise_bit_distance_plain, q, codes, "hamming")
        if b != TIMED_B[-1]:  # the plain version is compared at B = 4096 but not timed
            row["call_ms"] = _median_call_ms(torch, kernel)
            row["plain_call_ms"] = _median_call_ms(torch, plain)
            row["plain_ms"] = _device_ms(torch, plain)
        moved = n * w * 4 + b * w * 4 + b * n * 4  # codes + queries in, distances out
        row["bound_ms"] = _bound_ms(moved)
        row["int8_ops_ms"] = 2 * b * n * 32 * w / INT8_OPS_PER_S * 1e3
        row["ms"] = row[row["route"]]["cold"]
        row["share"] = row["bound_ms"] / row["ms"]
        times = "; ".join(f"{r} {row[r]['cold']:.5f} ms cold, {row[r]['warm']:.5f} ms warm"
                          for r in hamming.ROUTES)
        log(f"[timing] K1 == plain on the shard's codes B={b} N={n} W={w}, both metrics, every route; "
            f"max |err| {err}")
        log(f"[timing] K1 hamming B={b}: {times} (device time per call, mean of 30)")
        plain_txt = (f"plain {row['plain_ms']:.5f} ms on the device, {row['plain_call_ms']:.5f} ms a call; "
                     f"kernel {row['call_ms']:.5f} ms a call (median of 30)" if "plain_ms" in row
                     else "plain compared, not timed")
        log(f"[timing] K1 B={b} bound {row['bound_ms']:.6f} ms by bytes ({moved} B at "
            f"{HBM_BYTES_PER_S:.3g} B/s; the int8-rate operations term, for information: "
            f"{row['int8_ops_ms']:.6f} ms); the {row['route']} route (the wrapper's at this B) cold "
            f"at {row['share']:.1%} of the bound; {plain_txt}")
        out[b] = row
    sweep = {}
    for b in THRESHOLD_B:
        q = qcodes[:b].contiguous()
        sweep[b] = {}
        for route in hamming.ROUTES:
            call = functools.partial(hamming.pairwise_bit_distance_kernel, q, codes, "hamming", route=route)
            call()
            sweep[b][route] = _device_ms(torch, call, before=flush, kernel=K1_KERNEL)
    cold = {b: {r: out[b][r]["cold"] for r in hamming.ROUTES} for b in TIMED_B}
    cold.update(sweep)
    log("[timing] K1 hamming cold by B, route threshold TENSOR_MIN_B = "
        f"{hamming.TENSOR_MIN_B}: " + "; ".join(
            f"B={b} " + " / ".join(f"{r} {cold[b][r]:.5f}" for r in hamming.ROUTES) for b in sorted(cold)))
    return {"by_b": out, "threshold_sweep": sweep}


def _bound_ms(nbytes: int) -> float:
    """The least time for the work: its bytes over the memory rate. (K1's
    bit operations have no published tensor-core rate to bound them by.)"""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _gather_ids(torch, gen, n, cap, device):
    ids = torch.randint(0, cap, (n,), generator=gen, dtype=torch.int32, device=device)
    ids[0] = 0
    if n > 1:
        ids[-1] = cap - 1
    if n > 2:
        ids[n // 2] = ids[-1]  # a repeat
    return ids


def phase_gather_kernel(torch, gather, device) -> float:
    """K2 against its plain version at every listed shape, exactly, and its
    refusals."""
    gen = torch.Generator(device=device).manual_seed(4321)
    worst = 0.0
    cases = 0
    for d, n, cap in GATHER_SHAPES:
        vectors = torch.randn((cap, d), generator=gen, device=device)
        ids = _gather_ids(torch, gen, n, cap, device)
        got = gather.gather_rows_padded(vectors, ids, check=True)
        torch.cuda.synchronize()
        want = gather.gather_rows_plain(vectors, ids)
        if got.shape != (n, d) or not torch.equal(got, want):
            raise AssertionError(f"K2 D={d} n={n} cap={cap}: kernel != plain")
        if n % gather.TILE == 0 and not torch.equal(gather.gather_rows(vectors, ids, check=True), want):
            raise AssertionError(f"K2 gather_rows D={d} n={n} cap={cap}: kernel != plain")
        worst = max(worst, (got - want).abs().max().item())
        cases += 1
    flat = torch.randn(1 + 4096 * 128, generator=gen, device=device)
    vectors = flat[1:].view(4096, 128)  # 4 bytes off the 16-byte grid: the 4-byte copy
    ids = _gather_ids(torch, gen, 100003, 4096, device)
    if not torch.equal(gather.gather_rows_padded(vectors, ids, check=True), gather.gather_rows_plain(vectors, ids)):
        raise AssertionError("K2 on rows off the 16-byte grid: kernel != plain")
    try:
        gather.gather_rows(vectors, ids[:1000])
    except ValueError:
        pass
    else:
        raise AssertionError("gather_rows took 1000 ids, not a multiple of 1024")
    for bad in (4096, -1):
        bad_ids = ids[:64].clone()
        bad_ids[17] = bad
        try:
            gather.gather_rows_padded(vectors, bad_ids, check=True)
        except IndexError:
            pass
        else:
            raise AssertionError(f"K2's checked path took the id {bad} of a 4096-row matrix")
    torch.cuda.synchronize()
    log(f"[gather] K2 == plain (torch.equal) at {cases} shapes and on unaligned rows; max |err| {worst}; "
        f"gather_rows refuses n % 1024 != 0; the checked path refuses ids 4096 and -1 of 4096 rows")
    return worst


def phase_gatherbench(torch, hamming, gather) -> dict:
    """The gather path: the port's gatherbench at its defaults on cuda."""
    from semadb_tpu_torch.tools import gatherbench

    hamming.LAUNCHES = gather.LAUNCHES = 0  # counts from here on are the gatherbench path's
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gatherbench.main([])
    launches = gather.LAUNCHES
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[gatherbench] {json.dumps(res)}")
    if rc != 0 or res["kernel_correct"] is not True:
        raise AssertionError(f"gatherbench: the kernel's output differs from index_select (rc {rc})")
    if res["platform"] != "cuda" or launches <= 0:
        raise AssertionError(f"gatherbench did not run K2 on the card: {res['platform']}, {launches} launches")
    bound_ms, bound_by = _bound_ms(res["bound_bytes"]), "bytes"
    ms = {k: res[f"{k}_s"] * 1e3 for k in ("kernel", "torch", "plain")}
    log(f"[gatherbench] K2 launches: {launches}; K1 launches: {hamming.LAUNCHES}; "
        f"{res['unique_rows']} distinct of {res['rows']} rows of {res['row_bytes']} B")
    log(f"[gatherbench] kernel {ms['kernel']:.4f} ms ({res['kernel_gbps']:.1f} GB/s of output), "
        f"index_select {ms['torch']:.4f} ms ({res['torch_gbps']:.1f} GB/s), plain {ms['plain']:.4f} ms "
        f"({res['plain_gbps']:.1f} GB/s); bound {bound_ms:.4f} ms by {bound_by} "
        f"({res['bound_bytes']} B at {HBM_BYTES_PER_S:.3g} B/s); kernel at {bound_ms / ms['kernel']:.1%}, "
        f"index_select at {bound_ms / ms['torch']:.1%} of the bound")
    return {"launches": launches, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}


# -- the IVF engine: K3, K4 and the bench cell ---------------------------------

K3_BS, K3_PS, K3_SS, K3_RS, K3_RRS = (1, 7, 64, 4096), (1, 5, 24, 96), (64, 128, 192), (3, 100, 128), (20, 64, 256)
K4_DS, K4_KS = (3, 128, 1536), (1, 10, 100)
K4_ROUTE_DS, K4_ROUTE_KS = (3, 4, 128, 1536, 4096), (1, 10, 32, 33, 100)
K4_RRS, K4_BS = (20, 64, 256, 2048), (1, 7, 4096)
K3_SWEEP_B = (1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096)
# K3 at the 10M cell's cluster count: 32 tiles of 4,096 clusters in the
# offsets look-back scan
K3_BIG_C, K3_BIG_S, K3_BIG_R, K3_BIG_RR = 131_072, 192, 128, 64
K3_BIG_BS, K3_BIG_PS = (1, 4096), (24, 96)
K4_SWEEP_B = (1, 64, 264, 512, 1024, 2048, 4096)
IVF_RTOL = 1e-5  # of the magnitude of the summed terms: the sums run in another order
IVF_TIMED_RUNS = 20
K4_PROJ_ROWS, K4_PROJ_D, K4_PROJ_RR, K4_PROJ_B = 400_000, 1536, 256, 4096  # the projected traversal
HTTP_IVF_POINTS = 20_000
# Phase 9: the reference text bench's corpus (bench.py:806-850): 100,000
# documents of 12 terms, Zipf (s = 1.1) over a 20,000-word vocabulary,
# inserted 10,000 a write transaction; beside them a 128-d vector and three
# fields to filter on
HYBRID_POINTS, HYBRID_DIM, HYBRID_BATCH = 100_000, 128, 10_000
HYBRID_VOCAB, HYBRID_TERMS, HYBRID_ZIPF = 20_000, 12, 1.1
HYBRID_CATEGORIES, HYBRID_CATEGORY_ZIPF = 20, 1.5  # the rarest ~0.5%, the commonest ~45%
HYBRID_YEARS = (1990, 2024)
HYBRID_TAGS = 50
HYBRID_PAGE = 75  # config/singleServer.yaml's maxSearchLimit
HYBRID_QUERIES = 8  # held-out vectors, each kind of vector query runs on every one
TEXT_RTOL = 1e-5  # the index keeps tf in f32
WIDE_FILTER_SHARE, WIDE_QUERIES, WIDE_RECALL = 0.5, 256, 0.95
HTTP_IVF_DIM = 128
HTTP_IVF_RECALL = 0.95
CELL_RECALL = 0.99
LIBRARY_NONE = ("none: no single PyTorch call gathers probed slabs and keeps a top-rr "
                "(index_select + bmm + topk are three calls and materialise [B, p*S])")
LIBRARY_NONE_K4 = ("none: no single PyTorch call gathers pool rows and takes an exact top-k "
                   "(index_select + bmm + topk are three calls)")


def k3_cases():
    """Every value of each K3 parameter, in 20 combinations: the 16 (B, p)
    pairs with S, r, rr, slab type and mask cycling; the bench cell's shape
    (B 4096, p 24, S 128, r 128, rr 64) in both slab types, with and without
    a mask; and the layouts of a batch at the cell's widths: every query on
    the same probes, ids in two clusters, holes in the live prefixes, and B
    in chunks. Each is (B, p, S, r, rr, bf16, mask, layout)."""
    cases = []
    for i, (b, p) in enumerate((b, p) for b in K3_BS for p in K3_PS):
        cases.append((b, p, K3_SS[i % 3], K3_RS[(i // 3) % 3], K3_RRS[(i + 1) % 3], i % 2 == 1, (i // 2) % 2 == 1,
                      None))
    cases += [(4096, 24, 128, 128, 64, bf16, mask, None) for bf16 in (False, True) for mask in (False, True)]
    cases += [
        (4096, 24, 128, 128, 64, False, False, "same-probes"),
        (64, 24, 128, 128, 64, True, True, "same-probes"),
        (4096, 24, 128, 128, 64, False, False, "copies"),
        (7, 5, 64, 100, 20, True, True, "copies"),
        (4096, 24, 128, 128, 64, False, True, "holes"),
        (64, 8, 192, 3, 256, True, False, "holes"),
        (1000, 24, 128, 128, 64, False, True, "chunked"),
        (3, 40, 1024, 8, 2048, False, False, "chunked"),
    ]
    return cases


def k4_cases():
    """D x k x metric, 27 combinations (rr = max(64, 2k)); B cycles through
    1, 7, 64 and 4096 (4096 only at D = 128, where the bench cell runs);
    then D x metric with pools that repeat ids, deduplicated by the kernel
    (9 more). Then the routes of the bulk-copy design: D in {3, 4, 128, 1536,
    4096} x k in {1, 10, 32, 33, 100}, rr cycling through {20, 64, 256, 2048}
    and B through {1, 7, 4096}; bases off the 16-byte grid; pools with every
    id 2-3 times; a pool that is all empty. Each is (B, D, k, rr, metric,
    dedup, layout)."""
    metrics = ("euclidean", "dot", "cosine")
    cases = []
    for i, (d, k, metric) in enumerate((d, k, m) for d in K4_DS for k in K4_KS for m in metrics):
        b = 4096 if d == 128 and i % 3 == 0 else (1, 7, 64)[i % 3]
        cases.append((b, d, k, max(64, 2 * k), metric, False, None))
    for d in K4_DS:
        for metric in metrics:
            cases.append((4096 if d == 128 and metric == "euclidean" else 64, d, 10, 64, metric, True, None))
    for i, (d, k) in enumerate((d, k) for d in K4_ROUTE_DS for k in K4_ROUTE_KS):
        rr = K4_RRS[i % len(K4_RRS)]
        # B = 4096 where the plain version's gather stays under 2^31 elements
        b = K4_BS[i % len(K4_BS)]
        if b * rr * d > 2**31:
            b = 7
        cases.append((b, d, k, rr, metrics[i % 3], i % 2 == 0, None))
    cases += [
        (64, 128, 10, 64, "euclidean", True, "offgrid"), (7, 1536, 33, 256, "dot", False, "offgrid"),
        (4096, 128, 10, 64, "euclidean", True, "copies"), (64, 1536, 10, 256, "cosine", True, "copies"),
        (7, 3, 32, 20, "dot", True, "copies"), (1, 4096, 10, 2048, "euclidean", True, "copies"),
        (7, 128, 10, 64, "euclidean", True, "empty"), (1, 1536, 33, 256, "cosine", False, "empty"),
    ]
    return cases


def _k4_operands(torch, gen, b, d, rr, metric, dedup, layout, device):
    """Random rows and queries (unit rows for cosine); pools of distinct ids,
    a quarter repeated under dedup (or every id 2-3 times: "copies"); 20% of
    the slots empty by their coarse score and 5% by an id of -1 ("empty":
    every slot); "offgrid": the matrix one float off the 16-byte grid."""
    cap = 5000
    vectors = torch.randn((cap, d), generator=gen)
    queries = torch.randn((b, d), generator=gen)
    if metric == "cosine":
        vectors = vectors / vectors.norm(dim=1, keepdim=True)
        queries = queries / queries.norm(dim=1, keepdim=True)
    pool = torch.argsort(torch.rand((b, cap), generator=gen), dim=1)[:, :rr].to(torch.int32)
    if layout == "copies":
        reps = torch.randint(2, 4, (b, rr), generator=gen).cumsum(1)
        pool = torch.gather(pool, 1, torch.searchsorted(reps, torch.arange(rr).expand(b, rr).contiguous(),
                                                        right=True))
        pool = torch.gather(pool, 1, torch.argsort(torch.rand((b, rr), generator=gen), dim=1))
    elif dedup:
        again = torch.rand((b, rr), generator=gen) < 0.25
        pool = torch.where(again, torch.gather(pool, 1, torch.randint(0, rr, (b, rr), generator=gen)), pool)
    coarse = torch.randn((b, rr), generator=gen)
    empty = torch.rand((b, rr), generator=gen) < 0.2
    coarse[empty] = float("inf")
    pool[empty & (torch.rand((b, rr), generator=gen) < 0.5)] = -1
    if layout == "empty":
        coarse[:] = float("inf")
    ops = [t.to(device) for t in (vectors, queries, pool, coarse)]
    if layout == "offgrid":
        flat = torch.empty(cap * d + 1, device=device)
        ops[0] = flat[1:].view(cap, d)
        ops[0].copy_(vectors)
    return ops


def check_rows(torch, want, got, dist_of, atol, what) -> float:
    """Hold every row of ``got`` (d, i) against ``want`` by the multiset tie
    rule (``ops.topk.pool_errors``); rows that match exactly (ids equal,
    distances within atol) need no lookups. Returns the largest |error| of
    the finite distances."""
    from semadb_tpu_torch.ops.topk import pool_errors

    wd, wi = (t.cpu() for t in want)
    gd, gi = (t.cpu() for t in got)
    if gd.shape != wd.shape or gi.shape != wi.shape:
        raise AssertionError(f"{what}: shapes {tuple(gd.shape)} vs {tuple(wd.shape)}")
    atol = torch.as_tensor(atol, dtype=torch.float64).reshape(-1, 1).expand(wd.shape[0], 1)
    fin = torch.isfinite(wd) & torch.isfinite(gd)
    diff = torch.where(fin, (gd.double() - wd.double()).abs(), torch.zeros((), dtype=torch.float64))
    if not torch.equal(torch.isfinite(wd), torch.isfinite(gd)):
        bad = (torch.isfinite(wd) != torch.isfinite(gd)).any(1).nonzero()[:3, 0].tolist()
        raise AssertionError(f"{what}: finite places differ in rows {bad}")
    same = torch.equal(gi, wi) and bool((diff <= atol).all())
    if not same:
        rows = ((gi != wi).any(1) | (diff > atol).any(1)).nonzero()[:, 0].tolist()
        for b in rows:
            errs = pool_errors(wd[b].tolist(), wi[b].tolist(), gd[b].tolist(), gi[b].tolist(),
                               lambda i, b=b: dist_of(b, i), float(atol[b, 0]))
            if errs:
                raise AssertionError(f"{what}, row {b}: {errs}")
    return float(diff.max()) if diff.numel() else 0.0


def _k3_operands(torch, gen, b, p, s, r, bf16, masked, device, layout=None):
    c = max(2 * p, 32)
    rows = torch.randn((c, s, r), generator=gen)
    ids = (torch.randperm(c * s, generator=gen).reshape(c, s) + 2).to(torch.int32)
    nil = torch.rand((c, s), generator=gen) < 0.3
    if layout == "holes":  # live prefixes of random length, 10% of them deleted
        fill = torch.randint(s // 2, s + 1, (c, 1), generator=gen)
        nil = (torch.arange(s)[None, :] >= fill) | (torch.rand((c, s), generator=gen) < 0.1)
    ids[nil] = -1
    rows[nil] = 0.0
    if layout == "copies":  # each cluster's first quarter also fills the next cluster's last slots
        q4 = s // 4
        ids[:, s - q4:] = ids.roll(1, dims=0)[:, :q4].clone()
        rows[:, s - q4:] = rows.roll(1, dims=0)[:, :q4].clone()
    slabs = rows.to(torch.bfloat16) if bf16 else rows
    slab_sq = (rows * rows).sum(-1)
    qp = torch.randn((b, r), generator=gen)
    if layout == "same-probes":
        probe = torch.randperm(c, generator=gen)[:p].to(torch.int32).expand(b, p).contiguous()
    else:
        probe = torch.argsort(torch.rand((b, c), generator=gen), dim=1)[:, :p].to(torch.int32).contiguous()
    mask = (torch.rand(c * s + 2, generator=gen) < 0.5).to(torch.uint8) if masked else None
    ops = [qp, probe, slabs, slab_sq, ids, mask]
    return [None if t is None else t.to(device) for t in ops]


def _k3_dist_of(torch, qp, slabs, slab_sq, slab_ids):
    """id → its coarse score for query b, in f64 on the host (first copy),
    through a sorted index of the slots' ids made at the first lookup (a
    scan of every slot a lookup is too slow at 131,072 x 192 slots)."""
    index = {}

    def dist_of(b, i):
        if not index:
            ids_h = slab_ids.cpu().numpy().reshape(-1)
            index["order"] = np.argsort(ids_h, kind="stable")
            index["sorted"] = ids_h[index["order"]]
        cell = int(index["order"][np.searchsorted(index["sorted"], i)])
        row = slabs.reshape(-1, slabs.shape[-1])[cell].double().cpu()
        sq = float(slab_sq.reshape(-1)[cell])
        return sq - 2.0 * float(row @ qp[b].double().cpu())

    return dist_of


def _k3_atol(torch, qp, slabs):
    """Per query: IVF_RTOL x (|x|max^2 + 2 |x|max |q|), the size of the terms."""
    xmax = max(float(slabs[c0 : c0 + 4096].float().norm(dim=-1).max()) for c0 in range(0, slabs.shape[0], 4096))
    return (IVF_RTOL * (xmax * xmax + 2.0 * xmax * qp.double().norm(dim=1))).cpu()


def _k3_big_checks(torch, ivf_scan, device) -> tuple:
    """K3 against its plain version over the 131,072-cluster slab set (32
    tiles of the offsets scan) at B in {1, 4096} x p in {24, 96}, with and
    without the mask; returns (cases, largest |error|)."""
    gen, slabs, slab_sq, ids, mask = ivf_scan.random_operands(K3_BIG_C, K3_BIG_S, K3_BIG_R, 131072, device)
    worst, cases = 0.0, []
    for b in K3_BIG_BS:
        qp = torch.randn((b, K3_BIG_R), generator=gen, device=device)
        dist_of = _k3_dist_of(torch, qp, slabs, slab_sq, ids)
        atol = _k3_atol(torch, qp, slabs)
        for p in K3_BIG_PS:
            probe = torch.topk(torch.rand((b, K3_BIG_C), generator=gen, device=device), p, dim=1).indices
            probe = probe.to(torch.int32).contiguous()
            for m in (None, mask):
                ops = (qp, probe, slabs, slab_sq, ids, m, K3_BIG_RR)
                what = f"K3 C={K3_BIG_C} B={b} p={p} S={K3_BIG_S} r={K3_BIG_R} bf16 mask={m is not None}"
                got = ivf_scan.ivf_probe_scan(*ops)
                torch.cuda.synchronize()
                worst = max(worst, check_rows(torch, ivf_scan.ivf_probe_scan_plain(*ops), got, dist_of, atol, what))
                cases.append((b, p, m is not None))
    del slabs, slab_sq, ids, mask
    torch.cuda.empty_cache()
    return cases, worst


def _k4_atol(torch, vectors, queries):
    xmax = float(vectors.norm(dim=1).max())
    return (IVF_RTOL * ((xmax + queries.double().norm(dim=1)) ** 2 + 1.0)).cpu()


def _k4_dist_of(torch, vectors, queries, metric):
    def dist_of(b, i):
        x, q = vectors[i].double().cpu(), queries[b].double().cpu()
        if metric == "euclidean":
            return float(((x - q) ** 2).sum())
        dot = float(x @ q)
        return 1.0 - dot if metric == "cosine" else -dot
    return dist_of


def phase_ivf_kernels(torch, ivf_scan, ivf_rerank, device) -> dict:
    """K3 and K4 against their plain versions at every listed shape."""
    gen = torch.Generator().manual_seed(2468)
    worst3 = worst4 = 0.0
    chunked = []
    for b, p, s, r, rr, bf16, masked, layout in k3_cases():
        ops = _k3_operands(torch, gen, b, p, s, r, bf16, masked, device, layout)
        what = f"K3 B={b} p={p} S={s} r={r} rr={rr} {'bf16' if bf16 else 'f32'} mask={masked} layout={layout}"
        want = ivf_scan.ivf_probe_scan_plain(*ops, rr)
        dist_of = _k3_dist_of(torch, ops[0], ops[2], ops[3], ops[4])
        atol = _k3_atol(torch, ops[0], ops[2])
        budget = ivf_scan.SCRATCH_BYTES
        if layout == "chunked":  # about 8 chunks
            ivf_scan.SCRATCH_BYTES = p * s * 4 * max(1, b // 8)
            chunked.append((b, ivf_scan.batch_chunk(b, p, s)))
        try:
            got = ivf_scan.ivf_probe_scan(*ops, rr)
            torch.cuda.synchronize()
            worst3 = max(worst3, check_rows(torch, want, got, dist_of, atol, what))
        finally:
            ivf_scan.SCRATCH_BYTES = budget
    big, big_err = _k3_big_checks(torch, ivf_scan, device)
    worst3 = max(worst3, big_err)
    routes = {}
    for b, d, k, rr, metric, dedup, layout in k4_cases():
        vectors, queries, pool, coarse = _k4_operands(torch, gen, b, d, rr, metric, dedup, layout, device)
        route = ivf_rerank.route_of(vectors)
        routes[route] = routes.get(route, 0) + 1
        what = f"K4 B={b} D={d} k={k} rr={rr} {metric} dedup={dedup} layout={layout} route={route}"
        got = ivf_rerank.ivf_exact_rerank(vectors, queries, pool, coarse, k, metric, dedup)
        torch.cuda.synchronize()
        want = ivf_rerank.ivf_exact_rerank_plain(vectors, queries, pool, coarse, k, metric, dedup)
        if dedup:
            gi = got[1].cpu()
            if any(len(set(row[row >= 0].tolist())) != int((row >= 0).sum()) for row in gi):
                raise AssertionError(f"{what}: an id came back twice")
        if layout == "empty" and not (torch.isinf(got[0]).all() and (got[1] == -1).all()):
            raise AssertionError(f"{what}: an all-empty pool gave a result")
        worst4 = max(worst4, check_rows(torch, want, got, _k4_dist_of(torch, vectors, queries, metric),
                                        _k4_atol(torch, vectors, queries), what))
    log(f"[ivf-kernels] K3 == plain at {len(k3_cases())} shapes (chunked B, queries a chunk: {chunked}) and at "
        f"C={K3_BIG_C} S={K3_BIG_S} r={K3_BIG_R} bf16 rr={K3_BIG_RR}, (B, p, mask) in {big}; K4 == plain at "
        f"{len(k4_cases())} shapes ({sum(c[5] for c in k4_cases())} with the dedup inside; by route {routes}), "
        f"distances within "
        f"{IVF_RTOL:g} of the terms' magnitude, ids by the tie rule; max |err| K3 {worst3:.3g}, K4 {worst4:.3g}")
    return {"k3_err": worst3, "k4_err": worst4}


def _k4_times(torch, ivf_rerank, ops, baseline=None) -> dict:
    """K4's device time per call at ``ops`` (vectors, queries, pool, coarse,
    k, metric, dedup) and at B = 1 (the first query), and at B = 1 a call's
    time with its host work; the same for ``baseline`` (another K4 library,
    e.g. the parent commit's, built from its source) when given."""
    one = (ops[0], ops[1][:1].contiguous(), ops[2][:1].contiguous(), ops[3][:1].contiguous()) + tuple(ops[4:])
    out = {}
    sides = {"": ivf_rerank.ivf_exact_rerank}
    if baseline is not None:
        sides["base_"] = functools.partial(ivf_rerank.launch, baseline)
    for tag, fn in sides.items():
        out[tag + "ms"] = _device_ms(torch, functools.partial(fn, *ops), runs=IVF_TIMED_RUNS, kernel="rerank_kernel")
        out[tag + "b1_ms"] = _device_ms(torch, functools.partial(fn, *one), runs=IVF_TIMED_RUNS,
                                        kernel="rerank_kernel")
        out[tag + "b1_call_ms"] = _median_call_ms(torch, functools.partial(fn, *one))
    return out


def _k4_bytes(torch, vectors, queries, pool, coarse, k) -> tuple:
    """The least bytes of one K4 call: each distinct live pool row once, the
    queries, the pool and coarse scores, the output; and the distinct rows."""
    live = pool[(pool >= 0) & (pool < vectors.shape[0]) & torch.isfinite(coarse)]
    rows = int(torch.unique(live).numel())
    b, d = queries.shape
    return rows * d * 4 + pool.numel() * 8 + b * d * 4 + b * k * 8, rows


def _k4_line(name, t, bound_ms) -> str:
    base = (f"; the parent's design {t['base_ms']:.4f} ms ({bound_ms / t['base_ms']:.1%}), B=1 "
            f"{t['base_b1_ms']:.4f} ms on the device, {t['base_b1_call_ms']:.4f} ms a call" if "base_ms" in t else "")
    return (f"{name}: {t['ms']:.4f} ms a call ({bound_ms / t['ms']:.1%} of the {bound_ms:.4f} ms bound), B=1 "
            f"{t['b1_ms']:.4f} ms on the device, {t['b1_call_ms']:.4f} ms a call (median of 30){base}")


def phase_k4_projected(torch, ivf_rerank, seed: int, baseline=None) -> dict:
    """K4 at the projected traversal's shape (D = 1536, rr = 256, k = 10,
    B = 4,096) over a seeded f32[400,000, 1536] table and random pools, with
    the dedup on (the engine's copies): checked against the plain version,
    then timed, its bound from the distinct rows the pools hold."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1536)
    vectors = torch.randn((K4_PROJ_ROWS, K4_PROJ_D), generator=gen, device="cuda")
    queries = torch.randn((K4_PROJ_B, K4_PROJ_D), generator=gen, device="cuda")
    pool = torch.randint(0, K4_PROJ_ROWS, (K4_PROJ_B, K4_PROJ_RR), generator=gen, device="cuda", dtype=torch.int32)
    coarse = torch.randn((K4_PROJ_B, K4_PROJ_RR), generator=gen, device="cuda")
    ops = (vectors, queries, pool, coarse, LIMIT, "euclidean", True)
    got = ivf_rerank.ivf_exact_rerank(*ops)
    want = ivf_rerank.ivf_exact_rerank_plain(*ops)
    err = check_rows(torch, want, got, _k4_dist_of(torch, vectors, queries, "euclidean"),
                     _k4_atol(torch, vectors, queries), "K4 at the projected shape")
    nbytes, rows = _k4_bytes(torch, vectors, queries, pool, coarse, LIMIT)
    t = _k4_times(torch, ivf_rerank, ops, baseline)
    t_plain = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *ops), runs=3)
    one_bytes, _ = _k4_bytes(torch, vectors, queries[:1], pool[:1], coarse[:1], LIMIT)
    res = {"max_abs_err": err, "plain_ms": t_plain, "bound_ms": _bound_ms(nbytes), "bytes": nbytes,
           "distinct_rows": rows, "b1_bound_ms": _bound_ms(one_bytes), "route": ivf_rerank.route_of(vectors), **t}
    log(f"[k4-projected] K4 == plain at D={K4_PROJ_D} rr={K4_PROJ_RR} k={LIMIT} B={K4_PROJ_B} over "
        f"f32[{K4_PROJ_ROWS}, {K4_PROJ_D}] ({res['route']} route); max |err| {err:.3g}; {rows} distinct pool rows, "
        f"{nbytes} B")
    log("[k4-projected] " + _k4_line("K4", t, res["bound_ms"]) + f"; plain {t_plain:.4f} ms; B=1 bound "
        f"{res['b1_bound_ms']:.5f} ms")
    del vectors
    torch.cuda.empty_cache()
    return res


def phase_ivf_cell(torch, counted, argv=(), baseline=None) -> dict:
    """The bench cell through annbench.main, then K3 and K4 on the operands
    that one real search of the cell passes them."""
    from semadb_tpu_torch.ops.kernels import ivf_rerank, ivf_scan
    from semadb_tpu_torch.tools import annbench

    _zero_counts(counted)
    keep: dict = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = annbench.main(list(argv), keep=keep)
    launches = {name: mod.LAUNCHES for name, mod in counted}
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    prof = res.pop("profile", None)
    log(f"[ivf-cell] {json.dumps(res)}")
    if prof is not None:
        log(f"[ivf-cell] profile of one batch: {json.dumps(prof)}")
    if rc != 0 or res["recall@10"] < CELL_RECALL:
        raise AssertionError(f"the IVF cell's recall@10 {res['recall@10']} is below {CELL_RECALL} (rc {rc})")
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the IVF cell did not run K3 and K4 on the card: {launches}")
    log(f"[ivf-cell] launches during the cell's searches: {launches} (K3: one a call, "
        f"{len(ivf_scan.KERNELS)} kernels and a memset each)")

    # One more search of the cell, after the counts were read, hands over
    # the arguments it gives K3 and K4
    idx, test = keep["index"], keep["queries"]
    kc = _cell_kernels(torch, ivf_scan, ivf_rerank, idx, test[: res["batch"]], "the cell")
    k3_ops, k4_ops, k3_bytes, t3 = kc["k3_ops"], kc["k4_ops"], kc["k3_bytes"], kc["t3"]
    qp, probe, q, pool_i, pool_d = k3_ops[0], k3_ops[1], k4_ops[1], k4_ops[2], k4_ops[3]
    B, p, S, r, rr, k, dedup = (kc[key] for key in ("B", "p", "S", "r", "rr", "k", "dedup"))
    err3, err4, t3_plain, t4_plain = kc["err3"], kc["err4"], kc["t3_plain"], kc["t4_plain"]
    distinct, live_distinct, valid = kc["distinct"], kc["live_distinct"], kc["valid"]
    k4_bytes, rows4 = kc["k4_bytes"], kc["rows4"]
    t4 = _k4_times(torch, ivf_rerank, k4_ops, baseline)
    # K4 by B (the cell's first B queries), and on its element route (the
    # same rows one float off the 16-byte grid): where its time goes
    k4_sweep = {}
    for b in K4_SWEEP_B:
        sub = (k4_ops[0], q[:b].contiguous(), pool_i[:b].contiguous(), pool_d[:b].contiguous()) + tuple(k4_ops[4:])
        k4_sweep[b] = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, *sub), runs=IVF_TIMED_RUNS,
                                 kernel="rerank_kernel")
    offgrid = torch.empty(idx.vectors.numel() + 1, device=idx.vectors.device)[1:].view_as(idx.vectors)
    offgrid.copy_(idx.vectors)
    t4_element = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, offgrid, *k4_ops[1:]),
                            runs=IVF_TIMED_RUNS, kernel="rerank_kernel")
    del offgrid
    # K3 at smaller B (the cell's first B queries), device time per call, and
    # at B = 1 a call's time with its host launch work
    sweep = {}
    for b in K3_SWEEP_B:
        sub = (qp[:b].contiguous(), probe[:b].contiguous()) + tuple(k3_ops[2:])
        sweep[b] = _k3_device_ms(torch, ivf_scan, sub, 1, IVF_TIMED_RUNS)["ms"]
    one = (qp[:1].contiguous(), probe[:1].contiguous()) + tuple(k3_ops[2:])
    call1 = _median_call_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *one))
    k3 = {"launches": launches["K3"], "max_abs_err": err3, "ms": t3["ms"], "plain_ms": t3_plain,
          "bound_ms": _bound_ms(k3_bytes["distinct"]), "bound_by": "bytes", "bytes": k3_bytes,
          "per_query_bound_ms": _bound_ms(k3_bytes["per_query_read"]),
          "design_bytes_ms": _bound_ms(k3_bytes["design"]), "distinct_clusters": distinct,
          "live_slots_distinct": live_distinct, "valid_slots": valid, "by_kernel_ms": t3["by_kernel_ms"],
          "kernels_per_call": t3["kernels_per_call"], "b_sweep_ms": sweep, "b1_call_ms": call1}
    one_bytes, _ = _k4_bytes(torch, idx.vectors, q[:1], pool_i[:1], pool_d[:1], k)
    k4 = {"launches": launches["K4"], "max_abs_err": err4, "plain_ms": t4_plain, "dedup": dedup,
          "bound_ms": _bound_ms(k4_bytes), "bound_by": "bytes", "bytes": k4_bytes, "distinct_rows": rows4,
          "b1_bound_ms": _bound_ms(one_bytes), "route": ivf_rerank.route_of(idx.vectors), **t4,
          "b_sweep_ms": k4_sweep, "element_route_ms": t4_element}
    log(f"[ivf-cell] K3 == plain and K4 == plain on the cell's operands (B={B}, p={p}, S={S}, r={r}, rr={rr}, "
        f"{idx.slabs.dtype}, K4 dedup={dedup}); max |err| K3 {err3:.3g}, K4 {err4:.3g}")
    log(f"[ivf-cell] K3 {t3['ms']:.4f} ms a call, {t3['kernels_per_call']} device events a call, each one launch "
        f"a call (device, mean of {IVF_TIMED_RUNS}): "
        + ", ".join(f"{n} {v:.4f}" for n, v in t3["by_kernel_ms"].items()) + f"; plain {t3_plain:.4f} ms")
    log(f"[ivf-cell] K3 bound {k3['bound_ms']:.4f} ms by bytes ({k3_bytes['distinct']} B: {distinct} distinct "
        f"probed clusters once, the rows of their {live_distinct} live slots), {k3['bound_ms'] / t3['ms']:.1%} of "
        f"it; the design's own traffic (with the f32[{B}, {p}, {S}] scratch written and read) "
        f"{k3_bytes['design']} B = {k3['design_bytes_ms']:.4f} ms; what one block per query reads: "
        f"{k3_bytes['per_query_read']} B = {k3['per_query_bound_ms']:.4f} ms ({valid} live of {B * p * S} "
        f"probed slots; all slots {k3_bytes['per_query_all_slots']} B)")
    log("[ivf-cell] K3 by B (device ms a call, the cell's first B queries): "
        + "; ".join(f"B={b} {v:.4f}" for b, v in sweep.items())
        + f"; B=1 a call with its host launch work (median of 30) {call1:.4f} ms")
    log(f"[ivf-cell] K4 (dedup inside: {dedup}, {k4['route']} route) bound {k4['bound_ms']:.4f} ms by bytes "
        f"({k4_bytes} B: {rows4} distinct pool rows); B=1 bound {k4['b1_bound_ms']:.5f} ms; plain {t4_plain:.4f} ms")
    log("[ivf-cell] " + _k4_line("K4", t4, k4["bound_ms"]))
    log("[ivf-cell] K4 by B (device ms a call, the cell's first B queries): "
        + "; ".join(f"B={b} {v:.4f}" for b, v in k4_sweep.items())
        + f"; at B={B} on the element route (the rows off the 16-byte grid) {t4_element:.4f} ms")
    return {"res": res, "profile": prof, "k3": k3, "k4": k4, "index": idx, "queries": test}


def _cell_kernels(torch, ivf_scan, ivf_rerank, idx, queries, what: str, cross_check: bool = False) -> dict:
    """K3 and K4 on the operands one real search of ``idx`` gives them (a
    batch of ``queries``, through ``_ivf_query(keep=...)``): each checked
    against its plain version, K3 and both plain versions timed, and the
    bytes of each kernel's bound counted (K3: the ids of each distinct probed
    cluster once, the rows and norms of its live slots; K4: each distinct live
    pool row once). With ``cross_check`` K3's profiler time is held to a
    call's CUDA-event time (``k3_call``) where its window lost launches."""
    ops: dict = {}
    idx.search_batch_async(queries, LIMIT, keep=ops)
    k3_ops, k4_ops = ops["k3"], ops["k4"]
    qp, probe, slabs, rr = k3_ops[0], k3_ops[1], k3_ops[2], k3_ops[6]
    q, pool_i, pool_d, k, dedup = k4_ops[1], k4_ops[2], k4_ops[3], k4_ops[4], k4_ops[6]
    p = probe.shape[1]
    B, S, r = q.shape[0], slabs.shape[1], slabs.shape[2]
    got3 = ivf_scan.ivf_probe_scan(*k3_ops)
    want3 = ivf_scan.ivf_probe_scan_plain(*k3_ops)
    err3 = check_rows(torch, want3, got3, _k3_dist_of(torch, qp, slabs, idx.slab_sq, idx.slab_ids),
                      _k3_atol(torch, qp, slabs), f"K3 on {what}")
    got4 = ivf_rerank.ivf_exact_rerank(*k4_ops)
    want4 = ivf_rerank.ivf_exact_rerank_plain(*k4_ops)
    err4 = check_rows(torch, want4, got4, _k4_dist_of(torch, idx.vectors, q, idx.metric),
                      _k4_atol(torch, idx.vectors[: 1 + int(pool_i.max())], q), f"K4 on {what}")
    elem = slabs.element_size()
    probed = torch.unique(probe).long()
    distinct = int(probed.numel())
    # The least the function must read: every slot's id of each distinct
    # probed cluster once, and the row and norm of its live slots only
    live_distinct = int((idx.slab_ids[probed] != -1).sum())
    valid = int((idx.slab_ids[probe.long()] != -1).sum())
    io_bytes = B * r * 4 + B * p * 4 + B * rr * 8
    k3_bytes = {
        "distinct": distinct * S * 4 + live_distinct * (r * elem + 4) + io_bytes,
        "per_query_all_slots": B * p * S * (r * elem + 8) + io_bytes,
        "per_query_read": B * p * S * 4 + valid * (r * elem + 4) + io_bytes,
        # the design's own traffic: the distinct clusters, plus the
        # f32[B, p, S] scratch written once and read once
        "design": distinct * S * 4 + live_distinct * (r * elem + 4) + io_bytes + 2 * B * p * S * 4,
    }
    k4_bytes, rows4 = _k4_bytes(torch, idx.vectors, q, pool_i, pool_d, k)
    chunks = -(-B // ivf_scan.batch_chunk(B, p, S))
    k3_call = _median_call_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *k3_ops)) if cross_check else None
    return {
        "k3_ops": k3_ops, "k4_ops": k4_ops, "B": B, "p": p, "S": S, "r": r, "rr": rr, "k": k, "dedup": dedup,
        "err3": err3, "err4": err4, "k3_bytes": k3_bytes, "k4_bytes": k4_bytes, "rows4": rows4,
        "distinct": distinct, "live_distinct": live_distinct, "valid": valid, "chunks": chunks,
        "t3": _k3_device_ms(torch, ivf_scan, k3_ops, chunks, IVF_TIMED_RUNS, k3_call), "k3_call": k3_call,
        "t3_plain": _device_ms(torch, functools.partial(ivf_scan.ivf_probe_scan_plain, *k3_ops), runs=3),
        "t4_plain": _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *k4_ops), runs=3),
    }


def phase_ivf_http(torch, counted, device, seed: int, n_points: int = HTTP_IVF_POINTS) -> dict:
    """A vectorIVF collection over the port's node and HTTP v2 server."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like

    name = "ivf"
    schema = {"vector": {"type": "vectorIVF",
                         "vectorIVF": {"vectorSize": HTTP_IVF_DIM, "distanceMetric": "euclidean"}}}
    # The bench's generator and spread (embedding-like neighbour margins),
    # with held-out queries
    ds = embedding_like(n_points, HTTP_IVF_DIM, 10, spread=0.5, seed=seed + 11)
    data, queries = ds.train, ds.test
    rng = np.random.default_rng([seed, 11])
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    row_of = {pid: i for i, pid in enumerate(ids)}
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_ivf_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            out = bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema})
            assert out == {"message": "collection created"}, out
            col = srv.node.get_collection(bq.USER["X-User-Id"], name)
            col.user_plan = srv.plan
            t0 = time.perf_counter()
            for lo in range(0, n_points, 5000):
                pts = [Point.from_map({"vector": data[i].tolist()}, uuid.UUID(ids[i]))
                       for i in range(lo, min(lo + 5000, n_points))]
                failed = srv.node.insert_points(col, pts)
                assert failed == [], failed
            ingest_s = time.perf_counter() - t0
            hits, lat = 0, []
            for qv in queries:
                t1 = time.perf_counter()
                res = bq.http_json(srv.base, "POST", f"/{name}/points/search", {"query": {
                    "property": "vector", "vectorIVF": {"vector": qv.tolist(), "operator": "near", "limit": 10}}})
                lat.append(time.perf_counter() - t1)
                d = ((data.astype(np.float64) - qv.astype(np.float64)) ** 2).sum(-1)
                truth = set(np.argsort(d)[:10].tolist())
                got = [row_of[p["_id"]] for p in res["points"]]
                hits += len(truth & set(got))
                for pnt, row in zip(res["points"], got):
                    if abs(pnt["_distance"] - d[row]) > 1e-4 * max(1.0, d[row]):
                        raise AssertionError(f"HTTP vectorIVF: distance {pnt['_distance']} of a point at {d[row]}")
        launches = {nm: mod.LAUNCHES for nm, mod in counted}
    recall = hits / 100
    log(f"[ivf-http] {n_points} points of {HTTP_IVF_DIM}-d into a vectorIVF collection through "
        f"ClusterNode.insert_points in {ingest_s:.2f} s; 10 HTTP searches: recall@10 {recall:.3f} against "
        f"numpy brute force, p50 {np.median(lat) * 1e3:.2f} ms; launches {launches}")
    if recall < HTTP_IVF_RECALL:
        raise AssertionError(f"HTTP vectorIVF recall@10 {recall} is below {HTTP_IVF_RECALL}")
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the HTTP vectorIVF searches did not run K3 and K4: {launches}")
    return {"recall": recall, "launches": launches}


def phase_wide_filter(torch, counted, idx, queries, seed: int) -> dict:
    """The widened-probe path at scale, on the bench cell's index: a seeded
    random filter over half the points is wider than FILTER_EXACT_CAP, so
    the search probes FILTER_WIDEN times as many clusters and K3 skips the
    masked slots. Recall@10 against numpy's exact search over the members."""
    from semadb_tpu_torch.index.ivf import FILTER_EXACT_CAP, FILTER_WIDEN

    ids = np.fromiter(idx._loc.keys(), np.int64, len(idx._loc))
    rng = np.random.default_rng([seed, 33])
    fm = np.zeros(idx.capacity, bool)
    fm[ids[rng.random(len(ids)) < WIDE_FILTER_SHARE]] = True
    members = np.nonzero(fm)[0]
    if len(members) <= max(idx._num_probes() * idx.slab, FILTER_EXACT_CAP):
        raise AssertionError(f"{len(members)} members take the exact member path, not the widened probes")
    q = np.ascontiguousarray(queries[:WIDE_QUERIES], np.float32)
    _zero_counts(counted)
    t0 = time.perf_counter()
    _, got = idx.search_batch(q, LIMIT, filter_mask=fm)
    search_s = time.perf_counter() - t0
    launches = {nm: mod.LAUNCHES for nm, mod in counted}
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the widened-probe search did not run K3 and K4: {launches}")
    # numpy: f32 scores over the members, then the best 64 of each query in f64
    x = idx.vectors[torch.from_numpy(members).to(idx.device)].cpu().numpy()
    xx = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    hits = 0
    for lo in range(0, len(q), 64):
        qs = q[lo:lo + 64]
        cand = np.argpartition(xx[:, None] - 2.0 * (x @ qs.T), 64, axis=0)[:64].T
        for b, rows in enumerate(cand):
            d = ((x[rows].astype(np.float64) - qs[b].astype(np.float64)) ** 2).sum(1)
            truth = set(members[rows[np.argsort(d, kind="stable")[:LIMIT]]].tolist())
            hits += len(truth & set(got[lo + b].tolist()))
    recall = hits / (LIMIT * len(q))
    p = idx._num_probes()
    log(f"[wide-filter] {len(members)} of {len(ids)} points in the filter (> FILTER_EXACT_CAP {FILTER_EXACT_CAP}): "
        f"{len(q)} queries with p = {min(FILTER_WIDEN * p, idx.centroids.shape[0])} probes ({FILTER_WIDEN} x {p}) "
        f"in {search_s * 1e3:.1f} ms; recall@10 {recall:.4f} against numpy's exact search over the members; "
        f"launches {launches}")
    if recall < WIDE_RECALL:
        raise AssertionError(f"widened-probe recall@10 {recall} is below {WIDE_RECALL}")
    return {"recall": recall, "launches": launches, "members": int(len(members))}


CELL_10M_ARGV = ("--n", "10000000", "--sweep", "48,96")
CELL_10M_RECALL = 0.97  # the JAX package read 0.9790 on this configuration
WRITE_POINTS = 10_000
WRITE_SEED = 43  # the cell's generator is seeded 42


def _k3_line(t3, nbytes) -> str:
    return (f"{t3['ms']:.4f} ms a call ({_bound_ms(nbytes) / t3['ms']:.1%} of the {_bound_ms(nbytes):.4f} ms bound, "
            f"{nbytes} B): " + ", ".join(f"{n} {v:.4f}" for n, v in t3["by_kernel_ms"].items()))


def phase_ivf_10m(torch, counted, argv=CELL_10M_ARGV) -> dict:
    """Phase 10: ``BENCH_N=10000000 python bench.py`` on the port, through
    ``annbench.main`` (the device generator, the two-level refit, the sweep);
    then K3 and K4 on the cell's own operands, K3 and the recall on f32 slabs
    rebuilt from the same ``slab_ids``, and two write transactions of
    WRITE_POINTS new points each through the two-level assignment."""
    from semadb_tpu_torch.index import ivf
    from semadb_tpu_torch.ops.kernels import ivf_rerank, ivf_scan
    from semadb_tpu_torch.tools import annbench
    from semadb_tpu_torch.tools.datasets import embedding_like_device

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counted)
    keep: dict = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = annbench.main(list(argv), keep=keep)
    cell_s = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in counted}
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    prof = res.pop("profile", None)
    log(f"[ivf-10m] {json.dumps(res)}")
    if prof is not None:
        log(f"[ivf-10m] profile of one batch: {json.dumps(prof)}")
    idx, test, bench, gt = keep["index"], keep["queries"], keep["bench"], keep["ground_truth"]
    n, batch = res["n"], res["batch"]
    # What the refit should choose, by the code: C from the automatic count,
    # S from _auto_slab, bf16 past SLAB_BF16_BYTES
    want_c = ivf._npow2(max(n // ivf.TARGET_CLUSTER_SIZE, 1), 16, 131072)
    want_s = ivf._auto_slab(min(2, want_c), n, want_c, idx.tdim, ivf.DEFAULT_SLAB * 2)
    want_dtype = "bfloat16" if want_c * want_s * idx.tdim * 4 > ivf.SLAB_BF16_BYTES else "float32"
    got = (res["clusters"], res["slab"], res["slab_dtype"], res["two_level"])
    want = (want_c, want_s, want_dtype, want_c >= ivf.TWO_LEVEL_MIN_C)
    log(f"[ivf-10m] C, S, slab dtype, two-level: {got} (the code predicts {want}); super layer "
        f"{None if idx._sup_cents is None else tuple(idx._sup_cents.shape)}; {cell_s:.1f} s for annbench.main")
    if rc != 0 or got != want or idx._sup_cents is None:
        raise AssertionError(f"the 10M cell's refit chose {got}, not {want} (rc {rc})")
    if res["recall@10"] < CELL_10M_RECALL:
        raise AssertionError(f"the 10M cell's recall@10 {res['recall@10']} is below {CELL_10M_RECALL}")
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the 10M cell did not run K3 and K4 on the card: {launches}")
    if not res["sweep"]:
        raise AssertionError("the 10M cell printed no sweep rows")
    for row in res["sweep"]:
        log(f"[ivf-10m] sweep: p={row['probes']} recall@10 {row['recall@10']:.4f} eps-recall "
            f"{row['recall_eps@10']:.4f} QPS {row['qps']:.1f} (of 2 passes: {row['qps_spread']})")
    log(f"[ivf-10m] launches during the cell's searches: {launches}")

    # P2 lost K3 launches in every profiler window of this phase: its K3
    # times are held to a call's CUDA-event time
    kc = _cell_kernels(torch, ivf_scan, ivf_rerank, idx, test[:batch], "the 10M cell", cross_check=True)
    k3_ops, k4_ops, k3_bytes, k3_call = kc["k3_ops"], kc["k4_ops"], kc["k3_bytes"], kc["k3_call"]
    t4 = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, *k4_ops), runs=IVF_TIMED_RUNS,
                    kernel="rerank_kernel")
    log(f"[ivf-10m] K3 == plain and K4 == plain on the cell's operands (B={kc['B']}, p={kc['p']}, S={kc['S']}, "
        f"r={kc['r']}, rr={kc['rr']}, {idx.slabs.dtype}); max |err| K3 {kc['err3']:.3g}, K4 {kc['err4']:.3g}")
    log(f"[ivf-10m] K3 {_k3_line(kc['t3'], k3_bytes['distinct'])}; {kc['distinct']} distinct probed clusters, "
        f"{kc['live_distinct']} live slots in them; a call with its host work (median of 30, CUDA events) "
        f"{k3_call:.4f} ms; plain {kc['t3_plain']:.4f} ms")
    log(f"[ivf-10m] K4 {t4:.4f} ms a call ({_bound_ms(kc['k4_bytes']) / t4:.1%} of the "
        f"{_bound_ms(kc['k4_bytes']):.4f} ms bound, {kc['k4_bytes']} B: {kc['rows4']} distinct pool rows); "
        f"plain {kc['t4_plain']:.4f} ms")

    # The same slab_ids in f32 (no new k-means): K3 on both slab types, and
    # the recall and QPS f32 slabs would give
    t0 = time.perf_counter()
    slabs32, _ = ivf._slabs_from_ids(idx.vectors, idx.slab_ids, idx._proj, out_dtype=torch.float32, want_sq=False)
    torch.cuda.synchronize()
    f32_build_s = time.perf_counter() - t0
    ops32 = (k3_ops[0], k3_ops[1], slabs32) + tuple(k3_ops[3:])
    err32 = check_rows(torch, ivf_scan.ivf_probe_scan_plain(*ops32), ivf_scan.ivf_probe_scan(*ops32),
                       _k3_dist_of(torch, k3_ops[0], slabs32, idx.slab_sq, idx.slab_ids),
                       _k3_atol(torch, k3_ops[0], slabs32), "K3 on the 10M cell, f32 slabs")
    call32 = _median_call_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *ops32))
    t3_32 = _k3_device_ms(torch, ivf_scan, ops32, kc["chunks"], IVF_TIMED_RUNS, call32)
    bytes32 = k3_bytes["distinct"] + kc["live_distinct"] * kc["r"] * 2  # 4 B a value where bf16 has 2
    peak_f32 = torch.cuda.max_memory_allocated() / 2**30
    bf16 = idx.slabs
    with idx._state_lock:
        idx.slabs = slabs32
    try:
        passes = [bench.query_batch(test, LIMIT, batch) for _ in range(2)]
    finally:
        with idx._state_lock:
            idx.slabs = bf16
    ids32, wall32 = min(passes, key=lambda pw: pw[1])
    recall32 = float(np.mean([len(set(ids32[i]) & set(gt[i])) / LIMIT for i in range(len(gt))]))
    del slabs32, ops32, passes
    torch.cuda.empty_cache()
    log(f"[ivf-10m] f32 slabs from the same slab_ids ({f32_build_s:.2f} s, peak device memory then "
        f"{peak_f32:.2f} GiB): K3 == plain, max |err| {err32:.3g}; K3 {_k3_line(t3_32, bytes32)}; a call with "
        f"its host work (median of 30, CUDA events) {call32:.4f} ms; recall@10 "
        f"{recall32:.4f} (bf16 {res['recall@10']:.4f}), QPS {len(gt) / wall32:.1f} (bf16 {res['qps']:.1f}, best of "
        f"2 against best of 3)")

    # Two write transactions after the fit, of new ids past the corpus:
    # held-out rows of the corpus's own mixture (the cell's last queries), then
    # rows the cell's generator draws with another seed. Each goes through the
    # two-level assignment and the write repair; every point must come back as
    # its own nearest neighbour
    batches = {
        "held-out rows of the corpus's mixture": test[-WRITE_POINTS:].cpu().numpy(),
        f"rows of another mixture (seed {WRITE_SEED})": embedding_like_device(
            WRITE_POINTS, idx.params.vector_size, 1, spread=0.5, seed=WRITE_SEED, device=idx.device
        ).train.cpu().numpy(),
    }
    writes, next_id = {}, n + 2
    for what, new in batches.items():
        w = _write_after_fit(ivf, idx, new, np.arange(next_id, next_id + len(new)))
        next_id += len(new)
        writes[what] = w
        log(f"[ivf-10m] write transaction of {len(new)} {what}: {w['write_s']:.3f} s, of which the two-level "
            f"assignment {w['assign_s']:.3f} s ({w['two_level_assignments']} call(s)) and the repair "
            f"{w['repair_s']:.3f} s; rows the repair placed by their own probes {w['repaired']}; refit {w['refit']}; "
            f"{len(new) - w['lost']} of {len(new)} come back as their own nearest neighbour")
        if w["lost"] or not w["two_level_assignments"] or w["refit"]:
            raise AssertionError(f"the write of {what} after the 10M fit: {w}")
    log(f"[ivf-10m] peak device memory over the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    k3 = {"launches": launches["K3"], "max_abs_err": max(kc["err3"], err32), "ms": kc["t3"]["ms"],
          "plain_ms": kc["t3_plain"], "bound_ms": _bound_ms(k3_bytes["distinct"]), "bytes": k3_bytes,
          "by_kernel_ms": kc["t3"]["by_kernel_ms"], "distinct_clusters": kc["distinct"],
          "live_slots_distinct": kc["live_distinct"], "call_ms": k3_call, "f32_ms": t3_32["ms"], "f32_call_ms": call32,
          "f32_bound_ms": _bound_ms(bytes32)}
    k4 = {"launches": launches["K4"], "max_abs_err": kc["err4"], "ms": t4, "plain_ms": kc["t4_plain"],
          "bound_ms": _bound_ms(kc["k4_bytes"]), "bytes": kc["k4_bytes"], "distinct_rows": kc["rows4"]}
    return {"res": res, "profile": prof, "k3": k3, "k4": k4, "recall_f32": recall32, "qps_f32": len(gt) / wall32,
            "writes": writes, "cell_s": cell_s}


def _write_after_fit(ivf, idx, new, new_ids) -> dict:
    """One write transaction of ``new`` under ``new_ids`` into a fitted
    two-level index: its seconds, the seconds of the assignment and of the
    repair (``_within_own_probes``) inside it (each returns host arrays, so
    each has waited for its device work), the rows the repair moved, and the
    points that do not come back as their own nearest neighbour."""
    spent = {"assign_s": 0.0, "repair_s": 0.0}
    reached = []

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t0
            return out
        return call

    assign = ivf.kmeans_assign_two_level
    ivf.kmeans_assign_two_level = lambda *a, **kw: reached.append(1) or assign(*a, **kw)
    idx._assign_top = timed(idx._assign_top, "assign_s")
    idx._within_own_probes = timed(idx._within_own_probes, "repair_s")
    repaired, n_fit = idx.repaired_writes, idx._n_at_fit
    try:
        t0 = time.perf_counter()
        idx.insert_update_delete(zip(new_ids.tolist(), new))
        idx.sync()
        write_s = time.perf_counter() - t0
    finally:
        ivf.kmeans_assign_two_level = assign
        del idx._assign_top, idx._within_own_probes
    _, found = idx.search_batch(new, 1)
    return {"write_s": write_s, **spent, "two_level_assignments": len(reached),
            "repaired": idx.repaired_writes - repaired, "lost": int((found[:, 0] != new_ids).sum()),
            "refit": idx._n_at_fit != n_fit}


def load_k4_baseline(source: str):
    """Build and load another K4 source with the same C interface (e.g. the
    parent commit's ``csrc/ivf_rerank.cu``, its ``ivf_common.cuh`` beside it),
    to time beside the tree's K4; it launches through ``ivf_rerank.launch``
    and counts nothing."""
    import os

    from semadb_tpu_torch.ops.kernels import ivf_rerank
    from semadb_tpu_torch.utils.build import NVCC_FLAGS, build_library, nvcc

    header = os.path.join(os.path.dirname(os.path.abspath(source)), "ivf_common.cuh")
    path, _ = build_library("ivf_rerank_baseline", source, nvcc(), NVCC_FLAGS, (header,))
    log(f"[build] K4 baseline {source}: built into {path}")
    return ivf_rerank.bind(path)


def hybrid_corpus(n: int, seed: int) -> dict:
    """Phase 9's documents, from ``seed`` with numpy: vectors from
    ``embedding_like(spread=0.5)`` (and held-out queries); ``body`` 12 terms
    ``w<rank>``, Zipf over the vocabulary as the text bench draws them;
    ``category`` one of 20, Zipf-skewed; ``year`` uniform over 1990-2024;
    ``tags`` 1-3 distinct of 50."""
    import uuid

    from semadb_tpu_torch.tools.datasets import embedding_like

    ds = embedding_like(n, HYBRID_DIM, HYBRID_QUERIES, spread=0.5, seed=seed + 31)
    rng = np.random.default_rng([seed, 31])
    ranks = np.minimum(rng.zipf(HYBRID_ZIPF, size=(n, HYBRID_TERMS)) - 1, HYBRID_VOCAB - 1)
    p = 1.0 / np.arange(1, HYBRID_CATEGORIES + 1) ** HYBRID_CATEGORY_ZIPF
    category = rng.choice(HYBRID_CATEGORIES, size=n, p=p / p.sum())
    year = rng.integers(HYBRID_YEARS[0], HYBRID_YEARS[1] + 1, size=n)
    n_tags = rng.integers(1, 4, size=n)
    tag_order = np.argsort(rng.random((n, HYBRID_TAGS)), axis=1)[:, :3]
    tags = np.zeros((n, HYBRID_TAGS), bool)
    for j in range(3):
        rows = np.nonzero(n_tags > j)[0]
        tags[rows, tag_order[rows, j]] = True
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n)]
    return {"vectors": ds.train, "queries": ds.test, "ranks": ranks, "category": category, "year": year,
            "tags": tags, "ids": ids, "row_of": {pid: i for i, pid in enumerate(ids)}}


def _hybrid_doc(c: dict, i: int) -> dict:
    return {"vector": c["vectors"][i].tolist(),
            "body": " ".join(f"w{r}" for r in c["ranks"][i]),
            "category": f"c{c['category'][i]:02d}", "year": int(c["year"][i]),
            "tags": [f"t{j:02d}" for j in np.nonzero(c["tags"][i])[0]]}


def _text_scores(c: dict, terms) -> tuple:
    """Each document's TF-IDF score for the query terms (``index/text.py``:
    Σ over the terms of count / length · log10(N / (df + 1))), and which
    documents hold each term."""
    ranks = c["ranks"]
    n = len(ranks)
    counts = np.stack([(ranks == t).sum(1) for t in terms])
    df = (counts > 0).sum(1)
    score = (counts / HYBRID_TERMS * np.log10(n / (df + 1))[:, None]).sum(0)
    return score, counts > 0


def phase_hybrid(torch, counted, device, seed: int, n_points: int = HYBRID_POINTS) -> dict:
    """A hybrid collection over HTTP v2: a vectorIVF property beside text,
    string, integer and stringArray ones, every query checked against a
    plain evaluation over the generated documents."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.models.query import Query
    from semadb_tpu_torch.ops.topk import tie_rule_errors
    from semadb_tpu_torch.shard import pointstore
    from semadb_tpu_torch.tools import dbpedia_bq as bq

    name = "hybrid"
    schema = {"vector": {"type": "vectorIVF", "vectorIVF": {"vectorSize": HYBRID_DIM, "distanceMetric": "euclidean"}},
              "body": {"type": "text", "text": {"analyser": "standard"}},
              "category": {"type": "string", "string": {"caseSensitive": False}},
              "year": {"type": "integer", "integer": {}},
              "tags": {"type": "stringArray", "stringArray": {"caseSensitive": False}}}
    t0 = time.perf_counter()
    c = hybrid_corpus(n_points, seed)
    gen_s = time.perf_counter() - t0
    data = c["vectors"].astype(np.float64)
    row_of = c["row_of"]
    lat: dict = {}
    checked: dict = {}

    def search(query, limit=10, kind=None):
        t1 = time.perf_counter()
        res = bq.http_json(srv.base, "POST", f"/{name}/points/search", {"query": query, "limit": limit})
        if kind is not None:
            lat.setdefault(kind, []).append(time.perf_counter() - t1)
            checked[kind] = checked.get(kind, 0) + 1
        return res["points"]

    def members_of(query):
        """Every point of a set query, as the shard's index manager finds it
        (node ids to point ids through the shard's point store)."""
        def on_shard(shard):
            out = []

            def reader(bm):
                nodes = sorted(shard._index_manager(bm).search(Query.from_dict(query))[0])
                out.extend(shard._uuid_strs.lookup(bm.get(pointstore.POINTS_BUCKET_NAME), nodes))

            shard.db.read(reader)
            return out

        return [row_of[pid] for pid in srv.node.shard_manager.do_with_shard(col, col.shard_ids[0], on_shard)]

    def near(q, flt=None, limit=10):
        body = {"vector": q.tolist(), "operator": "near", "limit": limit}
        if flt is not None:
            body["filter"] = flt
        return {"property": "vector", "vectorIVF": body}

    cat, year, tags = c["category"], c["year"], c["tags"]
    counts = np.bincount(cat, minlength=HYBRID_CATEGORIES)
    rare, common = int(np.argmin(counts)), int(np.argmax(counts))
    ta, tb = 3, 17
    filters = [  # (kind, query, the members as a mask over the documents)
        ("string equals, rare", {"property": "category", "string": {"value": f"c{rare:02d}", "operator": "equals"}},
         cat == rare),
        ("string equals, common", {"property": "category", "string": {"value": f"c{common:02d}",
                                                                      "operator": "equals"}}, cat == common),
        ("integer inRange", {"property": "year", "integer": {"value": 2003, "endValue": 2004, "operator": "inRange"}},
         (year >= 2003) & (year <= 2004)),
        ("integer greaterThanOrEquals", {"property": "year", "integer": {"value": 2024,
                                                                         "operator": "greaterThanOrEquals"}},
         year >= 2024),
        ("stringArray containsAny", {"property": "tags", "stringArray": {"value": [f"t{ta:02d}", f"t{tb:02d}"],
                                                                          "operator": "containsAny"}},
         tags[:, [ta, tb]].any(1)),
        ("stringArray containsAll", {"property": "tags", "stringArray": {"value": [f"t{ta:02d}", f"t{tb:02d}"],
                                                                          "operator": "containsAll"}},
         tags[:, [ta, tb]].all(1)),
    ]
    rng = np.random.default_rng([seed, 32])
    mid = rng.integers(100, 1000, size=(4, 2))
    text_queries = ([("common", op, [a, b]) for op in ("containsAny", "containsAll") for a, b in ((0, 4), (1, 6))]
                    + [("mid", op, [int(a), int(b)]) for op in ("containsAny", "containsAll") for a, b in mid])

    with tempfile.TemporaryDirectory(prefix="semadb_smoke_hybrid_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            # one shard on the one device, so every search is exact over the collection
            out = bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema, "shardPlacement": "device"})
            assert out == {"message": "collection created"}, out
            col = srv.node.get_collection(bq.USER["X-User-Id"], name)
            col.user_plan = srv.plan
            t0 = time.perf_counter()
            for lo in range(0, n_points, HYBRID_BATCH):
                pts = [Point.from_map(_hybrid_doc(c, i), uuid.UUID(c["ids"][i]))
                       for i in range(lo, min(lo + HYBRID_BATCH, n_points))]
                failed = srv.node.insert_points(col, pts)
                assert failed == [], failed
            ingest_s = time.perf_counter() - t0
            assert len(col.shard_ids) == 1, col.shard_ids

            # Set queries: the first page over HTTP, the whole set on the shard
            for kind, query, mask in filters:
                want = set(np.nonzero(mask)[0].tolist())
                page = [row_of[p["_id"]] for p in search(query, HYBRID_PAGE, kind=kind)]
                if len(page) != min(HYBRID_PAGE, len(want)) or not set(page) <= want:
                    raise AssertionError(f"{kind}: a page of {len(page)} points, {len(set(page) - want)} not in "
                                         f"the {len(want)} the documents give")
                got = members_of(query)
                if len(got) != len(set(got)) or set(got) != want:
                    raise AssertionError(f"{kind}: {len(set(got))} points ({len(got)} with repeats), the "
                                         f"documents give {len(want)}; {len(set(got) ^ want)} differ")

            # vectorIVF filtered by each: numpy's brute force over the members
            for kind, query, mask in filters:
                members = np.nonzero(mask)[0]
                for q in c["queries"]:
                    pts = search(near(q, query), kind=f"vectorIVF filtered by {kind}")
                    d = ((data[members] - q.astype(np.float64)) ** 2).sum(-1)
                    order = np.argsort(d, kind="stable")[:10]
                    dist = dict(zip(members.tolist(), d.tolist()))
                    got_rows = [row_of[p["_id"]] for p in pts]
                    atol = IVF_RTOL * ((np.sqrt(d.max()) + 2 * float(np.linalg.norm(q))) ** 2 + 1.0)
                    errs = tie_rule_errors(d[order], members[order].tolist(), [p["_distance"] for p in pts],
                                           got_rows, lambda r: dist.get(r, float("inf")), atol=atol)
                    if errs:
                        raise AssertionError(f"vectorIVF filtered by {kind}: {errs[:3]}")

            # Text: scores by the formula, ids by the tie rule
            for tag, op, terms in text_queries:
                kind = f"text {op}, {tag} terms"
                value = " ".join(f"w{t}" for t in terms)
                pts = search({"property": "body", "text": {"value": value, "operator": op, "limit": 10}}, kind=kind)
                score, has = _text_scores(c, terms)
                sel = np.nonzero(has.all(0) if op == "containsAll" else has.any(0))[0]
                order = sel[np.argsort(-score[sel], kind="stable")[:10]]
                got_rows = [row_of[p["_id"]] for p in pts]
                got_s = [p["_score"] for p in pts]
                if any(not (has[:, r].all() if op == "containsAll" else has[:, r].any()) for r in got_rows):
                    raise AssertionError(f"{kind}: a result does not hold the terms {value}")
                if any(a < b for a, b in zip(got_s, got_s[1:])):
                    raise AssertionError(f"{kind}: scores not descending: {got_s}")
                atol = TEXT_RTOL * max(1e-12, float(score.max()))
                errs = tie_rule_errors((-score[order]).tolist(), order.tolist(), [-x for x in got_s], got_rows,
                                       lambda r: -score[r], atol=atol)
                if errs:
                    raise AssertionError(f"{kind} ({value}): {errs[:3]}")

            # Hybrid: an unfiltered vectorIVF arm (weight 1) or a text arm (weight 0.5)
            k3_before, k4_before = (mod.LAUNCHES for nm, mod in counted if nm in ("K3", "K4"))
            for i, q in enumerate(c["queries"]):
                terms = [int(t) for t in mid[i % len(mid)]]
                text = {"property": "body", "text": {"value": " ".join(f"w{t}" for t in terms),
                                                     "operator": "containsAny", "limit": 10, "weight": 0.5}}
                vec = near(q)
                vec["vectorIVF"]["weight"] = 1.0
                alone_v = {p["_id"]: p["_distance"] for p in search(vec)}
                alone_t = {p["_id"]: p["_score"] for p in search(text)}
                pts = search({"property": "_or", "_or": [vec, text]}, limit=20, kind="hybrid _or")
                if {p["_id"] for p in pts} != set(alone_v) | set(alone_t):
                    raise AssertionError("hybrid _or: the points are not the union of its arms")
                hs = [p["_hybridScore"] for p in pts]
                if any(a < b for a, b in zip(hs, hs[1:])):
                    raise AssertionError(f"hybrid _or: hybrid scores not descending: {hs}")
                for p in pts:
                    want = -alone_v.get(p["_id"], 0.0) * 1.0 + alone_t.get(p["_id"], 0.0) * 0.5
                    if abs(p["_hybridScore"] - want) > 1e-5 * max(1.0, abs(want)):
                        raise AssertionError(f"hybrid _or: {p['_hybridScore']} != {want}")
            launches = {nm: mod.LAUNCHES for nm, mod in counted}
            if launches["K3"] <= k3_before or launches["K4"] <= k4_before:
                raise AssertionError(f"the hybrid searches did not run K3 and K4: {launches}")

            # The exact member scan (K8, plain torch) at the common category:
            # its node ids from the shard's own inverted index
            def members_and_index(shard):
                out = []
                shard.db.read(lambda bm: out.append(shard._index_manager(bm).search(
                    Query.from_dict(filters[1][1]))[0]))
                return out[0], shard.device_indices["index/vectorIVF/vector"]

            nodes, idx = srv.node.shard_manager.do_with_shard(col, col.shard_ids[0], members_and_index)
            fm = np.zeros(idx.capacity, bool)
            fm[np.fromiter(nodes, np.int64, len(nodes))] = True
            scan = functools.partial(idx.search_batch_async, c["queries"][:1], 10, filter_mask=fm)
            member_ms = _device_ms(torch, scan, runs=IVF_TIMED_RUNS)
            member_call_ms = _median_call_ms(torch, scan)
    p50 = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
    log(f"[hybrid] {n_points} points (vectorIVF {HYBRID_DIM}-d, text, string, integer, stringArray) made in "
        f"{gen_s:.2f} s, ingested through ClusterNode.insert_points {HYBRID_BATCH} a txn in {ingest_s:.2f} s = "
        f"{n_points / ingest_s:.1f} points/s; one shard; category sizes rare {counts[rare]}, common {counts[common]}")
    log(f"[hybrid] every check passed: {json.dumps(checked)}")
    log("[hybrid] p50 ms over HTTP by kind: " + "; ".join(f"{k} {v:.2f}" for k, v in p50.items()))
    log(f"[hybrid] the exact member scan over {int(fm.sum())} members (the common category): {member_ms:.4f} ms "
        f"of device time a call, {member_call_ms:.4f} ms a call; launches in this phase {launches}")
    return {"ingest_rate": n_points / ingest_s, "p50_ms": p50, "member_ms": member_ms,
            "member_call_ms": member_call_ms, "launches": launches, "checked": checked}


def _zero_counts(counted) -> None:
    """Every kernel's launch count to 0, before a path is driven."""
    for _, mod in counted:
        mod.LAUNCHES = 0
    for _, mod in counted:
        if hasattr(mod, "LAUNCHES_BY"):
            mod.LAUNCHES_BY.clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--k4-baseline", metavar="SOURCE",
                        help="another K4 source (ivf_rerank.cu, its ivf_common.cuh beside it), e.g. the parent "
                             "commit's, timed beside the tree's K4 in phases 8 and 8c")
    args = parser.parse_args()

    sys.modules["jax"] = None  # this script and the port never import jax
    sys.modules["semadb_tpu"] = None  # nor the JAX package
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    import semadb_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    env = phase_environment(torch)
    hamming, gather, ivf_scan, ivf_rerank = phase_build()
    counted = (("K1", hamming), ("K2", gather), ("K3", ivf_scan), ("K4", ivf_rerank))
    worst = phase_kernel(torch, hamming, device)
    sl = phase_slice(torch, hamming, gather, device, args.seed)
    timing = phase_timing(torch, hamming, sl["codes"], sl["qcodes"])
    by_b = timing["by_b"]
    t64 = by_b[64]
    g_worst = phase_gather_kernel(torch, gather, device)
    gb = phase_gatherbench(torch, hamming, gather)
    kerr = phase_ivf_kernels(torch, ivf_scan, ivf_rerank, device)
    baseline = load_k4_baseline(args.k4_baseline) if args.k4_baseline else None
    cell = phase_ivf_cell(torch, counted, baseline=baseline)
    proj = phase_k4_projected(torch, ivf_rerank, args.seed, baseline)
    phase_ivf_http(torch, counted, device, args.seed)
    hybrid = phase_hybrid(torch, counted, device, args.seed)
    wide = phase_wide_filter(torch, counted, cell["index"], cell["queries"], args.seed)
    del cell["index"], cell["queries"]
    big = phase_ivf_10m(torch, counted)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    ivf_shape = (f"the IVF bench cell's operands: B={cell['res']['batch']} queries, p={cell['res']['probes']}, "
                 f"C={cell['res']['clusters']}, S={cell['res']['slab']}, {cell['res']['slab_dtype']} slabs; "
                 f"device time per call, mean of {IVF_TIMED_RUNS}")
    print(env["smi"])
    print(json.dumps({"kernels": [{
        "name": "K1 pairwise_bit_distance (hamming/jaccard over packed codes)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/hamming.cu",
        "replaces": "semadb_tpu/ops/pallas/hamming.py:79",
        "launches": sl["launches"],
        "launches_b1": sl["split"]["b1"],
        "launches_b_gt1": sl["split"]["b_gt1"],
        "launches_by_route": sl["routes"],
        "max_abs_err": max(worst, *(r["max_abs_err"] for r in by_b.values())),
        "ms": t64["ms"],
        "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": (f"hamming B=64 N={t64['n']} W={t64['w']} on the {t64['route']} route; device time "
                  "per call, L2-cold"),
        "call_ms": t64["call_ms"],
        "plain_call_ms": t64["plain_call_ms"],
        "by_b": {str(b): {k: r[k] for k in (
            "route", "ms", "bound_ms", "share", "int8_ops_ms", *hamming.ROUTES, "plain_ms", "call_ms")
            if k in r} for b, r in by_b.items()},
        "threshold_sweep_cold_ms": {str(b): v for b, v in timing["threshold_sweep"].items()},
    }, {
        "name": "K2 gather_rows (row gather vectors[ids])",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/gather.cu",
        "replaces": "semadb_tpu/ops/pallas/gather.py:71",
        "launches": gb["launches"],
        "max_abs_err": g_worst,
        "ms": gb["ms"]["kernel"],
        "plain_ms": gb["ms"]["plain"],
        "bound_ms": gb["bound_ms"],
        "bound_by": gb["bound_by"],
        "library_ms": gb["ms"]["torch"],
        "shape": "gatherbench defaults: f32[1000000, 128] x i32[1048576]; median of 21 calls, CUDA events",
    }, {
        "name": "K3 ivf_probe_scan (probed-slab scan with a running top-rr)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_scan.cu",
        "replaces": "semadb_tpu/index/ivf.py:428",
        **{key: cell["k3"][key] for key in ("launches", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(kerr["k3_err"], cell["k3"]["max_abs_err"], big["k3"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE,
        "kernels_per_call": cell["k3"]["kernels_per_call"],
        "by_kernel_ms": cell["k3"]["by_kernel_ms"],
        "b_sweep_ms": {str(b): v for b, v in cell["k3"]["b_sweep_ms"].items()},
        "b1_call_ms": cell["k3"]["b1_call_ms"],
        "bound_bytes": cell["k3"]["bytes"],
        "per_query_bound_ms": cell["k3"]["per_query_bound_ms"],
        "launches_hybrid": hybrid["launches"]["K3"],
        "launches_wide_filter": wide["launches"]["K3"],
        "shape": ivf_shape + "; every device event of a call (kernels and memset)",
        "cell_10m": {key: v for key, v in big["k3"].items() if key != "max_abs_err"},
    }, {
        "name": "K4 ivf_exact_rerank (copy dedup and exact rerank of the coarse pool)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_rerank.cu",
        "replaces": "semadb_tpu/index/ivf.py:510",
        **{key: cell["k4"][key] for key in ("launches", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(kerr["k4_err"], cell["k4"]["max_abs_err"], proj["max_abs_err"], big["k4"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE_K4,
        "bound_bytes": cell["k4"]["bytes"],
        "shape": ivf_shape + f", k=10, rr=64 with the copies, dedup inside: {cell['k4']['dedup']}",
        **{key: cell["k4"][key] for key in cell["k4"] if key.startswith(("b1_", "base_")) or key == "route"},
        "b_sweep_ms": {str(b): v for b, v in cell["k4"]["b_sweep_ms"].items()},
        "element_route_ms": cell["k4"]["element_route_ms"],
        "projected": {key: v for key, v in proj.items() if key != "max_abs_err"},
        "launches_hybrid": hybrid["launches"]["K4"],
        "launches_wide_filter": wide["launches"]["K4"],
        "cell_10m": {key: v for key, v in big["k4"].items() if key != "max_abs_err"},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
