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
   the card: K3 at B in {1, 7, 64, 4096}, p in {1, 5, 24, 96}, S in {64,
   128, 192}, r in {3, 100, 128}, rr in {20, 64, 256}, f32 and bf16 slabs,
   30% NIL slots, with and without a filter mask (every value of each
   parameter, in 20 combinations); K4 at D in {3, 128, 1536}, k in {1, 10,
   100}, all three metrics (27 combinations). Distances must agree within
   1e-5 of the summed terms' magnitude (the sums run in another order), ids
   by the tie rule at that tolerance.
8. The IVF bench cell: ``semadb_tpu_torch.tools.annbench.main`` at its
   defaults on ``cuda`` (the JAX package's default ``python bench.py``:
   1,000,000 x 128 ``embedding_like(spread=0.5, seed=42)``, euclidean,
   assignCopies 2, 32,768 queries in batches of 4,096, k = 10): recall@10
   against the exact f32 ground truth must be >= 0.99 and K3 and K4 must
   have launched; it prints the build's split, QPS, peak device memory, a
   torch.profiler pass over one batch and the batch stage by stage (CUDA
   events). Then K3 and K4 on the cell's own
   operands (4,096 queries): checked against their plain versions, timed
   (device time per call, torch.profiler, mean of 20), the plain versions
   timed, and set against their byte bounds.
8b. ``vectorIVF`` over HTTP v2: the port's node and server with
   ``config/singleServer.yaml``, a 128-d euclidean ``vectorIVF`` collection
   of 20,000 points (``embedding_like``, the bench cell's generator and
   spread) inserted through ``ClusterNode.insert_points``, 10 HTTP searches
   with held-out queries checked against numpy brute force (recall@10 >=
   0.95, every returned distance exact); K3 and K4 must have launched in
   this phase.

Each kernel's bound is its bytes (each input read once, each output
written once; for K2 each distinct row once; for K3 each distinct probed
cluster once, for K4 each distinct pool row once) over 3.35 TB/s, from this
run's inputs. K2 does no arithmetic. K1's work is bit operations, and the
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


def _device_ms(torch, fn, runs: int = 30, before=None, kernel=None):
    """Device time per call: the profiler's time of the device events over
    ``runs`` calls of ``fn`` (only events whose name holds ``kernel``, when
    given, averaged over the launches recorded; a CPU op's device time
    repeats its kernels', so only device-side events count). ``before``
    runs ahead of each call, outside the count. The window opens with
    untimed spin kernels (``annbench.prime_profiler``): in this script's
    process the profiler missed the first two or three device events of a
    window. Raises if the profiler saw no such device activity."""
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
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and PRIME_KERNEL not in e.key
              and (kernel is None or kernel in e.key)]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0:
        raise RuntimeError(f"torch.profiler recorded no device time of {kernel or 'any kernel'}; "
                           "the kernel times cannot be measured")
    calls = sum(e.count for e in events) if kernel is not None else runs
    return total_us / 1e3 / calls


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
IVF_RTOL = 1e-5  # of the magnitude of the summed terms: the sums run in another order
IVF_TIMED_RUNS = 20
HTTP_IVF_POINTS = 20_000
HTTP_IVF_DIM = 128
HTTP_IVF_RECALL = 0.95
CELL_RECALL = 0.99
LIBRARY_NONE = ("none: no single PyTorch call gathers probed slabs and keeps a top-rr "
                "(index_select + bmm + topk are three calls and materialise [B, p*S])")
LIBRARY_NONE_K4 = ("none: no single PyTorch call gathers pool rows and takes an exact top-k "
                   "(index_select + bmm + topk are three calls)")


def k3_cases():
    """Every value of each K3 parameter, in 20 combinations: the 16 (B, p)
    pairs with S, r, rr, slab type and mask cycling, plus the bench cell's
    shape (B 4096, p 24, S 128, r 128, rr 64) in both slab types, with and
    without a mask."""
    cases = []
    for i, (b, p) in enumerate((b, p) for b in K3_BS for p in K3_PS):
        cases.append((b, p, K3_SS[i % 3], K3_RS[(i // 3) % 3], K3_RRS[(i + 1) % 3], i % 2 == 1, (i // 2) % 2 == 1))
    cases += [(4096, 24, 128, 128, 64, bf16, mask) for bf16 in (False, True) for mask in (False, True)]
    return cases


def k4_cases():
    """D x k x metric, 27 combinations; B cycles through 1, 7, 64 and 4096
    (4096 only at D = 128, where the bench cell runs)."""
    cases = []
    for i, (d, k, metric) in enumerate(
            (d, k, m) for d in K4_DS for k in K4_KS for m in ("euclidean", "dot", "cosine")):
        b = 4096 if d == 128 and i % 3 == 0 else (1, 7, 64)[i % 3]
        cases.append((b, d, k, metric))
    return cases


def pool_errors(want_d, want_i, got_d, got_i, dist_of, atol) -> list:
    """The tie rule for one row of a pool that may hold an id twice (points
    with copies): distances equal within ``atol`` place by place; the
    multiset of ids below the last reference distance equal; every other
    returned id carries that distance (``dist_of``), or is -1 at inf."""
    import collections

    errs = [f"place {j}: {g} != {w}" for j, (w, g) in enumerate(zip(want_d, got_d))
            if not (w == g or abs(w - g) <= atol)]
    if errs:
        return errs[:3]
    dk = want_d[-1]
    below_w = collections.Counter(i for d, i in zip(want_d, want_i) if d < dk - atol)
    below_g = collections.Counter(i for d, i in zip(got_d, got_i) if d < dk - atol)
    if below_w != below_g:
        return [f"ids below the last distance differ: {below_w - below_g} / {below_g - below_w}"]
    for d, i in zip(got_d, got_i):
        if d >= dk - atol:
            true = float("inf") if i == -1 else float(dist_of(i))
            if not (true == d or abs(true - d) <= atol):
                return [f"id {i} at distance {d} has distance {true}"]
    return []


def check_rows(torch, want, got, dist_of, atol, what) -> float:
    """Hold every row of ``got`` (d, i) against ``want`` by
    :func:`pool_errors`; rows that match exactly (ids equal, distances
    within atol) need no lookups. Returns the largest |error| of the finite
    distances."""
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


def _k3_operands(torch, gen, b, p, s, r, bf16, masked, device):
    c = max(2 * p, 32)
    rows = torch.randn((c, s, r), generator=gen)
    ids = (torch.randperm(c * s, generator=gen).reshape(c, s) + 2).to(torch.int32)
    nil = torch.rand((c, s), generator=gen) < 0.3
    ids[nil] = -1
    rows[nil] = 0.0
    slabs = rows.to(torch.bfloat16) if bf16 else rows
    slab_sq = (rows * rows).sum(-1)
    qp = torch.randn((b, r), generator=gen)
    probe = torch.argsort(torch.rand((b, c), generator=gen), dim=1)[:, :p].to(torch.int32).contiguous()
    mask = (torch.rand(c * s + 2, generator=gen) < 0.5).to(torch.uint8) if masked else None
    ops = [qp, probe, slabs, slab_sq, ids, mask]
    return [None if t is None else t.to(device) for t in ops]


def _k3_dist_of(torch, qp, slabs, slab_sq, slab_ids):
    """id → its coarse score for query b, in f64 on the host (first copy)."""
    ids_h = slab_ids.cpu().reshape(-1)
    cache = {}

    def dist_of(b, i):
        if i not in cache:
            cache[i] = int((ids_h == i).nonzero()[0, 0])
        cell = cache[i]
        row = slabs.reshape(-1, slabs.shape[-1])[cell].double().cpu()
        sq = float(slab_sq.reshape(-1)[cell])
        return sq - 2.0 * float(row @ qp[b].double().cpu())

    return dist_of


def _k3_atol(torch, qp, slabs):
    """Per query: IVF_RTOL x (|x|max^2 + 2 |x|max |q|), the size of the terms."""
    xmax = float(slabs.float().norm(dim=-1).max())
    return (IVF_RTOL * (xmax * xmax + 2.0 * xmax * qp.double().norm(dim=1))).cpu()


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
    for b, p, s, r, rr, bf16, masked in k3_cases():
        ops = _k3_operands(torch, gen, b, p, s, r, bf16, masked, device)
        what = f"K3 B={b} p={p} S={s} r={r} rr={rr} {'bf16' if bf16 else 'f32'} mask={masked}"
        got = ivf_scan.ivf_probe_scan(*ops, rr)
        torch.cuda.synchronize()
        want = ivf_scan.ivf_probe_scan_plain(*ops, rr)
        worst3 = max(worst3, check_rows(torch, want, got, _k3_dist_of(torch, ops[0], ops[2], ops[3], ops[4]),
                                        _k3_atol(torch, ops[0], ops[2]), what))
    for b, d, k, metric in k4_cases():
        cap = 5000
        vectors = torch.randn((cap, d), generator=gen)
        if metric == "cosine":
            vectors = vectors / vectors.norm(dim=1, keepdim=True)
        queries = torch.randn((b, d), generator=gen)
        if metric == "cosine":
            queries = queries / queries.norm(dim=1, keepdim=True)
        rr = max(64, 2 * k)
        pool = torch.stack([torch.randperm(cap, generator=gen)[:rr] for _ in range(b)]).to(torch.int32)
        coarse = torch.randn((b, rr), generator=gen)
        empty = torch.rand((b, rr), generator=gen) < 0.2
        coarse[empty] = float("inf")
        pool[empty & (torch.rand((b, rr), generator=gen) < 0.5)] = -1
        vectors, queries, pool, coarse = (t.to(device) for t in (vectors, queries, pool, coarse))
        what = f"K4 B={b} D={d} k={k} {metric}"
        got = ivf_rerank.ivf_exact_rerank(vectors, queries, pool, coarse, k, metric)
        torch.cuda.synchronize()
        want = ivf_rerank.ivf_exact_rerank_plain(vectors, queries, pool, coarse, k, metric)
        worst4 = max(worst4, check_rows(torch, want, got, _k4_dist_of(torch, vectors, queries, metric),
                                        _k4_atol(torch, vectors, queries), what))
    log(f"[ivf-kernels] K3 == plain at {len(k3_cases())} shapes, K4 == plain at {len(k4_cases())} shapes, "
        f"distances within {IVF_RTOL:g} of the terms' magnitude, ids by the tie rule; "
        f"max |err| K3 {worst3:.3g}, K4 {worst4:.3g}")
    return {"k3_err": worst3, "k4_err": worst4}


def phase_ivf_cell(torch, counted, argv=()) -> dict:
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
    log(f"[ivf-cell] launches during the cell's searches: {launches}")

    # One more search of the cell, after the counts were read, hands over
    # the arguments it gives K3 and K4
    idx, test = keep["index"], keep["queries"]
    ops: dict = {}
    idx.search_batch_async(test[: res["batch"]], 10, keep=ops)
    k3_ops, k4_ops = ops["k3"], ops["k4"]
    qp, probe, rr = k3_ops[0], k3_ops[1], k3_ops[6]
    q, pool_i, pool_d, k = k4_ops[1], k4_ops[2], k4_ops[3], k4_ops[4]
    p = probe.shape[1]
    got3 = ivf_scan.ivf_probe_scan(*k3_ops)
    want3 = ivf_scan.ivf_probe_scan_plain(*k3_ops)
    err3 = check_rows(torch, want3, got3, _k3_dist_of(torch, qp, idx.slabs, idx.slab_sq, idx.slab_ids),
                      _k3_atol(torch, qp, idx.slabs), "K3 on the cell")
    got4 = ivf_rerank.ivf_exact_rerank(*k4_ops)
    want4 = ivf_rerank.ivf_exact_rerank_plain(*k4_ops)
    err4 = check_rows(torch, want4, got4, _k4_dist_of(torch, idx.vectors, q, idx.metric),
                      _k4_atol(torch, idx.vectors[: 1 + int(pool_i.max())], q), "K4 on the cell")

    B, S, r = q.shape[0], idx.slabs.shape[1], idx.slabs.shape[2]
    elem = idx.slabs.element_size()
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
    }
    live = pool_i[(pool_i >= 0) & torch.isfinite(pool_d)]
    rows4 = int(torch.unique(live).numel())
    k4_bytes = rows4 * idx.vectors.shape[1] * 4 + B * rr * 8 + B * idx.vectors.shape[1] * 4 + B * k * 8
    t3 = _device_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *k3_ops), runs=IVF_TIMED_RUNS,
                    kernel="probe_scan_kernel")
    t3_plain = _device_ms(torch, functools.partial(ivf_scan.ivf_probe_scan_plain, *k3_ops), runs=3)
    t4 = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, *k4_ops), runs=IVF_TIMED_RUNS,
                    kernel="rerank_kernel")
    t4_plain = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *k4_ops), runs=3)
    k3 = {"launches": launches["K3"], "max_abs_err": err3, "ms": t3, "plain_ms": t3_plain,
          "bound_ms": _bound_ms(k3_bytes["distinct"]), "bound_by": "bytes", "bytes": k3_bytes,
          "per_query_bound_ms": _bound_ms(k3_bytes["per_query_read"]), "distinct_clusters": distinct,
          "live_slots_distinct": live_distinct, "valid_slots": valid}
    k4 = {"launches": launches["K4"], "max_abs_err": err4, "ms": t4, "plain_ms": t4_plain,
          "bound_ms": _bound_ms(k4_bytes), "bound_by": "bytes", "bytes": k4_bytes, "distinct_rows": rows4}
    log(f"[ivf-cell] K3 == plain and K4 == plain on the cell's operands (B={B}, p={p}, S={S}, r={r}, "
        f"rr={rr}, {idx.slabs.dtype}); max |err| K3 {err3:.3g}, K4 {err4:.3g}")
    log(f"[ivf-cell] K3 {t3:.4f} ms a call (device, mean of {IVF_TIMED_RUNS}), plain {t3_plain:.4f} ms; "
        f"bound {k3['bound_ms']:.4f} ms by bytes ({k3_bytes['distinct']} B: {distinct} distinct probed "
        f"clusters once, the rows of their {live_distinct} live slots), {k3['bound_ms'] / t3:.1%} of it; "
        f"what one block per query reads: {k3_bytes['per_query_read']} B = {k3['per_query_bound_ms']:.4f} ms ({valid} live of {B * p * S} "
        f"probed slots; all slots {k3_bytes['per_query_all_slots']} B)")
    log(f"[ivf-cell] K4 {t4:.4f} ms a call, plain {t4_plain:.4f} ms; bound {k4['bound_ms']:.4f} ms by bytes "
        f"({k4_bytes} B: {rows4} distinct pool rows), {k4['bound_ms'] / t4:.1%} of it")
    return {"res": res, "profile": prof, "k3": k3, "k4": k4}


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
    cell = phase_ivf_cell(torch, counted)
    phase_ivf_http(torch, counted, device, args.seed)
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
        "max_abs_err": max(kerr["k3_err"], cell["k3"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE,
        "bound_bytes": cell["k3"]["bytes"],
        "per_query_bound_ms": cell["k3"]["per_query_bound_ms"],
        "shape": ivf_shape,
    }, {
        "name": "K4 ivf_exact_rerank (exact rerank of the coarse pool)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_rerank.cu",
        "replaces": "semadb_tpu/index/ivf.py:517",
        **{key: cell["k4"][key] for key in ("launches", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(kerr["k4_err"], cell["k4"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE_K4,
        "bound_bytes": cell["k4"]["bytes"],
        "shape": ivf_shape + ", k=10, rr=64 after dedup",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
