#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (semadb_tpu_torch) starts and is
right on one NVIDIA GPU.

Usage, from the root of a checkout (one CUDA card, no network):

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run (non-zero exit, no result line):

1. Environment and build: the card (``nvidia-smi``), torch and CUDA versions,
   the codecs, then K1 (``semadb_tpu_torch/csrc/hamming.cu``) and K2
   (``csrc/gather.cu``) built with ``nvcc`` and the key-value store
   (``csrc/kvstore.cpp``) with ``g++`` from the checkout's sources, all three
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

Each kernel's bound is its bytes (each input read once, each output
written once; for K2 each distinct row once) over 3.35 TB/s, from this
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
    """Build K1, K2 and the key-value store at once, one compiler each."""
    from semadb_tpu_torch.ops.kernels import gather, hamming
    from semadb_tpu_torch.store import native
    from semadb_tpu_torch.utils.build import BUILD_DIR

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(timed, fn) for name, fn in (
            ("K1", hamming._library), ("K2", gather._library), ("kvstore", native.load_library))}
        took = {name: job.result() for name, job in jobs.items()}
    if native.load_library() is None:
        raise RuntimeError(f"the key-value store {native.SOURCE} did not build")
    log(f"[build] into {BUILD_DIR}, all at once in {time.perf_counter() - t0:.2f} s")
    for name, mod in (("K1", hamming), ("K2", gather)):
        built = "built now" if mod.BUILD_LOG else "found built from this source hash"
        log(f"[build] {name} {mod.SOURCE}: {built} in {took[name]:.2f} s")
        for line in mod.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] kvstore {native.SOURCE}: loaded in {took['kvstore']:.2f} s")
    return hamming, gather


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
    given; a CPU op's device time repeats its kernels', so only device-side
    events count). ``before`` runs ahead of each call, outside the count.
    Raises if the profiler saw no such device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key)
    )
    if total_us <= 0:
        raise RuntimeError(f"torch.profiler recorded no device time of {kernel or 'any kernel'}; "
                           "the kernel times cannot be measured")
    return total_us / 1e3 / runs


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
    hamming, gather = phase_build()
    worst = phase_kernel(torch, hamming, device)
    sl = phase_slice(torch, hamming, gather, device, args.seed)
    timing = phase_timing(torch, hamming, sl["codes"], sl["qcodes"])
    by_b = timing["by_b"]
    t64 = by_b[64]
    g_worst = phase_gather_kernel(torch, gather, device)
    gb = phase_gatherbench(torch, hamming, gather)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
