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
   jaccard, at B in {1, 7, 64, 1000}, N in {1, 511, 100003}, W in {1, 5, 48}.
   Hamming must be exactly equal, jaccard within 1e-6 absolute.
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
   over the sign bits by the tie rule. K1's launch count is zeroed before
   this phase and must be > 0 after it.
4. Kernel timing at the slice's shapes: B = 1 and 64 over the largest
   shard's own code table (W = 48). K1 must first equal its plain version
   on these operands (hamming exactly, jaccard within 1e-6); then, for
   kernel and plain version, the device
   time per call (torch.profiler over 30 calls) and the time of a call
   with its host launch work (median of 30, CUDA events).
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

Each kernel's bound is the larger of its bytes (each input read once, each
output written once; for K2 each distinct row once) over 3.35 TB/s and its
operations over the card's peak for their type (K1: xor or and/or, popcount
and add per word pair, against 67 T/s, the card's rate outside the tensor
cores; K2 does none), computed from this run's inputs.

The data are unit-norm 1536-d vectors with an embedding-like spectrum,
made from ``--seed`` with numpy. Output: progress lines, then the card's
name and power limit, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

KERNEL_SHAPES = [(b, n, w) for b in (1, 7, 64, 1000) for n in (1, 511, 100003) for w in (1, 5, 48)]
JACCARD_TOL = 1e-6
LIMIT = 10
GATHER_SHAPES = [(d, n, cap) for d in (1, 3, 128, 1536) for n in (1, 1023, 1024, 100003) for cap in (1, 70001)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores


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


def phase_kernel(torch, hamming, device) -> float:
    gen = torch.Generator(device="cpu").manual_seed(1234)
    worst = 0.0
    for b, n, w in KERNEL_SHAPES:
        q = torch.randint(-2**31, 2**31 - 1, (b, w), generator=gen, dtype=torch.int64).to(torch.int32)
        x = torch.randint(-2**31, 2**31 - 1, (n, w), generator=gen, dtype=torch.int64).to(torch.int32)
        q[0] = 0  # a zero query row: jaccard's empty union against zero codes
        x[0] = 0
        q, x = q.to(device), x.to(device)
        for metric, tol in (("hamming", 0.0), ("jaccard", JACCARD_TOL)):
            got = hamming.pairwise_bit_distance_kernel(q, x, metric)
            torch.cuda.synchronize()
            want = hamming.pairwise_bit_distance_plain(q, x, metric)
            torch.cuda.synchronize()
            if got.shape != (b, n) or not torch.isfinite(got).all():
                raise AssertionError(f"K1 {metric} B={b} N={n} W={w}: bad output {tuple(got.shape)}")
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if err > tol:
                raise AssertionError(f"K1 {metric} B={b} N={n} W={w}: max |err| {err} > {tol}")
    log(f"[kernel] K1 == plain at {len(KERNEL_SHAPES)} shapes x 2 metrics "
        f"(hamming exact, jaccard <= {JACCARD_TOL}); max |err| {worst}")
    return worst


def phase_slice(torch, hamming, gather, device, seed: int):
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.vectorstore import bq_encode

    queries = bq.queries(seed, 10 + 64)
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_") as root:
        cfg = bq.slice_config(root)
        hamming.LAUNCHES = gather.LAUNCHES = 0  # counts from here on are the slice's
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
                               {"queries": [bq.search_body(q, LIMIT) for q in queries[10:]]})
            t_batch = time.perf_counter() - t1
            assert len(res["results"]) == 64
            for i, row in enumerate(res["results"]):
                check(queries[10 + i], row["points"], f"batch search {i}")
            launches = hamming.LAUNCHES
            if launches <= 0:
                raise AssertionError("K1 was never launched by the slice's searches")
            log(f"[slice] K2 launches during the slice: {gather.LAUNCHES} (no search path gathers through it)")
            p50 = float(np.median(lat)) * 1e3
            log(f"[slice] 10 single searches over HTTP: p50 {p50:.2f} ms (min {min(lat) * 1e3:.2f}, "
                f"max {max(lat) * 1e3:.2f}); batch of 64: {t_batch * 1e3:.2f} ms; "
                f"all {10 + 64} match numpy brute force by the tie rule")
            log(f"[slice] K1 launches during the slice: {launches}; "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            # The largest shard's own code table, for the timing phase
            largest = max(srv.shard_indices(), key=len)
            qcodes = bq_encode(torch.from_numpy(queries).to(device), largest.store.state.aux, bq.DIM)
            return {"launches": launches, "codes": largest.store.state.codes, "qcodes": qcodes}


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


def _device_ms(torch, fn, runs: int = 30):
    """Device time per call: the profiler's time of every kernel, copy and
    memset the calls ran on the card, over ``runs`` calls. Only device-side
    events count (a CPU op's device time repeats its kernels'). Raises if the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    )
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time; the kernel times cannot be measured")
    return total_us / 1e3 / runs


def phase_timing(torch, hamming, codes, qcodes) -> dict:
    """K1 and its plain version at the slice's shapes, on the largest
    shard's own code table. First both must agree on these operands; then
    the device time is what the card spends per call, and the call time adds
    the host's launch work, which bounds a single call of either at these
    sizes."""
    n, w = codes.shape
    out = {}
    for b in (1, 64):
        q = qcodes[:b].contiguous()
        err = 0.0
        for metric, tol in (("hamming", 0.0), ("jaccard", JACCARD_TOL)):
            got = hamming.pairwise_bit_distance_kernel(q, codes, metric)
            want = hamming.pairwise_bit_distance_plain(q, codes, metric)
            e = (got - want).abs().max().item()
            if not e <= tol:
                raise AssertionError(f"K1 {metric} on the shard's codes B={b} N={n} W={w}: max |err| {e} > {tol}")
            err = max(err, e)
        row = {}
        for name, fn in (("kernel", hamming.pairwise_bit_distance_kernel),
                         ("plain", hamming.pairwise_bit_distance_plain)):
            call = (lambda f: (lambda: f(q, codes, "hamming")))(fn)
            call_ms = _median_call_ms(torch, call)  # also warms the clocks
            row[name] = (_device_ms(torch, call), call_ms)
        moved = n * w * 4 + b * w * 4 + b * n * 4  # codes + queries in, distances out
        bound_ms, bound_by = _bound_ms(moved, 3 * b * n * w)  # xor, popcount, add per word pair
        (k_dev, k_call), (p_dev, p_call) = row["kernel"], row["plain"]
        log(f"[timing] K1 == plain on the shard's codes B={b} (hamming exact, jaccard <= {JACCARD_TOL}); "
            f"max |err| {err}")
        log(f"[timing] K1 hamming B={b} N={n} W={w}: kernel {k_dev:.4f} ms on the device "
            f"({moved / k_dev / 1e6:.1f} GB/s), {k_call:.4f} ms a call; plain {p_dev:.4f} ms on "
            f"the device, {p_call:.4f} ms a call (call: median of 30; device: mean of 30)")
        log(f"[timing] K1 B={b} bound {bound_ms:.6f} ms by {bound_by} (bytes {moved} at "
            f"{HBM_BYTES_PER_S:.3g} B/s: {moved / HBM_BYTES_PER_S * 1e3:.6f} ms); "
            f"kernel at {bound_ms / k_dev:.1%} of the bound")
        out[b] = {"ms": k_dev, "plain_ms": p_dev, "call_ms": k_call, "plain_call_ms": p_call,
                  "n": n, "w": w, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def _bound_ms(nbytes: int, ops: int):
    """The least time for the work: bytes over the memory rate or operations
    over the non-tensor peak, whichever is larger, and which one it was."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
    bound_ms, bound_by = _bound_ms(res["bound_bytes"], 0)
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
    times = phase_timing(torch, hamming, sl["codes"], sl["qcodes"])
    t64, t1 = times[64], times[1]
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
        "max_abs_err": max(worst, t64["max_abs_err"], t1["max_abs_err"]),
        "ms": t64["ms"],
        "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"],
        "bound_by": t64["bound_by"],
        "library_ms": None,
        "shape": f"hamming B=64 N={t64['n']} W={t64['w']}; device time per call",
        "call_ms": t64["call_ms"],
        "plain_call_ms": t64["plain_call_ms"],
        "ms_b1": t1["ms"],
        "plain_ms_b1": t1["plain_ms"],
        "bound_ms_b1": t1["bound_ms"],
        "bound_by_b1": t1["bound_by"],
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
