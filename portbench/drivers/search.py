"""Batched searches in a closed loop.

The traffic file gives ``batch`` (queries a request), ``outstanding``
(requests in flight: a new one is sent when the oldest has its results on
the host), ``k`` and ``warmup_requests``. The configuration's query set is
put in an order drawn from ``--seed``, and request j takes ``batch`` queries
of it in turn, from (j · batch) mod Q on, wrapping round: every seed sends
the same queries, in another order. A request's latency runs from its
submission to its ids and distances on the host; the window ends when the
last request sent before ``--seconds`` ran out has its results.

Every answer is read back to the host; a sample of the requests, each with
the chance ``judged_share`` drawn from ``--seed``, is kept for the
comparison, and the rest are dropped as a client drops a reply it has
served, so that the host's memory stays level through the window.
"""

from __future__ import annotations

import resource
import time
from collections import deque

import numpy as np

from portbench import datagen, stats
from portbench.reference import compare
from portbench.reference.exact_knn import Store
from portbench.trace import WINDOW, span

RATE_STEP_S = 5.0  # the window's rate is also logged in steps of this many seconds


def prepare(run) -> None:
    cfg, tr = run.config, run.traffic
    q = run.mix.rows(datagen.QUERIES, 0, cfg["n_queries"]).cpu().numpy()
    run.n_queries = len(q)
    run.perm = np.random.default_rng([run.seed % 2**63, 1]).permutation(len(q))
    q = q[run.perm]
    run.qtile = np.resize(q, (len(q) + tr["batch"], q.shape[1]))  # a request is one contiguous view
    run.next_request = 0
    _loop(run, count=tr["warmup_requests"])


def _loop(run, seconds: float = 0.0, count: int = 0, judged=None) -> dict:
    """Requests in a closed loop, ``count`` of them or as many as start
    within ``seconds``; the answers of those that ``judged()`` picks at
    their submission are kept."""
    tr, eng = run.traffic, run.engine
    B, k, depth, Q = tr["batch"], tr["k"], tr["outstanding"], run.n_queries
    pending, lat, enq, answers, done = deque(), [], [], [], []
    sent = 0
    t_start = last = time.perf_counter()
    deadline = t_start + seconds
    while True:
        while len(pending) < depth and (sent < count if count else time.perf_counter() < deadline):
            off = (run.next_request * B) % Q
            run.next_request += 1
            t0 = time.perf_counter()
            with span("portbench.submit"):
                handle = eng.search_batch_async(run.qtile[off : off + B], k)
            enq.append(time.perf_counter() - t0)
            pending.append((off, t0, handle, judged is not None and judged()))
            sent += 1
        if not pending:
            break
        off, t0, (d, i), keep = pending.popleft()
        with span("portbench.readback"):
            d, i = d.cpu().numpy(), i.cpu().numpy()
        last = time.perf_counter()
        lat.append(last - t0)
        done.append(last - t_start)
        if keep:
            answers.append((off, i, d))
    return {"window_s": last - t_start, "latencies": lat, "enqueue": enq, "answers": answers, "requests": sent,
            "done": done}


def window(run, seconds: float) -> dict:
    draw = np.random.default_rng([run.seed % 2**63, 2])
    share = run.traffic["judged_share"]
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    with span(WINDOW):
        w = _loop(run, seconds=seconds, judged=lambda: draw.random() < share)
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    run.answers = w["answers"]
    run.spans["enqueue"] = w["enqueue"]
    run.spans["latency"] = w["latencies"]
    B = run.traffic["batch"]
    diag = {"latency_ms_p50": stats.median(w["latencies"]) * 1e3, "latency_ms_p95": stats.p95(w["latencies"]) * 1e3,
            "latency_ms_max": max(w["latencies"]) * 1e3,
            "enqueue_ms_p50": stats.median(w["enqueue"]) * 1e3,
            "judged_requests": len(w["answers"]),
            "host_cpu_s": r1.ru_utime + r1.ru_stime - r0.ru_utime - r0.ru_stime,
            "minor_faults": r1.ru_minflt - r0.ru_minflt, "ctx_switches_forced": r1.ru_nivcsw - r0.ru_nivcsw,
            "qps_by_5s": [B * n / RATE_STEP_S for n in np.bincount((np.asarray(w["done"]) // RATE_STEP_S).astype(int))]}
    return {
        "window_s": w["window_s"], "attempted": w["requests"], "failed": 0, "diag": diag,
        "metrics": {"search_qps": w["requests"] * B / w["window_s"]},
    }


def judge(run) -> dict:
    """The window's answers against exact search over the corpus."""
    B, Q = run.traffic["batch"], run.n_queries
    store = Store(run.mix, run.config["n_points"], run.first_id)
    queries = run.mix.rows(datagen.QUERIES, 0, Q)
    answers = [(run.perm[(off + np.arange(B)) % Q], i, d) for off, i, d in run.answers]
    run.answers = None
    return compare.judge_answers(store, queries, answers, run.traffic["k"])

