"""One run of one cell: set-up, the measured window, the per-layer readers,
and the comparison with the plain reference that decides ``correct``.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``, which names the entry in
``entries/`` that makes and loads the system under test), its traffic mix
(``traffic/<mix>.json``, which names its driver in ``drivers/``), its limits
(``limits/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``). The driver runs the traffic and judges what the
system answered against the plain reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from portbench import datagen, trace
from portbench.reference import compare

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FIRST_ID = 2  # the corpus' first node id (the engines reserve 0 and 1)
# The port's kernel launch counters read beside the trace (module, kernel name)
LAUNCH_COUNTERS = (("ivf_rerank", "rerank_kernel"), ("vamana_search", "vamana_beam_search_kernel"),
                   ("vamana_prune", "vamana_robust_prune_kernel"))


def log(msg: str) -> None:
    print(f"# portbench {msg}", file=sys.stderr, flush=True)


def _json(*parts: str) -> dict:
    with open(os.path.join(PKG, *parts)) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def plan(spec: dict, name: str) -> dict:
    """The files and metrics of cell ``name``."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    e2e = [m for m in spec["end_to_end"] if m["name"] == "setup_s" or name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"cell": cell, "config": _json("configs", cell["config"] + ".json"),
            "traffic": _json("traffic", cell["traffic"] + ".json"), "limits": _json("limits", name + ".json"),
            "end_to_end": e2e, "per_layer": layer}


def entry(config: dict):
    """The module that makes and loads a configuration's system under test."""
    return importlib.import_module("portbench.entries." + config["entry"])


def reader(metric: str) -> Callable:
    path = os.path.join(PKG, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _launches() -> dict:
    out = {}
    for mod, kernel in LAUNCH_COUNTERS:
        m = sys.modules.get("semadb_tpu_torch.ops.kernels." + mod)
        out[kernel] = getattr(m, "LAUNCHES", 0)
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda", t_origin: Optional[float] = None,
             spec: Optional[dict] = None, overrides: Optional[dict] = None,
             make_engine: Optional[Callable] = None) -> dict:
    """The run's result line (a dict). ``overrides`` replaces keys of the
    configuration and the traffic (``{"config": {...}, "traffic": {...}}``,
    for tests at small sizes); ``make_engine(schema, device)`` replaces the
    entry's ``make`` (the control and the planted faults)."""
    t_origin = time.perf_counter() if t_origin is None else t_origin
    p = plan(spec or load_spec(), name)
    overrides = overrides or {}
    cfg = {**p["config"], **overrides.get("config", {})}
    tr = {**p["traffic"], **overrides.get("traffic", {})}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    system = entry(cfg)
    driver = importlib.import_module("portbench.drivers." + tr["driver"])
    run = SimpleNamespace(config=cfg, traffic=tr, seed=seed, first_id=FIRST_ID, spans={}, trace=None)
    split = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    import semadb_tpu_torch.utils.build as port_build  # the port's compile seconds (set-up split)

    split["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    run.mix = datagen.Mixture(cfg["generator"]["data_seed"], cfg["dim"], cfg["n_points"], cfg["generator"], cfg["metric"], dev)
    corpus = run.mix.rows(datagen.CORPUS, 0, cfg["n_points"])
    sync()
    split["data_s"] = time.perf_counter() - t
    run.engine = (make_engine or system.make)(cfg["schema"], dev)
    build = system.load(run.engine, corpus, FIRST_ID)
    del corpus
    split["build_s"] = build["build_s"]
    t = time.perf_counter()
    driver.prepare(run)
    sync()
    split["warmup_s"] = time.perf_counter() - t
    split["compile_s"] = port_build.BUILD_SECONDS
    setup_s = time.perf_counter() - t_origin
    log(f"setup {setup_s:.3f} s: {json.dumps(split)}; build split {json.dumps(build['split'])}")

    before = _launches()
    with trace.profiled(traced) as holder:
        w = driver.window(run, seconds)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window {w['window_s']:.3f} s, {w['attempted']} attempted; device memory peak {peak} B; "
        f"{json.dumps(w.get('diag', {}))}")
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": p["cell"]["chips"], "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if traced:
        run.trace = trace.read(holder)
        counted = {k: v - before[k] for k, v in _launches().items()}
        events = {k: sum(1 for n in run.trace.dev_names if k in n) for k in counted}
        log(f"trace read in {run.trace.read_s:.3f} s; {len(run.trace.dev_names)} device events; launches "
            f"counted by the program {counted}, their events in the trace {events}, lost "
            f"{ {k: max(counted[k] - events[k], 0) for k in counted} }")
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = run.trace.breakdown()
        for m in p["per_layer"]:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in p["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else w["metrics"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.engine = None
    run.trace = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = driver.judge(run)
    correct, checks = compare.judge(numbers, p["limits"])
    log(f"reference and comparison {time.perf_counter() - t:.3f} s")
    out = {"correct": bool(correct), "attempted": int(w["attempted"]), "failed": int(w["failed"]),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                 "must_be": "at_most" if c["better"] == "lower" else "at_least"} for c in checks}
    return out
