"""CPU tests of the port's benchmark: its files by name, its imports, the
reference, the window arithmetic, the trace reduction, the result line, and
that every planted fault makes ``correct`` false.

    python -m pytest portbench/tests -q

They run the engines' plain versions on the CPU at small sizes; what needs
the card is in ``test_card.py``.
"""

from __future__ import annotations

import ast
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import control, datagen, harness, readings, stats, trace
from portbench.drivers import search as search_driver
from portbench.reference import compare
from portbench.reference.exact_knn import Store, exact_knn
from portbench.run import FORBIDDEN

PKG = harness.PKG
SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
IVF_CELL = "mix1m-128-ivf.batch4096"
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py"))
SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be


def tiny(cell: str) -> dict:
    """Overrides that run ``cell`` in seconds on the CPU."""
    p = harness.plan(SPEC, cell)
    vamana = p["config"]["schema"]["type"] == "vectorVamana"
    n, dim = (500, 8) if vamana else (3000, 16)
    schema = copy.deepcopy(p["config"]["schema"])
    schema[schema["type"]]["vectorSize"] = dim
    return {"config": {"n_points": n, "dim": dim, "n_queries": 200, "schema": schema},
            "traffic": {"batch": 64, "outstanding": 4, "warmup_requests": 2, "judged_share": 0.5}}


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, PKG))
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


def test_forbidden_names_are_whole():
    """``semadb_tpu_torch`` passes and ``semadb_tpu`` fails: names are compared whole."""
    src = "import semadb_tpu_torch.index\nfrom semadb_tpu_torch import x\nimport semadb_tpu.ops\n"
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"portbench_imports_{os.getpid()}.py")
    with open(path, "w") as f:
        f.write(src)
    try:
        assert top_level_imports(path) & set(FORBIDDEN) == {"semadb_tpu"}
    finally:
        os.remove(path)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    p = harness.plan(SPEC, cell)
    cfg = next(c for c in SPEC["configs"] if c["name"] == p["cell"]["config"])
    assert os.path.isfile(os.path.join(harness.ROOT, cfg["file"]))
    assert p["config"]["name"] == cfg["name"] and p["config"]["source"] == cfg["source"]
    assert p["config"]["reduced"] == cfg["reduced"]
    assert os.path.isfile(os.path.join(PKG, "drivers", p["traffic"]["driver"] + ".py"))
    assert callable(harness.entry(p["config"]).make) and callable(harness.entry(p["config"]).load)
    assert os.path.isfile(os.path.join(PKG, p["config"]["reference"]))
    for m in p["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert {m["name"] for m in p["end_to_end"]} > {"setup_s"} and p["per_layer"]
    assert p["limits"] and all(v["better"] in ("lower", "higher") for v in p["limits"].values())


def test_reference_agrees_with_numpy_topk():
    mix = datagen.Mixture(SEED, 12, 2000, {"latent": 6, "cluster_size": 50, "spread": 0.5, "ambient": 0.25},
                          "euclidean", "cpu")
    store = Store(mix, 2000, 2)
    q = mix.rows(datagen.QUERIES, 0, 50)
    ids, d = exact_knn(store, q, 10)
    x = store.table.double().numpy()
    live = np.zeros(len(x), bool)
    live[2:2002] = True
    assert np.array_equal(store.live.numpy(), live)
    assert np.array_equal(x[2:], mix.rows(datagen.CORPUS, 0, 2000).double().numpy())
    full = ((q.double().numpy()[:, None, :] - x[None]) ** 2).sum(-1)
    full[:, ~live] = np.inf
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(ids.numpy(), want)
    assert np.allclose(d.numpy(), np.take_along_axis(full, want, 1), rtol=1e-12)


def test_rows_are_fixed_by_seed_stream_and_index():
    gen = {"latent": 8, "cluster_size": 10, "spread": 0.5, "ambient": 0.25}
    a = datagen.Mixture(SEED, 16, 500, gen, "euclidean", "cpu")
    b = datagen.Mixture(SEED, 16, 500, gen, "euclidean", "cpu")
    whole = a.rows(datagen.QUERIES, 0, datagen.BLOCK + 10)
    assert torch.equal(whole[datagen.BLOCK - 5 :], b.rows(datagen.QUERIES, datagen.BLOCK - 5, 15))
    assert not torch.equal(a.rows(datagen.CORPUS, 0, 5), a.rows(datagen.QUERIES, 0, 5))
    c = datagen.Mixture(SEED + 1, 16, 500, gen, "euclidean", "cpu")
    assert not torch.equal(a.rows(datagen.CORPUS, 0, 5), c.rows(datagen.CORPUS, 0, 5))


def test_p95_is_over_every_sample_with_a_stall():
    lat = [0.010] * 940 + [0.500] * 60  # a stall holds 6% of the requests
    assert stats.p95(lat) == 0.500
    assert stats.p95([0.010] * 950 + [0.500] * 50) == 0.010
    assert stats.median([3.0, 1.0, 2.0]) == 2.0
    with pytest.raises(ValueError):
        stats.p95([])


class _StallingEngine:
    """Answers at once, except that one request stalls the device for
    ``stall`` seconds."""

    def __init__(self, stall: float):
        self.calls, self.stall = 0, stall

    def search_batch_async(self, q, k):
        self.calls += 1
        if self.calls == 3:
            time.sleep(self.stall)
        return torch.zeros((len(q), k)), torch.zeros((len(q), k), dtype=torch.int32)


def test_rate_and_tail_are_over_the_whole_window():
    from types import SimpleNamespace

    run = SimpleNamespace(engine=_StallingEngine(0.3), traffic={"batch": 4, "k": 2, "outstanding": 2,
                                                                 "judged_share": 1.0},
                          n_queries=10, qtile=np.zeros((14, 3), np.float32), next_request=0, spans={}, seed=SEED)
    w = search_driver.window(run, 0.5)
    n = w["attempted"]
    assert w["window_s"] >= 0.5 and n == len(run.answers)
    assert w["metrics"]["search_qps"] == pytest.approx(n * 4 / w["window_s"])
    assert w["window_s"] > 0.3  # the stall is inside the window's time
    assert run.answers[0][0] == 0 and run.answers[1][0] == 4 and run.answers[3][0] == 2  # wraps round the set


def test_trace_union_gaps_and_breakdown():
    t = trace.Trace.__new__(trace.Trace)
    t.window_s = 1.0
    t.dev_names = ["k_a", "k_b", "k_a", "Memcpy DtoH"]  # the span mirrors are dropped when the trace is read
    t.dev_start = np.array([0.1, 0.15, 0.5, 0.8])
    t.dev_end = np.array([0.2, 0.3, 0.6, 0.85])
    t.host = [("outer", 0.0, 1.0), ("aten::topk", 0.35, 0.45), ("portbench.readback", 0.6, 0.79)]
    t.busy_s, t.gaps = t._union()
    assert t.busy_s == pytest.approx(0.2 + 0.1 + 0.05)
    assert [tuple(round(x, 6) for x in g) for g in t.gaps] == [(0.0, 0.1), (0.3, 0.5), (0.6, 0.8), (0.85, 1.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.2)]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle["aten::topk"] == pytest.approx(0.2) and idle["portbench.readback"] == pytest.approx(0.2)
    assert idle["outer"] == pytest.approx(0.25)
    from types import SimpleNamespace

    assert harness.reader("device_idle_pct.search")(SimpleNamespace(trace=t)) == pytest.approx(65.0)


def test_judged_sample_is_drawn_from_the_seed():
    from types import SimpleNamespace

    def sample(seed):
        run = SimpleNamespace(engine=_StallingEngine(0.0), traffic={"batch": 4, "k": 2, "outstanding": 2,
                                                                     "judged_share": 0.25},
                              n_queries=10, qtile=np.zeros((14, 3), np.float32), next_request=0, spans={}, seed=seed)
        w = search_driver.window(run, 0.2)
        return w["attempted"], [a[0] for a in run.answers]

    n, offs = sample(SEED)
    assert 0 < len(offs) < n
    assert all(math.isnan(v) for v in compare.judge_answers(None, None, [], 10).values())


def test_judge_holds_each_number_to_its_limit():
    limits = {"recall_min": {"limit": 0.99, "better": "higher"}, "bad_ids": {"limit": 0, "better": "lower"}}
    assert compare.judge({"recall_min": 0.995, "bad_ids": 0.0}, limits)[0]
    assert not compare.judge({"recall_min": 0.98, "bad_ids": 0.0}, limits)[0]
    assert not compare.judge({"recall_min": float("nan"), "bad_ids": 0.0}, limits)[0]
    assert not compare.judge({"bad_ids": 0.0}, limits)[0]


def test_result_line_has_the_contract_keys():
    cell = IVF_CELL
    out = harness.run_cell(cell, SEED, 0.5, False, "cpu", spec=SPEC, overrides=tiny(cell))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "search_qps"}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(out)


def test_run_refuses_without_cuda_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and proc.stdout == "" and "CUDA" in proc.stderr


def test_run_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    cannot run a cell."""
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench import harness; "
            "harness.run_cell(sys.argv[1], 1, 0.5, False, 'cpu')")
    proc = subprocess.run([sys.executable, "-c", code, CELLS[0]], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "semadb_tpu_torch" in proc.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_and_every_fault_is_caught(cell):
    ov = tiny(cell)
    assert readings.one(cell, SEED, 0.5, "program", "cpu", ov, SPEC)["correct"] is True
    for fault in readings.FAULTS:
        got = readings.one(cell, SEED, 0.5, fault, "cpu", ov, SPEC)
        failed = [k for k, c in got["checks"].items()
                  if not (c["value"] <= c["limit"] if c["must_be"] == "at_most" else c["value"] >= c["limit"])]
        assert got["correct"] is False and failed, (fault, got["checks"])


def test_control_engine_answers_exactly_on_the_cpu():
    """On the CPU there is no TF32: the control is the exact search, which
    the comparison passes; on the card it runs in TF32 (``test_card.py``)."""
    assert readings.one(IVF_CELL, SEED, 0.5, "control", "cpu", tiny(IVF_CELL))["correct"] is True


def test_program_paths_below_float32_switch_on_and_back():
    from semadb_tpu_torch.index import ivf

    keep_slabs, keep_tf32 = ivf.SLAB_BF16_BYTES, torch.backends.cuda.matmul.allow_tf32
    with control.bf16_slabs(), control.tf32_matmuls():
        assert ivf.SLAB_BF16_BYTES == 0 and torch.backends.cuda.matmul.allow_tf32
    assert ivf.SLAB_BF16_BYTES == keep_slabs and torch.backends.cuda.matmul.allow_tf32 == keep_tf32


@pytest.mark.parametrize("schema", [
    {"type": "vectorFlat", "vectorFlat": {"vectorSize": 8, "distanceMetric": "euclidean"}},
    {"type": "vectorIVF", "vectorIVF": {"vectorSize": 8, "distanceMetric": "euclidean"}},
    {"type": "vectorVamana", "vectorVamana": {"vectorSize": 8, "distanceMetric": "euclidean", "searchSize": 75,
                                              "degreeBound": 64, "alpha": 1.2}},
], ids=lambda s: s["type"])
def test_index_entry_makes_each_vector_type_by_the_ports_table(schema):
    from semadb_tpu_torch.index import manager

    engine = manager._ENGINES[schema["type"]][1]
    got = harness.entry({"entry": "index"}).make(schema, "cpu")
    assert isinstance(got, engine)


def test_index_entry_refuses_a_type_without_an_engine():
    with pytest.raises(ValueError):
        harness.entry({"entry": "index"}).make({"type": "text", "text": {"analyser": "standard"}}, "cpu")
