"""The 1536-d cosine cell of the port's benchmark on the CPU: its float64
angular reference, the port's projected IVF against it, the cell end to end
at a reduced size with its planted faults, the engine's projection counter
and the two metrics that read the cell's trace.

The cell (``mix1m-1536-ivf.batch4096-angular`` in ``BENCHMARK.json``) runs
``vectorIVF`` above ``PROJ_DIM``, so every search projects its queries onto
the corpus' principal directions; these tests keep D = 1536 or another width
above 128 for that reason. The engines run their plain versions here; the
control's TF32 and the traced window exist only on the card
(``portbench/tests/test_card_angular.py``).

Tolerances:
- the reference against numpy: relative 1e-12, two float64 sums of the
  same products in another order;
- returned distances against the float64 reference: 2e-5 absolute. A
  float32 dot product of two unit rows over D = 1536 terms carries a
  rounding error of about sqrt(D) · 2^-24 ≈ 2.3e-6 and at most
  D · 2^-24 ≈ 9.2e-5; the TF32 control's widest error on the card is
  about 3.8e-5 (6.3e-5 of a 10th-neighbour distance near 0.6, ``PERF.md``).
"""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import bytecount, control_angular, datagen, harness, k4bytes, readings
from portbench.drivers import search_angular
from portbench.reference import exact_angular
from portbench.reference.exact_knn import Store
from portbench.run import FORBIDDEN
from portbench.tests.test_portbench import top_level_imports
from semadb_tpu_torch.index import ivf
from semadb_tpu_torch.models.schema import VectorIVFParams

CELL = "mix1m-1536-ivf.batch4096-angular"
SPEC = harness.load_spec()
SEED = 2**31 + 2345  # past 32 signed bits, as a run's seed may be
GEN = {"latent": 64, "cluster_size": 100, "spread": 0.5, "ambient": 0.25}
DIST_ATOL = 2e-5
NEW_FILES = ("reference/exact_angular.py", "drivers/search_angular.py", "control_angular.py", "k4bytes.py",
             "metrics/ivf_project_ms.py", "metrics/k4_rerank_roofline.py")


def small(dim: int = 1536, n: int = 3000) -> dict:
    """Overrides that run the cell in seconds on the CPU, above PROJ_DIM."""
    schema = copy.deepcopy(harness.plan(SPEC, CELL)["config"]["schema"])
    schema["vectorIVF"]["vectorSize"] = dim
    return {"config": {"n_points": n, "dim": dim, "n_queries": 200, "schema": schema},
            "traffic": {"batch": 64, "outstanding": 4, "warmup_requests": 2, "judged_share": 1.0}}


def _index(dim: int, n: int, seed: int = SEED):
    """A fitted cosine IndexIVF over ``n`` unit rows of the mixture, and the mixture."""
    mix = datagen.Mixture(seed, dim, n, GEN, "cosine", "cpu")
    eng = ivf.IndexIVF(VectorIVFParams.from_dict({"vectorSize": dim, "distanceMetric": "cosine",
                                                  "assignCopies": 2}), torch.device("cpu"))
    eng.insert_bulk(np.arange(2, n + 2, dtype=np.int64), mix.rows(datagen.CORPUS, 0, n), defer_fit=True)
    eng.flush_pending()
    return eng, mix


@pytest.fixture(scope="module")
def projected():
    return _index(1536, 4000)


def test_exact_angular_agrees_with_numpy_cosine_topk():
    mix = datagen.Mixture(SEED, 24, 2000, {**GEN, "latent": 8, "cluster_size": 50}, "cosine", "cpu")
    store = Store(mix, 2000, 2)
    q = mix.rows(datagen.QUERIES, 0, 50)
    ids, d = exact_angular.exact_knn(store, q, 10)
    x = store.table.double().numpy()
    assert np.allclose(np.linalg.norm(x[2:], axis=1), 1.0, atol=1e-6)  # the mixture unit-norms under cosine
    full = 1.0 - q.double().numpy() @ x.T
    full[:, :2] = np.inf  # ids below first_id hold no row
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(ids.numpy(), want)
    assert np.allclose(d.numpy(), np.take_along_axis(full, want, 1), rtol=1e-12)
    pair = exact_angular.pair_distances(store, q, torch.arange(50), torch.from_numpy(want))
    assert np.allclose(pair.numpy(), np.take_along_axis(full, want, 1), rtol=1e-12)


def test_judge_answers_reads_the_three_numbers_under_cosine():
    mix = datagen.Mixture(SEED, 24, 1000, {**GEN, "latent": 8, "cluster_size": 50}, "cosine", "cpu")
    store = Store(mix, 1000, 2)
    q = mix.rows(datagen.QUERIES, 0, 40)
    ids, d = exact_angular.exact_knn(store, q, 10)
    rows = np.arange(40)
    exact = [(rows, ids.numpy().astype(np.int32), d.numpy().astype(np.float32))]
    got = exact_angular.judge_answers(store, q, exact, 10)
    assert got["recall_min"] == 1.0 and got["bad_ids"] == 0.0 and got["dist_err_max"] < 1e-7
    scale = float(d[:, 9].median())
    off = exact[0][2].copy()
    off[3, 4] += 1e-3
    assert exact_angular.judge_answers(store, q, [(rows, exact[0][1], off)], 10)["dist_err_max"] == \
        pytest.approx(1e-3 / scale, rel=1e-3)
    half = exact[0][1].copy()
    half[20:] = -1
    assert exact_angular.judge_answers(store, q, [(rows, half, exact[0][2])], 10)["recall_min"] == 0.5
    rep = exact[0][1].copy()
    rep[0, 0] = rep[0, -1]
    assert exact_angular.judge_answers(store, q, [(rows, rep, exact[0][2])], 10)["bad_ids"] == 1.0


def test_projected_ivf_holds_recall_and_distances(projected):
    """IndexIVF at D = 1536 over seeded unit rows (so it traverses the
    projection): recall@10 at the cell's 0.99, distances within DIST_ATOL
    of the float64 reference, and no bad or repeated id."""
    eng, mix = projected
    assert eng._proj is not None and eng._proj.shape == (1536, ivf.PROJ_DIM)
    q = mix.rows(datagen.QUERIES, 0, 256)
    d, i = eng.search_batch(q.numpy(), 10)
    store = Store(mix, 4000, 2)
    truth, _ = exact_angular.exact_knn(store, q, 10)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, truth.numpy())])
    assert recall >= 0.99
    ids = torch.from_numpy(i.astype(np.int64))
    assert bool((ids >= 2).all() & (ids < 4002).all())
    assert all(len(set(row)) == 10 for row in i)
    ref = exact_angular.pair_distances(store, q, torch.arange(256), ids)
    assert float((torch.from_numpy(d).double() - ref).abs().max()) <= DIST_ATOL


@pytest.mark.parametrize("kind", ["program", "half_left_out", "altered", "control"])
def test_angular_cell_end_to_end_on_the_cpu(kind):
    """The cell through ``harness.run_cell`` at 3,000 x 1,536: the program is
    correct and projects; each planted fault is caught; the control, exact
    on the CPU (no TF32), is correct here."""
    ov = small()
    before = dict(ivf.PROJECTIONS)
    if kind == "control":
        got = control_angular.one(CELL, SEED, 0.5, "cpu", ov, SPEC)
    else:
        got = readings.one(CELL, SEED, 0.5, kind, "cpu", ov, SPEC)
    held = {name: (c["value"] <= c["limit"] if c["must_be"] == "at_most" else c["value"] >= c["limit"])
            for name, c in got["checks"].items()}
    assert set(held) == {"recall_min", "dist_err_max", "bad_ids"}
    if kind in readings.FAULTS:
        assert got["correct"] is False and not all(held.values()), got["checks"]
    else:
        assert got["correct"] is True and all(held.values()), got["checks"]
    projected = ivf.PROJECTIONS["calls"] - before["calls"]
    assert projected == (0 if kind == "control" else got["attempted"] + 2)  # the window's and the warm-up's


def test_projection_counter_counts_projected_searches_only():
    eng, mix = _index(160, 600)
    q = mix.rows(datagen.QUERIES, 0, 37).numpy()
    before = dict(ivf.PROJECTIONS)
    eng.search_batch(q, 5)
    assert ivf.PROJECTIONS == {"calls": before["calls"] + 1, "rows": before["rows"] + 37}
    flat, mix128 = _index(128, 600)
    assert flat._proj is None
    before = dict(ivf.PROJECTIONS)
    flat.search_batch(mix128.rows(datagen.QUERIES, 0, 37).numpy(), 5)
    assert ivf.PROJECTIONS == before


class _Answers:
    """An engine that answers at once and projects nothing."""

    def search_batch_async(self, q, k):
        return torch.zeros((len(q), k)), torch.zeros((len(q), k), dtype=torch.int32)


def _loop_run(engine, dim: int, B: int = 8) -> SimpleNamespace:
    qtile = datagen.Mixture(SEED, dim, 600, GEN, "cosine", "cpu").rows(datagen.QUERIES, 0, 40 + B).numpy()
    return SimpleNamespace(engine=engine, traffic={"batch": B, "k": 5, "outstanding": 2, "judged_share": 0.0},
                           n_queries=40, qtile=qtile, next_request=0, spans={}, seed=SEED)


def test_driver_records_the_windows_projections(monkeypatch):
    eng, _ = _index(160, 600)
    run = _loop_run(eng, 160)
    w = search_angular.window(run, 0.2)
    assert run.spans["projections"] == {"calls": w["attempted"], "rows": w["attempted"] * 8}
    # a program without the counter (the parent commit's): nothing recorded, the metric silent
    monkeypatch.delattr(ivf, "PROJECTIONS")
    run = _loop_run(_Answers(), 160)
    search_angular.window(run, 0.1)
    assert "projections" not in run.spans
    assert harness.reader("ivf_project_ms")(SimpleNamespace(trace=object(), spans=run.spans)) is None


def _fake_trace(events):
    """A traced window holding ``events``: (name, start s, end s)."""
    return SimpleNamespace(dev_names=[e[0] for e in events], dev_start=np.array([e[1] for e in events]),
                           dev_end=np.array([e[2] for e in events]))


# The projection's kernels as the H100's profiler names them (a split-K product and its reduction)
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel"
SPLIT_K = GEMM.replace("execute_kernel", "execute_split_k_kernel")
K4 = "void (anonymous namespace)::rerank_kernel<true>(float const*, float const*, int const*, float const*)"


def test_ivf_project_ms_reads_the_projections_kernels():
    """Every kernel of the projection's product, once a counted projection."""
    read = harness.reader("ivf_project_ms")
    spans = {"projections": {"calls": 2, "rows": 8192}}
    trace = _fake_trace([(GEMM, 0.0, 1e-4), (SPLIT_K, 1e-4, 1.2e-4), (K4, 2e-4, 2e-3), (GEMM, 3e-3, 3.2e-3),
                         (SPLIT_K, 3.2e-3, 3.24e-3), ("ivf_scan_score", 4e-3, 5e-3)])
    assert read(SimpleNamespace(trace=trace, spans=spans)) == pytest.approx(0.18)
    one = _fake_trace([(GEMM, 0.0, 1e-4), (GEMM, 3e-3, 3.2e-3)])
    assert read(SimpleNamespace(trace=one, spans=spans)) == pytest.approx(0.15)
    # another product in the window, or a projection whose kernels the trace lost: silent
    extra = _fake_trace([(GEMM, 0.0, 1e-4), (GEMM, 3e-3, 3.2e-3), (SPLIT_K, 3.2e-3, 3.24e-3)])
    assert read(SimpleNamespace(trace=extra, spans=spans)) is None
    assert read(SimpleNamespace(trace=one, spans={"projections": {"calls": 3, "rows": 12288}})) is None
    assert read(SimpleNamespace(trace=one, spans={"projections": {"calls": 0, "rows": 0}})) is None
    assert read(SimpleNamespace(trace=None, spans=spans)) is None
    assert read(SimpleNamespace(trace=one, spans={})) is None


def test_k4_bytes_counts_each_distinct_live_row_once():
    vectors = torch.zeros((10, 6))
    queries = torch.zeros((2, 6))
    pool = torch.tensor([[3, 3, 5, -1], [5, 7, 12, 8]], dtype=torch.int32)  # 12 is out of range
    coarse = torch.tensor([[0.1, 0.2, 0.3, float("inf")], [0.1, 0.2, 0.3, float("inf")]])
    # distinct live rows 3, 5, 7 (8's coarse score is not finite)
    want = 3 * 6 * 4 + pool.numel() * 8 + 2 * 6 * 4 + 2 * 4 * 8
    assert k4bytes.k4_bytes(vectors, queries, pool, coarse, 4, "cosine", True) == want


def test_k4_rerank_roofline_is_the_bound_over_the_device_time(projected):
    eng, mix = projected
    B, k = 64, 10
    qtile = mix.rows(datagen.QUERIES, 0, 200 + B).numpy()
    nbytes = []
    for off in (0, B):
        keep = {}
        eng.search_batch_async(qtile[off : off + B], k, keep=keep)
        nbytes.append(k4bytes.k4_bytes(*keep["k4"]))
    bound = bytecount.bound_s(float(np.mean(nbytes)))
    trace = _fake_trace([(K4, 0.0, 2 * bound), (GEMM, 1.0, 1.1), (K4, 2.0, 2.0 + 2 * bound)])
    run = SimpleNamespace(trace=trace, engine=eng, traffic={"batch": B, "k": k}, n_queries=200, qtile=qtile)
    assert harness.reader("k4_rerank_roofline")(run) == pytest.approx(50.0)
    run.trace = _fake_trace([(GEMM, 1.0, 1.1)])
    assert harness.reader("k4_rerank_roofline")(run) is None


def test_the_cells_new_files_import_no_forbidden_module():
    for rel in NEW_FILES:
        assert not top_level_imports(os.path.join(harness.PKG, rel)) & set(FORBIDDEN), rel
