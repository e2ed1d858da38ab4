"""The port's ``bench`` (``python -m semadb_tpu_torch.bench``) against the
JAX package's root ``bench.py``, which runs unchanged in a subprocess on the
CPU; the port's mode runs here on ``cpu`` at the same sizes and seeds
(4,000 x 32, 256 queries in batches of 128).

- every mode: the same ``metric`` name, every JAX key present;
- ``filtered``: the filter subsets equal those ``bench.py`` drew (recorded
  from its searches), recall@10 >= 0.999 at both selectivities in both
  packages;
- ``hybrid`` and ``http``: recall@10 within 0.01 and 0.02 of the JAX run's,
  every HTTP distance exact;
- ``text``: the corpus and the queries equal ``bench.py``'s (recorded from
  its shard), and the port's ``Shard`` returns the same ids for every query,
  scores within 1e-5 relative;
- the dispatch: every annbench mode and ``fused`` by ``BENCH_MODE``, with
  ``bench.py``'s metric name and keys, ``BENCH_ADVERSARIAL``'s ``_adv``, and
  ``--device cuda`` refused without CUDA; ``annbench --adversarial``.
"""

import json

import numpy as np
import pytest
import torch

from jax_bench_run import port_settings, run_jax_mode
from semadb_tpu_torch import bench
from semadb_tpu_torch.tools import annbench

CPU = torch.device("cpu")
SMALL = {"BENCH_N": "3000", "BENCH_DIM": "16", "BENCH_QUERIES": "96", "BENCH_QUERY_BATCH": "32"}
# The dispatch cases build a Vamana graph on the CPU: a few hundred points keep them to seconds
TINY = {"BENCH_N": "600", "BENCH_DIM": "8", "BENCH_QUERIES": "32", "BENCH_QUERY_BATCH": "16"}
# bench.py:1252-1271, the annbench modes' keys (without the sweep's)
ANN_KEYS = {"metric", "value", "unit", "vs_baseline", "recall@10", "recall_eps@10", "build_s", "build_compile_s",
            "build_exec_s", "qps_spread", "n", "query_batch", "gt_queries", "margin_d10_over_drand", "platform"}
# bench.py:382-398
FUSED_KEYS = {"metric", "value", "unit", "vs_baseline", "recall@10", "build_s", "n", "query_batch", "gt_queries",
              "platform"}


def _same_shape(jax_out: dict, port_out: dict) -> None:
    assert port_out["metric"] == jax_out["metric"]
    assert set(jax_out) <= set(port_out), sorted(set(jax_out) - set(port_out))


RECORD_MASKS = """
import numpy as np
import semadb_tpu.index.ivf as _ivf
_masks = []
_search = _ivf.IndexIVF.search_batch_async
def _recording(self, queries, k, num_probes=0, filter_mask=None, *a, **kw):
    if filter_mask is not None:
        rows = np.nonzero(np.asarray(filter_mask))[0]
        if not any(np.array_equal(rows, m) for m in _masks):
            _masks.append(rows)
    return _search(self, queries, k, num_probes, filter_mask, *a, **kw)
_ivf.IndexIVF.search_batch_async = _recording
"""


def test_filtered_matches_the_jax_mode(tmp_path):
    out = tmp_path / "masks.npz"
    want = run_jax_mode("filtered", prelude=RECORD_MASKS,
                        epilogue=f"np.savez({str(out)!r}, *_masks)")
    keep: dict = {}
    s = port_settings("filtered")
    got = bench.run_filtered(s["n"], s["dim"], s["n_queries"], CPU, batch=s["batch"], sels=s["sels"], keep=keep)
    _same_shape(want, got)
    masks = np.load(out)
    jax_rows = [masks[f"arr_{i}"] for i in range(len(masks.files))]
    assert len(jax_rows) == 2
    for sel, rows in zip(s["sels"], jax_rows):
        assert np.array_equal(np.nonzero(keep["members"][sel])[0] + 2, rows), sel  # node id = row + 2
    for out_ in (want, got):
        assert out_["recall@10"] >= 0.999 and out_["selective"]["recall@10"] >= 0.999
    assert {r["path"] for r in got["by_selectivity"].values()} == {"exact member scan"}


def test_filtered_past_the_exact_cap_widens_the_probes(monkeypatch):
    from semadb_tpu_torch.index import ivf

    monkeypatch.setattr(ivf, "FILTER_EXACT_CAP", 100)
    got = bench.run_filtered(4000, 32, 256, CPU, batch=128, sels=(0.9, 0.005))
    rows = got["by_selectivity"]
    assert rows["sel_0.9"]["path"] == "widened probes" and rows["sel_0.005"]["path"] == "exact member scan"
    assert rows["sel_0.9"]["recall@10"] >= 0.95 and rows["sel_0.005"]["recall@10"] >= 0.999


def test_hybrid_matches_the_jax_mode():
    want = run_jax_mode("hybrid")
    got = bench.run_mode(port_settings("hybrid"), CPU)
    _same_shape(want, got)
    assert abs(got["recall@10"] - want["recall@10"]) <= 0.01


def test_hybrid_rerank_takes_each_candidate_once_by_the_combined_score():
    gen = torch.Generator().manual_seed(0)
    v1, v2 = torch.randn(50, 8, generator=gen), torch.randn(50, 4, generator=gen)
    q1, q2 = torch.randn(3, 8, generator=gen), torch.randn(3, 4, generator=gen)
    i1 = torch.randint(0, 50, (3, 12), generator=gen, dtype=torch.int32)
    i2 = torch.randint(0, 50, (3, 12), generator=gen, dtype=torch.int32)
    i1[:, -2:] = -1  # empty slots
    got = bench.hybrid_rerank(v1, v2, i1, i2, q1, q2, k=5)
    for b in range(3):
        cand = sorted(set(i1[b].tolist() + i2[b].tolist()) - {-1})
        score = {c: 0.7 * float(((v1[c] - q1[b]) ** 2).sum()) + 0.3 * float(((v2[c] - q2[b]) ** 2).sum())
                 for c in cand}
        assert got[b].tolist() == sorted(cand, key=score.get)[:5]


def test_http_matches_the_jax_mode():
    want = run_jax_mode("http")
    got = bench.run_mode(port_settings("http"), CPU)
    _same_shape(want, got)
    assert abs(got["recall@10"] - want["recall@10"]) <= 0.02
    assert got["max_distance_rel_err"] <= 1e-5


RECORD_TEXT = """
import json
import semadb_tpu.shard.shard as _sm
_docs, _answers = [], []
_insert, _search = _sm.Shard.insert_points, _sm.Shard.search_points
def _ins(self, points):
    _docs.extend((p.id.int, p.as_map()["body"]) for p in points)
    return _insert(self, points)
def _srch(self, request):
    res = _search(self, request)
    q = request.query.text
    _answers.append([q.value, q.operator, [str(r.point.id) for r in res], [r.score for r in res]])
    return res
_sm.Shard.insert_points, _sm.Shard.search_points = _ins, _srch
"""


def test_text_matches_the_jax_mode(tmp_path):
    out = tmp_path / "text.json"
    want = run_jax_mode("text", prelude=RECORD_TEXT,
                        epilogue=f"json.dump({{'docs': _docs, 'answers': _answers}}, open({str(out)!r}, 'w'))")
    keep: dict = {}
    got = bench.run_text(int(port_settings("text")["n"]), keep=keep)
    _same_shape(want, got)
    rec = json.loads(out.read_text())
    ranks, rng = bench.text_corpus(4000)
    docs = [[i + 1, " ".join(f"w{r}" for r in ranks[i])] for i in range(4000)]
    assert rec["docs"] == docs
    queries = bench.text_queries(rng)
    kinds = ("common", "mid_any", "mid_all")
    assert [[a[0], a[1]] for a in rec["answers"]] == [[q["value"], q["operator"]] for kind in kinds
                                                        for q in queries[kind]]
    port = [a for kind in kinds for a in keep["answers"][kind]]
    assert len(port) == len(rec["answers"])
    for (ids, scores), jax in zip(port, rec["answers"]):
        assert ids == jax[2], jax[:2]
        np.testing.assert_allclose(scores, jax[3], rtol=1e-5)


@pytest.mark.parametrize("mode", ["ivf", "ivfpq", "plain", "bq", "pq"])
@pytest.mark.parametrize("adversarial", [False, True])
def test_annbench_modes_by_bench_mode(mode, adversarial):
    env = {**TINY, **({"BENCH_ADVERSARIAL": "1"} if adversarial else {})}
    s = bench.settings({"BENCH_MODE": mode, **env})
    got = bench.run_mode(s, CPU)
    name = {"ivf": "ivf", "ivfpq": "ivfpq", "plain": "vamana", "bq": "vamana_bq", "pq": "vamana_pq"}[mode]
    assert got["metric"] == f"embed0k_d8_{name}{'_adv' if adversarial else ''}_qps"
    assert ANN_KEYS <= set(got) and got["platform"] == "cpu" and got["device"] == "cpu"
    assert got["query_batch"] == 16 and got["gt_queries"] == 32
    assert 0.5 <= got["recall@10"] <= 1.0


@pytest.mark.parametrize("adversarial", [False, True])
def test_fused_by_bench_mode(adversarial):
    env = {**TINY, **({"BENCH_ADVERSARIAL": "1"} if adversarial else {})}
    got = bench.run_mode(bench.settings({"BENCH_MODE": "fused", **env}), CPU)
    assert got["metric"] == f"embed0k_d8+16_fused{'_adv' if adversarial else ''}_qps"
    assert FUSED_KEYS <= set(got) and 0.5 <= got["recall@10"] <= 1.0


def test_settings_take_bench_py_defaults():
    s = bench.settings({})
    assert (s["mode"], s["n"], s["dim"], s["n_queries"], s["batch"], s["spread"]) == ("ivf", 1_000_000, 128, 32768,
                                                                                      4096, 0.5)
    assert bench.settings({"BENCH_MODE": "plain"})["batch"] == 8192
    assert bench.settings({"BENCH_MODE": "plain"})["search_size"] == 40
    assert bench.settings({"BENCH_MODE": "bq"})["search_size"] == 75
    assert bench.settings({"BENCH_MODE": "shardwrite"})["txns"] == 64
    assert bench.settings({"BENCH_MODE": "write"})["txns"] == 100
    assert bench.settings({})["sels"] == (0.10, 0.005)


def test_unknown_mode_and_a_partial_ground_truth_are_refused():
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.run_mode(bench.settings({"BENCH_MODE": "nope", **SMALL}), CPU)
    with pytest.raises(ValueError, match="BENCH_GT_QUERIES"):
        bench.run_mode(bench.settings({"BENCH_MODE": "ivf", **SMALL, "BENCH_GT_QUERIES": "10"}), CPU)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without CUDA")
def test_cuda_without_a_card_is_refused():
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main(["--device", "cuda"], env={"BENCH_MODE": "ivf", **SMALL})


def test_main_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu"], env={"BENCH_MODE": "filtered", **SMALL}) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["metric"] == "embed3k_d16_filtered_qps"


def test_annbench_adversarial(capsys):
    assert annbench.main(["--device", "cpu", "--n", "3000", "--dim", "16", "--queries", "96", "--batch", "32",
                          "--adversarial"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dataset"] == "adversarial-3000x16" and 0.5 <= out["recall@10"] <= 1.0
