"""``tools/annbench.py``'s quantized Vamana modes and pool build on the CPU.

``--engine vamana --quantizer binary`` (``BENCH_MODE=bq``), ``--quantizer
product`` (``BENCH_MODE=pq``) and ``--build pool``
(``SEMADB_VAMANA_BUILD=pool``) at a small size on ``cpu`` (the kernels' plain
versions): their JSON lines, past the quantizers' trigger. The triggers are
``bench.py``'s 10,000 points; the runs patch them to 2,000 and the pool
build's least batch to 1,024 to stay small. A file of its own, so that the
test runner can run these builds beside the other Vamana files.
"""

import pytest


def test_annbench_quantizers_are_bench_pys():
    """``bench.py:_quantizer``: hamming BQ and M = max(D // 16, 4) x 256 PQ,
    each fit at 10,000 points."""
    from semadb_tpu_torch.tools import annbench

    assert annbench.BQ_TRIGGER == annbench.PQ_TRIGGER == 10_000 and annbench.PQ_CENTROIDS == 256


@pytest.mark.parametrize("argv,kind", [(["--quantizer", "binary"], "binary"), (["--quantizer", "product"], "product"),
                                       (["--build", "pool"], None)])
def test_annbench_vamana_bq_pq_and_pool_on_cpu(capsys, monkeypatch, argv, kind):
    """``annbench --engine vamana`` with ``--quantizer binary`` (BENCH_MODE=bq),
    ``--quantizer product`` (BENCH_MODE=pq) and ``--build pool`` at a small
    size on ``cpu``: past the 10,000-point trigger the store is fitted, the
    walk runs at L = 75, and the pool build reports its stages."""
    import json

    import semadb_tpu_torch.index.vamana as port_vamana
    from semadb_tpu_torch.tools import annbench

    monkeypatch.setattr(annbench, "BQ_TRIGGER", 2_000)
    monkeypatch.setattr(annbench, "PQ_TRIGGER", 2_000)
    monkeypatch.setattr(port_vamana, "TWO_PASS_MIN", 1_024)
    n = 2500
    assert annbench.main(["--engine", "vamana", "--device", "cpu", "--n", str(n), "--dim", "16", "--queries", "64",
                          "--batch", "32", *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if kind is None:
        assert out["build_mode"] == "pool" and out["search_size"] == 40 and out["recall@10"] >= 0.95
        assert {"kmeans_s", "pools_s", "pass1_s", "pass2.0_s", "topup_s"} <= set(out["build_split_s"])
        return
    assert out["search_size"] == 75 and out["quantizer"]["kind"] == kind and out["quantizer"]["fitted"]
    assert out["quantizer"]["trigger"] == 2000 and out["build_split_s"]["fit_s"] >= 0
    if kind == "product":
        assert (out["quantizer"]["m"], out["quantizer"]["k"], out["quantizer"]["opq"]) == (4, 256, True)
        assert out["recall@10"] >= 0.9
    else:
        assert out["quantizer"]["bit_metric"] == "hamming" and out["recall@10"] >= 0.3
