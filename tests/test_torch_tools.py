"""The slice's deployment module and profiler, on ``cpu`` at a small size.

``semadb_tpu_torch.tools.dbpedia_bq`` serves the 1536-d binary-quantized
flat collection that ``chip_smoke.py`` checks on the card; here it takes
600 points (100 over HTTP, the rest through ``ClusterNode.insert_points``)
into several small shards, and every HTTP search must match the numpy
brute-force hamming scan by the tie rule (exact distances). The profiler
refuses to run without a CUDA device. The copied tools: ``loadrand`` loads
a port server, and ``dumpgraph`` writes the JAX tool's CSV byte for byte for
a shard file either package wrote.
"""

import sys

import numpy as np
import pytest
import torch

from semadb_tpu_torch.ops.kernels import hamming
from semadb_tpu_torch.tools import dbpedia_bq as bq
from semadb_tpu_torch.tools import profile_slice

CPU = torch.device("cpu")
N_POINTS = 600
LIMIT = 10


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(bq, "HTTP_POINTS", 100)
    mp.setattr(bq, "BLOCK", 250)
    cfg = bq.slice_config(str(tmp_path_factory.mktemp("slice")))
    cfg.cluster_node.max_shard_size = 2 * 2**20
    try:
        with bq.serving(cfg, CPU) as srv:
            yield srv, bq.load(srv, 0, N_POINTS)
    finally:
        mp.undo()


def test_load_spans_shards(served):
    srv, data = served
    assert sum(data.shard_counts) == N_POINTS and len(data.shard_counts) >= 2
    indices = srv.shard_indices()
    assert sorted(int(i.exists.sum()) for i in indices) == sorted(data.shard_counts)
    assert all(i.device == CPU and i.store.state.codes.dtype == torch.int32 for i in indices)
    assert data.words.shape == (N_POINTS, bq.DIM // 64)
    assert data.seconds > 0 and data.http_seconds > 0 and data.insert_seconds > 0


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch"])
def test_searches_match_brute_force(served, batch):
    srv, data = served
    qs = bq.queries(0, 5)
    before = hamming.LAUNCHES
    path = f"/{bq.COLLECTION}/points/search"
    if batch:
        res = bq.http_json(srv.base, "POST", path + "/batch",
                           {"queries": [bq.search_body(q, LIMIT) for q in qs]})
        rows = [r["points"] for r in res["results"]]
    else:
        rows = [bq.http_json(srv.base, "POST", path, bq.search_body(q, LIMIT))["points"] for q in qs]
    for q, points in zip(qs, rows):
        assert len(points) == LIMIT
        assert bq.brute_force_errors(q, points, data, LIMIT) == []
    assert hamming.LAUNCHES == before  # on cpu the plain version ran, no kernel


def test_brute_force_errors_catch_a_wrong_result(served):
    srv, data = served
    q = bq.queries(0, 1)[0]
    points = bq.http_json(srv.base, "POST", f"/{bq.COLLECTION}/points/search",
                          bq.search_body(q, LIMIT))["points"]
    wrong = [dict(p) for p in points]
    wrong[0]["_distance"] += 1.0
    assert bq.brute_force_errors(q, wrong, data, LIMIT) != []


def test_embeddings_are_seeded_unit_vectors():
    a, b = bq.Embeddings(3).block(2, 16), bq.Embeddings(3).block(2, 16)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, rtol=1e-5)
    assert not np.array_equal(a, bq.Embeddings(3).block(1, 16))


def test_profiler_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["profile_slice"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_slice.main() == 1


def test_loadrand_drives_a_port_server(tmp_path, capsys):
    """The port's copy of ``tools/loadrand.py`` parses its arguments and
    loads a vectorVamana collection of the port's server (on ``cpu``) in
    batches: the points are there afterwards."""
    from semadb_tpu_torch.tools import loadrand

    cfg = bq.slice_config(str(tmp_path))
    with bq.serving(cfg, CPU) as srv:
        root = srv.base.split("/v2/")[0]
        assert loadrand.main(["--base", root, "--collection", "loadtest", "--dim", "8", "--count", "25",
                              "--batch", "10", "--user", bq.USER["X-User-Id"], "--plan", "BASIC"]) == 0
        assert "inserted 25/25" in capsys.readouterr().out
        hits = bq.http_json(srv.base, "POST", "/loadtest/points/search", {"query": {
            "property": "vector", "vectorVamana": {"vector": [0.5] * 8, "operator": "near", "limit": 30}},
            "limit": 30})["points"]
        assert len(hits) == 25


def test_dumpgraph_equals_the_jax_one(tmp_path, capsys):
    """The port's copy of ``tools/dumpgraph.py`` writes the JAX tool's CSV
    for the same shard file: one written by the JAX package, then one the
    port wrote."""
    import uuid

    import semadb_tpu.models as jax_models
    import semadb_tpu.shard  # noqa: F401  (the JAX tool needs the shard package imported first)
    import semadb_tpu_torch.models as port_models
    from semadb_tpu.shard import Shard as JaxShard
    from semadb_tpu.store import open_store as jax_open_store
    from semadb_tpu.tools import dumpgraph as jax_dumpgraph
    from semadb_tpu_torch.shard import Shard
    from semadb_tpu_torch.store import open_store
    from semadb_tpu_torch.tools import dumpgraph

    schema = {"v": {"type": "vectorVamana", "vectorVamana": {"vectorSize": 8, "distanceMetric": "euclidean",
                                                             "searchSize": 24, "degreeBound": 8}}}
    vecs = np.random.default_rng(3).standard_normal((300, 8)).astype(np.float32)
    for pkg, models, shard_cls, opener in ((0, jax_models, JaxShard, jax_open_store),
                                           (1, port_models, Shard, open_store)):
        path = str(tmp_path / f"s{pkg}.sdb")
        col = models.Collection(user_id="u1", id="c1", index_schema=models.IndexSchema.from_dict(schema),
                                user_plan=models.UserPlan())
        sh = shard_cls(opener(path), col, CPU) if pkg else shard_cls(opener(path), col)
        sh.insert_points([models.Point.from_map({"v": vecs[i].tolist()}, uuid.UUID(int=i + 1)) for i in range(300)])
        sh.flush()
        (sh.close if pkg else sh.db.close)()
        out_j, out_p = str(tmp_path / f"j{pkg}.csv"), str(tmp_path / f"p{pkg}.csv")
        assert jax_dumpgraph.dump_graph(path, "v", out_j) == dumpgraph.dump_graph(path, "v", out_p) == 301
        assert open(out_j).read() == open(out_p).read()
        lines = open(out_p).read().splitlines()
        assert lines[0].startswith("1,") and all(len(line.split(",")) <= 9 for line in lines)
