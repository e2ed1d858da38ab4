"""The port's fused multi-view engine held against the JAX package's, on the CPU.

- ``_phi`` and ``_psi`` (the augmented point and query maps) exactly, on the
  same views drawn with numpy.
- Query parity: a JAX ``FusedHybridIVF`` is built on a seeded two-view
  corpus, its ``to_arrays`` go through the port's ``from_arrays``, and the
  same queries go to both, with the default weights, per-query weights and a
  filter mask. Fused distances within 1e-5 of the summed terms' magnitude,
  ids by the tie rule over the exact fused distance (f64 in numpy).
- The port's own build reaches recall@10 ≥ 0.99 against the exact
  combined-score ground truth (``tests/test_fused.py``'s bound), and the
  probe-centroid surgery is redone after every refit, through the engine's
  lock, with its cached probe norms.
- Writes and persistence through the port's ``Shard`` against the JAX
  ``Shard`` (``tests/test_shard_fused.py``): insert, per-query weights, a
  string filter, update, delete, flush and reopen; the same ids and
  distances within 1e-5 relative.
- ``embedding_like_views`` gives the JAX package's bytes.
"""

import uuid

import numpy as np
import pytest
import torch

import semadb_tpu.models as jax_models
from semadb_tpu.index.fused import FusedHybridIVF as JaxFused
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu.tools import datasets as jax_datasets
import semadb_tpu_torch.models as port_models
from semadb_tpu_torch.index.fused import FusedHybridIVF
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.shard.registry import index_nbytes
from semadb_tpu_torch.store import open_store
from semadb_tpu_torch.tools import datasets as port_datasets

CPU = torch.device("cpu")
RTOL = 1e-5
W = [0.7, 0.3]


def _clustered(rng, n, d, n_centers=40, scale=0.5):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32) * scale).astype(
        np.float32)


def _fused_dist(views, qviews, metrics, w):
    """f64 [B, N] weighted sum of the per-view distances."""
    total = np.zeros((qviews[0].shape[0], views[0].shape[0]), np.float64)
    for i, (x, q) in enumerate(zip(views, qviews)):
        x, q = x.astype(np.float64), q.astype(np.float64)
        if metrics[i] == "euclidean":
            d = (q * q).sum(-1)[:, None] - 2.0 * q @ x.T + (x * x).sum(-1)[None, :]
        elif metrics[i] == "cosine":
            d = 1.0 - q @ x.T
        else:
            d = -(q @ x.T)
        total += w[i] * d
    return total


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    n = 4000
    v1, v2 = _clustered(rng, n, 48), _clustered(rng, n, 24)
    ids = np.arange(2, n + 2, dtype=np.int64)
    jidx = JaxFused([48, 24], ["euclidean", "euclidean"], W)
    jidx.insert_bulk(ids, [v1, v2])
    return jidx, ids, v1, v2


def test_phi_and_psi_exact(built):
    jidx, _, v1, v2 = built
    tidx = FusedHybridIVF([48, 24], ["euclidean", "euclidean"], W, device=CPU)
    tidx._s, tidx._s_fixed = jidx._s.copy(), True
    views = [v1[:50], v2[:50]]
    np.testing.assert_array_equal(tidx._phi(views), jidx._phi(views))
    for w in (None, [0.2, 0.8]):
        for got, want in zip(tidx._psi(views, w), jidx._psi(views, w)):
            np.testing.assert_array_equal(got, want)
    mixed = FusedHybridIVF([16, 8, 4], ["euclidean", "dot", "cosine"], [1.0, 2.0, 0.5], device=CPU)
    jmixed = JaxFused([16, 8, 4], ["euclidean", "dot", "cosine"], [1.0, 2.0, 0.5])
    rng = np.random.default_rng(3)
    mv = [rng.standard_normal((9, d)).astype(np.float32) for d in (16, 8, 4)]
    np.testing.assert_array_equal(mixed._phi(mv), jmixed._phi(mv))
    np.testing.assert_array_equal(mixed._psi(mv, None)[0], jmixed._psi(mv, None)[0])


def _assert_same(want, got, views, qviews, w, metrics=("euclidean", "euclidean")):
    (wd, wi), (gd, gi) = want, got
    assert gd.shape == wd.shape and gi.dtype == np.int32
    full = _fused_dist(views, qviews, metrics, w)
    for b in range(len(qviews[0])):
        atol = RTOL * (1.0 + float(np.abs(full[b]).max()))
        live = np.isfinite(wd[b])
        np.testing.assert_array_equal(gi[b][~live], -1)
        errs = tie_rule_errors(wd[b][live], wi[b][live].tolist(), gd[b][live], gi[b][live].tolist(),
                               lambda i: full[b][int(i) - 2], atol=atol)
        assert errs == [], (b, errs[:3])


def test_query_parity_on_jax_built_index(built):
    jidx, ids, v1, v2 = built
    tidx = FusedHybridIVF.from_arrays(jidx.to_arrays(), None, CPU)
    assert tidx.view_dims == [48, 24] and len(tidx) == len(jidx)
    np.testing.assert_allclose(tidx.index.centroids.numpy(), np.asarray(jidx.index.centroids), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(8)
    q1 = v1[:32] + rng.standard_normal((32, 48)).astype(np.float32) * 0.05
    q2 = v2[:32] + rng.standard_normal((32, 24)).astype(np.float32) * 0.05
    for w in (None, [0.2, 0.8], [1.0, 1.0]):
        _assert_same(jidx.search_batch([q1, q2], 10, weights=w), tidx.search_batch([q1, q2], 10, weights=w),
                     [v1, v2], [q1, q2], w or W)
    mask = np.zeros(tidx.capacity, bool)
    mask[ids[::7]] = True
    want = jidx.search_batch([q1[:8], q2[:8]], 5, filter_mask=mask)
    got = tidx.search_batch([q1[:8], q2[:8]], 5, filter_mask=mask)
    assert np.all(np.isin(got[1][got[1] >= 0], ids[::7]))
    _assert_same(want, got, [v1, v2], [q1[:8], q2[:8]], W)


def test_port_build_recall_and_probe_centroids():
    rng = np.random.default_rng(17)
    n = 4000
    v1, v2 = _clustered(rng, n, 48), _clustered(rng, n, 24)
    ids = np.arange(2, n + 2, dtype=np.int64)
    idx = FusedHybridIVF([48, 24], ["euclidean", "euclidean"], W, device=CPU)
    idx.insert_bulk(ids, [v1, v2])
    inner = idx.index

    def check_surgery():
        c = inner.centroids
        for col, (off, d) in enumerate(((0, 48), (48, 24))):
            want = float(idx._s[col] / idx._a[col] ** 2) * (c[:, off : off + d] ** 2).sum(-1)
            torch.testing.assert_close(c[:, 72 + col], want)
        assert idx._cent_fixed == inner.refits

    check_surgery()
    q1 = v1[:64] + rng.standard_normal((64, 48)).astype(np.float32) * 0.05
    q2 = v2[:64] + rng.standard_normal((64, 24)).astype(np.float32) * 0.05
    full = _fused_dist([v1, v2], [q1, q2], ["euclidean", "euclidean"], W)
    gt = ids[np.argsort(full, axis=1)[:, :10]]
    d, i = idx.search_batch([q1, q2], 10)
    recall = np.mean([len(set(i[b]) & set(gt[b])) / 10 for b in range(64)])
    assert recall >= 0.99, recall
    np.testing.assert_allclose(d[:, 0], np.sort(full, axis=1)[:, 0], rtol=1e-3, atol=1e-2)
    # a write that doubles the corpus refits: the surgery is redone and the
    # cached probe norms go with the old centroids
    refits = inner.refits
    more = np.arange(n + 2, 2 * n + 2, dtype=np.int64)
    idx.insert_update_delete(zip(more.tolist(), zip(v1 + 0.01, v2 + 0.01)))
    assert inner.refits == refits + 1
    check_surgery()
    assert "cent" not in inner._sq_cache or torch.equal(inner._sq_cache["cent_p"], inner.centroids)
    assert index_nbytes(idx) == index_nbytes(inner) > inner.vectors.nbytes


def test_incremental_write_delete_and_persistence():
    rng = np.random.default_rng(12)
    n = 2000
    v1, v2 = _clustered(rng, n, 48), _clustered(rng, n, 24)
    idx = FusedHybridIVF([48, 24], ["euclidean", "euclidean"], W, device=CPU)
    idx.insert_bulk(np.arange(2, n + 2), [v1, v2])
    idx.insert_update_delete([(99999, (v1[17] + 0.001, v2[17] + 0.001))])
    assert 99999 in idx.search_batch([v1[17:18], v2[17:18]], 3)[1][0].tolist()
    idx.insert_update_delete([(99999, None)])
    assert 99999 not in idx.search_batch([v1[17:18], v2[17:18]], 3)[1][0].tolist()
    # a flat row (the journal's wire format) splits into its views
    idx.insert_update_delete([(88888, np.concatenate([v1[5], v2[5]]) + 0.001)])
    assert idx.search_batch([v1[5:6], v2[5:6]], 2)[1][0].tolist()[:2] in ([88888, 7], [7, 88888])
    arrays = idx.to_arrays()
    idx2 = FusedHybridIVF.from_arrays(arrays, None, CPU)
    jidx = JaxFused.from_arrays(arrays)
    q = [v1[:16], v2[:16]]
    want = idx.search_batch(q, 10)
    d2, i2 = idx2.search_batch(q, 10)
    np.testing.assert_array_equal(i2, want[1])
    np.testing.assert_allclose(d2, want[0], rtol=1e-5)
    np.testing.assert_array_equal(jidx.search_batch(q, 10)[1], want[1])


def test_embedding_like_views_bytes_match_jax():
    got = port_datasets.embedding_like_views(3000, [32, 16], 40, seed=42)
    want = jax_datasets.embedding_like_views(3000, [32, 16], 40, seed=42)
    for g, w in zip(got, want):
        assert g.name == w.name and g.metric == w.metric
        assert g.train.tobytes() == w.train.tobytes() and g.test.tobytes() == w.test.tobytes()


# -- the shard (mirrors tests/test_shard_fused.py) ---------------------------------------

D1, D2 = 12, 6


def _collection(models):
    schema = models.IndexSchema.from_dict({
        "embeds": {"type": "vectorFused", "vectorFused": {"views": [
            {"vectorSize": D1, "distanceMetric": "euclidean", "weight": 0.7},
            {"vectorSize": D2, "distanceMetric": "euclidean", "weight": 0.3}]}},
        "category": {"type": "string", "string": {"caseSensitive": False}},
    })
    return models.Collection(user_id="u1", id="cf", index_schema=schema, user_plan=models.UserPlan())


def _points(models, rng, n, offset=0):
    return [models.Point.from_map({
        "embeds": [rng.standard_normal(D1).tolist(), rng.standard_normal(D2).tolist()],
        "category": ["alpha", "beta"][(offset + i) % 2]}, uuid.UUID(int=offset + i + 1)) for i in range(n)]


def _request(models, v1, v2, limit=5, weights=None, filter_=None):
    q = {"property": "embeds", "vectorFused": {"vectors": [v1, v2], "operator": "near", "limit": limit,
                                               **({"weights": weights} if weights else {}),
                                               **({"filter": filter_} if filter_ else {})}}
    return models.SearchRequest.from_dict({"query": q, "limit": limit})


def _run(sh, models, queries):
    alpha = {"property": "category", "string": {"value": "alpha", "operator": "equals"}}
    out = []
    for v1, v2 in queries:
        for kw in ({}, {"weights": [0.1, 0.9]}, {"filter_": alpha}):
            out.append((kw, [(str(r.point.id), r.distance) for r in sh.search_points(_request(models, v1, v2, **kw))]))
    return out


def _check(rows, want_rows, truth, queries):
    """Each result row by the tie rule against ``want_rows`` (a reference
    row list) over the exact fused distance ``truth(q, kw)[uuid]``."""
    for (kw, got), (kw2, want), (v1, v2) in zip(rows, want_rows, [q for q in queries for _ in range(3)]):
        assert kw == kw2
        dist = truth(v1, v2, kw)
        atol = RTOL * (1.0 + max(abs(d) for d in dist.values()))
        errs = tie_rule_errors([d for _, d in want], [i for i, _ in want], [d for _, d in got], [i for i, _ in got],
                               dist.__getitem__, atol=atol)
        assert errs == [], (kw, errs[:3])


def test_shard_matches_jax_shard(tmp_path):
    """The same writes through the JAX and the port's Shard: the port's
    results are the exact fused top-5 where the probes reach it (its own
    build) and the JAX shard's, tie rule and all, on the file the JAX shard
    wrote (snapshot plus journal), reopened in the port."""
    rng = np.random.default_rng(21)
    views = {i: (rng.standard_normal(D1).astype(np.float32), rng.standard_normal(D2).astype(np.float32))
             for i in range(760)}
    views[7] = (np.full(D1, 5.0, np.float32), np.full(D2, 5.0, np.float32))  # the update below
    live = [i for i in range(760) if i != 3]
    cat = {i: ["alpha", "beta"][i % 2] for i in range(760)}

    def truth(v1, v2, kw):
        w = kw.get("weights") or W
        ok = [i for i in live if "filter_" not in kw or cat[i] == "alpha"]
        x1 = np.stack([views[i][0] for i in ok])
        x2 = np.stack([views[i][1] for i in ok])
        d = _fused_dist([x1, x2], [np.asarray([v1], np.float32), np.asarray([v2], np.float32)],
                        ("euclidean", "euclidean"), w)[0]
        return {str(uuid.UUID(int=i + 1)): float(v) for i, v in zip(ok, d)}

    def write(models, sh, flush_between):
        pts = [models.Point.from_map({"embeds": [views[i][0].tolist(), views[i][1].tolist()] if i != 7 else
                                      [np.zeros(D1).tolist(), np.zeros(D2).tolist()], "category": cat[i]},
                                     uuid.UUID(int=i + 1)) for i in range(760)]
        sh.insert_points(pts[:700])  # past MIN_FIT: the inner index fits
        if flush_between:
            sh.flush()  # the rest is journal only
        sh.insert_points(pts[700:])
        sh.update_points([models.Point.from_map({"embeds": [views[7][0].tolist(), views[7][1].tolist()],
                                                 "category": cat[7]}, pts[7].id)])
        sh.delete_points([pts[3].id])

    qrng = np.random.default_rng(22)
    queries = [(qrng.standard_normal(D1).tolist(), qrng.standard_normal(D2).tolist()) for _ in range(6)]
    queries.append(([5.0] * D1, [5.0] * D2))
    exact = [(kw, sorted(truth(v1, v2, kw).items(), key=lambda kv: kv[1])[:5])
             for v1, v2 in queries for kw in ({}, {"weights": [0.1, 0.9]}, {"filter_": {}})]
    exact = [({"filter_": {"property": "category", "string": {"value": "alpha", "operator": "equals"}}}
              if "filter_" in kw else kw, rows) for kw, rows in exact]

    # The JAX shard's file, reopened in the port
    jpath = str(tmp_path / "jax.sdb")
    jsh = JaxShard(jax_open_store(jpath), _collection(jax_models))
    write(jax_models, jsh, flush_between=True)
    want = _run(jsh, jax_models, queries)
    jsh.db.close()
    tsh = Shard(open_store(jpath), _collection(port_models), CPU)
    try:
        (idx,) = tsh.device_indices.values()
        assert isinstance(idx, FusedHybridIVF) and idx.index._n_at_fit > 0
        _check(_run(tsh, port_models, queries), want, truth, queries)
    finally:
        tsh.close()

    # The port's own shard: the same writes, then flush, close and reopen
    tpath = str(tmp_path / "port.sdb")
    tsh = Shard(open_store(tpath), _collection(port_models), CPU)
    write(port_models, tsh, flush_between=False)
    got = _run(tsh, port_models, queries)
    hits = sum(len({i for i, _ in g} & {i for i, _ in e}) for (_, g), (_, e) in zip(got, exact))
    assert hits >= 0.95 * sum(len(e) for _, e in exact), hits
    for (kw, rows), (v1, v2) in zip(got, [q for q in queries for _ in range(3)]):
        dist = truth(v1, v2, kw)
        atol = RTOL * (1.0 + max(abs(d) for d in dist.values()))  # of the summed terms' magnitude
        for pid, d in rows:
            assert abs(d - dist[pid]) <= atol, (pid, d, dist[pid])
    assert got[-3][1][0][0] == str(uuid.UUID(int=8))  # the updated point, on its own new values
    tsh.flush()
    tsh.close()
    tsh = Shard(open_store(tpath), _collection(port_models), CPU)
    try:
        again = _run(tsh, port_models, queries)
        assert [[i for i, _ in r] for _, r in again] == [[i for i, _ in r] for _, r in got]
    finally:
        tsh.close()


# -- annbench's fused mode (bench.py:_run_fused) ------------------------------------------


def test_fused_ground_truth_matches_numpy(monkeypatch):
    """``annbench.fused_ground_truth`` (f32 on the device, in query chunks)
    against a numpy f64 brute force of the weighted squared euclidean
    distances, ids by the tie rule."""
    from semadb_tpu_torch.tools import annbench

    monkeypatch.setattr(annbench, "FUSED_GT_CHUNK", 16)  # three chunks, the last one short
    rng = np.random.default_rng(11)
    train = [_clustered(rng, 2000, 24), _clustered(rng, 2000, 12)]
    test = [rng.standard_normal((40, 24)).astype(np.float32) * 4, rng.standard_normal((40, 12)).astype(np.float32) * 4]
    got = annbench.fused_ground_truth(train, test, W, 10, CPU)
    full = _fused_dist(train, test, ["euclidean", "euclidean"], W)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    for b in range(len(want)):
        atol = RTOL * (1.0 + float(np.abs(full[b]).max()))
        errs = tie_rule_errors(full[b][want[b]], want[b].tolist(), full[b][got[b]], got[b].tolist(),
                               lambda i: full[b][i], atol=atol)
        assert errs == [], (b, errs)


def test_annbench_fused_on_cpu(capsys):
    """``annbench --fused`` at a small size on ``cpu``: one JSON line with the
    fused cell's fields, ``--copies`` honoured, recall@10 against the exact
    combined-score ground truth; options the mode has no use for refused."""
    import json

    from semadb_tpu_torch.tools import annbench

    keep: dict = {}
    assert annbench.main(["--device", "cpu", "--fused", "--n", "3000", "--dim", "16", "--queries", "96",
                          "--batch", "32", "--copies", "2"], keep=keep) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["copies"] == 2 and keep["index"].index.params.assign_copies == 2
    assert out["aug_dim"] == 16 + 16 + 2 and out["weights"] == list(annbench.FUSED_WEIGHTS)
    assert out["recall@10"] >= 0.97 and out["qps"] > 0 and out["n"] == 3000
    assert keep["ground_truth"].shape == (96, 10)
    for extra in (["--quantizer", "product"], ["--sweep", "48"], ["--metric", "cosine"], ["--spread", "0.3"]):
        with pytest.raises(SystemExit):
            annbench.main(["--device", "cpu", "--fused", "--n", "3000", "--dim", "16", *extra])
    assert "--fused takes none of --" + extra[0][2:] in capsys.readouterr().err
