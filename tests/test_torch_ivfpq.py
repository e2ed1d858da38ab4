"""The port's IVF-PQ held against the JAX package's, on the CPU.

- K9's plain versions (``ops/kernels/ivf_pq_scan.py``) against the JAX ADC
  scores: the probed entry's pool against a top-rr of the JAX
  ``pq_gather_distance`` over the same probed slots (NIL slots, masked ids,
  probes outside [0, C) and a cluster probed twice), the dense entry against
  ``pq_scan_distance``. Scores within 1e-5 of M · max|table| (the sums run in
  another order), pools by the tie rule as multisets.
- Query parity: a JAX ``IndexIVF`` with a product quantizer is built on a
  seeded corpus, its ``to_arrays`` go through the port's ``from_arrays``, and
  the same queries go to both: unfiltered, a selective filter (the exact
  member scan), a broad one (wider probes with the mask inside K9), and an
  index with overflow rows (K9's dense entry, chunked). Final ids after the
  exact rerank by the tie rule, distances within 1e-5 of the summed terms'
  magnitude.
- The three IVF-PQ scenarios of ``tests/test_ivf.py`` on the port: recall
  with the f32 slabs shrunk to placeholders, CRUD after the fit, and
  persistence (through the JAX package too).
- ``vectorIVF`` and ``vectorFlat`` with a product quantizer through the
  port's ``Shard``, opened on shards the JAX ``Shard`` wrote, answering the
  JAX shard's searches.
"""

import uuid

import numpy as np
import pytest
import torch

import semadb_tpu.index.ivf as jax_ivf
import semadb_tpu.models as jax_models
import semadb_tpu.models.schema as jax_schema
import semadb_tpu.vectorstore.store as jax_store
import semadb_tpu_torch.index.ivf as port_ivf
import semadb_tpu_torch.models as port_models
import semadb_tpu_torch.models.schema as port_schema
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.ops.kernels import ivf_pq_scan
from semadb_tpu_torch.ops.topk import pool_errors, tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.shard.registry import index_nbytes
from semadb_tpu_torch.store import open_store

CPU = torch.device("cpu")
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered(rng, n, dim=32, k=20):
    cents = rng.standard_normal((k, dim)).astype(np.float32) * 5
    return (cents[rng.integers(0, k, n)] + rng.standard_normal((n, dim)).astype(np.float32)).astype(np.float32)


def _params(models, dim=32, metric="euclidean", m=8, trigger=512, **kw):
    q = models.Quantizer(type="product", product=models.ProductQuantizerParams(
        num_centroids=64, num_subvectors=m, trigger_threshold=trigger))
    schema = jax_schema if models is jax_models else port_schema
    return schema.VectorIVFParams(vector_size=dim, distance_metric=metric, quantizer=q, **kw)


def _port(**kw) -> port_ivf.IndexIVF:
    return port_ivf.IndexIVF(_params(port_models, **kw), CPU)


def _exact_top(vecs, ids, q, k):
    return ids[np.argsort(((vecs - q[None, :]) ** 2).sum(-1))[:k]]


def _true_dist(vecs, q, metric):
    x = vecs.astype(np.float64)
    if metric == "euclidean":
        d = ((x - q.astype(np.float64)) ** 2).sum(-1)
    else:
        dot = x @ q.astype(np.float64)
        d = 1.0 - dot if metric == "cosine" else -dot
    return lambda i: np.inf if i == -1 else float(d[int(i) - 2])


def _assert_same(want, got, vecs, queries, metric):
    (wd, wi), (gd, gi) = want, got
    assert gd.shape == wd.shape and gd.dtype == np.float32 and gi.dtype == np.int32
    xmax = float(np.linalg.norm(vecs, axis=1).max())
    for b in range(len(queries)):
        atol = RTOL * ((xmax + float(np.linalg.norm(queries[b]))) ** 2 + 1.0)
        live = np.isfinite(wd[b])
        np.testing.assert_array_equal(gi[b][~live], -1)
        errs = tie_rule_errors(wd[b][live], wi[b][live].tolist(), gd[b][live], gi[b][live].tolist(),
                               _true_dist(vecs, queries[b], metric), atol=atol)
        assert errs == [], (b, errs[:3])


# -- K9's plain versions against the JAX ADC ----------------------------------------

# b, p, c, s, m, k, rr, masked
K9_CASES = [
    (1, 1, 4, 16, 2, 16, 20, False),
    (5, 3, 9, 32, 4, 16, 20, True),
    (3, 6, 12, 24, 8, 256, 64, False),
    (4, 4, 20, 8, 16, 32, 256, True),
]


@pytest.mark.parametrize("b,p,c,s,m,k,rr,masked", K9_CASES)
def test_probe_scan_plain_matches_jax_adc(b, p, c, s, m, k, rr, masked):
    rng = np.random.default_rng(b * 100 + p * 10 + m)
    codes = rng.integers(0, k, (c, s, m)).astype(np.uint8)
    ids = (rng.permutation(c * s) + 2).astype(np.int32).reshape(c, s)
    ids[rng.random((c, s)) < 0.3] = -1
    ids[1] = -1  # a probed cluster that is all NIL
    table = rng.standard_normal((b, m, k)).astype(np.float32)
    probe = rng.integers(0, c, (b, p)).astype(np.int32)
    probe[0, -1] = probe[0, 0]  # a cluster probed twice: its slots count twice
    if p > 2:
        probe[-1, 1] = c  # outside [0, C): skipped
    mask = (rng.random(c * s + 2) < 0.5).astype(np.uint8) if masked else None
    got_d, got_i = ivf_pq_scan.ivf_pq_probe_scan(_t(table), _t(probe), _t(codes), _t(ids),
                                                 None if mask is None else _t(mask), rr)
    assert got_d.shape == (b, rr) and got_i.dtype == torch.int32
    # JAX: the ADC score of every probed slot, then the top rr
    slot = (np.clip(probe, 0, c - 1)[:, :, None] * s + np.arange(s)).reshape(b, -1).astype(np.int32)
    adc = np.asarray(jax_store.pq_gather_distance(codes.reshape(c * s, m), slot, table, k))
    sid = ids.reshape(-1)[slot]
    ok = (sid != -1) & (np.repeat(probe < c, s, axis=1))
    if mask is not None:
        ok &= mask[np.clip(sid, 0, len(mask) - 1)].astype(bool)
    adc = np.where(ok, adc, np.inf)
    atol = RTOL * m * float(np.abs(table).max())
    for q in range(b):
        order = np.argsort(adc[q], kind="stable")[:rr]
        want_d, want_i = adc[q][order], np.where(np.isfinite(adc[q][order]), sid[q][order], -1)
        if len(want_d) < rr:
            want_d = np.concatenate([want_d, np.full(rr - len(want_d), np.inf)])
            want_i = np.concatenate([want_i, np.full(rr - len(want_i), -1)])
        by_id = {int(i): float(d) for i, d in zip(sid[q], adc[q]) if np.isfinite(d)}
        errs = pool_errors(want_d, want_i.tolist(), got_d[q].numpy(), got_i[q].tolist(), by_id.__getitem__, atol)
        assert errs == [], (q, errs)


def test_dense_scan_plain_matches_jax_adc(monkeypatch):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 32, (1001, 4)).astype(np.uint8)
    table = rng.standard_normal((3, 4, 32)).astype(np.float32)
    mask = rng.random(1001) < 0.7
    want = np.asarray(jax_store.pq_scan_distance(codes, mask, table, 32))
    monkeypatch.setattr(ivf_pq_scan, "PLAIN_CHUNK", 3 * 4 * 100)  # rows in blocks of 100
    got = ivf_pq_scan.pq_scan(_t(table), _t(codes), _t(mask.astype(np.uint8))).numpy()
    assert np.isinf(got[:, ~mask]).all()
    np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=RTOL, atol=RTOL * 4 * float(np.abs(table).max()))
    got_all = ivf_pq_scan.pq_scan(_t(table), _t(codes), None).numpy()
    np.testing.assert_array_equal(got_all[:, mask], got[:, mask])


def test_k9_wrappers_refuse_bad_operands_on_cpu():
    table = torch.zeros((2, 4, 16))
    codes = torch.zeros((3, 5, 4), dtype=torch.uint8)
    ids = torch.zeros((3, 5), dtype=torch.int32)
    probe = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="slab_codes"):
        ivf_pq_scan.ivf_pq_probe_scan(table, probe, codes.int(), ids, None, 4)
    with pytest.raises(ValueError, match="rr"):
        ivf_pq_scan.ivf_pq_probe_scan(table, probe, codes, ids, None, 4096)
    with pytest.raises(ValueError, match="shared memory"):
        ivf_pq_scan.ivf_pq_probe_scan(torch.zeros((2, 256, 256)), probe, torch.zeros((3, 5, 256), dtype=torch.uint8),
                                      ids, None, 4)
    with pytest.raises(TypeError, match="tables"):
        ivf_pq_scan.pq_scan(torch.zeros((2, 3, 16)), codes[0], None)


# -- query parity on a JAX-built IVF-PQ index ----------------------------------------

# name: (metric, copies, n, index kwargs)
PARITY = {
    "euclidean-copies1": ("euclidean", 1, 3000, {}),
    "euclidean-copies2": ("euclidean", 2, 3000, {}),
    "cosine-copies2": ("cosine", 2, 2000, {}),
    "dot": ("dot", 1, 2000, {}),
    "overflow": ("euclidean", 1, 3000, {"slab_size": 16}),
}


def _pair(case, monkeypatch=None):
    metric, copies, n, kw = PARITY[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    vecs = _clustered(rng, n)
    if metric == "cosine":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = np.arange(2, n + 2, dtype=np.int32)
    jidx = jax_ivf.IndexIVF(_params(jax_models, metric=metric, assign_copies=copies, **kw))
    jidx.insert_update_delete(zip(ids, vecs))
    assert jidx.pq_active
    tidx = port_ivf.IndexIVF.from_arrays(_params(port_models, metric=metric, assign_copies=copies, **kw),
                                         jidx.to_arrays(), CPU)
    return jidx, tidx, vecs, ids, rng


@pytest.mark.parametrize("case", list(PARITY))
def test_query_parity_with_jax(case, monkeypatch):
    jidx, tidx, vecs, ids, rng = _pair(case)
    metric = PARITY[case][0]
    assert tidx.pq_active and tidx.slabs.shape[0] == 1 and tidx.ovf_vecs.shape[0] == 1
    np.testing.assert_array_equal(tidx.slab_codes.numpy(), np.asarray(jidx.slab_codes))
    assert len(tidx) == len(jidx)
    n_ovf = int(tidx.ovf_ids.shape[0]) - len(tidx._ovf_free)
    assert (n_ovf > 0) == (case == "overflow"), n_ovf
    if case == "overflow":
        monkeypatch.setattr(port_ivf, "OVF_CHUNK_BYTES", 1)  # the dense entry a chunk at a time
        monkeypatch.setattr(port_ivf, "OVF_CHUNK_ROWS", 256)
    queries = vecs[:24] + 0.3 * rng.standard_normal((24, vecs.shape[1])).astype(np.float32)
    if metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    for k, probes in ((10, 0), (3, 2)):
        _assert_same(jidx.search_batch(queries, k, probes), tidx.search_batch(queries, k, probes),
                     vecs, queries, metric)


@pytest.mark.parametrize("kind", ["selective", "broad"])
def test_filtered_query_parity_with_jax(kind, monkeypatch):
    jidx, tidx, vecs, ids, _ = _pair("euclidean-copies2")
    fm = np.zeros(4096, bool)
    members = ids[::41] if kind == "selective" else ids[ids % 2 == 0]
    fm[members] = True
    probes = 0 if kind == "selective" else 2
    if kind == "broad":
        for mod in (jax_ivf, port_ivf):
            monkeypatch.setattr(mod, "FILTER_EXACT_CAP", 64)
    keep: dict = {}
    queries = vecs[1:17]
    want = jidx.search_batch(queries, 5, probes, filter_mask=fm)
    got = tidx.search_batch_async(queries, 5, probes, filter_mask=fm, keep=keep)
    got = (got[0].numpy(), got[1].numpy())
    assert ("k9" in keep) == (kind == "broad")  # the selective filter scans the members exactly
    assert set(got[1][got[1] >= 0].tolist()) <= set(members.tolist())
    _assert_same(want, got, vecs, queries, "euclidean")


# -- behaviour (mirrors tests/test_ivf.py) ------------------------------------------


def test_ivfpq_fit_recall_and_memory():
    """f32 slabs until the codebook fits at the trigger; then u8 codes, the
    f32 slabs and overflow rows shrunk to placeholders, and recall@10 ≥ 0.9
    through ADC and the exact rerank."""
    rng = np.random.default_rng(31)
    vecs = _clustered(rng, 4000)
    ids = np.arange(2, 4002, dtype=np.int32)
    idx = _port(trigger=3000)
    idx.insert_update_delete(zip(ids[:2000], vecs[:2000]))
    assert not idx.pq_active and idx.slabs.shape[0] > 1
    f32_slab_bytes = idx.slabs.nbytes
    idx.insert_update_delete(zip(ids[2000:], vecs[2000:]))
    assert idx.pq_active and idx.refit_seconds.keys() >= {"pq_fit_s", "pq_encode_s"}
    assert "slab_build_s" not in idx.refit_seconds
    assert idx.slab_codes.shape[-1] == 8 and idx.slab_codes.dtype == torch.uint8
    assert idx.slabs.shape[0] == 1 and idx.ovf_vecs.shape[0] == 1 and idx.slabs.nbytes < f32_slab_bytes
    queries = vecs[:32]
    _, i = idx.search_batch(queries, k=10)
    recall = np.mean([len(set(_exact_top(vecs, ids, queries[b], 10)) & set(i[b])) / 10 for b in range(32)])
    assert recall >= 0.9, recall
    # the registry's budget counts the codes, not the placeholders
    assert index_nbytes(idx) >= idx.slab_codes.nbytes + idx.ovf_codes.nbytes + idx.vectors.nbytes


def test_ivfpq_crud_after_fit():
    rng = np.random.default_rng(32)
    idx = _port()
    vecs = _clustered(rng, 2000)
    idx.insert_update_delete(zip(np.arange(2, 2002, dtype=np.int32), vecs))
    assert idx.pq_active
    new = _clustered(rng, 50)
    new_ids = np.arange(9000, 9050, dtype=np.int32)
    idx.insert_update_delete(zip(new_ids, new))
    _, i = idx.search_batch(new[:5], k=1)
    assert list(i[:, 0]) == list(new_ids[:5])
    idx.insert_update_delete([(9000, None)])
    assert 9000 not in idx.search_batch(new[:1], k=3)[1][0]
    idx.insert_update_delete([(9001, vecs[0] + 100.0)])
    _, i = idx.search_batch((vecs[0] + 100.0)[None, :], k=1)
    assert i[0, 0] == 9001


def test_ivfpq_persistence_roundtrip():
    rng = np.random.default_rng(33)
    idx = _port()
    vecs = _clustered(rng, 1500)
    ids = np.arange(2, 1502, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    arrays = idx.to_arrays()
    assert arrays["slab_codes"].dtype == np.uint8 and "pq_codebook" in arrays
    idx2 = port_ivf.IndexIVF.from_arrays(idx.params, arrays, CPU)
    assert idx2.pq_active
    jidx = jax_ivf.IndexIVF.from_arrays(_params(jax_models), arrays)
    assert jidx.pq_active
    q = vecs[:4]
    want = idx.search_batch(q, k=5)
    np.testing.assert_array_equal(idx2.search_batch(q, k=5)[1], want[1])
    _assert_same(want, jidx.search_batch(q, k=5), vecs, q, "euclidean")
    idx2.insert_update_delete([(5000, vecs[0])])
    assert 5000 in idx2.search_batch(vecs[:1], k=2)[1][0]


# -- the shard ---------------------------------------------------------------------


def _collection(models, kind):
    if kind == "ivf":
        entry = {"type": "vectorIVF", "vectorIVF": {"vectorSize": 24, "distanceMetric": "euclidean", "quantizer": {
            "type": "product", "product": {"numCentroids": 32, "numSubVectors": 4, "triggerThreshold": 1000}}}}
    else:
        entry = {"type": "vectorFlat", "vectorFlat": {"vectorSize": 24, "distanceMetric": "euclidean", "quantizer": {
            "type": "product", "product": {"numCentroids": 32, "numSubVectors": 4, "triggerThreshold": 1000,
                                           "opq": True}}}}
    schema = models.IndexSchema.from_dict({"v": entry})
    return models.Collection(user_id="u1", id="c1", index_schema=schema, user_plan=models.UserPlan())


def _requests(models, kind, queries):
    key = "vectorIVF" if kind == "ivf" else "vectorFlat"
    return [models.SearchRequest.from_dict({"query": {"property": "v", key: {
        "vector": q.tolist(), "limit": 5}}, "limit": 5}) for q in queries]


@pytest.mark.parametrize("kind", ["ivf", "flat"])
def test_jax_written_pq_shard_opens_in_port(tmp_path, kind):
    """A shard the JAX package wrote with a PQ index (a flushed snapshot
    holding the codes, then journaled writes) opens in the port and answers
    the JAX shard's searches: IVF-PQ by the exact distances after the
    rerank, flat PQ by its ADC distances."""
    rng = np.random.default_rng(12)
    vecs = _clustered(rng, 1400, dim=24)
    queries = vecs[:10] + 0.2 * rng.standard_normal((10, 24)).astype(np.float32)
    path = str(tmp_path / "s.sdb")
    jsh = JaxShard(jax_open_store(path), _collection(jax_models, kind))
    pts = [jax_models.Point.from_map({"v": vecs[i].tolist()}, uuid.UUID(int=i + 1)) for i in range(1400)]
    jsh.insert_points(pts[:1200])
    jsh.flush()  # the snapshot holds the fitted codes
    jsh.insert_points(pts[1200:])  # journal only from here on
    jsh.delete_points({pts[3].id, pts[1300].id})
    want = jsh.search_points_batch_wire(_requests(jax_models, kind, queries))
    jsh.db.close()
    tsh = Shard(open_store(path), _collection(port_models, kind), CPU)
    try:
        assert tsh.point_count() == 1398
        (idx,) = tsh.device_indices.values()
        fitted = idx.pq_active if kind == "ivf" else idx.store.fitted
        assert fitted
        got = tsh.search_points_batch_wire(_requests(port_models, kind, queries))
        tsh.flush()  # the port's snapshot carries the codes too
        if kind == "flat":
            full = idx.store.scan_distances(_t(queries), idx.vectors, idx.exists).numpy()
    finally:
        tsh.close()
    row_of = {str(uuid.UUID(int=i + 1)): i for i in range(1400)}
    for b, (q, wrow, grow) in enumerate(zip(queries, want, got)):
        if kind == "ivf":
            d = ((vecs.astype(np.float64) - q) ** 2).sum(-1)
            dist_of, atol = (lambda pid: d[row_of[pid]]), RTOL * (1.0 + float(d.max()))
        else:
            dist_of, atol = (lambda pid: full[b][row_of[pid] + 2]), RTOL * (1.0 + float(np.abs(full[b][np.isfinite(full[b])]).max()))
        errs = tie_rule_errors([p["_distance"] for p in wrow], [p["_id"] for p in wrow],
                               [p["_distance"] for p in grow], [p["_id"] for p in grow], dist_of, atol=atol)
        assert errs == [], (b, errs)
        assert {str(uuid.UUID(int=4)), str(uuid.UUID(int=1301))}.isdisjoint(p["_id"] for p in grow)
    # reopened from the port's own snapshot
    tsh = Shard(open_store(path), _collection(port_models, kind), CPU)
    try:
        again = tsh.search_points_batch_wire(_requests(port_models, kind, queries))
        assert [[p["_id"] for p in r] for r in again] == [[p["_id"] for p in r] for r in got]
    finally:
        tsh.close()


def test_annbench_product_quantizer_on_cpu(capsys):
    """``annbench --quantizer product`` (``BENCH_MODE=ivfpq``) at a small size
    on ``cpu``, past the trigger: the codebook of bench.py's quantizer
    (M = max(D // 16, 4), K = 256, fit at 10,000 points) is active, the
    build split names its fit and encode, and recall@10 against the exact
    ground truth holds the cell's bar."""
    import json

    from semadb_tpu_torch.tools import annbench

    keep: dict = {}
    assert annbench.main(["--device", "cpu", "--quantizer", "product", "--n", "12000", "--dim", "16",
                          "--queries", "96", "--batch", "32"], keep=keep) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pq"] == {"m": 4, "k": 256, "trigger": 10_000, "active": True}
    assert out["slab_dtype"] == "u8 PQ codes" and keep["index"].pq_active
    assert set(out["build_split_s"]) >= {"pq_fit_s", "pq_encode_s"}
    assert out["recall@10"] >= 0.95 and out["n"] == 12000
