"""The port's product quantizer held against the JAX package's, on the CPU.

- The PQ functions on the same codebooks and rows (drawn with numpy):
  ``pq_encode`` and ``_pq_decode`` exactly, ``pq_query_table``,
  ``pq_scan_distance`` and ``pq_gather_distance`` within 1e-5 relative (the
  sums run in another order), for all three metrics.
- The fits: JAX seeds its k-means with ``jax.random``, the port with a
  ``torch.Generator``, so codebooks cannot match bit for bit. They are held
  on quality instead: one ``kmeans_fit``'s inertia, and the mean squared
  reconstruction error (the ADC distortion) of the ``pq_fit`` and
  ``opq_fit`` codebooks, within 5% of the JAX fits' on the same rows.
- ``VectorStore``: the product store fits at its trigger and not before, and
  a fitted JAX store's arrays load into the port's (``load_arrays``) and
  score the same.
- ``IndexFlat`` with a product quantizer against the JAX flat index loaded
  from the same arrays: ADC distances within 1e-5 relative, ids by the tie
  rule over the ADC distances.
"""

import numpy as np
import pytest
import torch

import semadb_tpu.models as jax_models
import semadb_tpu.vectorstore.store as jax_store
import semadb_tpu_torch.models as port_models
import semadb_tpu_torch.vectorstore.store as port_store
from semadb_tpu.index.flat import IndexFlat as JaxIndexFlat
from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.ops.topk import tie_rule_errors

CPU = torch.device("cpu")
RTOL = 1e-5
METRICS = ("euclidean", "dot", "cosine")


def _rows(rng, n, d, metric="euclidean"):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "cosine" else x


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("metric", METRICS)
def test_pq_functions_match_jax(metric):
    rng = np.random.default_rng(sum(map(ord, metric)))
    m, k, d = 8, 32, 64
    cb = rng.standard_normal((m, k, d // m)).astype(np.float32)
    x = _rows(rng, 500, d, metric)
    q = _rows(rng, 7, d, metric)
    want = np.asarray(jax_store.pq_encode(x, cb, m, k, metric))
    got = port_store.pq_encode(_t(x), _t(cb), m, k, metric)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_store._pq_decode(_t(want), _t(cb)).numpy(),
                                  np.asarray(jax_store._pq_decode(want, cb)))
    jt = np.asarray(jax_store.pq_query_table(q, cb, m, k, metric))
    tt = port_store.pq_query_table(_t(q), _t(cb), m, k, metric)
    _close(tt, jt, float(np.abs(jt).max()))
    scale = m * float(np.abs(jt).max())
    mask = rng.random(500) < 0.8
    ws = np.asarray(jax_store.pq_scan_distance(want, mask, jt, k))
    gs = port_store.pq_scan_distance(_t(want), _t(mask), _t(jt), k).numpy()
    assert np.isinf(gs[:, ~mask]).all() and np.isinf(ws[:, ~mask]).all()
    _close(gs[:, mask], ws[:, mask], scale)
    ids = rng.integers(0, 500, (7, 40)).astype(np.int32)
    _close(port_store.pq_gather_distance(_t(want), _t(ids), _t(jt), k),
           jax_store.pq_gather_distance(want, ids, jt, k), scale)


def test_pq_encode_blocks_like_one_pass(monkeypatch):
    """Past ENCODE_BLOCK elements (and with row ids) the encode runs block by
    block and gives the one-pass codes."""
    rng = np.random.default_rng(3)
    cb = _t(rng.standard_normal((4, 16, 8)).astype(np.float32))
    x = _t(_rows(rng, 300, 32))
    whole = port_store.pq_encode(x, cb, 4, 16, "euclidean")
    monkeypatch.setattr(port_store, "ENCODE_BLOCK", 4 * 16 * 7)
    assert torch.equal(port_store.pq_encode(x, cb, 4, 16, "euclidean"), whole)
    rid = torch.arange(299, -1, -1, dtype=torch.int32)
    assert torch.equal(port_store.pq_encode(x, cb, 4, 16, "euclidean", row_ids=rid), whole.flip(0))


def test_kmeans_fit_quality_matches_jax():
    """One fit (``kmeans_fit``): the port's inertia within 5% of the JAX
    fit's on the same rows, labels u8 and each row's nearest centroid."""
    from semadb_tpu.vectorstore import kmeans as jax_kmeans
    from semadb_tpu_torch.vectorstore import kmeans as port_kmeans

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((20, 8)) * 4)[rng.integers(0, 20, 2000)] + rng.standard_normal((2000, 8))
    x = x.astype(np.float32)
    jc, _ = jax_kmeans.kmeans_fit(x, 32, 0, 50)
    tc, tl = port_kmeans.kmeans_fit(_t(x), 32, 0, 50)
    assert tl.dtype == torch.uint8 and tc.shape == (32, 8)
    d = ((x[:, None, :] - tc.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(tl.numpy(), d.argmin(1))
    inertia = lambda c: float(((x[:, None, :] - np.asarray(c)[None]) ** 2).sum(-1).min(1).mean())
    assert inertia(tc) <= 1.05 * inertia(jc), (inertia(tc), inertia(jc))


def _distortion(x, codes, cb, rot=None):
    rec = port_store._pq_decode(_t(np.asarray(codes)), _t(np.asarray(cb))).numpy()
    xr = x if rot is None else x @ np.asarray(rot)
    return float(((xr - rec) ** 2).sum(-1).mean())


@pytest.mark.parametrize("opq", [False, True], ids=["pq_fit", "opq_fit"])
def test_fit_quality_matches_jax(opq):
    """ADC distortion of the port's codebooks within 5% of the JAX
    codebooks' on the same rows (anisotropic rows, where OPQ's rotation
    matters)."""
    rng = np.random.default_rng(11)
    m, k, d, n = 4, 16, 32, 3000
    x = (rng.standard_normal((n, d)) * np.linspace(3.0, 0.2, d)).astype(np.float32)
    x = (x @ np.linalg.qr(rng.standard_normal((d, d)))[0]).astype(np.float32)
    live = np.ones(n, bool)
    if opq:
        jr, jcb = jax_store.opq_fit(x, live, m, k, iters=3)
        tr, tcb = port_store.opq_fit(_t(x), _t(live), m, k, iters=3)
        tr_np = tr.numpy()
        np.testing.assert_allclose(tr_np @ tr_np.T, np.eye(d), atol=1e-4)  # orthonormal
    else:
        jr = tr_np = None
        jcb = jax_store.pq_fit(x, live, m, k)
        tcb = port_store.pq_fit(_t(x), _t(live), m, k)
    jx = x if jr is None else x @ np.asarray(jr)
    tx = x if tr_np is None else x @ tr_np
    want = _distortion(x, jax_store.pq_encode(jx, jcb, m, k, "euclidean"), jcb, jr)
    got = _distortion(x, port_store.pq_encode(_t(tx), tcb, m, k, "euclidean"), tcb.numpy(), tr_np)
    assert got <= 1.05 * want, (got, want)


def _product_cfg(models, trigger=300, opq=False, metric="euclidean", dim=32):
    q = models.Quantizer(type="product", product=models.ProductQuantizerParams(
        num_centroids=16, num_subvectors=4, trigger_threshold=trigger, opq=opq))
    return q, dim, metric


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_vector_store_fits_at_trigger_and_loads_jax_arrays(opq):
    rng = np.random.default_rng(5)
    vecs = _rows(rng, 400, 32)
    cfg = port_store.QuantConfig.from_params(*_product_cfg(port_models, opq=opq))
    assert (cfg.kind, cfg.num_subvectors, cfg.num_centroids, cfg.opq) == ("product", 4, 16, opq)
    tstore = port_store.VectorStore(cfg, CPU)
    few = np.arange(400) < 250
    assert not tstore.maybe_fit(_t(vecs), _t(few)) and not tstore.fitted
    assert tstore.maybe_fit(_t(vecs), _t(np.ones(400, bool))) and tstore.fitted
    assert tstore.state.codes.shape == (400, 4) and (tstore.state.rot is not None) == opq
    # A fitted JAX store's arrays, loaded into a fresh port store
    jstore = jax_store.VectorStore(jax_store.QuantConfig.from_params(*_product_cfg(jax_models, opq=opq)))
    jstore.maybe_fit(vecs, np.ones(400, bool))
    arrays = jstore.to_arrays()
    loaded = port_store.VectorStore(cfg, CPU)
    loaded.load_arrays(arrays)
    out = loaded.to_arrays()
    assert set(out) == set(arrays)
    for key in ("codes", "aux") + (("rot",) if opq else ()):
        assert out[key].dtype == arrays[key].dtype
        np.testing.assert_array_equal(out[key], arrays[key])
    q = _rows(rng, 5, 32)
    live = np.ones(400, bool)
    live[::9] = False
    want = np.asarray(jstore.scan_distances(q, vecs, live))
    got = loaded.scan_distances(_t(q), _t(vecs), _t(live)).numpy()
    scale = 4 * float(np.abs(np.asarray(jstore.prepare_queries(q))).max())
    assert np.isinf(got[:, ~live]).all()
    _close(got[:, live], want[:, live], scale)
    # rows written after the fit are encoded like the JAX store's
    new = _rows(rng, 3, 32)
    vecs[[7, 8, 9]] = new
    jstore.encode_rows(vecs, np.array([7, 8, 9]))
    loaded.encode_rows(_t(vecs), np.array([7, 8, 9]))
    np.testing.assert_array_equal(loaded.state.codes.numpy(), np.asarray(jstore.state.codes))


def _flat_params(models, metric, opq):
    q, dim, _ = _product_cfg(models, trigger=300, opq=opq)
    return models.VectorFlatParams(vector_size=dim, distance_metric=metric, quantizer=q)


@pytest.mark.parametrize("metric,opq", [("euclidean", False), ("cosine", True), ("dot", False)])
def test_flat_pq_matches_jax_from_the_same_arrays(metric, opq):
    rng = np.random.default_rng(sum(map(ord, metric)) + opq)
    vecs = _rows(rng, 500, 32, metric)
    jidx = JaxIndexFlat(_flat_params(jax_models, metric, opq))
    jidx.insert_update_delete(zip(range(2, 502), vecs))
    jidx.insert_update_delete([(i, None) for i in range(2, 502, 11)])
    assert jidx.store.fitted
    tidx = IndexFlat.from_arrays(_flat_params(port_models, metric, opq), jidx.to_arrays(), CPU)
    assert tidx.store.fitted and tidx.store.state.codes.dtype == torch.uint8
    queries = np.concatenate([vecs[:3], _rows(rng, 5, 32, metric)])
    fmask = np.zeros(tidx.capacity, bool)
    fmask[rng.choice(np.arange(2, 502), 120, replace=False)] = True
    for fm in (None, fmask):
        jd, ji = jidx.search_batch(queries, 10, filter_mask=fm)
        td, ti = tidx.search_batch(queries, 10, filter_mask=fm)
        live = tidx.exists if fm is None else tidx.exists & _t(fm)
        full = tidx.store.scan_distances(_t(queries), tidx.vectors, live).numpy()
        scale = 4 * float(np.abs(tidx.store.prepare_queries(_t(queries)).numpy()).max())
        for b in range(len(queries)):
            errs = tie_rule_errors(jd[b], ji[b].tolist(), td[b], ti[b].tolist(), full[b], atol=RTOL * scale)
            assert errs == [], (b, errs[:3])
    # writes after the load are encoded by the loaded codebooks, like the JAX index's
    new = _rows(rng, 4, 32, metric)
    for idx in (jidx, tidx):
        idx.insert_update_delete(zip(range(600, 604), new))
    np.testing.assert_array_equal(tidx.store.state.codes[600:604].numpy(), np.asarray(jidx.store.state.codes)[600:604])
