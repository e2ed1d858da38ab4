"""Port vector store and flat index held against the JAX package's.

The same seeded numpy inserts, deletes and queries go through
``semadb_tpu`` (JAX on the CPU) and ``semadb_tpu_torch`` (PyTorch on the
CPU). Tolerances: bit distances exact; float distances rtol 1e-5, atol 1e-4;
ids by the tie rule (``semadb_tpu_torch.ops.topk.tie_rule_errors``).
``from_arrays`` / ``to_arrays`` are crossed in both directions. Each package
gets its own parameter objects (``_params``), built the same way.
"""

import numpy as np
import pytest
import torch

import semadb_tpu.models as jax_models
import semadb_tpu_torch.models as port_models
from semadb_tpu.index.flat import IndexFlat as JaxIndexFlat
from semadb_tpu.vectorstore import QuantConfig as JaxQuantConfig
from semadb_tpu.vectorstore import VectorStore as JaxVectorStore
from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.vectorstore import QuantConfig, VectorStore

CPU = torch.device("cpu")
RNG = np.random.default_rng(77)
DIM = 96


def _unit(n, dim=DIM):
    v = RNG.standard_normal((n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _params(kind, models=port_models, metric="cosine"):
    """Flat index parameters of ``kind``, as objects of ``models`` (the JAX
    package's or the port's)."""
    if kind == "plain":
        q = None
    elif kind == "binary-fixed":
        q = models.Quantizer(type="binary", binary=models.BinaryQuantizerParams(distance_metric="hamming", threshold=0.0))
    elif kind == "binary-fitted":
        q = models.Quantizer(type="binary", binary=models.BinaryQuantizerParams(distance_metric="jaccard", trigger_threshold=40))
    return models.VectorFlatParams(vector_size=DIM, distance_metric=metric, quantizer=q)


def _assert_same_search(jidx, tidx, queries, k, filter_mask=None, float_metric=False):
    jd, ji = jidx.search_batch(queries, k, filter_mask=filter_mask)
    td, ti = tidx.search_batch(queries, k, filter_mask=filter_mask)
    assert td.dtype == np.float32 and ti.dtype == np.int32 and td.shape == jd.shape
    if float_metric:
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(ti, ji)  # random floats: no ties
        return
    full = tidx.store.scan_distances(
        torch.from_numpy(np.asarray(queries, np.float32)), tidx.vectors, tidx.exists
    ).numpy()
    for b in range(len(queries)):
        live = np.isfinite(jd[b])
        np.testing.assert_array_equal(ti[b][~live], -1)
        errs = tie_rule_errors(jd[b][live], ji[b][live], td[b][live], ti[b][live], full[b])
        assert errs == [], errs


# -- vector store -------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [
        dict(kind="plain", dim=DIM, metric="cosine"),
        dict(kind="binary", dim=DIM, metric="cosine", bit_metric="hamming", threshold=0.0),
        dict(kind="binary", dim=DIM, metric="cosine", bit_metric="jaccard", trigger=50),
    ],
    ids=["plain", "binary-fixed", "binary-fitted"],
)
def test_vector_store_scan_matches_jax(cfg):
    vectors = _unit(128)
    live = np.arange(128) < 100
    live[[3, 17]] = False
    jstore, tstore = JaxVectorStore(JaxQuantConfig(**cfg)), VectorStore(QuantConfig(**cfg), CPU)
    assert jstore.fitted == tstore.fitted
    assert jstore.maybe_fit(vectors, live) == tstore.maybe_fit(torch.from_numpy(vectors), torch.from_numpy(live))
    if cfg["kind"] == "binary":
        jstore.encode_rows(vectors, np.arange(128))
        tstore.encode_rows(torch.from_numpy(vectors), np.arange(128))
        np.testing.assert_allclose(tstore.state.aux.numpy(), np.asarray(jstore.state.aux), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tstore.to_arrays()["codes"], np.asarray(jstore.state.codes))
    q = _unit(6)
    want = np.asarray(jstore.scan_distances(q, vectors, live))
    got = tstore.scan_distances(torch.from_numpy(q), torch.from_numpy(vectors), torch.from_numpy(live)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert np.isinf(got[:, ~live]).all()


def test_flat_index_fits_product_quantizer_at_its_trigger():
    """A flat index takes a product store and fits it at its trigger
    (``tests/test_torch_pq.py`` holds it against the JAX package)."""
    q = port_models.Quantizer(type="product", product=port_models.ProductQuantizerParams(
        num_centroids=16, num_subvectors=8, trigger_threshold=200, opq=False))
    params = port_models.VectorFlatParams(vector_size=DIM, distance_metric="euclidean", quantizer=q)
    idx = IndexFlat(params, CPU)
    assert idx.store.config.kind == "product" and not idx.store.fitted
    vecs = _unit(240)
    idx.insert_update_delete(zip(range(2, 242), vecs))
    assert idx.store.fitted and idx.store.state.codes.dtype == torch.uint8
    assert tuple(idx.store.state.aux.shape) == (8, 16, DIM // 8)


# -- flat index ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "binary-fixed", "binary-fitted"])
def test_flat_index_matches_jax(kind):
    jidx, tidx = JaxIndexFlat(_params(kind, jax_models)), IndexFlat(_params(kind), CPU)
    vecs = _unit(300)
    ids = np.arange(2, 302)
    for lo in (0, 120):  # two batches: the second crosses a capacity growth
        chunk = list(zip(ids[lo : lo + 180].tolist(), vecs[lo : lo + 180]))
        jidx.insert_update_delete(chunk)
        tidx.insert_update_delete(chunk)
    dels = [(int(i), None) for i in ids[::7]]
    update = [(5, _unit(1)[0])]
    for idx in (jidx, tidx):
        idx.insert_update_delete(dels)
        idx.insert_update_delete(update)
    assert len(tidx) == len(jidx) and tidx.capacity == jidx.capacity
    assert tidx.store.fitted == jidx.store.fitted
    queries = np.concatenate([vecs[:3], _unit(5)])
    _assert_same_search(jidx, tidx, queries, 10, float_metric=(kind == "plain"))
    fmask = np.zeros(tidx.capacity, bool)
    fmask[RNG.choice(np.arange(2, 302), 60, replace=False)] = True
    _assert_same_search(jidx, tidx, queries, 10, filter_mask=fmask, float_metric=(kind == "plain"))
    # k past the live count: empty slots are (inf, -1) on both sides
    _assert_same_search(jidx, tidx, queries[:2], 300, float_metric=(kind == "plain"))


def test_flat_index_reserved_ids_refused():
    idx = IndexFlat(_params("plain"), CPU)
    with pytest.raises(ValueError, match="reserved"):
        idx.insert_update_delete([(1, _unit(1)[0])])


@pytest.mark.parametrize("kind", ["plain", "binary-fixed", "binary-fitted"])
def test_flat_arrays_cross_both_ways(kind):
    params, jparams = _params(kind), _params(kind, jax_models)
    vecs = _unit(220)
    changes = list(zip(range(2, 222), vecs)) + [(9, None), (30, None)]
    queries = _unit(4)
    float_metric = kind == "plain"

    jidx = JaxIndexFlat(jparams)
    jidx.insert_update_delete(changes)
    jarrays = jidx.to_arrays()
    tidx = IndexFlat.from_arrays(params, jarrays, CPU)
    _assert_same_search(jidx, tidx, queries, 12, float_metric=float_metric)

    tsrc = IndexFlat(params, CPU)
    tsrc.insert_update_delete(changes)
    tarrays = tsrc.to_arrays()
    for key in ("vectors", "exists"):
        np.testing.assert_array_equal(tarrays[key], jarrays[key])
    if tarrays["store"]["fitted"]:
        assert tarrays["store"]["codes"].dtype == np.uint32
        np.testing.assert_array_equal(tarrays["store"]["codes"], jarrays["store"]["codes"])
    jback = JaxIndexFlat.from_arrays(jparams, tarrays)
    _assert_same_search(jback, tsrc, queries, 12, float_metric=float_metric)
    # Row-bounded arrays (what snapshots hold) re-pad on the same chain
    rows = 150
    bounded = {
        "vectors": jarrays["vectors"][:rows], "exists": jarrays["exists"][:rows],
        "store": dict(jarrays["store"]),
    }
    if bounded["store"]["fitted"]:
        bounded["store"]["codes"] = jarrays["store"]["codes"][:rows]
    jb, tb = JaxIndexFlat.from_arrays(jparams, bounded), IndexFlat.from_arrays(params, bounded, CPU)
    assert tb.capacity == jb.capacity
    _assert_same_search(jb, tb, queries, 12, float_metric=float_metric)
