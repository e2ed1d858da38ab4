"""The port's two-level coarse quantizer held against the JAX package's, on the CPU.

Past ``TWO_LEVEL_MIN_C`` clusters an IVF refit fits 512 super-centroids, then
the children of each super on its own members, refines them globally and
assigns over the nearest supers (``vectorstore/kmeans.py``). Here the
constants are patched low in both packages (``TWO_LEVEL_MIN_C`` 64, 8
supers, probe selection chunked), as ``tests/test_ivf.py`` does, and the
same numpy inputs go through both:

- the deterministic pieces are held on their outputs: ``_group_rows``
  (identical arrays), ``_kmeans_grouped`` (centroids within 1e-5 relative),
  ``kmeans_assign_two_level`` (top-t ids by the tie rule), a query on a
  JAX-built two-level index loaded through ``from_arrays`` (tie rule), and
  the placement of the same write in both (slab ids, overflow, locations);
- the fit, whose seeding cannot be reproduced (F6), on its quantization
  error and the recall of the index it builds;
- the device generator on its statistics, annbench on its device-data path.
"""

import dataclasses
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semadb_tpu.index.ivf as jax_ivf
import semadb_tpu.models as jax_models
import semadb_tpu.models.schema as jax_schema
import semadb_tpu.vectorstore.kmeans as jax_km
import semadb_tpu_torch.index.ivf as port_ivf
import semadb_tpu_torch.models as port_models
import semadb_tpu_torch.models.schema as port_schema
import semadb_tpu_torch.vectorstore.kmeans as port_km
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.store import open_store
from semadb_tpu_torch.tools import datasets as port_datasets

CPU = torch.device("cpu")
RTOL = 1e-5
DIM, C_TOTAL, SUPERS = 16, 128, 8


def _clustered(rng, n, dim=DIM, k=30):
    cents = rng.standard_normal((k, dim)).astype(np.float32) * 5
    return (cents[rng.integers(0, k, n)] + rng.standard_normal((n, dim)).astype(np.float32)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def two_level(monkeypatch):
    """The two-level path at a test's size in both packages."""
    for mod in (jax_ivf, port_ivf):
        monkeypatch.setattr(mod, "TWO_LEVEL_MIN_C", 64)
        monkeypatch.setattr(mod, "TWO_LEVEL_SUPERS", SUPERS)
        monkeypatch.setattr(mod, "PROBE_CHUNK_BYTES", 1)
        monkeypatch.setattr(mod, "PROBE_CHUNK_C", 32)


def _params(schema, copies=2, **kw):
    return schema.VectorIVFParams(vector_size=DIM, distance_metric="euclidean", num_clusters=C_TOTAL,
                                  assign_copies=copies, **kw)


# -- the deterministic pieces -----------------------------------------------------


@pytest.mark.parametrize("maxm", [128, 20], ids=["fast", "subsampled"])
def test_group_rows_is_identical(maxm):
    labels = np.random.default_rng(1).integers(0, 7, 300).astype(np.int32)
    labels[labels == 3] = 4  # an empty group
    want = jax_km._group_rows(labels, 8, maxm)
    got = port_km._group_rows(labels, 8, maxm)
    assert (np.bincount(labels).max() > maxm) == (maxm == 20)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


def _grouped_inputs(n=1200, groups=6, maxm=256, seed=2):
    rng = np.random.default_rng(seed)
    data = _clustered(rng, n, k=40)
    labels = rng.integers(0, groups, n).astype(np.int32)
    rows, w, cnt = port_km._group_rows(labels, groups, maxm)
    return data, rows, w, cnt


@pytest.mark.parametrize("kc,iters", [(8, 4), (16, 1)])
def test_kmeans_grouped_matches_jax(kc, iters):
    data, rows, w, cnt = _grouped_inputs()
    assert cnt.max() <= rows.shape[1]
    want = np.asarray(jax_km._kmeans_grouped(jnp.asarray(data), jnp.asarray(rows), jnp.asarray(w),
                                             jnp.asarray(cnt), kc, iters))
    got = port_km._kmeans_grouped(_t(data), _t(rows), _t(w), _t(cnt), kc, iters).numpy()
    assert got.shape == want.shape == (len(cnt), kc, DIM)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


def test_kmeans_grouped_inits_inside_a_subsampled_group():
    """A group larger than ``maxm`` is subsampled by ``_group_rows``, and its
    true count strides the JAX init past the gathered members, where
    ``take_along_axis`` fills NaN. The port strides over the members it
    gathered: it equals the JAX function given the counts clipped to maxm."""
    data, rows, w, cnt = _grouped_inputs(maxm=100)
    assert cnt.max() > 100
    args = (jnp.asarray(data), jnp.asarray(rows), jnp.asarray(w))
    assert np.isnan(np.asarray(jax_km._kmeans_grouped(*args, jnp.asarray(cnt), 8, 3))).any()
    want = np.asarray(jax_km._kmeans_grouped(*args, jnp.asarray(np.minimum(cnt, 100)), 8, 3))
    got = port_km._kmeans_grouped(_t(data), _t(rows), _t(w), _t(cnt), 8, 3).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def fitted():
    """Supers and children from a JAX two-level fit (the inputs of both
    assignments), over 3,000 clustered rows."""
    rng = np.random.default_rng(3)
    data = _clustered(rng, 3000)
    cents, _, sup = jax_km.kmeans_fit_two_level(jnp.asarray(data), C_TOTAL, iters=6, supers=SUPERS)
    return data, np.asarray(sup), np.asarray(cents)


def _assert_assign_agrees(data, cents, want, got, rows):
    assert got.shape == want.shape and got.dtype == np.int32
    x = data[rows].astype(np.float64)
    d = ((x[:, None, :] - cents[None, :, :].astype(np.float64)) ** 2).sum(-1)
    for r in range(len(rows)):
        errs = tie_rule_errors(d[r, want[r]], want[r].tolist(), d[r, got[r]], got[r].tolist(),
                               lambda c, r=r: d[r, c], atol=RTOL * float(d[r].max()))
        assert errs == [], (r, errs)


@pytest.mark.parametrize("n", [1500, 3000], ids=["n<=2048", "n>2048"])
@pytest.mark.parametrize("via_ids", [False, True], ids=["data", "row_ids"])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("n_sup", [1, 4, SUPERS], ids=["1", "4", "all"])
def test_assign_two_level_matches_jax(fitted, n, via_ids, t, n_sup):
    data, sup, cents = fitted
    if via_ids:
        rows = np.random.default_rng(n + t).permutation(len(data))[:n].astype(np.int32)
        want = jax_km.kmeans_assign_two_level(jnp.asarray(data), jnp.asarray(sup), jnp.asarray(cents), t,
                                              row_ids=jnp.asarray(rows), n_sup=n_sup)
        got = port_km.kmeans_assign_two_level(_t(data), _t(sup), _t(cents), t, row_ids=_t(rows), n_sup=n_sup)
    else:
        rows = np.arange(n)
        want = jax_km.kmeans_assign_two_level(jnp.asarray(data[:n]), jnp.asarray(sup), jnp.asarray(cents), t,
                                              n_sup=n_sup)
        got = port_km.kmeans_assign_two_level(_t(data[:n]), _t(sup), _t(cents), t, n_sup=n_sup)
    _assert_assign_agrees(data, cents, np.asarray(want), got.numpy(), rows)


def test_two_level_fit_with_full_coverage_is_flat():
    """With every super covered, the two-level assignment is the flat one,
    through data and through row ids, and the fit's labels are a fresh
    assignment over its ``final_n_sup`` nearest supers."""
    rng = np.random.default_rng(4)
    data = _t(rng.standard_normal((3000, DIM)).astype(np.float32))
    cents, labels, sup = port_km.kmeans_fit_two_level(data, 4 * 8, iters=6, supers=4)
    flat = port_km.kmeans_assign(data, cents, 2)
    assert torch.equal(port_km.kmeans_assign_two_level(data, sup, cents, 2, n_sup=4), flat)
    assert torch.equal(labels, flat[:, 0])
    perm = _t(np.random.default_rng(3).permutation(3000)[:1500].astype(np.int32))
    assert torch.equal(port_km.kmeans_assign_two_level(data, sup, cents, 2, row_ids=perm, n_sup=4),
                       flat[perm.long()])


@pytest.mark.parametrize("via_ids", [False, True], ids=["data", "row_ids"])
def test_two_level_fit_quality_matches_jax(via_ids):
    """The seeding differs (F6), so the fit is held on its quantization
    error: within 5% of the JAX fit's on the same rows. Its labels are a
    fresh assignment over the 8 nearest supers."""
    rng = np.random.default_rng(5)
    data = port_datasets.embedding_like(6000, DIM, 1, latent=8, spread=0.5, seed=5).train
    rows = rng.permutation(6000)[:5000].astype(np.int32) if via_ids else None
    kw_j = {"row_ids": jnp.asarray(rows)} if via_ids else {}
    kw_t = {"row_ids": _t(rows)} if via_ids else {}
    jc, jl, _ = jax_km.kmeans_fit_two_level(jnp.asarray(data), C_TOTAL, iters=8, supers=SUPERS, **kw_j)
    tc, tl, ts = port_km.kmeans_fit_two_level(_t(data), C_TOTAL, iters=8, supers=SUPERS, **kw_t)
    x = data[rows] if via_ids else data

    def qerr(c, lab):
        return float(((x - np.asarray(c)[np.asarray(lab)]) ** 2).sum(-1).mean())

    assert tc.shape == (C_TOTAL, DIM) and ts.shape == (SUPERS, DIM) and tl.dtype == torch.int32
    assert qerr(tc, tl) <= 1.05 * qerr(jc, jl), (qerr(tc, tl), qerr(jc, jl))
    fresh = port_km.kmeans_assign_two_level(_t(data), ts, tc, 1, n_sup=8, **kw_t)[:, 0]
    assert torch.equal(tl, fresh)


# -- the index: JAX-built arrays in the port, the port's own build -------------------


@pytest.fixture
def jax_built(two_level):
    rng = np.random.default_rng(6)
    vecs = _clustered(rng, 4000)
    ids = np.arange(2, 4002, dtype=np.int32)
    jidx = jax_ivf.IndexIVF(_params(jax_schema))
    jidx.insert_update_delete(zip(ids, vecs))
    assert jidx._sup_cents is not None and jidx.centroids.shape[0] == C_TOTAL
    return jidx, vecs, ids, rng


def _true_dist(vecs, q):
    d = ((vecs.astype(np.float64) - q.astype(np.float64)) ** 2).sum(-1)
    return lambda i: np.inf if i == -1 else float(d[int(i) - 2])


def _assert_same(want, got, vecs, queries):
    (wd, wi), (gd, gi) = want, got
    xmax = float(np.linalg.norm(vecs, axis=1).max())
    for b in range(len(queries)):
        atol = RTOL * ((xmax + float(np.linalg.norm(queries[b]))) ** 2 + 1.0)
        live = np.isfinite(wd[b])
        np.testing.assert_array_equal(gi[b][~live], -1)
        errs = tie_rule_errors(wd[b][live], wi[b][live].tolist(), gd[b][live], gi[b][live].tolist(),
                               _true_dist(vecs, queries[b]), atol=atol)
        assert errs == [], (b, errs[:3])


@pytest.mark.parametrize("kind", ["unfiltered", "selective", "broad"])
def test_query_parity_on_a_jax_built_two_level_index(jax_built, kind, monkeypatch):
    jidx, vecs, ids, rng = jax_built
    tidx = port_ivf.IndexIVF.from_arrays(_params(port_schema), jidx.to_arrays(), CPU)
    assert tidx._sup_cents is not None and torch.equal(tidx._sup_cents, _t(np.asarray(jidx._sup_cents)))
    queries = vecs[:24] + 0.3 * rng.standard_normal((24, DIM)).astype(np.float32)
    fm = None
    if kind != "unfiltered":
        fm = np.zeros(4096, bool)
        fm[ids[::41] if kind == "selective" else ids[ids % 2 == 0]] = True
        if kind == "broad":
            for mod in (jax_ivf, port_ivf):
                monkeypatch.setattr(mod, "FILTER_EXACT_CAP", 64)
    for k, probes in ((10, 24), (3, 4)):
        _assert_same(jidx.search_batch(queries, k, probes, filter_mask=fm),
                     tidx.search_batch(queries, k, probes, filter_mask=fm), vecs, queries)


def test_write_parity_after_the_fit(jax_built):
    """The same insert batch (new points and updates) into the JAX index and
    the port, both loaded from the JAX index's arrays, places every point
    alike: ``_place_fitted`` reaches the two-level ``_assign_top`` on both."""
    jidx, vecs, ids, rng = jax_built
    arrays = jidx.to_arrays()
    jload = jax_ivf.IndexIVF.from_arrays(_params(jax_schema), arrays)
    tload = port_ivf.IndexIVF.from_arrays(_params(port_schema), arrays, CPU)
    new = _clustered(rng, 300)
    changes = list(zip(range(5000, 5300), new)) + [(int(i), vecs[i - 2] + 0.5) for i in ids[:40]]
    for idx in (jload, tload):
        idx.insert_update_delete(changes)
    assert tload.repaired_writes == 0  # every row's two-level candidates lie among its own probes
    np.testing.assert_array_equal(np.asarray(jload.slab_ids), tload.slab_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jload.ovf_ids), tload.ovf_ids.numpy())
    assert tload._loc == jload._loc
    assert {i: sorted(v) for i, v in tload._loc2.items()} == {i: sorted(v) for i, v in jload._loc2.items()}
    np.testing.assert_array_equal(jload._fill, tload._fill)
    assert sorted(tload._ovf_free) == sorted(jload._ovf_free)


def test_written_points_land_within_their_own_probes(monkeypatch):
    """Points from another mixture written into a JAX-built two-level index
    (2,048 clusters under 128 supers, 64-d): the JAX package places some
    where a search for the point itself does not look, so the point does
    not come back as its own nearest neighbour. The port places those rows
    by their own probes and finds every point."""
    for mod in (jax_ivf, port_ivf):
        monkeypatch.setattr(mod, "TWO_LEVEL_MIN_C", 64)
        monkeypatch.setattr(mod, "TWO_LEVEL_SUPERS", 128)
    corpus = port_datasets.embedding_like(20000, 64, 1, spread=0.5, seed=5).train
    new = port_datasets.embedding_like(2000, 64, 1, spread=0.5, seed=6).train[:500]
    params = {s: s.VectorIVFParams(vector_size=64, distance_metric="euclidean", num_clusters=2048, assign_copies=2)
              for s in (jax_schema, port_schema)}
    jidx = jax_ivf.IndexIVF(params[jax_schema])
    jidx.insert_update_delete(zip(range(2, 20002), corpus))
    assert jidx._sup_cents is not None
    tidx = port_ivf.IndexIVF.from_arrays(params[port_schema], jidx.to_arrays(), CPU)
    new_ids = np.arange(30000, 30500)
    lost = {}
    for name, idx in (("jax", jidx), ("port", tidx)):
        idx.insert_update_delete(zip(new_ids.tolist(), new))
        lost[name] = int((idx.search_batch(new, 1)[1][:, 0] != new_ids).sum())
    assert lost["jax"] > 0 and lost["port"] == 0, lost
    assert tidx.repaired_writes > 0


def test_port_two_level_build_recall(two_level):
    """The port's own two-level build: the recall the JAX test asks of its
    build (>= 0.95 at 24 probes), a write through the two-level assignment,
    and a reload that carries the super layer."""
    rng = np.random.default_rng(11)
    vecs = _clustered(rng, 4000, k=20)
    ids = np.arange(2, 4002, dtype=np.int32)
    idx = port_ivf.IndexIVF(_params(port_schema), CPU)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx._sup_cents is not None and idx.centroids.shape[0] == C_TOTAL
    assert set(idx.refit_seconds) >= {"kmeans_super_fit_s", "kmeans_child_fit_s", "kmeans_final_labels_s"}
    queries = vecs[:32]
    _, got = idx.search_batch(queries, 10, num_probes=24)
    hits = sum(len(set(ids[np.argsort(((vecs - q) ** 2).sum(-1))[:10]]) & set(g)) / 10 for q, g in zip(queries, got))
    assert hits / 32 >= 0.95, hits / 32
    nv = rng.standard_normal((5, DIM)).astype(np.float32)
    idx.insert_update_delete(zip(range(9000, 9005), nv))
    assert idx.search_batch(nv, 1, num_probes=24)[1][:, 0].tolist() == list(range(9000, 9005))
    idx2 = port_ivf.IndexIVF.from_arrays(idx.params, idx.to_arrays(), CPU)
    assert idx2._sup_cents is not None
    assert np.array_equal(idx.search_batch(queries, 10, 16)[1], idx2.search_batch(queries, 10, 16)[1])


def test_refit_to_a_flat_count_drops_the_super_layer(two_level):
    """A later refit below TWO_LEVEL_MIN_C binds no super layer, and one
    past it binds a new one with its centroids."""
    rng = np.random.default_rng(12)
    idx = port_ivf.IndexIVF(_params(port_schema), CPU)
    idx.insert_update_delete(zip(range(2, 1002), _clustered(rng, 1000)))
    first = idx._sup_cents
    assert first is not None and idx.centroids.shape[0] == C_TOTAL
    idx.params = dataclasses.replace(idx.params, num_clusters=32)
    idx._refit()
    assert idx._sup_cents is None and idx.centroids.shape[0] == 32
    idx.params = _params(port_schema)
    idx._refit()
    assert idx._sup_cents is not None and idx._sup_cents is not first


# -- snapshots -----------------------------------------------------------------------


def _collection(models):
    schema = models.IndexSchema.from_dict({"v": {"type": "vectorIVF", "vectorIVF": {
        "vectorSize": DIM, "distanceMetric": "euclidean", "numClusters": C_TOTAL, "assignCopies": 2}}})
    return models.Collection(user_id="u1", id="c1", index_schema=schema, user_plan=models.UserPlan())


def _requests(models, queries):
    return [models.SearchRequest.from_dict({"query": {"property": "v", "vectorIVF": {
        "vector": q.tolist(), "limit": 5, "numProbes": 24}}, "limit": 5}) for q in queries]


def _points(models, vecs):
    return [models.Point.from_map({"v": v.tolist()}, uuid.UUID(int=i + 1)) for i, v in enumerate(vecs)]


def _shard_ivf(sh):
    (idx,) = sh.device_indices.values()
    return idx


def test_two_level_shard_snapshot_roundtrip(tmp_path, two_level):
    vecs = _clustered(np.random.default_rng(13), 3000)
    path = str(tmp_path / "s1")
    sh = Shard(open_store(path), _collection(port_models), CPU)
    sh.insert_points(_points(port_models, vecs))
    assert _shard_ivf(sh)._sup_cents is not None
    want = sh.search_points_batch_wire(_requests(port_models, vecs[:8]))
    sup = _shard_ivf(sh)._sup_cents.clone()
    sh.flush()
    sh.close()
    sh2 = Shard(open_store(path), _collection(port_models), CPU)
    try:
        assert torch.equal(_shard_ivf(sh2)._sup_cents, sup)
        assert sh2.search_points_batch_wire(_requests(port_models, vecs[:8])) == want
    finally:
        sh2.close()


def test_jax_written_two_level_shard_opens_in_port(tmp_path, two_level):
    rng = np.random.default_rng(14)
    vecs = _clustered(rng, 3000)
    queries = vecs[:10] + 0.2 * rng.standard_normal((10, DIM)).astype(np.float32)
    path = str(tmp_path / "s.sdb")
    jsh = JaxShard(jax_open_store(path), _collection(jax_models))
    jsh.insert_points(_points(jax_models, vecs))
    (jidx,) = jsh.device_indices.values()
    assert jidx._sup_cents is not None
    want = jsh.search_points_batch_wire(_requests(jax_models, queries))
    jsh.close()
    tsh = Shard(open_store(path), _collection(port_models), CPU)
    try:
        assert _shard_ivf(tsh)._sup_cents is not None
        got = tsh.search_points_batch_wire(_requests(port_models, queries))
    finally:
        tsh.close()
    row_of = {str(uuid.UUID(int=i + 1)): i for i in range(len(vecs))}
    for q, wrow, grow in zip(queries, want, got):
        d = ((vecs.astype(np.float64) - q) ** 2).sum(-1)
        errs = tie_rule_errors([p["_distance"] for p in wrow], [p["_id"] for p in wrow],
                               [p["_distance"] for p in grow], [p["_id"] for p in grow],
                               lambda pid: d[row_of[pid]], atol=RTOL * (1.0 + float(d.max())))
        assert errs == [], errs


# -- the device generator and annbench's device-data path -------------------------------


def _margin(train, test, k=10):
    d = ((test[:, None, :].astype(np.float64) - train[None, :, :]) ** 2).sum(-1)
    dk = np.sqrt(np.sort(d, axis=1)[:, k - 1])
    rng = np.random.default_rng(0)
    ra, rb = rng.integers(0, len(train), 4096), rng.integers(0, len(train), 4096)
    return float(dk.mean() / np.linalg.norm(train[ra] - train[rb], axis=1).mean())


@pytest.mark.parametrize("dim,latent", [(64, 64), (32, 64)], ids=["latent=dim", "latent clamped"])
def test_embedding_like_device_statistics(dim, latent):
    """Shapes, seed determinism, the neighbour margin within 0.03 of the
    host generator's at the same size, and unit rows under cosine."""
    kw = dict(latent=latent, spread=0.5, seed=7)
    ds = port_datasets.embedding_like_device(6000, dim, 64, device=CPU, **kw)
    assert ds.train.shape == (6000, dim) and ds.test.shape == (64, dim)
    assert ds.train.dtype == torch.float32 and ds.train.device == CPU and ds.metric == "euclidean"
    again = port_datasets.embedding_like_device(6000, dim, 64, device=CPU, **kw)
    assert torch.equal(ds.train, again.train) and torch.equal(ds.test, again.test)
    other = port_datasets.embedding_like_device(6000, dim, 64, device=CPU, **{**kw, "seed": 8})
    assert not torch.equal(ds.train, other.train)
    host = port_datasets.embedding_like(6000, dim, 64, **kw)
    m_dev, m_host = _margin(ds.train.numpy(), ds.test.numpy()), _margin(host.train, host.test)
    assert abs(m_dev - m_host) <= 0.03, (m_dev, m_host)
    cos = port_datasets.embedding_like_device(2000, dim, 16, metric="cosine", device=CPU, **kw)
    np.testing.assert_allclose(torch.linalg.vector_norm(cos.train, dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(cos.test, dim=1).numpy(), 1.0, rtol=1e-5)


def test_embedding_like_device_in_row_blocks(monkeypatch):
    """Rows made a block at a time (the last block short) fill the whole
    tensor with the same mixture: no row is left unwritten, the margin stays
    within 0.03 of the host generator's, and cosine rows are unit rows."""
    monkeypatch.setattr(port_datasets, "GEN_BLOCK_ROWS", 1000)
    kw = dict(latent=64, spread=0.5, seed=7)
    ds = port_datasets.embedding_like_device(6500, 64, 64, device=CPU, **kw)
    assert ds.train.shape == (6500, 64) and bool(torch.isfinite(ds.train).all())
    assert float(torch.linalg.vector_norm(ds.train, dim=1).min()) > 0.5  # every block was written
    host = port_datasets.embedding_like(6500, 64, 64, **kw)
    m_dev, m_host = _margin(ds.train.numpy(), ds.test.numpy()), _margin(host.train, host.test)
    assert abs(m_dev - m_host) <= 0.03, (m_dev, m_host)
    cos = port_datasets.embedding_like_device(2500, 64, 16, metric="cosine", device=CPU, **kw)
    np.testing.assert_allclose(torch.linalg.vector_norm(cos.train, dim=1).numpy(), 1.0, rtol=1e-5)


def test_annbench_device_data_path_on_cpu():
    """annbench's ``run`` on a dataset from the device generator on ``cpu``
    (``main`` takes that generator from N x D >= 2^28 on a card): the build
    adopts the corpus tensor, recall and eps-recall come out, and the sweep
    gives one row per extra probe count."""
    from semadb_tpu_torch.tools import annbench

    ds = port_datasets.embedding_like_device(3000, DIM, 96, spread=0.5, device=CPU)
    keep = {}
    out = annbench.run(ds, k=10, batch=32, device=CPU, keep=keep, sweep=[4, 24, 48], assign_copies=2)
    assert ds.train is None  # the build took the corpus over
    assert out["generator"] == "device" and out["n"] == 3000 and out["probes"] == 24
    assert out["recall@10"] >= 0.95 and out["recall_eps@10"] >= out["recall@10"]
    assert [row["probes"] for row in out["sweep"]] == [4, 48]
    assert out["sweep"][1]["recall@10"] >= out["sweep"][0]["recall@10"]
    assert keep["index"].vectors.shape[0] >= 3002 and torch.equal(keep["queries"], ds.test)
