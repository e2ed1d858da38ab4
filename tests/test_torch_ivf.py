"""The port's IVF engine held against the JAX package's, on the CPU.

- Query parity: a JAX ``IndexIVF`` is built on a seeded corpus, its
  ``to_arrays`` go through the port's ``from_arrays``, and the same queries
  go to both. On CPU tensors the port runs K3's and K4's plain versions.
  Results agree by the tie rule (``semadb_tpu_torch.ops.topk``), distances
  within 1e-5 of the summed terms' magnitude (the sums run in another
  order). Cases: f32 and bf16 slabs, assignCopies 1 and 2, all three
  metrics, projected traversal at D = 160, the chunked overflow scan, a
  selective filter (the exact member scan) and a broad one (wider probes).
- Build: the port's own k-means build reaches the JAX build's recall@10,
  less 0.01, against ``compute_ground_truth``. The two cannot agree bit for
  bit: JAX's ``random.choice`` seeds the JAX fit.
- Behaviour: the non-PQ, single-level cases of ``tests/test_ivf.py`` on the
  port, plus the write order that keeps a concurrent search from scoring a
  slot before its row is written.
- Wiring: ``vectorIVF`` through the port's shard and HTTP v2 server, a shard
  written by the JAX package opened by the port, and the refusal of a
  product quantizer.
"""

import threading
import uuid

import numpy as np
import pytest
import requests
import torch

import semadb_tpu.index.ivf as jax_ivf
import semadb_tpu.models as jax_models
import semadb_tpu.models.schema as jax_schema
import semadb_tpu_torch.index.ivf as port_ivf
import semadb_tpu_torch.models as port_models
import semadb_tpu_torch.models.schema as port_schema
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
from semadb_tpu_torch.httpapi.server import HttpApiConfig, HttpServer
from semadb_tpu_torch.index.manager import check_supported
from semadb_tpu_torch.models.errors import ValidationError
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.store import open_store
from semadb_tpu_torch.tools.datasets import compute_ground_truth, embedding_like

CPU = torch.device("cpu")
RTOL = 1e-5
HEADERS = {"X-User-Id": "ivfu", "X-Plan-Id": "BASIC"}


def _params(schema=port_schema, dim=16, metric="euclidean", **kw):
    return schema.VectorIVFParams(vector_size=dim, distance_metric=metric, **kw)


def _port(dim=16, metric="euclidean", **kw) -> port_ivf.IndexIVF:
    return port_ivf.IndexIVF(_params(port_schema, dim, metric, **kw), CPU)


def _clustered(rng, n, dim=16, k=20):
    cents = rng.standard_normal((k, dim)).astype(np.float32) * 5
    return (cents[rng.integers(0, k, n)] + rng.standard_normal((n, dim)).astype(np.float32)).astype(np.float32)


def _true_dist(vecs, q, metric):
    """id → the exact metric distance of row id - 2 of ``vecs`` to q (f64)."""
    x = vecs.astype(np.float64)
    if metric == "euclidean":
        d = ((x - q.astype(np.float64)) ** 2).sum(-1)
    else:
        dot = x @ q.astype(np.float64)
        d = 1.0 - dot if metric == "cosine" else -dot
    return lambda i: np.inf if i == -1 else float(d[int(i) - 2])


def _assert_same(want, got, vecs, queries, metric):
    """Every row of got (dists, ids) against want by the tie rule."""
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


def _exact_top(vecs, ids, q, k):
    return ids[np.argsort(((vecs - q[None, :]) ** 2).sum(-1))[:k]]


# -- query parity ---------------------------------------------------------------

# name: (dim, metric, copies, n, module patches)
PARITY = {
    "euclidean-copies1": (16, "euclidean", 1, 3000, {}),
    "euclidean-copies2": (16, "euclidean", 2, 3000, {}),
    "dot": (16, "dot", 1, 2000, {}),
    "cosine-copies2": (16, "cosine", 2, 2000, {}),
    "bf16-slabs": (32, "euclidean", 2, 3000, {"SLAB_BF16_BYTES": 1}),
    "projected-160": (160, "euclidean", 1, 1500, {}),
    "projected-160-cosine": (160, "cosine", 2, 1500, {}),
    "chunked-overflow": (32, "euclidean", 1, 300, {"OVF_CHUNK_BYTES": 1}),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_query_parity_with_jax(case, monkeypatch):
    dim, metric, copies, n, patches = PARITY[case]
    for mod in (jax_ivf, port_ivf):
        for name, value in patches.items():
            monkeypatch.setattr(mod, name, value)
    if case == "chunked-overflow":
        monkeypatch.setattr(port_ivf, "OVF_CHUNK_ROWS", 64)
    rng = np.random.default_rng(sum(map(ord, case)))
    vecs = _clustered(rng, n, dim)
    if metric == "cosine":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = np.arange(2, n + 2, dtype=np.int32)
    jidx = jax_ivf.IndexIVF(_params(jax_schema, dim, metric, assign_copies=copies))
    jidx.insert_update_delete(zip(ids, vecs))
    tidx = port_ivf.IndexIVF.from_arrays(_params(port_schema, dim, metric, assign_copies=copies),
                                         jidx.to_arrays(), CPU)
    if case == "chunked-overflow":
        assert tidx._n_at_fit == 0 and tidx.ovf_ids.shape[0] > 64
    else:
        assert tidx._n_at_fit == n
    if dim > jax_ivf.PROJ_DIM:
        assert tidx._proj is not None and tidx.slabs.shape[-1] == jax_ivf.PROJ_DIM
    want_bf16 = "SLAB_BF16_BYTES" in patches
    assert (tidx.slabs.dtype == torch.bfloat16) == want_bf16
    assert len(tidx) == len(jidx) and tidx.capacity == jidx.capacity
    queries = vecs[:24] + 0.3 * rng.standard_normal((24, dim)).astype(np.float32)
    if metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    for k, probes in ((10, 0), (3, 2)):
        _assert_same(jidx.search_batch(queries, k, probes), tidx.search_batch(queries, k, probes),
                     vecs, queries, metric)


@pytest.fixture(scope="module")
def filtered_pair():
    rng = np.random.default_rng(404)
    vecs = _clustered(rng, 3000)
    ids = np.arange(2, 3002, dtype=np.int32)
    jidx = jax_ivf.IndexIVF(_params(jax_schema, assign_copies=2))
    jidx.insert_update_delete(zip(ids, vecs))
    tidx = port_ivf.IndexIVF.from_arrays(_params(port_schema, assign_copies=2), jidx.to_arrays(), CPU)
    return jidx, tidx, vecs, ids


@pytest.mark.parametrize("kind", ["selective", "broad"])
def test_filtered_query_parity_with_jax(filtered_pair, kind, monkeypatch):
    """A selective filter goes to the exact member scan, a broad one to
    FILTER_WIDEN times the probes with the mask inside K3 and the overflow
    scan; both packages take the same route."""
    jidx, tidx, vecs, ids = filtered_pair
    fm = np.zeros(4096, bool)
    members = ids[::41] if kind == "selective" else ids[ids % 2 == 0]
    fm[members] = True
    probes = 0 if kind == "selective" else 2
    if kind == "broad":
        for mod in (jax_ivf, port_ivf):
            monkeypatch.setattr(mod, "FILTER_EXACT_CAP", 64)
        assert len(members) > max(tidx._num_probes(probes) * tidx.slab, 64)
    calls = []
    monkeypatch.setattr(tidx, "_member_exact", lambda *a, _f=tidx._member_exact: calls.append(1) or _f(*a))
    queries = vecs[1:17]
    want = jidx.search_batch(queries, 5, probes, filter_mask=fm)
    got = tidx.search_batch(queries, 5, probes, filter_mask=fm)
    assert bool(calls) == (kind == "selective")
    assert set(got[1][got[1] >= 0].tolist()) <= set(members.tolist())
    _assert_same(want, got, vecs, queries, "euclidean")
    if kind == "selective":  # exact: the members' own top-5
        for b in range(len(queries)):
            assert got[1][b].tolist() == _exact_top(vecs[members - 2], members, queries[b], 5).tolist()


def test_port_build_recall_matches_jax():
    """The port's own build (k-means, packing, SOAR copies, slabs) reaches
    the JAX build's recall@10 on the same corpus, less 0.01."""
    ds = embedding_like(4000, 32, 64, latent=16, seed=21, spread=0.5)
    gt = compute_ground_truth(ds, 10) + 2
    ids = np.arange(2, len(ds.train) + 2, dtype=np.int32)
    jidx = jax_ivf.IndexIVF(_params(jax_schema, 32, assign_copies=2))
    jidx.insert_update_delete(zip(ids, ds.train))
    tidx = _port(32, assign_copies=2)
    tidx.insert_bulk(ids, ds.train)
    assert tidx.centroids.shape == jidx.centroids.shape and tidx.slab == jidx.slab
    recall = {}
    for name, idx in (("jax", jidx), ("port", tidx)):
        _, got = idx.search_batch(ds.test, 10, num_probes=4)
        recall[name] = float(np.mean([len(set(got[b]) & set(gt[b])) / 10 for b in range(len(gt))]))
    assert recall["port"] >= recall["jax"] - 0.01, recall
    assert recall["port"] >= 0.9, recall


# -- behaviour (mirrors tests/test_ivf.py) ----------------------------------------


def test_prefit_exact():
    idx = _port()
    vecs = _clustered(np.random.default_rng(1), 100)
    ids = np.arange(2, 102, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert len(idx) == 100 and idx._n_at_fit == 0
    d, i = idx.search_batch(vecs[:5], k=3)
    assert list(i[:, 0]) == list(ids[:5]) and d[0, 0] == pytest.approx(0.0, abs=1e-4)


def test_fit_recall_crud_and_delete():
    rng = np.random.default_rng(2)
    idx = _port()
    vecs = _clustered(rng, 3000)
    ids = np.arange(2, 3002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx._n_at_fit == 3000
    _, i = idx.search_batch(vecs[:32], k=10)
    hits = np.mean([len(set(_exact_top(vecs, ids, vecs[b], 10)) & set(i[b])) / 10 for b in range(32)])
    assert hits >= 0.95, hits
    q = vecs[0]
    idx.insert_update_delete([(2, None)])
    assert len(idx) == 2999
    assert 2 not in idx.search_batch(q[None, :], k=5)[1][0]
    idx.insert_update_delete([(3, q)])  # update: move point 3 onto the query
    d, i = idx.search_batch(q[None, :], k=1)
    assert i[0, 0] == 3 and d[0, 0] == pytest.approx(0.0, abs=1e-4)
    idx.insert_update_delete([(2, np.full(16, 99.0, np.float32))])
    assert len(idx) == 3000
    assert idx.search_batch(np.full((1, 16), 99.0, np.float32), k=1)[1][0, 0] == 2


def test_dot_and_cosine_metrics():
    rng = np.random.default_rng(3)
    for metric in ("dot", "cosine"):
        idx = _port(metric=metric)
        vecs = _clustered(rng, 800)
        if metric == "cosine":
            vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        idx.insert_update_delete(zip(np.arange(2, 802, dtype=np.int32), vecs))
        d, i = idx.search_batch(vecs[:4], k=3)
        if metric == "cosine":
            assert list(i[:, 0]) == [2, 3, 4, 5] and d[0, 0] == pytest.approx(0.0, abs=1e-3)
        else:
            assert d[0, 0] == pytest.approx(-float(vecs[int(i[0, 0]) - 2] @ vecs[0]), rel=1e-5)


@pytest.mark.parametrize("after_delete", [False, True])
def test_persistence_roundtrip(after_delete):
    """to_arrays → from_arrays in the port, and across to the JAX package,
    answers the same; _fill comes back as a high-water mark, so inserts
    after a reload never overwrite a live slot."""
    rng = np.random.default_rng(4)
    idx = _port(assign_copies=2)
    vecs = _clustered(rng, 1500)
    ids = np.arange(2, 1502, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    victims = []
    if after_delete:  # the lowest live slot of clusters with 2+ members: holes below the mark
        slab_ids = idx.slab_ids.numpy()
        for c in range(slab_ids.shape[0]):
            live = np.nonzero(slab_ids[c] != -1)[0]
            if len(live) >= 2 and int(slab_ids[c, live[0]]) not in victims:
                victims.append(int(slab_ids[c, live[0]]))
            if len(victims) >= 8:
                break
        idx.insert_update_delete([(v, None) for v in victims])
    arrays = idx.to_arrays()
    idx2 = port_ivf.IndexIVF.from_arrays(idx.params, arrays, CPU)
    np.testing.assert_array_equal(idx2._fill, idx._fill)
    assert len(idx2) == len(idx) and idx2.capacity == idx.capacity
    jidx = jax_ivf.IndexIVF.from_arrays(_params(jax_schema, assign_copies=2), arrays)
    q = vecs[:16]
    for other in (idx2.search_batch(q, 5), jidx.search_batch(q, 5)):
        _assert_same(idx.search_batch(q, 5), other, vecs, q, "euclidean")
    new_ids = np.arange(5000, 5064, dtype=np.int32)
    idx2.insert_update_delete(zip(new_ids, _clustered(rng, 64)))
    survivors = [int(i) for i in ids if int(i) not in victims]
    assert len(idx2) == len(survivors) + 64
    sample = survivors[:: max(1, len(survivors) // 50)]
    _, i = idx2.search_batch(np.stack([vecs[s - 2] for s in sample]), k=1)
    assert i[:, 0].tolist() == sample
    slab_ids2 = idx2.slab_ids.numpy()
    assert all(slab_ids2[l[1], l[2]] == nid for nid, l in idx2._loc.items() if l[0] == "s")


def test_deferred_fit_placeholders():
    """A delete between a defer_fit bulk insert and flush_pending drops the
    placeholder only; to_arrays in the placeholder window materialises."""
    rng = np.random.default_rng(5)
    n = 600
    vecs = _clustered(rng, n, dim=8)
    ids = np.arange(2, 2 + n, dtype=np.int32)
    idx = _port(dim=8)
    idx.insert_bulk(ids, torch.from_numpy(vecs), defer_fit=True)
    assert idx._has_placeholders() and idx.snapshot_row_bounds()["vectors"] == n + 2
    idx.insert_update_delete([(int(i), None) for i in ids[:5]])
    assert -1 not in idx._ovf_free
    idx.flush_pending()
    assert not idx._has_placeholders() and len(idx) == n - 5
    assert list(idx.search_batch(vecs[5:10], k=1)[1][:, 0]) == list(ids[5:10])
    assert not set(ids[:5].tolist()) & set(idx.search_batch(vecs[:5], k=3)[1].ravel().tolist())

    idx = _port(dim=8)
    idx.insert_bulk(ids, vecs, defer_fit=True)
    idx2 = port_ivf.IndexIVF.from_arrays(idx.params, idx.to_arrays(), CPU)
    assert len(idx2) == n and not idx._has_placeholders()
    assert list(idx2.search_batch(vecs[:5], k=1)[1][:, 0]) == list(ids[:5])


@pytest.mark.parametrize("copies", [1, 2])
def test_spill_relocation_keeps_overflow_empty(copies):
    ds = embedding_like(20000, 32, 8, latent=16, seed=7)
    ids = np.arange(2, 20002, dtype=np.int32)
    idx = _port(dim=32, assign_copies=copies)
    idx.insert_bulk(ids, ds.train)
    n_ovf = sum(1 for l in idx._loc.values() if l[0] == "o")
    assert n_ovf <= len(ids) // 1000, n_ovf
    assert (copies > 1) == bool(idx._loc2)
    _, i = idx.search_batch(ds.train[:32], 1, num_probes=8)
    assert (i[:, 0] == ids[:32]).mean() > 0.9


def test_auto_slab():
    assert port_ivf._auto_slab(2, 10_000_000, 131072, 128, 128) == 192
    assert port_ivf._auto_slab(2, 1000, 128, 16, 128) == 128
    assert port_ivf._auto_slab(2, 1_000_000, 4096, 128, 64) == 640
    assert port_ivf._auto_slab(2, 0, 128, 16, 128) == 128
    vecs = _clustered(np.random.default_rng(6), 4096, dim=16, k=16)
    idx = _port(num_clusters=16, assign_copies=2)
    assert idx.slab == 128
    idx.insert_update_delete(zip(np.arange(2, 4098, dtype=np.int32), vecs))
    assert idx.slab >= 640 and idx.slabs.shape[1] == idx.slab
    assert np.array_equal(idx.search_batch(vecs[:8], k=1, num_probes=8)[1][:, 0], np.arange(2, 10))
    fixed = _port(num_clusters=16, assign_copies=2, slab_size=512)
    fixed.insert_update_delete(zip(np.arange(2, 4098, dtype=np.int32), vecs))
    assert fixed.slab == 512


def test_reload_capacity_matches_live(monkeypatch):
    """A row-bounded snapshot re-pads to the live capacity (the pregrow
    shape), not to a larger bucket of the growth chain."""
    import semadb_tpu_torch.utils.grow as grow

    monkeypatch.setattr(grow, "PREGROW_ROWS", 5000)
    monkeypatch.setattr(port_ivf, "initial_capacity", grow.initial_capacity)
    vecs = np.random.default_rng(6).standard_normal((4500, 16)).astype(np.float32)
    idx = _port()
    idx.insert_bulk(np.arange(2, 4502, dtype=np.int64), vecs)
    assert idx.capacity == 8192
    arrays = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in idx.device_arrays().items()}
    arrays["vectors"] = arrays["vectors"][: idx.snapshot_row_bounds()["vectors"]]
    idx2 = port_ivf.IndexIVF.from_arrays(idx.params, arrays, CPU)
    assert idx2.capacity == idx.capacity
    assert set(idx.search_batch(vecs[77:78], 10)[1][0]) == set(idx2.search_batch(vecs[77:78], 10)[1][0])


def test_search_while_insert_sees_only_written_rows(monkeypatch):
    """Placement writes slabs and norms before slab_ids, the write that makes
    a slot visible; searches running beside a writer only ever score slots
    whose rows are written (every coarse score equals the row's own)."""
    rng = np.random.default_rng(8)
    idx = _port(dim=8, assign_copies=2)
    base = rng.standard_normal((800, 8)).astype(np.float32)
    idx.insert_update_delete(zip(range(2, 802), base))
    order = []
    set_cells = idx._set_cells
    monkeypatch.setattr(idx, "_set_cells", lambda name, *a: order.append(name) or set_cells(name, *a))
    idx.insert_update_delete([(5000, base[0] + 0.01)])
    assert order.index("slab_ids") > max(order.index("slabs"), order.index("slab_sq")), order

    vec_of = {i + 2: base[i] for i in range(800)}
    more = {20_000 + j: rng.standard_normal(8).astype(np.float32) for j in range(600)}
    vec_of.update(more)
    vec_of[5000] = base[0] + 0.01
    errors = []
    scan = port_ivf.ivf_probe_scan

    def checked_scan(qp, probe, slabs, slab_sq, slab_ids, mask, rr):
        d, i = scan(qp, probe, slabs, slab_sq, slab_ids, mask, rr)
        for b in range(qp.shape[0]):
            for dd, nid in zip(d[b].tolist(), i[b].tolist()):
                if nid != -1:
                    x = vec_of[nid].astype(np.float64)
                    true = float(x @ x) - 2.0 * float(x @ qp[b].double().numpy())
                    if abs(true - dd) > 1e-3 * (1.0 + abs(true)):
                        errors.append((nid, dd, true))
        return d, i

    monkeypatch.setattr(port_ivf, "ivf_probe_scan", checked_scan)
    stop = threading.Event()

    def writer():
        keys = list(more)
        for lo in range(0, len(keys), 100):
            idx.insert_update_delete((k, more[k]) for k in keys[lo : lo + 100])
        stop.set()

    def searcher():
        while not stop.is_set():
            d, i = idx.search_batch(base[:8], k=5)
            assert i.shape == (8, 5)

    ts = [threading.Thread(target=f) for f in (writer, searcher, searcher)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errors, errors[:3]
    assert len(idx) == 800 + 1 + 600
    assert idx.search_batch(more[20_137][None, :], 1)[1][0, 0] == 20_137


def test_refit_binds_the_overflow_free_list_with_its_pool():
    """A refit binds the new overflow pool and its free list under one hold
    of ``_state_lock``. A search skips the overflow scan when the free list
    is as long as the pool; had the lock been released between the two
    bindings, a search there would pair the new pool (live spilled rows)
    with the old, full free list and drop the spilled points. The JAX
    package always scans its overflow pool. Here a deferred bulk load of 515
    points into 16 clusters of 32 slots spills 3 into a pool of 8, the size
    of the pre-fit pool; every release of the lock checks what a search can
    see, and a search right after the refit's bind must find the spilled
    points."""
    rng = np.random.default_rng(1)
    cents = rng.standard_normal((16, 8)).astype(np.float32) * 20
    lab = np.concatenate([np.repeat(np.arange(16), 32), [0, 0, 0]])
    vecs = (cents[lab] + rng.standard_normal((len(lab), 8)).astype(np.float32)).astype(np.float32)
    ids = np.arange(2, 2 + len(vecs), dtype=np.int32)
    idx = _port(dim=8, num_clusters=16, slab_size=32)
    idx.insert_bulk(ids, vecs, defer_fit=True)
    pool0 = idx.ovf_ids
    assert pool0.shape[0] == len(idx._ovf_free) == 8
    seen, window = [], {}
    lock = threading.RLock()

    class CheckedLock:
        def __enter__(self):
            lock.acquire()

        def __exit__(self, *exc):
            pool = idx.ovf_ids
            if pool.shape[0] == len(idx._ovf_free) and bool((pool != -1).any()):
                seen.append((pool.shape[0], int((pool != -1).sum())))
            lock.release()
            if pool is not pool0 and "found" not in window:
                window["found"] = None  # the search below takes the lock too
                window["found"] = idx.search_batch(vecs, k=1)[1][:, 0]

    idx._state_lock = CheckedLock()
    idx.flush_pending()
    spilled = sorted(i for i, loc in idx._loc.items() if loc[0] == "o")
    assert idx.ovf_ids.shape[0] == 8 and 1 <= len(spilled) <= 4, (idx.ovf_ids.shape, spilled)
    assert seen == [], f"a search could see a live overflow row beside a full free list: {seen}"
    for found in (window["found"], idx.search_batch(vecs, k=1)[1][:, 0]):
        assert [int(found[i - 2]) for i in spilled] == spilled


# -- wiring: shard, HTTP v2, JAX-written shard files --------------------------------

IVF_SCHEMA = {"emb": {"type": "vectorIVF", "vectorIVF": {"vectorSize": 8, "distanceMetric": "euclidean"}}}


def test_shard_and_http_integration(tmp_path):
    node = ClusterNode(ClusterNodeConfig(root_dir=str(tmp_path), rpc_host="127.0.0.1", rpc_port=0), CPU)
    node.serve()
    srv = HttpServer(node, HttpApiConfig(http_host="127.0.0.1", http_port=0,
                                         user_plans={"BASIC": port_models.UserPlan(name="BASIC", max_collections=2)}))
    srv.serve_background()
    base = f"http://127.0.0.1:{srv.port}/v2/collections"
    try:
        r = requests.post(base, json={"id": "ivfcol", "indexSchema": IVF_SCHEMA}, headers=HEADERS)
        assert r.status_code == 200, r.text
        vecs = _clustered(np.random.default_rng(9), 1200, dim=8)
        pts = [{"_id": str(uuid.UUID(int=j)), "emb": vecs[j].tolist()} for j in range(1200)]
        r = requests.post(f"{base}/ivfcol/points", json={"points": pts}, headers=HEADERS)
        assert r.status_code == 200 and r.json()["failedRanges"] == [], r.text

        def search(j, **extra):
            body = {"query": {"property": "emb", "vectorIVF": {
                "vector": vecs[j].tolist(), "operator": "near", "limit": 3, **extra}}, "limit": 3}
            r = requests.post(f"{base}/ivfcol/points/search", json=body, headers=HEADERS)
            assert r.status_code == 200, r.text
            return r.json()["points"]

        got = search(7, numProbes=8)
        assert got[0]["_id"] == str(uuid.UUID(int=7)) and got[0]["_distance"] == pytest.approx(0.0, abs=1e-4)
        allowed = [str(uuid.UUID(int=j)) for j in range(1, 1200, 2)]
        got = search(8, filter={"property": "_id", "stringArray": {"value": allowed, "operator": "containsAny"}})
        assert len(got) == 3 and {p["_id"] for p in got} <= set(allowed)
        want = sorted(range(1, 1200, 2), key=lambda j: float(((vecs[j] - vecs[8]) ** 2).sum()))[:3]
        assert [p["_id"] for p in got] == [str(uuid.UUID(int=j)) for j in want]
        r = requests.delete(f"{base}/ivfcol/points", json={"ids": [str(uuid.UUID(int=7))]}, headers=HEADERS)
        assert r.status_code == 200 and r.json()["failedPoints"] == [], r.text
        assert str(uuid.UUID(int=7)) not in {p["_id"] for p in search(7)}
    finally:
        srv.shutdown()
        node.close()


def _ivf_collection(models, copies=2):
    schema = models.IndexSchema.from_dict({"v": {"type": "vectorIVF", "vectorIVF": {
        "vectorSize": 24, "distanceMetric": "euclidean", "assignCopies": copies}}})
    return models.Collection(user_id="u1", id="c1", index_schema=schema, user_plan=models.UserPlan())


def _requests(models, queries):
    return [models.SearchRequest.from_dict({"query": {"property": "v", "vectorIVF": {
        "vector": q.tolist(), "limit": 5}}, "limit": 5}) for q in queries]


def test_shard_ivf_assign_copies_e2e(tmp_path):
    vecs = np.random.default_rng(10).standard_normal((800, 24)).astype(np.float32)
    path = str(tmp_path / "s1")
    sh = Shard(open_store(path), _ivf_collection(port_models), CPU)
    sh.insert_points([port_models.Point.from_map({"v": vecs[i].tolist()}, uuid.UUID(int=i + 1))
                      for i in range(800)])
    (req,) = _requests(port_models, vecs[5:6])
    assert sh.search_points(req)[0].point.id == uuid.UUID(int=6)
    sh.flush()
    sh.close()
    sh2 = Shard(open_store(path), _ivf_collection(port_models), CPU)
    assert sh2.search_points(req)[0].point.id == uuid.UUID(int=6)
    (idx,) = sh2.device_indices.values()
    assert isinstance(idx, port_ivf.IndexIVF) and idx._loc2  # the secondary copies came back
    sh2.close()


@pytest.mark.parametrize("journal", [False, True], ids=["snapshot", "snapshot+journal"])
def test_jax_written_ivf_shard_opens_in_port(tmp_path, journal):
    """A shard the JAX package wrote with a vectorIVF index (a flushed
    snapshot, or a snapshot plus journal) opens in the port, which rebuilds
    the slabs from ``vectors`` and answers the same searches."""
    rng = np.random.default_rng(11)
    vecs = _clustered(rng, 1400, dim=24)
    queries = vecs[:12] + 0.2 * rng.standard_normal((12, 24)).astype(np.float32)
    path = str(tmp_path / "s.sdb")
    jsh = JaxShard(jax_open_store(path), _ivf_collection(jax_models))
    pts = [jax_models.Point.from_map({"v": vecs[i].tolist()}, uuid.UUID(int=i + 1)) for i in range(1400)]
    jsh.insert_points(pts[:1000])
    if journal:
        jsh.flush()
        jsh.insert_points(pts[1000:])  # journal only from here on
        jsh.delete_points({pts[3].id, pts[1200].id})
        want = jsh.search_points_batch_wire(_requests(jax_models, queries))
        jsh.db.close()
    else:
        jsh.insert_points(pts[1000:])
        jsh.delete_points({pts[3].id, pts[1200].id})
        want = jsh.search_points_batch_wire(_requests(jax_models, queries))
        jsh.close()
    tsh = Shard(open_store(path), _ivf_collection(port_models), CPU)
    try:
        assert tsh.point_count() == 1398
        got = tsh.search_points_batch_wire(_requests(port_models, queries))
    finally:
        tsh.close()
    row_of = {str(uuid.UUID(int=i + 1)): i for i in range(1400)}
    for q, wrow, grow in zip(queries, want, got):
        d = ((vecs.astype(np.float64) - q) ** 2).sum(-1)
        errs = tie_rule_errors([p["_distance"] for p in wrow], [p["_id"] for p in wrow],
                               [p["_distance"] for p in grow], [p["_id"] for p in grow],
                               lambda pid: d[row_of[pid]], atol=RTOL * (1.0 + float(d.max())))
        assert errs == [], errs
        assert {str(uuid.UUID(int=4)), str(uuid.UUID(int=1201))}.isdisjoint(p["_id"] for p in grow)


def test_product_quantizer_on_ivf_is_refused():
    schema = port_models.IndexSchema.from_dict({"v": {"type": "vectorIVF", "vectorIVF": {
        "vectorSize": 16, "distanceMetric": "euclidean",
        "quantizer": {"type": "product", "product": {"numCentroids": 16, "numSubVectors": 4}}}}})
    with pytest.raises(ValidationError, match="product quantizer on vectorIVF"):
        check_supported(schema)
    with pytest.raises(NotImplementedError, match="product quantizer"):
        port_ivf.IndexIVF(schema.get("v").vector_ivf, CPU)
    check_supported(port_models.IndexSchema.from_dict(IVF_SCHEMA))


def test_ground_truth_on_device_matches_jax_and_host(monkeypatch):
    """The torch ground truth (f32 on the given device) against the JAX
    package's device version and the f64 host one; ties by the tie rule."""
    from semadb_tpu.tools import datasets as jax_datasets
    from semadb_tpu_torch.tools import datasets as port_datasets

    ds = embedding_like(3000, 24, 40, latent=16, seed=3, spread=0.5)
    wants = (jax_datasets.compute_ground_truth_device(ds, 10), compute_ground_truth(ds, 10))
    gots = [port_datasets.compute_ground_truth_device(ds, 10, CPU, qchunk=16)]  # one corpus block
    # blocks of 700 rows merged per query chunk
    monkeypatch.setattr(port_datasets, "GT_BLOCK_FLOATS", 16 * 700)
    gots.append(port_datasets.compute_ground_truth_device(ds, 10, CPU, qchunk=16))
    for got in gots:
        for want in wants:
            for b in range(len(ds.test)):
                d = ((ds.train.astype(np.float64) - ds.test[b]) ** 2).sum(-1)
                errs = tie_rule_errors(d[want[b]], want[b].tolist(), d[got[b]], got[b].tolist(),
                                       lambda i: d[i], atol=RTOL * float(d.max()))
                assert errs == [], errs


def test_annbench_runs_the_ivf_engine_on_cpu(capsys):
    """The port's annbench at a small size on ``cpu``: one JSON line with the
    bench's fields; the Vamana engine is refused by name."""
    import json

    from semadb_tpu_torch.tools import annbench

    assert annbench.main(["--device", "cpu", "--n", "3000", "--dim", "16", "--queries", "96",
                          "--batch", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["recall@10"] >= 0.95 and out["qps"] > 0 and out["n"] == 3000 and out["batch"] == 32
    assert set(out["build_split_s"]) >= {"upload_s", "kmeans_s", "pack_s", "slab_build_s"}
    with pytest.raises(NotImplementedError, match="Vamana"):
        annbench.AnnBench(dim=16, device="cpu", engine="vamana")
