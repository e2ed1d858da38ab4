"""The port's pool build (``index/vamana/fastbuild.py``) held against the JAX package's, on the CPU.

Each deterministic piece takes the same inputs, made from a numpy seed, in
both packages: ``_pool_group`` (the per-cluster kNN), ``_truncate_pools``,
``_expand_pool``, ``_topup_chunk``, ``_connect_start`` and ``build_pools``'
one-cluster path (its kNN columns). On integer-valued vectors every distance
is exact in f32, and the selections break ties by index in both packages,
so the outputs must be equal. The k-means and the random far candidates do
not repeat the JAX package's bits (F6: another generator), so the whole
build is held, as ``tests/test_vamana.py`` holds the JAX one, to recall@10
>= 0.98 and the graph's invariants, on the default, seeded-refine, mixed-
partition and lean schedules, and to CRUD after the build.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semadb_tpu_torch.index.vamana as port_vamana
from semadb_tpu_torch.index.vamana import fastbuild as port_fb
from semadb_tpu_torch.index.vamana.build import reachable_mask
from semadb_tpu_torch.models.schema import VectorVamanaParams as PortParams
from semadb_tpu_torch.tools.datasets import embedding_like

jax_fb = pytest.importorskip("semadb_tpu.index.vamana.fastbuild")
jax_graph = sys.modules["semadb_tpu.index.vamana.graph"]

CPU = torch.device("cpu")
NIL = -1
INF = float("inf")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _int_vecs(rng, n, d):
    return rng.integers(-8, 9, (n, d)).astype(np.float32)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
@pytest.mark.parametrize("row_off", [0, 5])
def test_pool_group_equals_jax(metric, row_off):
    rng = np.random.default_rng(1)
    n, d, k, T = 300, 16, 12, 2
    vecs = _int_vecs(rng, n + row_off, d)
    G, m = 6, 40
    member = np.full((G, m), NIL, np.int32)
    slot = np.zeros((G, m), np.int32)
    for g in range(G):
        cnt = rng.integers(5, m + 1)
        member[g, :cnt] = rng.choice(n, cnt, replace=False)
        slot[g, :cnt] = g % T
    P = T * k + 4
    pd0 = np.full((n, P), INF, np.float32)
    pi0 = np.full((n, P), NIL, np.int32)
    jd, ji = jax_fb._pool_group(jnp.asarray(pd0), jnp.asarray(pi0), jnp.asarray(member), jnp.asarray(slot),
                                jnp.asarray(vecs), metric, k, row_off=row_off)
    pd, pi = port_fb._pool_group(torch.from_numpy(pd0.copy()), torch.from_numpy(pi0.copy()),
                                 torch.from_numpy(member), torch.from_numpy(slot), torch.from_numpy(vecs), metric, k,
                                 row_off=row_off)
    assert np.array_equal(_np(pi), np.asarray(ji))
    assert np.array_equal(_np(pd), np.asarray(jd))


def _pools(rng, n, P, cap):
    pd = rng.integers(0, 50, (n, P)).astype(np.float32)
    pi = rng.integers(2, cap, (n, P)).astype(np.int32)
    pi[rng.random((n, P)) < 0.1] = NIL
    pd[pi == NIL] = INF
    return pd, pi


def test_truncate_pools_equals_jax():
    rng = np.random.default_rng(2)
    P = 40 + port_fb.N_RAND
    pd, pi = _pools(rng, 64, P, 500)
    jd, ji = jax_fb._truncate_pools(jnp.asarray(pd), jnp.asarray(pi), 24)
    gd, gi = port_fb._truncate_pools(torch.from_numpy(pd), torch.from_numpy(pi), 24)
    assert np.array_equal(_np(gi), np.asarray(ji)) and np.array_equal(_np(gd), np.asarray(jd))


def _graph(rng, n=400, d=16, R=24):
    from semadb_tpu_torch.tools import vamana_operands as vo

    v, a = vo.random_graph(n, d, R, integer=True, metric="euclidean", seed=int(rng.integers(1000)), device=CPU)
    ex = torch.ones(v.shape[0], dtype=torch.bool)
    ex[0] = False
    return v, a, ex


@pytest.mark.parametrize("metric", ["euclidean", "dot"])
def test_expand_pool_equals_jax(metric):
    rng = np.random.default_rng(3)
    v, a, ex = _graph(rng)
    ids = np.arange(2, 66, dtype=np.int32)
    pd, pi = _pools(rng, 64, 48, v.shape[0])
    jst = jax_graph.GraphState(jnp.asarray(_np(v)), jnp.asarray(_np(a)), jnp.asarray(_np(ex)))
    jd, ji = jax_fb._expand_pool(jst, jnp.asarray(ids), jnp.asarray(_np(v)[ids]), jnp.asarray(pd), jnp.asarray(pi),
                                 metric)
    pst = port_vamana.GraphState(v, a, ex)
    gd, gi = port_fb._expand_pool(pst, torch.from_numpy(ids), v[torch.from_numpy(ids).long()],
                                  torch.from_numpy(pd), torch.from_numpy(pi), metric)
    assert np.array_equal(_np(gi), np.asarray(ji)) and np.array_equal(_np(gd), np.asarray(jd))


def test_topup_chunk_equals_jax():
    rng = np.random.default_rng(4)
    v, a, ex = _graph(rng)
    a[2:66, 10:] = NIL  # under-full rows
    ex[rng.integers(2, v.shape[0], 40)] = False
    ids = np.arange(2, 66, dtype=np.int32)
    pd, pi = _pools(rng, 64, 48, v.shape[0])
    pi[:, 1::7] = pi[:, ::7][:, : pi[:, 1::7].shape[1]]  # repeated ids at one distance
    pd[:, 1::7] = pd[:, ::7][:, : pd[:, 1::7].shape[1]]
    want = jax_fb._topup_chunk(jnp.asarray(_np(a)), jnp.asarray(ids), jnp.asarray(pd), jnp.asarray(pi),
                               jnp.asarray(_np(ex)))
    got = port_fb._topup_chunk(a.clone(), torch.from_numpy(ids), torch.from_numpy(pd), torch.from_numpy(pi), ex)
    assert np.array_equal(_np(got), np.asarray(want))


def test_connect_start_equals_jax():
    rng = np.random.default_rng(5)
    v, a, ex = _graph(rng)
    for n_ids in (10, 300):
        ids = np.sort(rng.choice(np.arange(2, v.shape[0]), n_ids, replace=False)).astype(np.int32)
        jst = jax_graph.GraphState(jnp.asarray(_np(v)), jnp.asarray(_np(a)), jnp.asarray(_np(ex)))
        cfg = jax_graph.GraphConfig(dim=16, degree_bound=24)
        want = jax_fb._connect_start(jst, ids, cfg).adjacency
        pst = port_vamana.GraphState(v, a.clone(), ex)
        got = port_fb._connect_start(pst, ids, port_vamana.GraphConfig(dim=16, degree_bound=24)).adjacency
        assert np.array_equal(_np(got), np.asarray(want))


def test_build_pools_one_cluster_knn_equals_jax():
    """At most 4 x MEMBER_TARGET points are one cluster: the kNN columns are
    a function of the vectors alone (the random columns are not compared)."""
    rng = np.random.default_rng(6)
    vecs = _int_vecs(rng, 700, 16)
    jd, ji, jc, _ = jax_fb.build_pools(jnp.asarray(vecs), "euclidean")
    gd, gi, gc, _ = port_fb.build_pools(torch.from_numpy(vecs), "euclidean")
    knn = gd.shape[1] - port_fb.N_RAND
    assert jc is None and gc is None
    assert np.array_equal(_np(gi)[:, :knn], np.asarray(ji)[:, :knn])
    assert np.array_equal(_np(gd)[:, :knn], np.asarray(jd)[:, :knn])
    r = _np(gi)[:, knn:]
    assert ((r == NIL) | ((r >= 0) & (r < 700) & (r != np.arange(700)[:, None]))).all()


# -- the whole build ------------------------------------------------------------

N = 2000  # the pool build's least batch (TWO_PASS_MIN) is patched to 1,024 below


@pytest.fixture(autouse=True)
def _small_batches(monkeypatch):
    monkeypatch.setattr(port_vamana, "TWO_PASS_MIN", 1_024)


def _ds(seed):
    ds = embedding_like(N, 32, 64, latent=16, seed=seed, spread=0.5)
    dd = ((ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64)) ** 2).sum(-1)
    return ds, np.argsort(dd, 1)[:, :10] + 2


def _params():
    return PortParams(vector_size=32, distance_metric="euclidean", search_size=75, degree_bound=32, alpha=1.2)


def _recall(idx, ds, gt):
    _, i_ = idx.search_batch(ds.test, 10, search_size=75)
    return np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(len(gt))])


def _check_invariants(idx, ids):
    adj = _np(idx.adjacency)
    ex = _np(idx.exists)
    rows = adj[ids]
    assert ((rows != NIL).sum(-1) <= idx.config.degree_bound).all()
    assert ((rows == NIL) | ex[np.clip(rows, 0, len(ex) - 1)]).all(), "an edge to a node that does not exist"
    for row, nid in zip(rows[:200], ids[:200]):
        e = row[row != NIL]
        assert nid not in e and len(set(e.tolist())) == len(e)
    assert bool((reachable_mask(idx.state) | ~idx.exists).all()), "a node the start cannot reach"


SCHEDULES = {
    "default": {},  # through SEMADB_VAMANA_BUILD=pool (BUILD_MODE), not build_mode=
    "seeded_refine": {"SEMADB_VAMANA_FB_EXPAND": "-1", "SEMADB_VAMANA_FB_REFINE": "1",
                      "SEMADB_VAMANA_FB_SEED_OWN": "1"},
    "mixed": {"SEMADB_VAMANA_FB_MIX": "1", "SEMADB_VAMANA_FB_TOPUP": "1", "SEMADB_VAMANA_FB_REPS": "2"},
    "lean": {"SEMADB_VAMANA_FB_LEAN_BYTES": "1"},
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pool_build_invariants_and_recall(schedule, monkeypatch):
    for key, value in SCHEDULES[schedule].items():
        monkeypatch.setenv(key, value)
    if schedule == "mixed":
        monkeypatch.setattr(port_fb, "ASSIGN_T", 3)
    ds, gt = _ds(9 if schedule in ("default", "lean") else 11)
    ids = np.arange(2, N + 2, dtype=np.int32)
    idx = port_vamana.IndexVamana(_params(), CPU)
    if schedule == "default":
        monkeypatch.setattr(port_vamana, "BUILD_MODE", "pool")
        idx.insert_bulk(ids, ds.train)
    else:
        idx.insert_bulk(ids, ds.train, build_mode="pool")
    split = idx.build_seconds
    assert split["lean"] == (schedule == "lean")
    assert ("pass2.0_s" in split) == (schedule != "seeded_refine")
    assert idx._route is not None
    if schedule == "mixed":
        assert split["pool_width"] == 3 * port_fb.KNN_K + port_fb.N_RAND and idx._route[1].dim() == 2
    assert _recall(idx, ds, gt) >= 0.98, schedule
    _check_invariants(idx, ids)


def test_pool_build_then_crud():
    """Writes after a pool build take the walk path and stay findable; a
    deleted point is gone; a batch on a graph that holds points takes the
    two passes; non-contiguous ids build without the lean flow."""
    ds, gt = _ds(9)
    ids = np.arange(2, N + 2, dtype=np.int32)
    idx = port_vamana.IndexVamana(_params(), CPU)
    idx.insert_bulk(ids, ds.train, build_mode="pool")
    idx.insert_update_delete([(int(ids[0]), None)])
    _, i_ = idx.search_batch(ds.train[:1], 1, search_size=36)
    assert i_[0][0] != ids[0]
    nv = ds.train[:1] + 0.01
    idx.insert_update_delete([(N + 10, nv[0])])
    _, i_ = idx.search_batch(nv, 1, search_size=36)
    assert i_[0][0] == N + 10
    idx.insert_bulk(np.arange(N + 20, N + 20 + 64), ds.train[:64] + 0.02, build_mode="pool")
    assert "pass1_s" in idx.build_seconds  # not a fresh graph: the two passes
    idx2 = port_vamana.IndexVamana(_params(), CPU)
    gap = np.concatenate([ids[: N // 2], ids[N // 2 :] + 7]).astype(np.int32)
    idx2.insert_bulk(gap, ds.train, build_mode="pool")
    assert not idx2.build_seconds["lean"]
    _, i2 = idx2.search_batch(ds.test[:8], 10, search_size=75)
    assert i2.shape == (8, 10) and set(i2.reshape(-1)) <= set(gap.tolist())
