"""The port's shard-mesh fan-out held against the JAX package's, on the CPU.

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``); the port runs
on a mesh of ``cpu`` slots (``shard_mesh(devices=[cpu] * S)``). Shard
states are built by the JAX package and carried over: Vamana graphs as their
arrays, IVF and fused indices through ``to_arrays`` → ``from_arrays`` (builds
are not reproducible bit for bit across the packages).

Tolerances. The merge (``_allgather_topk``) and the Vamana fan-out and write
steps run on integer-valued data, where every distance is exact in f32: the
(distance, id, shard) triples and the graphs after each step are EQUAL to
JAX's. The IVF, IVF-PQ and fused fan-outs run on real data and are held by
the tie rule (``ops.topk.tie_rule_errors``, ids taken as (shard, node id)
pairs) with distances within 1e-5 relative to the scale of the data,
against JAX's result and against the merge of each port shard's own search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import semadb_tpu.index.vamana as jax_vamana
import semadb_tpu.parallel.fanout as jf
from semadb_tpu.index.fused import FusedHybridIVF as JaxFused
from semadb_tpu.index.ivf import IndexIVF as JaxIVF
from semadb_tpu.models.quantizer import ProductQuantizerParams as JaxPQP
from semadb_tpu.models.quantizer import Quantizer as JaxQuantizer
from semadb_tpu.models.schema import VectorIVFParams as JaxIVFParams
from semadb_tpu.models.schema import VectorVamanaParams as JaxVamanaParams
from semadb_tpu.parallel.mesh import SHARD_AXIS
from semadb_tpu.parallel.mesh import shard_mesh as jax_mesh
from semadb_tpu_torch.index.fused import FusedHybridIVF as PortFused
from semadb_tpu_torch.index.ivf import IndexIVF as PortIVF
from semadb_tpu_torch.index.vamana.graph import GraphConfig as PortConfig
from semadb_tpu_torch.index.vamana.graph import GraphState as PortState
from semadb_tpu_torch.models.quantizer import ProductQuantizerParams as PortPQP
from semadb_tpu_torch.models.quantizer import Quantizer as PortQuantizer
from semadb_tpu_torch.models.schema import VectorIVFParams as PortIVFParams
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.parallel import fanout as pf
from semadb_tpu_torch.parallel.mesh import ShardMesh, shard_mesh

CPU = torch.device("cpu")
RTOL = 1e-5
START = 1


def _port_mesh(n):
    return shard_mesh(devices=[CPU] * n)


def test_shard_mesh_slots():
    mesh = _port_mesh(8)
    assert isinstance(mesh, ShardMesh) and mesh.size == 8 and mesh.first == CPU
    assert shard_mesh(devices=["cpu", "cpu"]).slots == (CPU, CPU)
    with pytest.raises(ValueError):
        shard_mesh(devices=[])


def test_poisson_shard_limit():
    for limit in (1, 5, 10, 37, 100, 1000):
        for n in range(1, 17):
            assert pf.poisson_shard_limit(limit, n) == jf.poisson_shard_limit(limit, n)


def _jax_merge(d, i, s, k):
    """The JAX package's ``_allgather_topk`` under ``shard_map`` over the
    first S virtual devices; inputs [S, B, k]."""
    S = d.shape[0]
    mesh = jax_mesh(S)

    def local(dl, il, sl):
        return jf._allgather_topk(dl[0], il[0], sl[0], k)

    fan = jax.shard_map(local, mesh=mesh, in_specs=(P(SHARD_AXIS),) * 3, out_specs=(P(), P(), P()),
                        check_vma=False)
    return [np.asarray(x) for x in fan(jnp.asarray(d), jnp.asarray(i), jnp.asarray(s))]


@pytest.mark.parametrize("S", [2, 8])
def test_allgather_topk_keeps_shard_order_on_ties(S):
    """Crafted ties: equal (distance, id) pairs in every shard, inf slots and
    id -1; the port's merge equals JAX's, triples and order."""
    rng = np.random.default_rng(S)
    B, k = 6, 7
    d = rng.integers(0, 3, (S, B, k)).astype(np.float32)
    ids = rng.integers(-1, 4, (S, B, k)).astype(np.int32)
    d[:, 0, :] = np.arange(k, dtype=np.float32) // 2  # the same row on every shard
    ids[:, 0, :] = np.arange(k, dtype=np.int32) % 3
    d[:, 1, 3:] = np.inf  # empty slots
    ids[:, 1, 3:] = -1
    d[::2, 2, :] = np.inf
    ids[::2, 2, :] = -1
    d[:, 3, :] = 1.0  # one distance everywhere
    sh = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None, None], (S, B, k)).copy()
    want = _jax_merge(d, ids, sh, k)
    got = pf._allgather_topk([torch.from_numpy(x) for x in d], [torch.from_numpy(x) for x in ids],
                             [torch.from_numpy(x) for x in sh], k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    # row 0: every shard holds the same pairs, so the first slots of the
    # merge are pair 0 from shard 0, 1, ... in order
    np.testing.assert_array_equal(got[2][0, :S].numpy(), np.arange(min(S, k)))


# -- Vamana: search, insert and delete steps on integer data --------------------


def _int_graphs(S, n, dim, degree, seed):
    """S JAX-built Vamana graphs over integer vectors (an integer start
    vector too, so every distance and tie is exact) and the port's states
    holding the same arrays."""
    rng = np.random.default_rng(seed)
    params = JaxVamanaParams(vector_size=dim, distance_metric="euclidean", search_size=36, degree_bound=degree)
    jstates, pstates = [], []
    for _ in range(S):
        idx = jax_vamana.IndexVamana(params, capacity=256)
        start = rng.integers(-8, 9, dim).astype(np.float32)
        st = idx.state
        idx.state = type(st)(st.vectors.at[START].set(jnp.asarray(start)), st.adjacency, st.exists)
        vecs = rng.integers(-8, 9, (n, dim)).astype(np.float32)
        idx.insert_update_delete(zip(range(2, n + 2), vecs))
        jstates.append(idx.state)
        pstates.append(PortState(*(torch.from_numpy(np.asarray(a).copy()) for a in idx.state)))
    return jstates, pstates, idx.config


def _same_graphs(jstacked, pstacked):
    for si, st in enumerate(pstacked):
        for name in ("vectors", "adjacency", "exists"):
            want = np.asarray(getattr(jstacked, name))[si]
            np.testing.assert_array_equal(getattr(st, name).numpy(), want, err_msg=f"shard {si} {name}")


def test_sharded_vamana_search_and_steps_equal_jax():
    S, dim, degree = 4, 16, 16
    jstates, pstates, jconfig = _int_graphs(S, 90, dim, degree, seed=5)
    config = PortConfig(dim=dim, metric="euclidean", degree_bound=degree, search_size=36)
    jmesh, pmesh = jax_mesh(S), _port_mesh(S)
    jst = jf.stack_states(jstates, jmesh)
    pst = pf.stack_states(pstates, pmesh)
    assert all(a.vectors.data_ptr() != b.vectors.data_ptr() for a, b in zip(pst, pstates)), "a stack holds copies"
    rng = np.random.default_rng(6)
    q = rng.integers(-8, 9, (12, dim)).astype(np.float32)

    def check_search(L, k):
        want = jf.sharded_search(jst, jnp.asarray(q), jconfig, L, k, jmesh)
        got = pf.sharded_search(pst, q, config, L, k, pmesh)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    check_search(36, 10)
    # an insert step: 24 rows a shard, the last 5 of shard 1 padding
    B = 24
    ids = np.tile(np.arange(100, 100 + B, dtype=np.int32)[None], (S, 1))
    vecs = rng.integers(-8, 9, (S, B, dim)).astype(np.float32)
    valid = np.ones((S, B), bool)
    valid[1, -5:] = False
    ids[1, -5:] = 0
    jst = jf.sharded_insert_step(jst, jnp.asarray(ids), jnp.asarray(vecs), jnp.asarray(valid), jconfig, 36, jmesh)
    out = pf.sharded_insert_step(pst, ids, vecs, valid, config, 36, pmesh)
    assert out is pst
    _same_graphs(jst, pst)
    # a delete step: a few ids a shard, several in shard 0
    cap = pst[0].capacity
    masks = np.zeros((S, cap), bool)
    masks[0, 2:30] = True
    masks[1, [5, 50, 101]] = True
    masks[3, 100:110] = True
    jst = jf.sharded_delete_step(jst, jnp.asarray(masks), jconfig, jmesh)
    pf.sharded_delete_step(pst, masks, config, pmesh)
    _same_graphs(jst, pst)
    check_search(40, 12)
    # the filtered fan-out: each shard's own members seed its walk
    fm = np.zeros((S, cap), bool)
    fm[:, ::3] = True
    want = jf.sharded_search_filtered(jst, jnp.asarray(q), jnp.asarray(fm), jconfig, 36, 8, jmesh)
    got = pf.sharded_search_filtered(pst, q, fm, config, 36, 8, pmesh)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- IVF, IVF-PQ and fused fan-outs on real data ---------------------------------


def _clustered(rng, n, dim, k=12):
    cents = rng.standard_normal((k, dim)).astype(np.float32) * 4
    return (cents[rng.integers(0, k, n)] + rng.standard_normal((n, dim))).astype(np.float32)


def _check_triples(want, got, dist_of, q, scale):
    """Row by row by the tie rule; ids are (shard, node id) pairs."""
    wd, wi, ws = (np.asarray(x) for x in want)
    gd, gi, gs = (np.asarray(x) for x in got)
    for b in range(len(q)):
        atol = RTOL * scale[b]
        live = np.isfinite(wd[b]) & (wi[b] >= 0)
        glive = np.isfinite(gd[b]) & (gi[b] >= 0)
        errs = tie_rule_errors(wd[b][live], list(zip(ws[b][live].tolist(), wi[b][live].tolist())),
                               gd[b][glive], list(zip(gs[b][glive].tolist(), gi[b][glive].tolist())),
                               lambda key, b=b: dist_of(b, *key), atol=atol)
        assert errs == [], (b, errs[:3])


def _union(port_shards, search, k):
    """The merge of each port shard's own search: (d, i, shard) [B, k]."""
    ds, is_, ss = [], [], []
    for si, idx in enumerate(port_shards):
        d, i = search(idx)
        ds.append(np.asarray(d))
        is_.append(np.asarray(i))
        ss.append(np.full_like(np.asarray(i), si))
    d, i, s = np.concatenate(ds, 1), np.concatenate(is_, 1), np.concatenate(ss, 1)
    out_d, out_i, out_s = [], [], []
    for b in range(d.shape[0]):
        o = np.lexsort((i[b], d[b]))[:k]
        out_d.append(d[b][o])
        out_i.append(i[b][o])
        out_s.append(s[b][o])
    return np.stack(out_d), np.stack(out_i), np.stack(out_s)


def _ivf_fleet(S, n, dim, pq=False, seed=0):
    rng = np.random.default_rng(seed)
    if pq:
        jp = JaxIVFParams(vector_size=dim, distance_metric="euclidean", quantizer=JaxQuantizer(
            type="product", product=JaxPQP(num_centroids=16, num_subvectors=4, trigger_threshold=64)))
        pp = PortIVFParams(vector_size=dim, distance_metric="euclidean", quantizer=PortQuantizer(
            type="product", product=PortPQP(num_centroids=16, num_subvectors=4, trigger_threshold=64)))
    else:
        jp = JaxIVFParams(vector_size=dim, distance_metric="euclidean", assign_copies=2)
        pp = PortIVFParams(vector_size=dim, distance_metric="euclidean", assign_copies=2)
    jidx, pidx, corpora = [], [], []
    for _ in range(S):
        vecs = _clustered(rng, n, dim)
        j = JaxIVF(jp)
        j.insert_bulk(np.arange(2, n + 2, dtype=np.int32), vecs)
        assert j._n_at_fit > 0 and j.pq_active == pq
        jidx.append(j)
        pidx.append(PortIVF.from_arrays(pp, j.to_arrays(), CPU))
        corpora.append(vecs)
    return jidx, pidx, corpora, rng


def _euclid(corpora, q):
    def dist_of(b, s, i):
        return float(((corpora[s][i - 2].astype(np.float64) - q[b]) ** 2).sum())
    return dist_of


def _scale(corpora, q):
    xmax = max(float(np.linalg.norm(c, axis=1).max()) for c in corpora)
    return [(xmax + float(np.linalg.norm(x))) ** 2 + 1.0 for x in q]


@pytest.mark.parametrize("kind", ["ivf", "ivf_filtered", "ivf_pq"])
def test_sharded_ivf_fan_outs_match_jax_and_the_shards_own(kind):
    S, dim, k, p = 4, 16, 10, 8
    pq = kind == "ivf_pq"
    jidx, pidx, corpora, rng = _ivf_fleet(S, 1100 if pq else 800, dim, pq=pq, seed=len(kind))
    jmesh, pmesh = jax_mesh(S), _port_mesh(S)
    jst = jf.stack_ivf_states(jidx, jmesh)
    pst = pf.stack_ivf_states([i.capture_stack_view() for i in pidx], pmesh)
    q = np.concatenate([corpora[1][:4] + 0.01, _clustered(rng, 12, dim)]).astype(np.float32)
    dist_of, scale = _euclid(corpora, q), _scale(corpora, q)
    if kind == "ivf":
        want = jf.sharded_ivf_search(jst, jnp.asarray(q), p, k, jmesh)
        got = pf.sharded_ivf_search(pst, q, p, k, pmesh)
        own = _union(pidx, lambda idx: idx.search_batch(q, k, num_probes=p), k)
    elif kind == "ivf_pq":
        want = jf.sharded_ivf_pq_search(jst, jnp.asarray(q), p, k, 16, jmesh)
        got = pf.sharded_ivf_pq_search(pst, q, p, k, 16, pmesh)
        own = _union(pidx, lambda idx: idx.search_batch(q, k, num_probes=p), k)
    else:
        cap = jst["vectors"].shape[1]
        masks = np.zeros((S, cap), bool)
        masks[:, ::2] = True
        want = jf.sharded_ivf_search_filtered(jst, jnp.asarray(q), jnp.asarray(masks), p, k, jmesh)
        got = pf.sharded_ivf_search_filtered(pst, q, masks, p, k, pmesh)
        own = None
        assert (np.asarray(got[1]) % 2 == 0).all()
    got = [x.numpy() for x in got]
    _check_triples(want, got, dist_of, q, scale)
    if own is not None:
        _check_triples(own, got, dist_of, q, scale)
    # the planted queries find their own points on shard 1 (the filter
    # admits only the even ones)
    planted = np.arange(2, 6)
    hit = planted % 2 == 0 if kind == "ivf_filtered" else np.ones(4, bool)
    assert (got[2][:4, 0][hit] == 1).all() and (got[1][:4, 0][hit] == planted[hit]).all()


def _fused_fleet(S, n, seed):
    rng = np.random.default_rng(seed)
    dims, metrics, w = [6, 4], ["euclidean", "dot"], [0.7, 0.3]
    jf_, pf_, views = [], [], []
    for _ in range(S):
        v = [_clustered(rng, n, d) for d in dims]
        j = JaxFused(dims, metrics, w)
        j.insert_bulk(np.arange(2, n + 2, dtype=np.int32), v)
        jf_.append(j)
        pf_.append(PortFused.from_arrays(j.to_arrays(), device=CPU))
        views.append(v)
    return jf_, pf_, views, rng, w


@pytest.mark.parametrize("filtered", [False, True])
def test_sharded_fused_fan_out_matches_jax_and_the_shards_own(filtered):
    S, k, p = 4, 8, 8
    jidx, pidx, views, rng, w = _fused_fleet(S, 700, seed=3 + filtered)
    jmesh, pmesh = jax_mesh(S), _port_mesh(S)
    jcaps = [i.capture_stack_view() for i in jidx]
    pcaps = [i.capture_stack_view() for i in pidx]
    jst = jf.stack_ivf_states([c[0] for c in jcaps], jmesh)
    pst = pf.stack_ivf_states([c[0] for c in pcaps], pmesh)
    qv = [_clustered(rng, 10, d) for d in (6, 4)]
    jpsi = [c[1].psi(qv) for c in jcaps]
    ppsi = [c[1].psi(qv) for c in pcaps]
    for a, b in zip(jpsi, ppsi):
        np.testing.assert_array_equal(a[0], b[0])
    psi = np.stack([x[0] for x in ppsi])
    const = np.stack([x[1] for x in ppsi])
    if filtered:
        masks = np.zeros((S, jst["vectors"].shape[1]), bool)
        masks[:, 1::2] = True
        want = jf.sharded_fused_search_filtered(jst, jnp.asarray(psi), jnp.asarray(const), jnp.asarray(masks), p,
                                                k, jmesh)
        got = pf.sharded_fused_search_filtered(pst, psi, const, masks, p, k, pmesh)
    else:
        want = jf.sharded_fused_search(jst, jnp.asarray(psi), jnp.asarray(const), p, k, jmesh)
        got = pf.sharded_fused_search(pst, psi, const, p, k, pmesh)
    got = [x.numpy() for x in got]

    def dist_of(b, s, i):
        x0, x1 = views[s][0][i - 2].astype(np.float64), views[s][1][i - 2].astype(np.float64)
        return w[0] * float(((x0 - qv[0][b]) ** 2).sum()) - w[1] * float(x1 @ qv[1][b])

    xmax = max(float(np.abs(np.concatenate(v, 1)).max()) for v in views)
    scale = [(xmax * 10 + float(np.abs(qv[0][b]).sum() + np.abs(qv[1][b]).sum())) ** 2 for b in range(10)]
    _check_triples(want, got, dist_of, qv[0], scale)
    if not filtered:
        own = _union(pidx, lambda idx: idx.search_batch(qv, k, num_probes=p), k)
        _check_triples(own, got, dist_of, qv[0], scale)
    else:
        assert (got[1][np.isfinite(got[0])] % 2 == 1).all()


def test_stack_ivf_states_rejects_mixed_pq_fleet():
    """Shards in MIXED PQ / f32 modes share no scoring space: refused with
    NotImplementedError, as the JAX package refuses them."""
    jpq, ppq, _, rng = _ivf_fleet(1, 1100, 16, pq=True, seed=9)
    plain = PortIVF(PortIVFParams(vector_size=16, distance_metric="euclidean"), CPU)
    plain.insert_bulk(np.arange(2, 602, dtype=np.int32), rng.standard_normal((600, 16)).astype(np.float32))
    with pytest.raises(NotImplementedError):
        pf.stack_ivf_states([ppq[0], plain], _port_mesh(2))
    jplain = JaxIVF(JaxIVFParams(vector_size=16, distance_metric="euclidean"))
    jplain.insert_bulk(np.arange(2, 602, dtype=np.int32), rng.standard_normal((600, 16)).astype(np.float32))
    with pytest.raises(NotImplementedError):
        jf.stack_ivf_states([jpq[0], jplain], jax_mesh(2))


def test_update_stacked_shard_and_inert_views():
    """``update_stacked_shard`` replaces one slot's copy and keeps the
    others; an inert view launches and yields no hit."""
    jidx, pidx, corpora, rng = _ivf_fleet(2, 700, 8, seed=4)
    mesh = _port_mesh(3)
    geom = pf.ivf_stack_geometry(pidx)
    st = pf.stack_ivf_states(pidx, mesh)
    pidx[0].insert_update_delete([(800, corpora[1][5] + 0.001)])
    assert pf.ivf_view_fits(pidx[0], geom)
    new = pf.update_stacked_shard(st, 0, pf.pad_ivf_view(pidx[0].capture_stack_view(), geom), mesh)
    assert new[1] is st[1] and new[0] is not st[0]
    q = (corpora[1][5:6] + 0.001).astype(np.float32)
    d, i, s = pf.sharded_ivf_search(new + [pf.inert_ivf_view(geom)], q, 8, 3, mesh)
    assert (int(s[0, 0]), int(i[0, 0])) == (0, 800) and (int(s[0, 1]), int(i[0, 1])) == (1, 7)
    d, i, s = pf.sharded_ivf_search(st, q, 8, 3, mesh)
    assert (int(s[0, 0]), int(i[0, 0])) == (1, 7), "the old stack does not see the write"
    g = pf.inert_graph_state(256, 8, 16)
    d, i, _ = pf.sharded_search([g], q, PortConfig(dim=8, degree_bound=16, search_size=20), 20, 4, mesh)
    assert not np.isfinite(d.numpy()).any() and (i.numpy() == -1).all()
