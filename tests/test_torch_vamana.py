"""The port's Vamana search and prune held against the JAX package's, on the CPU.

A graph the JAX ``IndexVamana`` built comes across by ``to_arrays`` →
``IndexVamana.from_arrays``, and the same queries, made from a numpy seed,
go through both packages: ``beam_search``, ``search``, ``search_filtered``,
``exact_search`` and ``robust_prune_batch`` (the port's run K10's and K11's
plain versions on ``cpu``).

Tolerances. On integer-valued vectors (|x| <= 8, D = 16) every distance and
product is exact in f32, so the outputs must be equal: lists, rings, hop
counts, rows. The start vector, a random unit vector in both packages, is
replaced by an integer one in the JAX index before it is built, so that its
distances are exact too. The plain query walk (no ring) leaves dedup holes
in its list, which a query that finished early has moved to its list's tail
by the JAX batch loop's later steps and not by the port's per-query exit:
such lists are compared with their holes dropped (``search`` drops them),
everything else exactly. On real-valued data the sums run in another order:
search results by the tie rule with distances within 1e-5 of the terms'
magnitude, and recall@10 within 0.002 of the JAX package's. Haversine meters
come from ``sin``/``cos``/``asin`` of two libraries and differ in the last
bits; on integer degrees many meters are mathematically equal and the walks
part there, so haversine runs on real-valued points: search results by the
tie rule within 1e-5 relative, prune rows equal.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semadb_tpu.index.vamana as jax_vamana
import semadb_tpu_torch.index.vamana as port_vamana
from semadb_tpu.models.schema import VectorVamanaParams as JaxParams
from semadb_tpu_torch.models.schema import VectorVamanaParams as PortParams
from semadb_tpu_torch.ops.kernels import vamana_search as k10
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.tools import vamana_operands as vo

jax_search = sys.modules["semadb_tpu.index.vamana.search"]
jax_build = sys.modules["semadb_tpu.index.vamana.build"]
jax_graph = sys.modules["semadb_tpu.index.vamana.graph"]
port_search = sys.modules["semadb_tpu_torch.index.vamana.search"]
port_build = sys.modules["semadb_tpu_torch.index.vamana.build"]
port_graph = sys.modules["semadb_tpu_torch.index.vamana.graph"]

CPU = torch.device("cpu")
RTOL = 1e-5
NIL = -1


def _jax_index(vecs, dim, metric, start, search_size=36, degree=32):
    params = JaxParams(vector_size=dim, distance_metric=metric, search_size=search_size, degree_bound=degree)
    idx = jax_vamana.IndexVamana(params)
    if start is not None:
        st = idx.state
        idx.state = jax_graph.GraphState(st.vectors.at[1].set(jnp.asarray(start)), st.adjacency, st.exists)
    idx.insert_update_delete(zip(range(2, len(vecs) + 2), vecs))
    return idx


def _port_index(jidx):
    p = jidx.params
    params = PortParams(vector_size=p.vector_size, distance_metric=p.distance_metric, search_size=p.search_size,
                        degree_bound=p.degree_bound, alpha=p.alpha)
    return port_vamana.IndexVamana.from_arrays(params, jidx.to_arrays(), CPU)


@pytest.fixture(scope="module")
def int_graph():
    rng = np.random.default_rng(0)
    vecs = rng.integers(-8, 9, (1500, 16)).astype(np.float32)
    jidx = _jax_index(vecs, 16, "euclidean", rng.integers(-8, 9, 16).astype(np.float32))
    queries = rng.integers(-8, 9, (48, 16)).astype(np.float32)
    return jidx, _port_index(jidx), vecs, queries


@pytest.fixture(scope="module")
def real_graph():
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((2500, 24)).astype(np.float32)
    jidx = _jax_index(vecs, 24, "euclidean", None, search_size=40)
    queries = rng.standard_normal((64, 24)).astype(np.float32)
    return jidx, _port_index(jidx), vecs, queries


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _no_holes(ids):
    return [list(row[row != NIL]) for row in ids]


def _seeds(jidx, b):
    seeds = np.asarray(jidx._get_entry_seeds(), np.int32)
    return np.broadcast_to(seeds[None, :], (b, len(seeds))).copy()


@pytest.mark.parametrize("L,W,track,seeded", [
    (36, 8, True, False), (36, 8, True, True), (40, 2, False, True), (40, 2, False, False),
    (25, 1, True, False), (75, 2, True, True),
])
def test_beam_search_equals_jax_on_integer_graph(int_graph, L, W, track, seeded):
    jidx, pidx, _, queries = int_graph
    seeds = _seeds(jidx, len(queries)) if seeded else None
    want = jax_search.beam_search(jidx.state, jnp.asarray(queries), jidx.config, L, expand_width=W,
                                  track_visited=track, seed_ids=None if seeds is None else jnp.asarray(seeds))
    got = port_search.beam_search(pidx.state, torch.from_numpy(queries), pidx.config, L, expand_width=W,
                                  track_visited=track, seed_ids=None if seeds is None else torch.from_numpy(seeds))
    assert int(got.hops) == int(want.hops)
    for name in ("visited_dists", "visited_ids"):
        assert np.array_equal(_np(getattr(got, name)), _np(getattr(want, name))), name
    if track:
        assert np.array_equal(_np(got.cand_ids), _np(want.cand_ids))
        assert np.array_equal(_np(got.cand_dists), _np(want.cand_dists))
    else:
        assert _no_holes(_np(got.cand_ids)) == _no_holes(_np(want.cand_ids))
        gd, wd = _np(got.cand_dists), _np(want.cand_dists)
        assert [list(r[np.isfinite(r)]) for r in gd] == [list(r[np.isfinite(r)]) for r in wd]


def test_per_query_exit_equals_the_batch_loop(int_graph):
    """JAX's loop runs while any query of the batch has a pending entry; the
    port's walk stops each query on its own. The queries finish at different
    hops here, and every query's result equals both its walk alone and its
    row of the JAX batch (holes dropped for the uncompacted list)."""
    jidx, pidx, _, queries = int_graph
    q = torch.from_numpy(queries)
    for track, W in ((True, 8), (False, 2)):
        batch = port_search.beam_search(pidx.state, q, pidx.config, 36, expand_width=W, track_visited=track)
        hops = _np(batch.query_hops)
        assert hops.min() < hops.max(), "every query took the same hops: the case is not exercised"
        want = jax_search.beam_search(jidx.state, jnp.asarray(queries), jidx.config, 36, expand_width=W,
                                      track_visited=track)
        assert int(want.hops) == hops.max()
        for b in range(0, len(queries), 7):
            alone = port_search.beam_search(pidx.state, q[b : b + 1], pidx.config, 36, expand_width=W,
                                            track_visited=track)
            for name in ("cand_dists", "cand_ids", "visited_dists", "visited_ids", "query_hops"):
                assert np.array_equal(_np(getattr(alone, name))[0], _np(getattr(batch, name))[b]), (b, name)
        assert np.array_equal(_np(batch.visited_ids), _np(want.visited_ids))
        if track:
            assert np.array_equal(_np(batch.cand_ids), _np(want.cand_ids))
        else:
            assert _no_holes(_np(batch.cand_ids)) == _no_holes(_np(want.cand_ids))


def test_searches_equal_jax_on_integer_graph(int_graph):
    jidx, pidx, _, queries = int_graph
    jq, pq = jnp.asarray(queries), torch.from_numpy(queries)
    seeds = _seeds(jidx, len(queries))
    cases = [
        (jax_search.search(jidx.state, jq, jidx.config, 40, 10, seed_ids=jnp.asarray(seeds)),
         port_search.search(pidx.state, pq, pidx.config, 40, 10, seed_ids=torch.from_numpy(seeds))),
        (jax_search.exact_search(jidx.state, jq, jidx.config, 10),
         port_search.exact_search(pidx.state, pq, pidx.config, 10)),
    ]
    for every in (3, 2):
        fm = np.arange(jidx.state.capacity) % every == 0
        cases.append((
            jax_search.search_filtered(jidx.state, jq, jnp.asarray(fm), jidx.config, 36, 10),
            port_search.search_filtered(pidx.state, pq, torch.from_numpy(fm), pidx.config, 36, 10),
        ))
    for (wd, wi), (gd, gi) in cases:
        assert np.array_equal(_np(gi), _np(wi))
        assert np.array_equal(_np(gd), _np(wd))
    # The index entry points, entry seeds and all
    for fm in (None, np.arange(jidx.state.capacity) % 3 == 0):
        wd, wi = jidx.search_batch(queries, 10, filter_mask=fm)
        gd, gi = pidx.search_batch(queries, 10, filter_mask=fm)
        assert np.array_equal(gi, wi) and np.array_equal(gd, wd)


def test_searches_agree_with_jax_on_real_data(real_graph):
    jidx, pidx, vecs, queries = real_graph
    wd, wi = jidx.search_batch(queries, 10, search_size=40)
    gd, gi = pidx.search_batch(queries, 10, search_size=40)
    exact = np.argsort(((vecs[None, :, :] - queries[:, None, :]) ** 2).sum(-1), axis=1)[:, :10] + 2
    for b in range(len(queries)):
        dist = ((vecs.astype(np.float64) - queries[b]) ** 2).sum(-1)
        mag = float(np.abs(vecs).max() + np.abs(queries[b]).max()) ** 2 * vecs.shape[1]
        errs = tie_rule_errors(wd[b], wi[b].tolist(), gd[b], gi[b].tolist(), lambda i: dist[i - 2],
                               atol=RTOL * mag)
        assert not errs, (b, errs[:3])

    def recall(ids):
        return np.mean([len(set(ids[b]) & set(exact[b])) / 10 for b in range(len(ids))])

    assert abs(recall(gi) - recall(wi)) <= 0.002


@pytest.mark.parametrize("metric", ["euclidean", "dot", "cosine", "haversine"])
def test_beam_search_other_metrics_equal_jax(metric):
    """Every float metric of ``gather_distance`` on one random graph. On
    integer vectors (euclidean, dot, cosine) lists and rings are equal.
    Haversine meters differ in the last bits between the two libraries'
    ``sin``/``cos``; integer degrees would make many mathematically equal
    distances, where the walks part, so haversine runs on real-valued
    points, and the top-10 of ``search`` is held by the tie rule with
    distances within 1e-5 relative."""
    hav = metric == "haversine"
    dim = 2 if hav else 16
    v, a = vo.random_graph(800, dim, 32, integer=not hav, metric=metric, seed=7, device=CPU)
    q = vo.random_queries(24, dim, integer=not hav, metric=metric, seed=8, device=CPU)
    seeds = vo.random_seeds(24, 20, v.shape[0], seed=9, device=CPU)
    cap = v.shape[0]
    exists = np.ones(cap, bool)
    exists[0] = False
    jst = jax_graph.GraphState(jnp.asarray(v.numpy()), jnp.asarray(a.numpy()), jnp.asarray(exists))
    pst = port_graph.GraphState(v, a, torch.from_numpy(exists))
    jcfg = jax_graph.GraphConfig(dim=dim, metric=metric, degree_bound=32, search_size=40)
    pcfg = port_graph.GraphConfig(dim=dim, metric=metric, degree_bound=32, search_size=40)
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(seeds.numpy())
    if not hav:
        want = jax_search.beam_search(jst, jq, jcfg, 40, expand_width=4, seed_ids=js)
        got = port_search.beam_search(pst, q, pcfg, 40, expand_width=4, seed_ids=seeds)
        for name in ("cand_dists", "cand_ids", "visited_dists", "visited_ids"):
            assert np.array_equal(_np(getattr(got, name)), _np(getattr(want, name))), name
        assert int(got.hops) == int(want.hops)
        return
    wd, wi = (_np(t) for t in jax_search.search(jst, jq, jcfg, 40, 10, seed_ids=js))
    gd, gi = (_np(t) for t in port_search.search(pst, q, pcfg, 40, 10, seed_ids=seeds))
    full = np.asarray(jax_search.pairwise_distance(jq, jst.vectors, metric))
    for b in range(len(q)):
        errs = tie_rule_errors(wd[b], wi[b].tolist(), gd[b], gi[b].tolist(), lambda i, b=b: float(full[b, i]),
                               atol=RTOL * float(wd[b][-1]))
        assert not errs, (b, errs[:3])


@pytest.mark.parametrize("metric", ["euclidean", "dot", "cosine", "haversine"])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_robust_prune_equals_jax(metric, alpha):
    """The same sorted pools through JAX's ``_pairwise_among`` +
    ``robust_prune_batch`` and the port's (K11's plain version): equal rows
    on integer vectors, with repeated ids, the node's own id and -1 tails in
    the pools. Haversine on real-valued points, as above: the two libraries'
    meters differ in the last bits, which decides nothing away from ties."""
    hav = metric == "haversine"
    dim = 2 if hav else 16
    v, _ = vo.random_graph(600, dim, 8, integer=not hav, metric=metric, seed=11, device=CPU)
    d, i, self_ids = vo.prune_pools(v, 40, 96, metric, seed=12)
    jcfg = jax_graph.GraphConfig(dim=dim, metric=metric, degree_bound=32)
    pcfg = port_graph.GraphConfig(dim=dim, metric=metric, degree_bound=32)
    jv = jnp.asarray(v.numpy())
    pd = jax_build._pairwise_among(jv, jnp.asarray(i.numpy()), metric)
    want = jax_build.robust_prune_batch(jnp.asarray(d.numpy()), jnp.asarray(i.numpy()), pd,
                                        jnp.asarray(self_ids.numpy()), jcfg, jnp.float32(alpha))
    got = port_build.robust_prune_batch(d, i, self_ids, v, pcfg, alpha)
    assert np.array_equal(_np(got), _np(want))


def test_robust_prune_on_insert_pools_equals_jax(int_graph):
    """The pools an insert prunes: the visited rings of the build walk
    (L = 36, W = 8) of 48 points, at alpha 1.0 and the index's 1.2."""
    jidx, pidx, _, queries = int_graph
    res = jax_search.beam_search(jidx.state, jnp.asarray(queries), jidx.config, 36)
    self_ids = np.arange(2, 2 + len(queries), dtype=np.int32)
    pd = jax_build._pairwise_among(jidx.state.vectors, res.visited_ids, "euclidean")
    for alpha in (1.0, 1.2):
        want = jax_build.robust_prune_batch(res.visited_dists, res.visited_ids, pd, jnp.asarray(self_ids),
                                            jidx.config, jnp.float32(alpha))
        got = port_build.robust_prune_batch(torch.from_numpy(_np(res.visited_dists)),
                                            torch.from_numpy(_np(res.visited_ids)), torch.from_numpy(self_ids),
                                            pidx.state.vectors, pidx.config, alpha)
        assert np.array_equal(_np(got), _np(want))


def test_routed_seeds_equal_jax(int_graph):
    """A graph saved with query routing (the JAX pool build's centroids and
    representatives) searches the same way in the port."""
    jidx, _, vecs, queries = int_graph
    rng = np.random.default_rng(4)
    cents = rng.integers(-8, 9, (12, 16)).astype(np.float32)
    reps = rng.integers(2, len(vecs) + 2, 12).astype(np.int32)
    jidx.set_query_routing(cents, reps)
    try:
        pidx = _port_index(jidx)
        wd, wi = jidx.search_batch(queries, 10)
        gd, gi = pidx.search_batch(queries, 10)
    finally:
        jidx._route = None
    assert np.array_equal(gi, wi) and np.array_equal(gd, wd)


@pytest.mark.parametrize("seeded", [False, True])
def test_k10_least_bytes_counts_distinct_rows(seeded):
    """The K10 bound's rows: a walk whose ring never wraps (max_hops = V/W)
    has every expanded node in its ring, so the distinct nodes expanded are
    the batch's ring ids, and the distinct rows scored are the start node, the
    seeds and those nodes' neighbours; no more than the walks' own counts."""
    L, W = 25, 2
    v, a = vo.random_graph(300, 16, 16, integer=True, metric="euclidean", seed=3, device=CPU)
    q = vo.random_queries(9, 16, integer=True, metric="euclidean", seed=4, device=CPU)
    seeds = vo.random_seeds(9, 12, v.shape[0], seed=5, device=CPU) if seeded else None
    hops = k10.ring_size(L, W) // W
    got = vo.k10_least_bytes(v, a, q, L, W, hops, "euclidean", seeds, True)
    out = k10.vamana_beam_search(v, a, q, L, W, hops, "euclidean", seeds, True)
    ring = out.visited_ids.numpy()
    expanded = set(ring[ring != NIL].tolist())
    adj = a.numpy()
    scored = {1} | {int(x) for e in expanded for x in adj[e] if x != NIL}
    if seeded:
        s = seeds.numpy()
        scored |= {int(x) for x in s[(s != NIL) & (s != 1)]}
    assert got["distinct_nodes_expanded"] == len(expanded)
    assert got["distinct_rows_scored"] == len(scored)
    assert got["nodes_expanded"] == int(out.counts[:, 0].sum()) >= len(expanded)
    assert got["rows_scored"] >= len(scored)
    io = q.numel() * 4 + (0 if seeds is None else seeds.numel() * 4) + 9 * (L + ring.shape[1]) * 8 + 9 * 12
    assert got["bytes"] == len(scored) * 16 * 4 + len(expanded) * 16 * 4 + io


def test_k11_least_bytes_counts_distinct_live_rows():
    """The K11 bound's rows: the distinct ids over the batch's pools that are
    neither -1 nor the pool's own node, at a finite distance."""
    v, _ = vo.random_graph(400, 16, 8, integer=True, metric="euclidean", seed=6, device=CPU)
    d, i, s = vo.prune_pools(v, 12, 64, "euclidean", seed=7)
    got = vo.k11_least_bytes(d, i, s, 16, 32)
    dn, ids, own = d.numpy(), i.numpy(), s.numpy()
    live = {int(x) for r in range(12) for x, dist in zip(ids[r], dn[r])
            if x != NIL and x != own[r] and np.isfinite(dist)}
    assert got["distinct_rows"] == len(live) < got["live_rows"]
    assert got["bytes"] == len(live) * 16 * 4 + ids.size * 8 + 12 * 4 + 12 * 32 * 4
