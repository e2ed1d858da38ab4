"""The port's quantized Vamana walk held against the JAX package's, on the CPU.

The JAX ``_make_gd``'s routes (packed bits by hamming or jaccard, PQ codes
through ADC tables) go through ``gather_bit_distance``, the port's
``_make_gd`` and K10's plain version (``beam_search_plain``) on the same
inputs, made from a numpy seed. A graph and a fitted store that the JAX
``IndexVamana`` built come across by ``to_arrays`` → ``from_arrays``, and
``search`` and ``search_filtered`` must answer as the JAX package does.

Tolerances. Bit distances are integers, and jaccard is one IEEE division
of two of them on both sides: equal. ADC sums of integer-valued tables are
exact in f32 (equal walks); on real-valued tables the sums run in another
order, so distances agree to 1e-6 of the summed terms' magnitude. Reranked
results are held by the tie rule with exact distances within 1e-5 relative;
the user bit metric returns raw bit counts, equal.
"""

import dataclasses
import sys
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semadb_tpu.index.vamana as jax_vamana
import semadb_tpu.models as jax_models
import semadb_tpu.vectorstore.store as jax_store
import semadb_tpu_torch.index.vamana as port_vamana
import semadb_tpu_torch.models as port_models
from semadb_tpu.models.quantizer import BinaryQuantizerParams as JaxBQ
from semadb_tpu.models.quantizer import ProductQuantizerParams as JaxPQ
from semadb_tpu.models.quantizer import Quantizer as JaxQuantizer
from semadb_tpu.models.schema import VectorVamanaParams as JaxParams
from semadb_tpu.ops.distance import gather_bit_distance as jax_gather_bits
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, ProductQuantizerParams, Quantizer
from semadb_tpu_torch.models.schema import VectorVamanaParams as PortParams
from semadb_tpu_torch.ops.distance import gather_bit_distance
from semadb_tpu_torch.ops.kernels import vamana_search as k10
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.store import open_store
from semadb_tpu_torch.tools import vamana_operands as vo
from semadb_tpu_torch.vectorstore.store import QuantConfig, pq_gather_distance

jax_search = sys.modules["semadb_tpu.index.vamana.search"]
jax_graph = sys.modules["semadb_tpu.index.vamana.graph"]
port_search = sys.modules["semadb_tpu_torch.index.vamana.search"]

CPU = torch.device("cpu")
RTOL = 1e-5
NIL = -1
N = 1200
DIM = 32


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _u32(a):
    """int32 words as the JAX package's uint32 words."""
    return jnp.asarray(np.ascontiguousarray(_np(a)).view(np.uint32))


# -- QuantConfig -------------------------------------------------------------


def test_quant_config_user_bit_metric():
    """A hamming or jaccard user metric is a forced binary store flagged
    user_bit_metric, as the JAX package's; a binary quantizer is not."""
    for metric in ("hamming", "jaccard"):
        got = QuantConfig.from_params(None, 64, metric)
        want = jax_store.QuantConfig.from_params(None, 64, metric)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.user_bit_metric and got.threshold == 0.5 and got.metric == "euclidean"
    q = Quantizer(type="binary", binary=BinaryQuantizerParams(distance_metric="jaccard"))
    jq = JaxQuantizer(type="binary", binary=JaxBQ(distance_metric="jaccard"))
    got = QuantConfig.from_params(q, 64, "cosine")
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_store.QuantConfig.from_params(jq, 64, "cosine"))
    assert not got.user_bit_metric


# -- the scoring routes -------------------------------------------------------


def _bit_operands(rng, cap, b, w, ties: bool):
    """Codes i32[cap, w] and query codes i32[B, w]; with ``ties`` the bits
    come from 3 random words, so that many ids sit at one hamming distance,
    and a tenth of the rows and queries are all zero (jaccard's union 0)."""
    if ties:
        base = rng.integers(-2**31, 2**31, (3, w), dtype=np.int64).astype(np.int32)
        codes = base[rng.integers(0, 3, cap)]
        q = base[rng.integers(0, 3, b)]
        codes[rng.random(cap) < 0.1] = 0
        q[rng.random(b) < 0.1] = 0
    else:
        codes = rng.integers(-2**31, 2**31, (cap, w), dtype=np.int64).astype(np.int32)
        q = rng.integers(-2**31, 2**31, (b, w), dtype=np.int64).astype(np.int32)
    return codes, q


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("w", [1, 4, 7])
def test_gather_bit_distance_equals_jax(metric, ties, w):
    rng = np.random.default_rng(w)
    codes, q = _bit_operands(rng, 500, 9, w, ties)
    ids = rng.integers(0, 500, (9, 40)).astype(np.int32)
    got = gather_bit_distance(torch.from_numpy(codes), torch.from_numpy(ids), torch.from_numpy(q), metric)
    want = np.asarray(jax_gather_bits(_u32(codes), jnp.asarray(ids), _u32(q), metric))
    assert np.array_equal(got.numpy(), want)
    if ties:
        assert (got.numpy() == 0).any() and len(np.unique(got.numpy())) < 40


def _graph(seed, integer=True):
    v, a = vo.random_graph(1500, DIM, 32, integer=integer, metric="euclidean", seed=seed, device=CPU)
    return v, a


def _jax_state(v, a):
    return jax_graph.GraphState(jnp.asarray(_np(v)), jnp.asarray(_np(a)), jnp.ones(v.shape[0], bool))


def _quant(kind, bit_metric="hamming", k=16, m=8):
    return jax_store.QuantConfig(kind=kind, dim=DIM, metric="euclidean", bit_metric=bit_metric, num_subvectors=m,
                                 num_centroids=k)


def _route_operands(route, b, seed, integer=True):
    """Graph, queries and the route's operands in both packages' dtypes:
    (v, a, q, port Codes, JAX quant config, JAX codes, JAX prepared)."""
    v, a = _graph(seed)
    q = vo.random_queries(b, DIM, integer=True, metric="euclidean", seed=seed + 1, device=CPU)
    if route in ("hamming", "jaccard"):
        c, p = vo.bit_codes(v, q, zero_rows=0.1, seed=seed)
        return v, a, q, k10.Codes("binary", c, p, route), _quant("binary", route), _u32(c), _u32(p)
    c, p = vo.adc_codes(v.shape[0], b, 8, 16, integer=integer, seed=seed, device=CPU)
    return v, a, q, k10.Codes("product", c, p), _quant("product"), jnp.asarray(_np(c)), jnp.asarray(_np(p))


@pytest.mark.parametrize("route", ["hamming", "jaccard", "adc"])
def test_make_gd_routes_equal_jax(route):
    v, a, q, codes, jq, jc, jp = _route_operands(route, 11, 3)
    ids = np.random.default_rng(4).integers(-1, v.shape[0] + 5, (11, 50)).astype(np.int32)
    st = port_vamana.GraphState(v, a, torch.ones(v.shape[0], dtype=torch.bool))
    pq = QuantConfig(kind=jq.kind, dim=DIM, metric="euclidean", bit_metric=jq.bit_metric, num_subvectors=8,
                     num_centroids=16)
    got = port_search._make_gd(st, q, None, pq, codes.codes, codes.prepared)(torch.from_numpy(ids))
    want = jax_search._make_gd(_jax_state(v, a), jnp.asarray(_np(q)), None, jq, jc, jp)(jnp.asarray(ids))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["hamming", "jaccard", "adc"])
@pytest.mark.parametrize("L,W,track,seeded", [(40, 2, False, False), (40, 2, True, True), (36, 8, True, False),
                                              (36, 2, False, True)])
def test_beam_search_routes_equal_jax(route, L, W, track, seeded):
    """K10's plain version on each route against the JAX walk: equal lists
    (an uncompacted list with its holes dropped, as ``search`` drops them),
    rings and the batch's hops, on integer distances that tie constantly."""
    v, a, q, codes, jq, jc, jp = _route_operands(route, 24, 10 + L + W)
    seeds = vo.random_seeds(24, 16, v.shape[0], seed=L, device=CPU) if seeded else None
    got = k10.beam_search_plain(v, a, q, L, W, 0, "euclidean", seeds=seeds, track_visited=track, codes=codes)
    want = jax_search.beam_search(_jax_state(v, a), jnp.asarray(_np(q)), jax_graph.GraphConfig(
        dim=DIM, degree_bound=32, search_size=L), L, expand_width=W, quant=jq, qcodes=jc, qquery=jp,
        track_visited=track, seed_ids=None if seeds is None else jnp.asarray(_np(seeds)))
    if track:
        assert np.array_equal(_np(got.cand_ids), np.asarray(want.cand_ids))
        assert np.array_equal(_np(got.cand_dists), np.asarray(want.cand_dists))
        assert np.array_equal(_np(got.visited_ids), np.asarray(want.visited_ids))
        assert np.array_equal(_np(got.visited_dists), np.asarray(want.visited_dists))
    else:
        for b in range(24):
            gi, wi = _np(got.cand_ids)[b], np.asarray(want.cand_ids)[b]
            assert np.array_equal(gi[gi != NIL], wi[wi != NIL]), b
    assert int(got.hops.max()) == int(want.hops)


def test_beam_search_adc_real_tables_within_tolerance():
    """Real-valued tables: the walks' list distances agree to 1e-6 of the
    summed terms, and the lists hold the same ids but where a near-tie parts."""
    v, a, q, codes, jq, jc, jp = _route_operands("adc", 32, 21, integer=False)
    got = k10.beam_search_plain(v, a, q, 40, 2, 0, "euclidean", track_visited=True, codes=codes)
    want = jax_search.beam_search(_jax_state(v, a), jnp.asarray(_np(q)), jax_graph.GraphConfig(
        dim=DIM, degree_bound=32, search_size=40), 40, expand_width=2, quant=jq, qcodes=jc, qquery=jp)
    gi, wi = _np(got.cand_ids), np.asarray(want.cand_ids)
    same = gi == wi
    assert same.mean() >= 0.95
    ref = pq_gather_distance(codes.codes, torch.from_numpy(gi).clamp(min=0), codes.prepared, 16).numpy()
    ok = gi != NIL
    assert np.abs(_np(got.cand_dists)[ok] - ref[ok]).max() <= 1e-6 * 4 * 8
    assert np.abs(_np(got.cand_dists)[same & ok] - np.asarray(want.cand_dists)[same & ok]).max() <= 1e-6 * 4 * 8


# -- quantized search end to end ----------------------------------------------


def _build_pair(kind, rng_seed=0):
    """A JAX IndexVamana with a fitted store of ``kind`` and the port's copy
    of it (to_arrays → from_arrays). Integer vectors (0/1 for the user bit
    metrics), an integer start vector, so every f32 distance is exact."""
    rng = np.random.default_rng(rng_seed)
    user_bits = kind in ("user_hamming", "user_jaccard")
    vecs = (rng.integers(0, 2, (N, DIM)) if user_bits else rng.integers(-8, 9, (N, DIM))).astype(np.float32)
    if kind.startswith("user_"):
        metric, jq, pq = kind[5:], None, None
    elif kind.startswith("bq"):
        bm = kind[3:]
        metric = "euclidean"
        jq = JaxQuantizer(type="binary", binary=JaxBQ(distance_metric=bm, trigger_threshold=1000))
        pq = Quantizer(type="binary", binary=BinaryQuantizerParams(distance_metric=bm, trigger_threshold=1000))
    else:
        opq = kind == "pq_opq"
        metric = "euclidean"
        jq = JaxQuantizer(type="product", product=JaxPQ(num_centroids=16, num_subvectors=8, trigger_threshold=1000,
                                                        opq=opq))
        pq = Quantizer(type="product", product=ProductQuantizerParams(num_centroids=16, num_subvectors=8,
                                                                      trigger_threshold=1000, opq=opq))
    jp = JaxParams(vector_size=DIM, distance_metric=metric, search_size=36, degree_bound=32, quantizer=jq)
    jidx = jax_vamana.IndexVamana(jp)
    st = jidx.state
    start = (rng.integers(0, 2, DIM) if user_bits else rng.integers(-8, 9, DIM)).astype(np.float32)
    jidx.state = jax_graph.GraphState(st.vectors.at[1].set(jnp.asarray(start)), st.adjacency, st.exists)
    jidx.insert_update_delete(zip(range(2, N + 2), vecs))
    assert jidx.store.fitted
    params = PortParams(vector_size=DIM, distance_metric=metric, search_size=36, degree_bound=32, quantizer=pq)
    pidx = port_vamana.IndexVamana.from_arrays(params, jidx.to_arrays(), CPU)
    assert pidx.store.fitted and pidx.store.state.codes.shape[0] == pidx.capacity
    queries = (rng.integers(0, 2, (40, DIM)) if user_bits else rng.integers(-8, 9, (40, DIM))).astype(np.float32)
    return jidx, pidx, vecs, queries


KINDS = ["bq_hamming", "bq_jaccard", "pq", "pq_opq", "user_hamming"]


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    return request.param, _build_pair(request.param)


def _dist_table(kind, pidx, queries):
    """id → the distance a result must carry: raw bits for the user bit
    metric, else exact squared euclidean (the rerank)."""
    v = pidx.vectors.numpy()
    if kind.startswith("user_"):
        qc = pidx.store.prepare_queries(torch.from_numpy(queries))
        return port_search.gather_bit_distance(
            pidx.store.state.codes, torch.arange(pidx.capacity)[None, :].expand(len(queries), -1).contiguous(), qc,
            kind[5:]).numpy()
    return ((queries[:, None, :].astype(np.float64) - v[None].astype(np.float64)) ** 2).sum(-1)


def _compare(kind, want, got, table):
    (wd, wi), (gd, gi) = want, got
    for b in range(len(wd)):
        scale = 0.0 if kind.startswith("user_") else RTOL * (1.0 + float(np.abs(wd[b][np.isfinite(wd[b])]).max()))
        errs = tie_rule_errors(wd[b], wi[b].tolist(), gd[b], gi[b].tolist(), table[b], atol=scale)
        assert not errs, (kind, b, errs[:3])
        if kind.startswith("user_"):
            assert np.array_equal(wd[b], gd[b])


def test_quantized_search_equals_jax(pair):
    kind, (jidx, pidx, vecs, queries) = pair
    table = _dist_table(kind, pidx, queries)
    want = jidx.search_batch(queries, 10)
    got = pidx.search_batch(queries, 10)
    _compare(kind, want, got, table)


def test_quantized_search_filtered_equals_jax(pair):
    kind, (jidx, pidx, vecs, queries) = pair
    table = _dist_table(kind, pidx, queries)
    fm = np.arange(pidx.capacity) % 3 == 0
    want = jidx.search_batch(queries, 10, filter_mask=fm)
    got = pidx.search_batch(queries, 10, filter_mask=fm)
    _compare(kind, want, got, table)
    assert (got[1][got[1] != NIL] % 3 == 0).all()


def test_quantized_search_reranks_through_k4(pair, monkeypatch):
    """The unfiltered search of a reranked store goes through K4's wrapper
    with dedup (its plain version on the CPU); the user bit metric does not
    rerank."""
    kind, (jidx, pidx, vecs, queries) = pair
    calls = []
    real = port_search.ivf_exact_rerank

    def spy(*args, **kwargs):
        calls.append((args[2].shape, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_search, "ivf_exact_rerank", spy)
    pidx.search_batch(queries[:4], 10)
    if kind.startswith("user_"):
        assert calls == []
    else:
        L = pidx.params.search_size
        assert calls == [((4, L + k10.ring_size(L, 2)), {"dedup": True})]


@pytest.mark.parametrize("kind", ["bq_hamming", "pq", "user_hamming", "user_jaccard"])
def test_port_built_quantized_index_self_recall(kind):
    """A quantized index the port builds itself (the builds do not repeat
    the JAX package's bit for bit, F6): its points find themselves, at the
    distance 0 after the rerank or in raw bits."""
    rng = np.random.default_rng(5)
    user_bits = kind.startswith("user_")
    vecs = (rng.integers(0, 2, (600, 64)) if user_bits else rng.random((600, 64)) * 2).astype(np.float32)
    if user_bits:
        params = PortParams(vector_size=64, distance_metric=kind[5:], search_size=36, degree_bound=32)
    elif kind == "bq_hamming":
        params = PortParams(vector_size=64, distance_metric="euclidean", search_size=36, degree_bound=32,
                            quantizer=Quantizer(type="binary", binary=BinaryQuantizerParams(trigger_threshold=100)))
    else:
        params = PortParams(vector_size=64, distance_metric="euclidean", search_size=36, degree_bound=32,
                            quantizer=Quantizer(type="product", product=ProductQuantizerParams(
                                num_centroids=32, num_subvectors=8, trigger_threshold=1000)))
    idx = port_vamana.IndexVamana(params, CPU)
    if kind == "pq":
        idx.store.config = dataclasses.replace(idx.store.config, trigger=100)
    ids = np.arange(2, 602)
    idx.insert_update_delete(zip(ids[:300], vecs[:300]))
    assert idx.store.fitted
    idx.insert_update_delete(zip(ids[300:], vecs[300:]))  # encoded after the fit
    assert idx.store.state.codes.shape[0] == idx.capacity
    d, i = idx.search_batch(vecs[::20], 5)
    hits = [ids[::20][b] in i[b] for b in range(len(i))]
    assert np.mean(hits) >= 0.8
    for b in range(len(i)):
        pos = np.nonzero(i[b] == ids[::20][b])[0]
        if len(pos) and not user_bits:
            assert d[b, pos[0]] == pytest.approx(0.0, abs=1e-4)
        elif len(pos):
            assert d[b, pos[0]] == 0.0


def test_codes_grow_with_the_graph():
    """The code table keeps the graph's capacity through growth (F1's one
    chain), so a search reads no row past it and copies nothing."""
    params = PortParams(vector_size=DIM, distance_metric="hamming", search_size=20, degree_bound=16)
    idx = port_vamana.IndexVamana(params, CPU)
    assert idx.store.state.codes.shape[0] == idx.capacity
    rng = np.random.default_rng(1)
    vecs = rng.integers(0, 2, (400, DIM)).astype(np.float32)
    idx.insert_update_delete(zip(range(2, 402), vecs))
    assert idx.capacity > 128 and idx.store.state.codes.shape[0] == idx.capacity
    d, i = idx.search_batch(vecs[:4], 1)
    assert list(i[:, 0]) == [2, 3, 4, 5] and (d == 0).all()


# -- persistence ---------------------------------------------------------------


def _collection(models, kind):
    if kind == "bq":
        entry = {"vectorSize": DIM, "distanceMetric": "euclidean", "searchSize": 36, "degreeBound": 32,
                 "quantizer": {"type": "binary", "binary": {"distanceMetric": "hamming", "triggerThreshold": 1000}}}
    else:
        entry = {"vectorSize": DIM, "distanceMetric": "euclidean", "searchSize": 36, "degreeBound": 32,
                 "quantizer": {"type": "product", "product": {"numCentroids": 16, "numSubVectors": 8,
                                                              "triggerThreshold": 1000}}}
    schema = models.IndexSchema.from_dict({"v": {"type": "vectorVamana", "vectorVamana": entry}})
    return models.Collection(user_id="u1", id="c1", index_schema=schema, user_plan=models.UserPlan())


def _requests(models, queries, flt=False):
    out = []
    for q in queries:
        body = {"query": {"property": "v", "vectorVamana": {"vector": q.tolist(), "limit": 5}}, "limit": 5}
        out.append(models.SearchRequest.from_dict(body))
    return out


@pytest.mark.parametrize("kind", ["bq", "pq"])
def test_jax_written_quantized_vamana_shard_opens_in_port(tmp_path, kind):
    """A shard the JAX package wrote with a fitted BQ or PQ vectorVamana (a
    flushed snapshot holding the graph and the codes, then journaled writes
    encoded after the fit) opens in the port and answers the JAX shard's
    searches by the tie rule, distances exact after the rerank."""
    rng = np.random.default_rng(14)
    vecs = rng.integers(-8, 9, (1400, DIM)).astype(np.float32)
    queries = rng.integers(-8, 9, (10, DIM)).astype(np.float32)
    path = str(tmp_path / "s.sdb")
    jsh = JaxShard(jax_open_store(path), _collection(jax_models, kind))
    pts = [jax_models.Point.from_map({"v": vecs[i].tolist()}, uuid.UUID(int=i + 1)) for i in range(1400)]
    jsh.insert_points(pts[:1200])
    jsh.flush()  # the snapshot holds the fitted codes
    jsh.insert_points(pts[1200:])  # journal only from here on
    jsh.delete_points({pts[3].id, pts[1300].id})
    want = jsh.search_points_batch_wire(_requests(jax_models, queries))
    jsh.db.close()
    tsh = Shard(open_store(path), _collection(port_models, kind), CPU)
    try:
        assert tsh.point_count() == 1398
        (idx,) = tsh.device_indices.values()
        assert idx.store.fitted and idx.store.state.codes.shape[0] == idx.capacity
        got = tsh.search_points_batch_wire(_requests(port_models, queries))
        tsh.flush()  # the port's snapshot carries the codes too
    finally:
        tsh.close()
    row_of = {str(uuid.UUID(int=i + 1)): i for i in range(1400)}
    for b, (q, wrow, grow) in enumerate(zip(queries, want, got)):
        d = ((vecs.astype(np.float64) - q) ** 2).sum(-1)
        errs = tie_rule_errors([p["_distance"] for p in wrow], [p["_id"] for p in wrow],
                               [p["_distance"] for p in grow], [p["_id"] for p in grow],
                               lambda pid: d[row_of[pid]], atol=RTOL * (1.0 + float(d.max())))
        assert errs == [], (b, errs)
        assert {str(uuid.UUID(int=4)), str(uuid.UUID(int=1301))}.isdisjoint(p["_id"] for p in grow)
    tsh = Shard(open_store(path), _collection(port_models, kind), CPU)
    try:
        again = tsh.search_points_batch_wire(_requests(port_models, queries))
        assert [[p["_id"] for p in r] for r in again] == [[p["_id"] for p in r] for r in got]
    finally:
        tsh.close()
