"""The port's inverted and text indices, filters and hybrid search, held
against the JAX package's on the CPU.

The same points (a 16-d ``vectorIVF`` vector beside ``text``, ``string``,
``integer``, ``float`` and ``stringArray`` properties, made from a seed with
numpy) go into a JAX ``Shard`` and a port ``Shard`` in two write
transactions, then the same updates (values changed, a property removed by
the ``"_delete"`` tombstone) and deletes. Every query tree then goes to both:
each operator of each host type; text ``containsAny`` and ``containsAll``
with a filter and a limit; ``_and`` and ``_or`` with weights; ``vectorIVF``
filtered by each host type. Ids, text scores and set results must be equal
(the host indices are copies of the JAX modules, so their arithmetic is the
same); vector distances and hybrid scores agree within 1e-5 (the sums run in
another order), vector ids by the tie rule. The IVF builds differ (the JAX
k-means seeds from ``jax.random``), so the corpus is small enough that
``numProbes`` covers every cluster: both sides are then exact.

Also: the decoded postings survive transactions in the port's shard and are
scrapped when a write fails, and the port's HTTP v2 server takes a hybrid
schema and answers as the JAX server does.
"""

import uuid

import numpy as np
import pytest
import requests
import torch

import semadb_tpu.models as jax_models
import semadb_tpu_torch.models as port_models
from semadb_tpu.cluster.node import ClusterNode as JaxClusterNode
from semadb_tpu.cluster.node import ClusterNodeConfig as JaxClusterNodeConfig
from semadb_tpu.httpapi.server import HttpApiConfig as JaxHttpApiConfig
from semadb_tpu.httpapi.server import HttpServer as JaxHttpServer
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
from semadb_tpu_torch.httpapi.server import HttpApiConfig, HttpServer
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.store import open_store

CPU = torch.device("cpu")
RTOL = 1e-5
DIM = 16
N = 600  # past the IVF's first fit (512 points): 32 clusters
PROBES = 64  # at least every cluster
SCHEMA = {
    "vector": {"type": "vectorIVF", "vectorIVF": {"vectorSize": DIM, "distanceMetric": "euclidean"}},
    "body": {"type": "text", "text": {"analyser": "standard"}},
    "category": {"type": "string", "string": {"caseSensitive": False}},
    "year": {"type": "integer", "integer": {}},
    "rating": {"type": "float", "float": {}},
    "tags": {"type": "stringArray", "stringArray": {"caseSensitive": False}},
}
WORDS = [f"w{i}" for i in range(60)]
IDS = [uuid.UUID(int=i + 1) for i in range(N)]


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    ranks = np.minimum(rng.zipf(1.3, size=(N, 6)) - 1, len(WORDS) - 1)
    docs = []
    for i in range(N):
        docs.append({
            "vector": vecs[i].tolist(),
            "body": " ".join(WORDS[r] for r in ranks[i]) + (" The quick" if i % 7 == 0 else ""),
            "category": ["Alpha", "beta", "gamma", "delta", "epsilon"][int(rng.integers(5)) if i % 9 else 0],
            "year": int(rng.integers(1990, 2025)),
            "rating": float(np.round(rng.uniform(0, 5), 2)),
            "tags": [f"t{j}" for j in rng.choice(12, size=int(rng.integers(1, 4)), replace=False)],
        })
    return vecs, docs


VECS, DOCS = _corpus()
QUERY_VECS = np.random.default_rng(1).standard_normal((3, DIM)).astype(np.float32)
# Updates: new values for some points, a property removed for others; deletes
UPDATES = {i: {"category": "Zeta", "year": 1989, "body": "w1 w2 w2", "tags": ["t1", "t99"]} for i in range(0, 40, 4)}
UPDATES.update({i: {"tags": "_delete", "rating": "_delete", "body": "_delete"} for i in range(2, 40, 8)})
DELETES = {IDS[i] for i in range(5, 40, 10)}


def _collection(models):
    schema = models.IndexSchema.from_dict(SCHEMA)
    return models.Collection(user_id="u", id="c", index_schema=schema, user_plan=models.UserPlan())


def _load(shard, models):
    pts = [models.Point.from_map(DOCS[i], IDS[i]) for i in range(N)]
    shard.insert_points(pts[:300])
    shard.insert_points(pts[300:])
    shard.update_points([models.Point.from_map(v, IDS[i]) for i, v in UPDATES.items()])
    shard.delete_points(set(DELETES))
    return shard


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("hybrid")
    jax_shard = _load(JaxShard(jax_open_store(str(root / "jax")), _collection(jax_models)), jax_models)
    port_shard = _load(Shard(open_store(str(root / "port")), _collection(port_models), CPU), port_models)
    yield jax_shard, port_shard
    jax_shard.close()
    port_shard.close()


def _near(q, limit=10, flt=None, weight=None):
    opts = {"vector": q.tolist(), "operator": "near", "limit": limit, "numProbes": PROBES}
    if flt is not None:
        opts["filter"] = flt
    if weight is not None:
        opts["weight"] = weight
    return {"property": "vector", "vectorIVF": opts}


def _text(value, op="containsAny", limit=10, flt=None, weight=None):
    opts = {"value": value, "operator": op, "limit": limit}
    if flt is not None:
        opts["filter"] = flt
    if weight is not None:
        opts["weight"] = weight
    return {"property": "body", "text": opts}


def _prop(prop, kind, value, op, end=None):
    opts = {"value": value, "operator": op}
    if end is not None:
        opts["endValue"] = end
    return {"property": prop, kind: opts}


CAT = lambda op, v="beta", end=None: _prop("category", "string", v, op, end)  # noqa: E731
YEAR = lambda op, v=2005, end=None: _prop("year", "integer", v, op, end)  # noqa: E731
RATING = lambda op, v=2.5, end=None: _prop("rating", "float", v, op, end)  # noqa: E731
TAGS = lambda op, v=("t1", "t3"): {"property": "tags", "stringArray": {"value": list(v), "operator": op}}  # noqa: E731
RANGE_OPS = ("equals", "notEquals", "greaterThan", "greaterThanOrEquals", "lessThan", "lessThanOrEquals")

QUERIES = {
    **{f"string {op}": CAT(op) for op in RANGE_OPS},
    "string equals, other case": CAT("equals", "ALPHA"),
    "string startsWith": CAT("startsWith", "e"),
    "string inRange": CAT("inRange", "beta", "delta"),
    **{f"integer {op}": YEAR(op) for op in RANGE_OPS},
    "integer inRange": YEAR("inRange", 1995, 2001),
    **{f"float {op}": RATING(op, 1.23 if op in ("equals", "notEquals") else 2.5) for op in RANGE_OPS},
    "float inRange": RATING("inRange", 1.0, 2.0),
    "stringArray containsAny": TAGS("containsAny"),
    "stringArray containsAll": TAGS("containsAll"),
    "text containsAny": _text("w0 w3 quick"),
    "text containsAll": _text("w0 w1", "containsAll"),
    "text containsAny, filtered, limit 5": _text("w2 w5", limit=5, flt=YEAR("greaterThan", 2000)),
    "text containsAll, filtered": _text("w1 w2", "containsAll", flt=TAGS("containsAny", ("t1", "t2", "t99"))),
    "_and of a range and tags": {"property": "_and", "_and": [YEAR("inRange", 2000, 2010), TAGS("containsAny")]},
    "_or of vector and text, weights 1 and 0.5": {
        "property": "_or", "_or": [_near(QUERY_VECS[0], weight=1.0), _text("w0 w4", weight=0.5)]},
    "_and of vector and text, weights 2 and 1": {
        "property": "_and", "_and": [_near(QUERY_VECS[1], limit=60, weight=2.0), _text("w0 w1 w2", limit=60)]},
    "vectorIVF filtered by string": _near(QUERY_VECS[2], flt=CAT("equals", "gamma")),
    "vectorIVF filtered by integer": _near(QUERY_VECS[2], flt=YEAR("lessThan", 2000)),
    "vectorIVF filtered by float": _near(QUERY_VECS[2], flt=RATING("inRange", 2.0, 4.0)),
    "vectorIVF filtered by stringArray": _near(QUERY_VECS[2], flt=TAGS("containsAll", ("t2",))),
    "vectorIVF filtered by text": _near(QUERY_VECS[2], flt=_text("w0 w2", limit=50)),
    "vectorIVF filtered by _and": _near(QUERY_VECS[2], flt={"property": "_and", "_and": [
        CAT("notEquals", "beta"), RATING("greaterThanOrEquals", 1.5)]}),
}


def _rows(models, shard, query):
    req = models.SearchRequest.from_dict({"query": query, "limit": 100})
    out = []
    for r in shard.search_points(req):
        out.append((str(r.point.id), r.distance, r.score, r.hybrid_score))
    return out


def _row_of(pid):
    return uuid.UUID(pid).int - 1


@pytest.mark.parametrize("name", list(QUERIES))
def test_query_matches_jax(shards, name):
    query = QUERIES[name]
    jax_shard, port_shard = shards
    want = _rows(jax_models, jax_shard, query)
    got = _rows(port_models, port_shard, query)
    assert len(want) > 0, "the query should match something"
    assert {r[0] for r in got} == {r[0] for r in want}
    if all(r[1] is None for r in want):  # sets and text: the same list, the same scores
        assert got == want
        if name.startswith("text"):
            scores = [r[2] for r in got]
            assert scores == sorted(scores, reverse=True)
        return
    hybrid = {r[0]: r[3] for r in want}
    for pid, _, score, hs in got:
        assert abs(hs - hybrid[pid]) <= RTOL * max(1.0, abs(hs))
        assert score == {r[0]: r[2] for r in want}[pid]
    if name.startswith("vectorIVF"):
        vecs = VECS.astype(np.float64)
        q = np.asarray(query["vectorIVF"]["vector"], np.float64)
        dist = {pid: float(((vecs[_row_of(pid)] - q) ** 2).sum()) for pid, *_ in want}
        dist.update({pid: float(((vecs[_row_of(pid)] - q) ** 2).sum()) for pid, *_ in got})
        errs = tie_rule_errors([r[1] for r in want], [r[0] for r in want], [r[1] for r in got],
                               [r[0] for r in got], dist, atol=RTOL * (1.0 + max(dist.values())))
        assert errs == [], errs


def test_filter_mask_holds_the_filter_set():
    """The mask the manager hands the vector index: the members below the
    index's capacity, nothing else."""
    from semadb_tpu_torch.index.manager import IndexManager

    class Idx:
        capacity = 64

    members = {0, 5, 63, 64, 1000}
    mask = IndexManager._filter_mask(Idx, members)
    assert mask.dtype == bool and mask.shape == (64,)
    assert set(np.nonzero(mask)[0].tolist()) == {0, 5, 63}
    assert IndexManager._filter_mask(Idx, None) is None
    assert not IndexManager._filter_mask(Idx, set()).any()


def test_postings_cache_survives_txns_and_scraps_on_failure(tmp_path):
    """Scalar inverted postings decode once and survive across transactions
    in the port's shard; a failed txn scraps the cache (it may hold
    rolled-back mutations). The JAX test of the same name, plus a txn that
    fails after its postings reached the cache."""
    from semadb_tpu_torch.index import inverted as inv_mod
    from semadb_tpu_torch.models import Collection, IndexSchema, Point, UserPlan
    from semadb_tpu_torch.models.query import SearchRequest

    schema = IndexSchema.from_dict(
        {"n": {"type": "integer", "integer": {}},
         "v": {"type": "vectorFlat", "vectorFlat": {"vectorSize": 2, "distanceMetric": "euclidean"}}}
    )
    col = Collection(user_id="u", id="c", index_schema=schema, user_plan=UserPlan())
    sh = Shard(open_store(str(tmp_path / "s.sdb")), col, CPU)

    def pts(lo, hi):
        return [Point.from_map({"n": i, "v": [float(i), 0.0]}, uuid.UUID(int=i + 1)) for i in range(lo, hi)]

    sh.insert_points(pts(0, 50))

    def rng_search(lo, hi, limit=100):
        sr = SearchRequest.from_dict(
            {"query": {"property": "n", "integer": {"value": lo, "endValue": hi, "operator": "inRange"}},
             "limit": limit}
        )
        return {r.point.id.int - 1 for r in sh.search_points(sr)}

    assert rng_search(10, 12) == {10, 11, 12}
    decodes = []
    orig = inv_mod._decode_set

    def spy(raw):
        decodes.append(1)
        return orig(raw)

    inv_mod._decode_set = spy
    try:
        assert rng_search(10, 12) == {10, 11, 12}
        assert not decodes, "postings were re-decoded despite the cache"
        sh.insert_points(pts(50, 55))
        assert rng_search(49, 51) == {49, 50, 51}
        sh.delete_points([uuid.UUID(int=51)])
        assert rng_search(49, 51) == {49, 51}
        with pytest.raises(Exception):  # a duplicate id fails the txn after the cache was touched
            sh.insert_points([Point.from_map({"n": 999, "v": [9.0, 0.0]}, uuid.UUID(int=50))])
        assert rng_search(995, 1000) == set()
        assert rng_search(49, 51) == {49, 51}
        # A txn that fails after the dispatch wrote the integer postings (a
        # vector of the wrong length fails the vector index next): the scrap
        # drops the rolled-back postings, so the node id the next insert
        # reuses is not found under n = 777
        with pytest.raises(RuntimeError):
            sh.insert_points([Point.from_map({"n": 777, "v": [1.0, 2.0, 3.0]}, uuid.UUID(int=900))])
        sh.insert_points(pts(55, 56))
        eq = SearchRequest.from_dict({"query": {"property": "n", "integer": {"value": 777, "operator": "equals"}}})
        assert sh.search_points(eq) == []
        assert rng_search(55, 56) == {55}
    finally:
        inv_mod._decode_set = orig
    sh.close()

    sh2 = Shard(open_store(str(tmp_path / "s.sdb")), col, CPU)
    sr = SearchRequest.from_dict(
        {"query": {"property": "n", "integer": {"value": 49, "endValue": 51, "operator": "inRange"}}, "limit": 10}
    )
    assert {r.point.id.int - 1 for r in sh2.search_points(sr)} == {49, 51}
    sh2.close()


def _start(kind, root):
    if kind == "jax":
        node = JaxClusterNode(JaxClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0))
        node.serve()
        srv = JaxHttpServer(node, JaxHttpApiConfig(
            http_host="127.0.0.1", http_port=0, user_plans={"BASIC": jax_models.UserPlan(name="BASIC")}))
    else:
        node = ClusterNode(ClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0), CPU)
        node.serve()
        srv = HttpServer(node, HttpApiConfig(
            http_host="127.0.0.1", http_port=0, user_plans={"BASIC": port_models.UserPlan(name="BASIC")}))
    srv.serve_background()
    return node, srv, f"http://127.0.0.1:{srv.port}/v2/collections"


def test_http_hybrid_collection_matches_jax(tmp_path):
    """A hybrid schema over HTTP v2: the port's server creates it, takes the
    points and answers filtered, text and hybrid searches as the JAX server
    does."""
    headers = {"X-User-Id": "u1", "X-Plan-Id": "BASIC"}
    searches = [QUERIES[n] for n in ("text containsAny", "vectorIVF filtered by stringArray",
                                     "_or of vector and text, weights 1 and 0.5", "string startsWith")]
    answers = {}
    for kind in ("jax", "port"):
        node, srv, base = _start(kind, str(tmp_path / kind))
        try:
            r = requests.post(base, json={"id": "hybrid", "indexSchema": SCHEMA}, headers=headers)
            assert r.status_code == 200, r.text
            pts = [{"_id": str(IDS[i]), **DOCS[i]} for i in range(N)]
            r = requests.post(f"{base}/hybrid/points", json={"points": pts}, headers=headers)
            assert r.status_code == 200 and r.json()["failedRanges"] == [], r.text
            answers[kind] = [requests.post(f"{base}/hybrid/points/search", json={"query": q, "limit": 20},
                                           headers=headers).json()["points"] for q in searches]
        finally:
            srv.shutdown()
            node.close()
    for want, got in zip(answers["jax"], answers["port"]):
        assert [p["_id"] for p in got] and {p["_id"] for p in got} == {p["_id"] for p in want}
        hybrid = {p["_id"]: p["_hybridScore"] for p in want}
        for p in got:
            assert abs(p["_hybridScore"] - hybrid[p["_id"]]) <= RTOL * max(1.0, abs(p["_hybridScore"]))
            assert p.get("_score") == next(w.get("_score") for w in want if w["_id"] == p["_id"])
