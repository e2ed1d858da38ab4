"""The port's whole slice held against the JAX package's, over HTTP v2.

Both servers run in-process on ephemeral ports (JAX on the CPU, the port on
``cpu``) and get the same v2 requests: create a 1536-d ``vectorFlat``
collection with a binary quantizer (hamming, threshold 0.0), insert 2,000
points with a small ``maxShardSize`` so the collection spans several shards,
then single, batch and select searches and one delete. Every response is
held against a numpy brute-force hamming scan over the sign bits by the tie
rule (``semadb_tpu_torch.ops.topk.tie_rule_errors``; bit distances are
exact), and the two servers against each other the same way. Shard files
either package wrote — a flushed snapshot, and a snapshot plus journal —
open in the other. Each package gets its own model objects, built from the
same dicts.
"""

import uuid

import numpy as np
import pytest
import requests
import torch

from semadb_tpu.cluster.node import ClusterNode as JaxClusterNode
from semadb_tpu.cluster.node import ClusterNodeConfig as JaxClusterNodeConfig
from semadb_tpu.httpapi.server import HttpApiConfig as JaxHttpApiConfig
from semadb_tpu.httpapi.server import HttpServer as JaxHttpServer
import semadb_tpu.models as jax_models
import semadb_tpu_torch.models as port_models
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
from semadb_tpu_torch.httpapi.server import HttpApiConfig, HttpServer
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.store import open_store

CPU = torch.device("cpu")
DIM = 1536
N_POINTS = 2000
HEADERS = {"X-User-Id": "u1", "X-Plan-Id": "BASIC"}
SCHEMA = {
    "vector": {
        "type": "vectorFlat",
        "vectorFlat": {
            "vectorSize": DIM,
            "distanceMetric": "cosine",
            "quantizer": {"type": "binary", "binary": {"distanceMetric": "hamming", "threshold": 0.0}},
        },
    }
}
# About 14 KB a point as msgpack: 8 MiB holds ~600, so 2,000 span ≥ 3 shards
MAX_SHARD_SIZE = 8 * 2**20


def _data(n, seed):
    v = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


VECTORS = _data(N_POINTS, 0)
QUERIES = _data(6, 1)
IDS = [str(uuid.UUID(int=i + 1)) for i in range(N_POINTS)]


def _bits(v):
    return np.packbits(v > 0.0, axis=-1)


def _hamming(q, live):
    """Brute-force hamming of one query to every live point: {uuid: d}."""
    d = np.unpackbits(_bits(q)[None, :] ^ _bits(VECTORS), axis=-1).sum(-1)
    return {IDS[i]: float(d[i]) for i in range(N_POINTS) if live[i]}


def _check(points, q, live, k=10):
    dist = _hamming(q, live)
    ref = sorted(dist.items(), key=lambda kv: kv[1])[:k]
    got_d = [p["_distance"] for p in points]
    got_ids = [p["_id"] for p in points]
    errs = tie_rule_errors([d for _, d in ref], [i for i, _ in ref], got_d, got_ids, dist)
    assert errs == [], errs
    assert all(p["_hybridScore"] == -p["_distance"] for p in points)
    return got_d, got_ids


def _start(kind, root):
    if kind == "jax":
        plans = {"BASIC": jax_models.UserPlan(name="BASIC")}
        node = JaxClusterNode(JaxClusterNodeConfig(
            root_dir=root, rpc_host="127.0.0.1", rpc_port=0, max_shard_size=MAX_SHARD_SIZE))
        node.serve()
        srv = JaxHttpServer(node, JaxHttpApiConfig(http_host="127.0.0.1", http_port=0, user_plans=plans))
    else:
        plans = {"BASIC": port_models.UserPlan(name="BASIC")}
        node = ClusterNode(ClusterNodeConfig(
            root_dir=root, rpc_host="127.0.0.1", rpc_port=0, max_shard_size=MAX_SHARD_SIZE), CPU)
        node.serve()
        srv = HttpServer(node, HttpApiConfig(http_host="127.0.0.1", http_port=0, user_plans=plans))
    srv.serve_background()
    return node, srv, f"http://127.0.0.1:{srv.port}/v2/collections"


def _search_body(q, limit=10, select=None):
    body = {"query": {"property": "vector", "vectorFlat": {"vector": q.tolist(), "operator": "near", "limit": limit}}}
    if select:
        body["select"] = select
    return body


def _drive(base):
    """Send the slice's requests; return the search responses."""
    out = {}
    r = requests.post(base, json={"id": "dbpedia", "indexSchema": SCHEMA}, headers=HEADERS)
    assert r.status_code == 200, r.text
    for lo in range(0, N_POINTS, 1000):
        pts = [{"_id": IDS[i], "vector": VECTORS[i].tolist(), "n": i} for i in range(lo, lo + 1000)]
        r = requests.post(f"{base}/dbpedia/points", json={"points": pts}, headers=HEADERS)
        assert r.status_code == 200 and r.json()["failedRanges"] == [], r.text
    r = requests.get(f"{base}/dbpedia", headers=HEADERS)
    out["shards"] = sorted(s["pointCount"] for s in r.json()["shards"])
    out["single"] = [
        requests.post(f"{base}/dbpedia/points/search", json=_search_body(q), headers=HEADERS).json()["points"]
        for q in QUERIES[:3]
    ]
    r = requests.post(
        f"{base}/dbpedia/points/search/batch",
        json={"queries": [_search_body(q) for q in QUERIES]}, headers=HEADERS,
    )
    out["batch"] = [row["points"] for row in r.json()["results"]]
    out["select"] = requests.post(
        f"{base}/dbpedia/points/search", json=_search_body(QUERIES[0], select=["n"]), headers=HEADERS
    ).json()["points"]
    dist0 = _hamming(QUERIES[0], np.ones(N_POINTS, bool))
    victim = min(IDS, key=lambda i: dist0[i])  # a nearest point of query 0
    r = requests.delete(f"{base}/dbpedia/points", json={"ids": [victim]}, headers=HEADERS)
    assert r.status_code == 200 and r.json()["failedPoints"] == [], r.text
    out["victim"] = victim
    out["after_delete"] = requests.post(
        f"{base}/dbpedia/points/search", json=_search_body(QUERIES[0]), headers=HEADERS
    ).json()["points"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for kind in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(kind))
        node, srv, base = _start(kind, root)
        try:
            out[kind] = _drive(base)
        finally:
            srv.shutdown()
            node.close()
        out[kind]["root"] = root
    return out


def test_slice_spans_shards(runs):
    assert runs["port"]["shards"] == runs["jax"]["shards"]
    assert len(runs["port"]["shards"]) >= 2 and sum(runs["port"]["shards"]) == N_POINTS


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_slice_searches_match_brute_force(runs, kind):
    all_live = np.ones(N_POINTS, bool)
    for q, pts in zip(QUERIES, runs[kind]["single"]):
        _check(pts, q, all_live)
    for q, pts in zip(QUERIES, runs[kind]["batch"]):
        _check(pts, q, all_live)
    live = all_live.copy()
    live[IDS.index(runs[kind]["victim"])] = False
    _check(runs[kind]["after_delete"], QUERIES[0], live)
    # The object path (select) gives the same results, with the field
    sel = runs[kind]["select"]
    _check(sel, QUERIES[0], all_live)
    assert all(p["n"] == IDS.index(p["_id"]) for p in sel)


def test_port_matches_jax_server(runs):
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["victim"] == jax_run["victim"]
    for key in ("single", "batch"):
        for q, jpts, tpts in zip(QUERIES, jax_run[key], port_run[key]):
            dist = _hamming(q, np.ones(N_POINTS, bool))
            errs = tie_rule_errors(
                [p["_distance"] for p in jpts], [p["_id"] for p in jpts],
                [p["_distance"] for p in tpts], [p["_id"] for p in tpts], dist,
            )
            assert errs == [], errs


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "port"), ("port", "jax")])
def test_flushed_shards_reopen(runs, writer, reader):
    """A closed server's root (every shard flushed a snapshot) served again,
    by the port or by the JAX package: the snapshot format is shared."""
    node, srv, base = _start(reader, runs[writer]["root"])
    try:
        r = requests.get(f"{base}/dbpedia", headers=HEADERS)
        counts = [s["pointCount"] for s in r.json()["shards"]]
        assert len(counts) == len(runs[writer]["shards"]) and sum(counts) == N_POINTS - 1
        live = np.ones(N_POINTS, bool)
        live[IDS.index(runs[writer]["victim"])] = False
        r = requests.post(
            f"{base}/dbpedia/points/search/batch",
            json={"queries": [_search_body(q) for q in QUERIES]}, headers=HEADERS,
        )
        for q, row in zip(QUERIES, r.json()["results"]):
            _check(row["points"], q, live)
    finally:
        srv.shutdown()
        node.close()


def _open_shard(kind, path):
    """A shard of ``kind``'s package at ``path``, with that package's own
    model classes (returned too)."""
    models = jax_models if kind == "jax" else port_models
    col = models.Collection(user_id="u1", id="c1", index_schema=models.IndexSchema.from_dict(SCHEMA),
                            user_plan=models.UserPlan())
    shard = JaxShard(jax_open_store(path), col) if kind == "jax" else Shard(open_store(path), col, CPU)
    return shard, models


def _journal_shard(tmp_path, writer, reader):
    """A shard closed without a final flush: snapshot + journal, written by
    ``writer`` and opened by ``reader``. Both answer the same searches.
    Returns the reader's open shard, its model classes and the live mask."""
    path = str(tmp_path / "sharddb.sdb")
    shard, models = _open_shard(writer, path)
    points = [models.Point.from_map({"vector": VECTORS[i].tolist()}, uuid.UUID(IDS[i])) for i in range(600)]
    shard.insert_points(points[:300])
    shard.flush()  # snapshot of the first 300
    shard.insert_points(points[300:])  # journal only from here on
    shard.delete_points({points[7].id, points[450].id})
    written_docs = shard.search_points_batch_wire([models.SearchRequest.from_dict(_search_body(q)) for q in QUERIES])
    shard.db.close()

    shard, models = _open_shard(reader, path)
    assert shard.point_count() == 598
    read_docs = shard.search_points_batch_wire([models.SearchRequest.from_dict(_search_body(q)) for q in QUERIES])
    live = np.zeros(N_POINTS, bool)
    live[:600] = True
    live[[7, 450]] = False
    for q, wrow, rrow in zip(QUERIES, written_docs, read_docs):
        _check(wrow, q, live)
        _check(rrow, q, live)
    return shard, models, live


def test_port_replays_jax_journal(tmp_path):
    """A JAX shard closed without a final flush: snapshot + journal. The
    port replays the journal over the snapshot."""
    shard, models, live = _journal_shard(tmp_path, "jax", "port")
    # Filtered search through the index manager: _or of two _id filters
    allowed = list(range(0, 600, 13))
    flt = {"property": "_or", "_or": [
        {"property": "_id", "stringArray": {"value": [IDS[i] for i in allowed[:20]], "operator": "containsAny"}},
        {"property": "_id", "string": {"value": IDS[allowed[20]], "operator": "equals"}},
    ]}
    body = _search_body(QUERIES[0])
    body["query"]["vectorFlat"]["filter"] = flt
    fmask = np.zeros(N_POINTS, bool)
    fmask[allowed[:21]] = True
    (trow,) = shard.search_points_batch_wire([models.SearchRequest.from_dict(body)])
    _check(trow, QUERIES[0], fmask & live)
    shard.close()


def test_jax_replays_port_journal(tmp_path):
    """The reverse: a port shard closed without a final flush opens in the
    JAX package, which replays the port's journal and answers the same
    searches."""
    shard, _, _ = _journal_shard(tmp_path, "port", "jax")
    shard.close()


def test_port_admits_fused_pq_and_quantized_vamana_and_serves_them(tmp_path):
    """vectorFused, a product quantizer, a plain vectorVamana and a quantized
    one are admitted, and the quantized vectorVamana serves points over HTTP:
    a point finds itself first."""
    node, srv, base = _start("port", str(tmp_path))
    try:
        vamana = {"v": {"type": "vectorVamana", "vectorVamana": {
            "vectorSize": 4, "distanceMetric": "euclidean",
            "quantizer": {"type": "binary", "binary": {"threshold": 0.0}}}}}
        for name, schema in (
            ("fusedcol", {"v": {"type": "vectorFused", "vectorFused": {"views": [
                {"vectorSize": 4, "distanceMetric": "euclidean"}, {"vectorSize": 4, "distanceMetric": "dot"}]}},
              "title": {"type": "text", "text": {"analyser": "standard"}}}),
            ("pqcol", {"v": {"type": "vectorFlat", "vectorFlat": {"vectorSize": 8, "distanceMetric": "euclidean",
                    "quantizer": {"type": "product", "product": {"numCentroids": 16, "numSubVectors": 2}}}}}),
            ("vamanacol", {"v": {"type": "vectorVamana", "vectorVamana": {"vectorSize": 4,
                                                                          "distanceMetric": "euclidean"}}}),
            ("bqcol", vamana),
        ):
            r = requests.post(base, json={"id": name, "indexSchema": schema}, headers=HEADERS)
            assert r.status_code == 200, r.text
        assert sorted(c["id"] for c in requests.get(base, headers=HEADERS).json()["collections"]) == [
            "bqcol", "fusedcol", "pqcol", "vamanacol"]
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((50, 4)).astype(np.float32)
        pts = [{"_id": str(uuid.UUID(int=i + 1)), "v": vecs[i].tolist()} for i in range(50)]
        r = requests.post(f"{base}/bqcol/points", json={"points": pts}, headers=HEADERS)
        assert r.status_code == 200, r.text
        r = requests.post(f"{base}/bqcol/points/search", json={"query": {"property": "v", "vectorVamana": {
            "vector": vecs[7].tolist(), "operator": "near", "limit": 3}}}, headers=HEADERS)
        assert r.status_code == 200, r.text
        top = r.json()["points"][0]
        assert top["_id"] == str(uuid.UUID(int=8)) and abs(top["_distance"]) < 1e-5
    finally:
        srv.shutdown()
        node.close()
