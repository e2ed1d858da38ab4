"""HTTP v1 and a v2 ``vectorVamana`` collection: the port's server against the JAX package's.

Both servers run in-process on ephemeral ports (JAX on the CPU, the port on
``cpu``) and get the same requests: a v1 collection (vectorSize 16,
euclidean: a fixed Vamana schema at searchSize 75, degreeBound 64, alpha
1.2) and a v2 ``vectorVamana`` collection with a ``string`` property, each
of 1,200 points, then single, batch and filtered searches, updates and
deletes. The vectors are integers in [-8, 8], so every distance between them
is exact in f32 and the two servers must answer the same: the same ids, the
same distances. Only the start node's vector is real-valued (the same unit
vector in both packages, from the same numpy seed); its distances never tie
an integer one, so the two walks take the same steps. Every returned
distance must also equal numpy's for its id, and recall@10 against numpy's
brute force must be >= 0.95. Then each server's root, closed (a snapshot
written), is served by the other package, which must answer the same.
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
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
from semadb_tpu_torch.httpapi.server import HttpApiConfig, HttpServer

CPU = torch.device("cpu")
DIM = 16
N = 1200
HEADERS = {"X-User-Id": "u1", "X-Plan-Id": "BASIC"}
RNG = np.random.default_rng(21)
VECTORS = RNG.integers(-8, 9, (N, DIM)).astype(np.float32)
QUERIES = RNG.integers(-8, 9, (10, DIM)).astype(np.float32)
IDS = [str(uuid.UUID(int=i + 1)) for i in range(N)]
TAGS = [f"t{i % 3}" for i in range(N)]
V2_SCHEMA = {
    "vec": {"type": "vectorVamana", "vectorVamana": {"vectorSize": DIM, "distanceMetric": "euclidean",
                                                     "searchSize": 75, "degreeBound": 64, "alpha": 1.2}},
    "tag": {"type": "string", "string": {"caseSensitive": True}},
}
DELETED = set(range(0, N, 11))
MOVED = list(range(5, 105, 5))


def _start(kind, root):
    if kind == "jax":
        plans = {"BASIC": jax_models.UserPlan(name="BASIC")}
        node = JaxClusterNode(JaxClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0))
        node.serve()
        srv = JaxHttpServer(node, JaxHttpApiConfig(http_host="127.0.0.1", http_port=0, user_plans=plans))
    else:
        plans = {"BASIC": port_models.UserPlan(name="BASIC")}
        node = ClusterNode(ClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0), CPU)
        node.serve()
        srv = HttpServer(node, HttpApiConfig(http_host="127.0.0.1", http_port=0, user_plans=plans))
    srv.serve_background()
    return node, srv, f"http://127.0.0.1:{srv.port}"


def _ok(r):
    assert r.status_code == 200, r.text
    return r.json()


def _v2_body(q, flt=None):
    body = {"query": {"property": "vec", "vectorVamana": {"vector": q.tolist(), "operator": "near",
                                                          "searchSize": 75, "limit": 10}}, "select": ["tag"]}
    if flt is not None:
        body["query"]["vectorVamana"]["filter"] = flt
    return body


def _searches(base):
    """The searches of both collections: v1 single, v2 single, batch and
    filtered; each result (id, distance) pairs."""
    out = {}
    out["v1"] = [[(p["id"], p["distance"]) for p in _ok(requests.post(
        f"{base}/v1/collections/vone/points/search", json={"vector": q.tolist(), "limit": 10},
        headers=HEADERS))["points"]] for q in QUERIES]
    v2 = f"{base}/v2/collections/vtwo/points/search"
    out["v2"] = [[(p["_id"], p["_distance"]) for p in _ok(requests.post(v2, json=_v2_body(q), headers=HEADERS))["points"]]
                 for q in QUERIES]
    rows = _ok(requests.post(f"{v2}/batch", json={"queries": [_v2_body(q) for q in QUERIES]}, headers=HEADERS))
    out["v2_batch"] = [[(p["_id"], p["_distance"]) for p in row["points"]] for row in rows["results"]]
    flt = {"property": "tag", "string": {"value": "t1", "operator": "equals"}}
    out["v2_filtered"] = [[(p["_id"], p["_distance"], p["tag"]) for p in _ok(requests.post(
        v2, json=_v2_body(q, flt), headers=HEADERS))["points"]] for q in QUERIES[:4]]
    return out


def _drive(base):
    out = {"ping": _ok(requests.get(f"{base}/v1/ping"))}
    _ok(requests.post(f"{base}/v1/collections", json={"id": "vone", "vectorSize": DIM, "distanceMetric": "euclidean"},
                      headers=HEADERS))
    _ok(requests.post(f"{base}/v2/collections", json={"id": "vtwo", "indexSchema": V2_SCHEMA}, headers=HEADERS))
    out["v1_list"] = _ok(requests.get(f"{base}/v1/collections", headers=HEADERS))
    for lo in range(0, N, 600):
        pts = [{"id": IDS[i], "vector": VECTORS[i].tolist(), "metadata": {"n": i}} for i in range(lo, lo + 600)]
        out.setdefault("v1_insert", []).append(_ok(requests.post(
            f"{base}/v1/collections/vone/points", json={"points": pts}, headers=HEADERS)))
        pts = [{"_id": IDS[i], "vec": VECTORS[i].tolist(), "tag": TAGS[i]} for i in range(lo, lo + 600)]
        _ok(requests.post(f"{base}/v2/collections/vtwo/points", json={"points": pts}, headers=HEADERS))
    out["before"] = _searches(base)
    out["v1_meta"] = _ok(requests.post(f"{base}/v1/collections/vone/points/search",
                                       json={"vector": VECTORS[3].tolist(), "limit": 1}, headers=HEADERS))
    dels = [IDS[i] for i in sorted(DELETED)]
    for lo in range(0, len(dels), 100):
        out.setdefault("v1_delete", []).append(_ok(requests.delete(
            f"{base}/v1/collections/vone/points", json={"ids": dels[lo : lo + 100]}, headers=HEADERS)))
        _ok(requests.delete(f"{base}/v2/collections/vtwo/points", json={"ids": dels[lo : lo + 100]},
                            headers=HEADERS))
    moved = [{"id": IDS[i], "vector": (-VECTORS[i]).tolist(), "metadata": {"n": -i}} for i in MOVED]
    out["v1_update"] = _ok(requests.put(f"{base}/v1/collections/vone/points", json={"points": moved},
                                        headers=HEADERS))
    _ok(requests.put(f"{base}/v2/collections/vtwo/points",
                     json={"points": [{"_id": IDS[i], "vec": (-VECTORS[i]).tolist()} for i in MOVED]},
                     headers=HEADERS))
    out["after"] = _searches(base)
    got = _ok(requests.get(f"{base}/v1/collections/vone", headers=HEADERS))
    got["shards"] = [s["pointCount"] for s in got["shards"]]  # shard ids are random uuids
    out["v1_get"] = got
    return out


def _live_vectors():
    vecs = VECTORS.copy()
    vecs[MOVED] = -vecs[MOVED]
    live = np.ones(N, bool)
    live[sorted(DELETED)] = False
    return vecs, live


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


def test_port_answers_as_the_jax_server(runs):
    """Every response equal: searches (ids and distances), listings,
    insert, update and delete replies, shard point counts (shard ids are
    random)."""
    jax_run, port_run = runs["jax"], runs["port"]
    for key in jax_run:
        if key != "root":
            assert port_run[key] == jax_run[key], key


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_searches_hold_against_numpy(runs, kind):
    """Each returned distance is numpy's for its id; recall@10 >= 0.95; no
    deleted id comes back; a moved point finds itself; the filter holds."""
    for phase, (vecs, live) in (("before", (VECTORS, np.ones(N, bool))), ("after", _live_vectors())):
        res = runs[kind][phase]
        hits = 0
        for key in ("v1", "v2", "v2_batch"):
            for q, row in zip(QUERIES, res[key]):
                d = ((vecs - q) ** 2).sum(-1)
                d[~live] = np.inf
                for pid, dist in row:
                    i = IDS.index(pid)
                    assert live[i] and dist == d[i], (phase, key, pid, dist, d[i])
                hits += len({pid for pid, _ in row} & {IDS[i] for i in np.argsort(d, kind="stable")[:10]})
        assert hits / (3 * 10 * len(QUERIES)) >= 0.95, (phase, hits)
        for q, row in zip(QUERIES, res["v2_filtered"]):
            assert row and all(tag == "t1" for _, _, tag in row)
    assert runs[kind]["v1_meta"]["points"][0]["metadata"] == {"n": 3}
    assert runs[kind]["v1_get"]["shards"] == [N - len(DELETED)]


def test_moved_points_find_themselves(runs):
    """An updated point is its own nearest neighbour in both servers."""
    for kind in ("jax", "port"):
        node, srv, base = _start(kind, runs[kind]["root"])
        try:
            for i in MOVED[:6]:
                if i in DELETED:
                    continue
                top = _ok(requests.post(f"{base}/v1/collections/vone/points/search",
                                        json={"vector": (-VECTORS[i]).tolist(), "limit": 1}, headers=HEADERS))
                assert top["points"][0]["id"] == IDS[i]
        finally:
            srv.shutdown()
            node.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_flushed_roots_reopen_in_either_package(runs, writer, reader):
    """A closed server's root (each shard's snapshot: the port's writer
    rewrites only dirty chunks) served by the other package: the same
    searches give the same answers."""
    node, srv, base = _start(reader, runs[writer]["root"])
    try:
        assert _searches(base) == runs[writer]["after"]
    finally:
        srv.shutdown()
        node.close()
