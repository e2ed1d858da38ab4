"""The port's device-mesh serving path (shardPlacement "device") end to end.

The port's counterparts of ``tests/test_mesh_serving.py``, on a
``ClusterNode(..., mesh=shard_mesh(devices=[cpu] * 8))``: spread placement
over one shard a slot, searches served by the mesh searcher (a spy on
``MeshSearcher.search_batch`` / ``search_batch_fused`` proves it), results
equal to the host-placement twin's on the same data, the version-checked
cache and its incremental restack, filtered, fused, IVF-PQ and HTTP v2
queries, and the two-node RPC x mesh composition. The same points and
queries also go through the JAX node, whose mesh is its 8 virtual CPU
devices, and the ids must be equal.

The snapshot case: the stack is a copy, so a write made to a shard's engine
directly (the node's cache sees no new ``write_version``) leaves the stack's
answers as they were before it; a stack that held references would answer
with the write.
"""

import uuid

import numpy as np
import pytest
import torch

from semadb_tpu.cluster.node import ClusterNode as JaxNode
from semadb_tpu.cluster.node import ClusterNodeConfig as JaxNodeConfig
from semadb_tpu.models import Collection as JaxCollection
from semadb_tpu.models import IndexSchema as JaxSchema
from semadb_tpu.models import Point as JaxPoint
from semadb_tpu.models import UserPlan as JaxPlan
from semadb_tpu.models.query import SearchRequest as JaxRequest
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
from semadb_tpu_torch.models import Collection, IndexSchema, Point, UserPlan
from semadb_tpu_torch.models.query import SearchRequest
from semadb_tpu_torch.parallel.mesh import shard_mesh

CPU = torch.device("cpu")
DIM = 8
N = 240

PORT = dict(schema=IndexSchema, point=Point, request=SearchRequest, collection=Collection, plan=UserPlan)
JAX = dict(schema=JaxSchema, point=JaxPoint, request=JaxRequest, collection=JaxCollection, plan=JaxPlan)


def schema_dict(kind: str) -> dict:
    if kind == "ivf":
        return {"emb": {"type": "vectorIVF", "vectorIVF": {"vectorSize": DIM, "distanceMetric": "euclidean"}}}
    return {"emb": {"type": "vectorVamana", "vectorVamana": {
        "vectorSize": DIM, "distanceMetric": "euclidean", "searchSize": 36, "degreeBound": 16, "alpha": 1.2}}}


FUSED_SCHEMA = {"embeds": {"type": "vectorFused", "vectorFused": {"views": [
    {"vectorSize": 6, "distanceMetric": "euclidean", "weight": 0.7},
    {"vectorSize": 4, "distanceMetric": "euclidean", "weight": 0.3},
]}}}


def make_node(tmp_path, name="n") -> ClusterNode:
    node = ClusterNode(ClusterNodeConfig(root_dir=str(tmp_path / name), rpc_host="127.0.0.1", rpc_port=0), CPU,
                       mesh=shard_mesh(devices=[CPU] * 8))
    node.serve()
    return node


def make_jax_node(tmp_path) -> JaxNode:
    node = JaxNode(JaxNodeConfig(root_dir=str(tmp_path / "jax"), rpc_host="127.0.0.1", rpc_port=0))
    node.serve()
    return node


def corpus(seed=3, n=N, dim=DIM):
    # Tiny noise so the dim-0 ramp fully determines nearest neighbours
    rng = np.random.default_rng(seed)
    vecs = (0.01 * rng.standard_normal((n, dim))).astype(np.float32)
    vecs[:, 0] += np.arange(n)
    return vecs


def collection(m, cid, sch: dict, device=True):
    kw = dict(shard_placement="device") if device else {}
    return m["collection"](user_id="u1", id=cid, index_schema=m["schema"].from_dict(sch), user_plan=m["plan"](), **kw)


def points(m, vecs, extra=None):
    return [m["point"].from_map({"emb": vecs[i].tolist(), **(extra(i) if extra else {})}, uuid.UUID(int=i + 1))
            for i in range(len(vecs))]


def request(m, vec, kind, limit=5, filt=None):
    vq = {"vector": [float(x) for x in vec], "limit": limit}
    if filt is not None:
        vq["filter"] = filt
    if kind == "ivf":
        q = {"property": "emb", "vectorIVF": vq}
    else:
        q = {"property": "emb", "vectorVamana": {**vq, "operator": "near", "searchSize": 36}}
    return m["request"].from_dict({"query": q, "limit": limit})


def spy(ms, name, calls, check=None):
    orig = getattr(ms, name)

    def wrapped(*a, **kw):
        if check is not None:
            check(kw)
        out = orig(*a, **kw)
        if out is not None:
            calls.append(1)
        return out

    setattr(ms, name, wrapped)


def ids(results):
    return [r.point.id for r in results]


@pytest.mark.parametrize("kind", ["ivf", "vamana"])
def test_mesh_search_matches_host_fanout_and_jax(tmp_path, kind):
    node, jnode = make_node(tmp_path), make_jax_node(tmp_path)
    try:
        vecs = corpus()
        dev_col = collection(PORT, "dev1", schema_dict(kind))
        node.create_collection(dev_col)
        assert not node.insert_points(dev_col, points(PORT, vecs))
        assert len(dev_col.shard_ids) == 8  # spread placement used every slot
        host_col = collection(PORT, "host1", schema_dict(kind), device=False)
        node.create_collection(host_col)
        assert not node.insert_points(host_col, points(PORT, vecs))
        jcol = collection(JAX, "dev1", schema_dict(kind))
        jnode.create_collection(jcol)
        assert not jnode.insert_points(jcol, points(JAX, vecs))

        calls = []
        spy(node._mesh(), "search_batch", calls)
        q = np.zeros(DIM, np.float32)
        q[0] = 117.3
        got = node.search_points(dev_col, request(PORT, q, kind))
        assert calls, "device placement must route through the mesh path"
        want = node.search_points(host_col, request(PORT, q, kind))
        assert ids(got) == ids(want)
        assert got[0].point.id == uuid.UUID(int=118)
        assert ids(got) == ids(jnode.search_points(jcol, request(JAX, q, kind)))

        q2 = np.zeros(DIM, np.float32)
        q2[0] = 42.4
        calls.clear()
        gotb = node.search_points_batch(dev_col, [request(PORT, q, kind), request(PORT, q2, kind)])
        assert calls
        assert gotb[0][0].point.id == uuid.UUID(int=118) and gotb[1][0].point.id == uuid.UUID(int=43)
        wantb = jnode.search_points_batch(jcol, [request(JAX, q, kind), request(JAX, q2, kind)])
        assert [ids(r) for r in gotb] == [ids(r) for r in wantb]

        # No select / sort: both planes answer id-only results
        for r_mesh, r_host in zip(got, want):
            assert r_mesh.point.data == r_host.point.data == b""
        sr_sel = request(PORT, q, kind)
        sr_sel.select = ["emb"]
        calls.clear()
        got_sel = node.search_points(dev_col, sr_sel)
        assert calls and "emb" in (got_sel[0].decoded_data or {})
        # the wire path too
        calls.clear()
        docs = node.search_points_batch_wire(dev_col, [request(PORT, q, kind)])[0]
        assert calls and [d["_id"] for d in docs] == [str(i) for i in ids(got)]
    finally:
        node.close()
        jnode.close()


def test_mesh_cache_invalidates_on_write(tmp_path):
    node = make_node(tmp_path)
    try:
        col = collection(PORT, "dev2", schema_dict("ivf"))
        node.create_collection(col)
        assert not node.insert_points(col, points(PORT, corpus()))
        q = np.zeros(DIM, np.float32)
        q[0] = 99.2
        assert node.search_points(col, request(PORT, q, "ivf"))[0].point.id == uuid.UUID(int=100)
        newv = np.zeros(DIM, np.float32)
        newv[0] = 99.21
        node.insert_points(col, [Point.from_map({"emb": newv.tolist()}, uuid.UUID(int=5000))])
        assert node.search_points(col, request(PORT, q, "ivf"))[0].point.id == uuid.UUID(int=5000)
    finally:
        node.close()


@pytest.mark.parametrize("kind", ["ivf", "vamana"])
def test_mesh_filtered_matches_host_fanout(tmp_path, kind):
    sch = {"emb": schema_dict(kind)["emb"], "grp": {"type": "integer", "integer": {}}}
    node = make_node(tmp_path)
    try:
        vecs = corpus()
        dev_col, host_col = collection(PORT, "fdev3", sch), collection(PORT, "fhost3", sch, device=False)
        for col in (dev_col, host_col):
            node.create_collection(col)
            assert not node.insert_points(col, points(PORT, vecs, lambda i: {"grp": i % 3}))
        calls = []
        spy(node._mesh(), "search_batch", calls, check=lambda kw: kw.get("filter_query") is not None or 1 / 0)
        q = np.zeros(DIM, np.float32)
        q[0] = 117.3
        sr = request(PORT, q, kind, filt={"property": "grp", "integer": {"value": 1, "operator": "equals"}})
        got = node.search_points(dev_col, sr)
        assert calls, "a filtered device-placement query must ride the mesh"
        assert ids(got) == ids(node.search_points(host_col, sr))
        assert all((r.point.id.int - 1) % 3 == 1 for r in got)
        assert got[0].point.id == uuid.UUID(int=119)
    finally:
        node.close()


def test_http_v2_device_placement_end_to_end(tmp_path):
    import requests as rq

    from semadb_tpu_torch.httpapi.server import HttpApiConfig, HttpServer

    node = make_node(tmp_path)
    srv = HttpServer(node, HttpApiConfig(http_host="127.0.0.1", http_port=0,
                                         user_plans={"BASIC": UserPlan(name="BASIC")}))
    srv.serve_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        H = {"X-User-Id": "u1", "X-Plan-Id": "BASIC"}
        r = rq.post(f"{base}/v2/collections", headers=H, json={
            "id": "meshcol", "shardPlacement": "device", "indexSchema": schema_dict("ivf")})
        assert r.status_code == 200, r.text
        vecs = corpus()
        pts = [{"_id": str(uuid.UUID(int=i + 1)), "emb": vecs[i].tolist()} for i in range(N)]
        r = rq.post(f"{base}/v2/collections/meshcol/points", json={"points": pts}, headers=H)
        assert r.status_code == 200, r.text
        calls = []
        spy(node._mesh(), "search_batch", calls)
        q = np.zeros(DIM, np.float32)
        q[0] = 77.1
        r = rq.post(f"{base}/v2/collections/meshcol/points/search", headers=H, json={
            "query": {"property": "emb", "vectorIVF": {"vector": q.tolist(), "limit": 3}}, "limit": 3})
        assert r.status_code == 200, r.text
        assert calls, "HTTP search must ride the mesh path"
        assert r.json()["points"][0]["_id"] == str(uuid.UUID(int=78))
    finally:
        srv.shutdown()
        node.close()


def _fused_points(m, seed, filt=False):
    rng = np.random.default_rng(seed)
    v1 = (0.01 * rng.standard_normal((N, 6))).astype(np.float32)
    v2 = (0.01 * rng.standard_normal((N, 4))).astype(np.float32)
    v1[:, 0] += np.arange(N)
    v2[:, 0] += np.arange(N)
    return [m["point"].from_map({"embeds": [v1[i].tolist(), v2[i].tolist()], **({"grp": i % 3} if filt else {})},
                                uuid.UUID(int=i + 1)) for i in range(N)]


def _fused_request(m, at, limit=5, weights=None, filt=None):
    q1, q2 = np.zeros(6, np.float32), np.zeros(4, np.float32)
    q1[0] = q2[0] = at
    vf = {"vectors": [q1.tolist(), q2.tolist()], "operator": "near", "limit": limit}
    if weights:
        vf["weights"] = weights
    if filt:
        vf["filter"] = filt
    return m["request"].from_dict({"query": {"property": "embeds", "vectorFused": vf}, "limit": limit})


def test_mesh_fused_matches_host_fanout_and_jax(tmp_path):
    node, jnode = make_node(tmp_path), make_jax_node(tmp_path)
    try:
        dev_col, host_col = collection(PORT, "fdev", FUSED_SCHEMA), collection(PORT, "fhost", FUSED_SCHEMA, False)
        for col in (dev_col, host_col):
            node.create_collection(col)
            assert not node.insert_points(col, _fused_points(PORT, 7))
        jcol = collection(JAX, "fdev", FUSED_SCHEMA)
        jnode.create_collection(jcol)
        assert not jnode.insert_points(jcol, _fused_points(JAX, 7))
        calls = []
        spy(node._mesh(), "search_batch_fused", calls)
        got = node.search_points(dev_col, _fused_request(PORT, 77.3))
        assert calls, "fused device placement must route through the mesh"
        want = node.search_points(host_col, _fused_request(PORT, 77.3))
        assert ids(got) == ids(want) and got[0].point.id == uuid.UUID(int=78)
        for rg, rw in zip(got, want):  # the true fused distances on both planes
            assert abs(rg.distance - rw.distance) < 1e-3, (rg.distance, rw.distance)
        assert ids(got) == ids(jnode.search_points(jcol, _fused_request(JAX, 77.3)))
        calls.clear()
        got_w = node.search_points(dev_col, _fused_request(PORT, 77.3, weights=[0.95, 0.05]))
        assert calls
        assert ids(got_w) == ids(node.search_points(host_col, _fused_request(PORT, 77.3, weights=[0.95, 0.05])))
    finally:
        node.close()
        jnode.close()


def test_mesh_fused_filtered_matches_host_fanout(tmp_path):
    sch = {**FUSED_SCHEMA, "grp": {"type": "integer", "integer": {}}}
    node = make_node(tmp_path)
    try:
        dev_col, host_col = collection(PORT, "ffdev", sch), collection(PORT, "ffhost", sch, device=False)
        for col in (dev_col, host_col):
            node.create_collection(col)
            assert not node.insert_points(col, _fused_points(PORT, 8, filt=True))
        calls = []
        spy(node._mesh(), "search_batch_fused", calls, check=lambda kw: kw.get("filter_query") is not None or 1 / 0)
        filt = {"property": "grp", "integer": {"value": 1, "operator": "equals"}}
        got = node.search_points(dev_col, _fused_request(PORT, 117.3, filt=filt))
        assert calls, "a filtered fused device query must ride the mesh"
        assert ids(got) == ids(node.search_points(host_col, _fused_request(PORT, 117.3, filt=filt)))
        assert all((r.point.id.int - 1) % 3 == 1 for r in got) and got[0].point.id == uuid.UUID(int=119)
    finally:
        node.close()


def test_mesh_incremental_restack_on_single_shard_write(tmp_path):
    node = make_node(tmp_path)
    try:
        col = collection(PORT, "incr1", schema_dict("ivf"))
        node.create_collection(col)
        assert not node.insert_points(col, points(PORT, corpus()))
        q = np.zeros(DIM, np.float32)
        q[0] = 99.2
        assert node.search_points(col, request(PORT, q, "ivf"))[0].point.id == uuid.UUID(int=100)
        ms = node._mesh()
        rebuilds, incrementals, captured = [], [], []
        orig_build, orig_incr, orig_collect = ms._build_from, ms._try_incremental, ms._collect

        def spy_build(*a, **kw):
            rebuilds.append(1)
            return orig_build(*a, **kw)

        def spy_incr(*a, **kw):
            out = orig_incr(*a, **kw)
            if out is not None:
                incrementals.append(1)
            return out

        def spy_collect(c, prop, sids):
            captured.extend(sids)
            return orig_collect(c, prop, sids)

        ms._build_from, ms._try_incremental, ms._collect = spy_build, spy_incr, spy_collect
        newv = np.zeros(DIM, np.float32)
        newv[0] = 99.21
        node.insert_points(col, [Point.from_map({"emb": newv.tolist()}, uuid.UUID(int=7000))])
        assert node.search_points(col, request(PORT, q, "ivf"))[0].point.id == uuid.UUID(int=7000)
        assert incrementals and not rebuilds, (incrementals, rebuilds)
        assert len(captured) == 1, "only the written shard is copied again"
        # an unchanged fleet copies nothing
        captured.clear()
        node.search_points(col, request(PORT, q, "ivf"))
        assert captured == []
    finally:
        node.close()


@pytest.mark.parametrize("kind", ["ivf", "vamana"])
def test_stack_is_a_snapshot_of_the_shards(tmp_path, kind):
    """Write to one shard's engine directly, in place, without a new
    ``write_version``: the cached stack still answers as before the write.
    A capture that held the engine's tensors (references) fails this."""
    node = make_node(tmp_path)
    try:
        col = collection(PORT, "snap1", schema_dict(kind))
        node.create_collection(col)
        assert not node.insert_points(col, points(PORT, corpus()))
        q = np.zeros(DIM, np.float32)
        q[0] = 99.2
        before = ids(node.search_points(col, request(PORT, q, kind)))
        assert before[0] == uuid.UUID(int=100)
        (_, sid, nid), = node._mesh().search_batch(col, "emb", q[None, :], 1)[0]

        def write(shard):
            idx = next(iter(shard.device_indices.values()))
            far = np.full(DIM, 1e4, np.float32)
            idx.insert_update_delete([(nid, far)])  # in place: move the nearest point far away

        node.shard_manager.do_with_shard(col, sid, write)
        assert node.shard_manager.do_with_shard(col, sid, lambda s: s.search_points(request(PORT, q, kind)))[
            0].point.id != uuid.UUID(int=100), "the engine took the write"
        assert ids(node.search_points(col, request(PORT, q, kind))) == before
    finally:
        node.close()


def test_mesh_pq_collection_matches_host_fanout(tmp_path):
    node = make_node(tmp_path)
    try:
        n = 6400  # 800 a shard: past MIN_FIT = 512 so every shard fits PQ
        sch = {"emb": {"type": "vectorIVF", "vectorIVF": {
            "vectorSize": DIM, "distanceMetric": "euclidean", "quantizer": {"type": "product", "product": {
                "numCentroids": 16, "numSubvectors": 4, "triggerThreshold": 64}}}}}
        vecs = corpus(seed=4, n=n)
        dev_col, host_col = collection(PORT, "pqdev", sch), collection(PORT, "pqhost", sch, device=False)
        for col in (dev_col, host_col):
            node.create_collection(col)
            assert not node.insert_points(col, points(PORT, vecs))
        assert all(node.shard_manager.do_with_shard(dev_col, sid, lambda s: next(iter(
            s.device_indices.values())).pq_active) for sid in dev_col.shard_ids), "PQ never activated: bad fixture"
        calls = []
        spy(node._mesh(), "search_batch", calls)
        q = np.zeros(DIM, np.float32)
        q[0] = 404.4
        got = node.search_points(dev_col, request(PORT, q, "ivf"))
        assert calls, "PQ device placement must be mesh-served"
        assert ids(got) == ids(node.search_points(host_col, request(PORT, q, "ivf")))
        assert got[0].point.id == uuid.UUID(int=405)
    finally:
        node.close()


def test_two_node_rpc_x_mesh_composition(tmp_path):
    """A device-placement collection spanning two nodes over real RPC: the
    querying node mesh-serves the shards it owns (a partial stack) and fans
    the rest out over RPC, merged per request; equal to a single-node
    host-placement collection on the same data."""
    node_a, node_b = make_node(tmp_path, "a"), make_node(tmp_path, "b")
    servers = [node_a.my_hostname, node_b.my_hostname]
    node_a.servers = node_b.servers = servers
    try:
        vecs = corpus()
        col = collection(PORT, "span1", schema_dict("ivf"))
        node_a.create_collection(col)
        assert not node_a.insert_points(col, points(PORT, vecs))
        col = node_a.get_collection("u1", "span1")
        owners = {sid: node_a._owner(sid) for sid in col.shard_ids}
        local_a = [s for s, o in owners.items() if o == node_a.my_hostname]
        assert local_a and len(local_a) < len(owners), f"rendezvous must split shards across both nodes: {owners}"
        ref_col = collection(PORT, "refhost", schema_dict("ivf"), device=False)
        node_a.create_collection(ref_col)
        assert not node_a.insert_points(ref_col, points(PORT, vecs))
        served = []
        spy(node_a._mesh(), "search_batch", served,
            check=lambda kw: set(kw["shard_ids"]) == set(local_a) or 1 / 0)
        for q0 in (117.3, 42.4, 230.8):
            q = np.zeros(DIM, np.float32)
            q[0] = q0
            got = node_a.search_points(col, request(PORT, q, "ivf"))
            assert ids(got) == ids(node_a.search_points(ref_col, request(PORT, q, "ivf"))), q0
        assert served, "the local subset must ride the mesh plane"
        st = node_a._mesh()._cache[("u1", "span1", "emb")]
        assert len(st.stacked) == len(local_a) < node_a._mesh().mesh.size
    finally:
        node_a.close()
        node_b.close()


def test_node_without_mesh_serves_device_placement_on_one_shard(tmp_path):
    """On cpu with no mesh given the node has none (maybe_mesh), spread
    placement makes one shard, and the host fan-out serves."""
    node = ClusterNode(ClusterNodeConfig(root_dir=str(tmp_path), rpc_host="127.0.0.1", rpc_port=0), CPU)
    node.serve()
    try:
        assert node._mesh() is None
        col = collection(PORT, "one", schema_dict("ivf"))
        node.create_collection(col)
        assert not node.insert_points(col, points(PORT, corpus()))
        assert len(col.shard_ids) == 1
        q = np.zeros(DIM, np.float32)
        q[0] = 12.2
        assert node.search_points(col, request(PORT, q, "ivf"))[0].point.id == uuid.UUID(int=13)
    finally:
        node.close()


def test_shard_write_version_and_mesh_helpers(tmp_path):
    """``write_version`` is random at open and moves after every write txn,
    the one that rolls back included; ``filter_node_ids`` and
    ``resolve_node_ids`` answer in one read txn each, skipping unknown ids."""
    from semadb_tpu_torch.models.errors import ExistsError
    from semadb_tpu_torch.models.query import Query
    from semadb_tpu_torch.shard import Shard
    from semadb_tpu_torch.store import open_store

    sch = {"emb": schema_dict("ivf")["emb"], "grp": {"type": "integer", "integer": {}}}
    col = collection(PORT, "wv", sch, device=False)
    path = str(tmp_path / "s.sdb")
    shard = Shard(open_store(path), col, CPU)
    v0 = shard.write_version
    pts = points(PORT, corpus(n=30), lambda i: {"grp": i % 3})
    shard.insert_points(pts)
    v1 = shard.write_version
    assert v1 > v0
    with pytest.raises(ExistsError):
        shard.insert_points(pts[:1])  # rolls back
    assert shard.write_version > v1
    ids = shard.filter_node_ids(Query.from_dict({"property": "grp", "integer": {"value": 1, "operator": "equals"}}))
    got = shard.resolve_node_ids(sorted(ids) + [10_000], with_data=False)
    assert set(got) == ids and len(ids) == 10
    assert sorted(p.id.int - 1 for p in got.values()) == list(range(1, 30, 3))
    assert all(p.data == b"" for p in got.values())
    with_data = shard.resolve_node_ids(sorted(ids)[:1])
    assert next(iter(with_data.values())).data != b""
    shard.close()
    again = Shard(open_store(path), col, CPU)
    assert again.write_version != v0  # a new random seed each open
    again.close()


@pytest.mark.parametrize("query", [
    {"property": "emb", "vectorVamana": {"vector": [0.5] * DIM, "operator": "near", "searchSize": 36, "limit": 4,
                                         "filter": {"property": "grp", "integer": {"value": 1, "operator": "equals"}}}},
    {"property": "embeds", "vectorFused": {"vectors": [[1.0] * 6, [2.0] * 4], "operator": "near", "limit": 3,
                                           "weights": [0.6, 0.4], "numProbes": 5}},
    {"property": "txt", "text": {"value": "a b", "operator": "containsAny", "limit": 7}},
    {"property": "_and", "_and": [{"property": "grp", "integer": {"value": 2, "operator": "greaterThan"}},
                                  {"property": "f", "float": {"value": 0.5, "operator": "lessThan"}}]},
])
def test_rpc_encodes_every_query_kind(query):
    """The node's RPC encoding of a search request is the JAX node's: a
    vectorVamana, vectorFused, text, integer or float query survives the
    round trip that sends it to a remote shard."""
    from semadb_tpu.cluster.node import _search_request_to_dict as jax_encode
    from semadb_tpu_torch.cluster.node import _search_request_to_dict as encode

    sr = SearchRequest.from_dict({"query": query, "limit": 9})
    wire = encode(sr)
    assert wire == jax_encode(JaxRequest.from_dict({"query": query, "limit": 9}))
    back = SearchRequest.from_dict(wire)
    assert encode(back) == wire
