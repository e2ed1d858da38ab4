"""The port's cluster layer against the JAX package's, on the CPU.

The counterparts of ``tests/test_cluster.py``: multi-shard placement, the
point quota, two nodes over the msgpack RPC, the device-memory budget that
evicts and reloads (Vamana and IVF), and a request that arrives while the
idle cleanup closes its shard. Each runs the same operations on a JAX
cluster and a port cluster and holds the port to the JAX answers. The budget
tests size ``max_cache_size`` from the port's own ``index_nbytes`` (the two
packages' capacities differ: F1, F2), not from the JAX test's byte counts.

Then two mixed clusters: a JAX node and a port node serving one collection
over the RPC plane (the wire format both packages speak), and a startup sync
that ships shard files from one package's node to the other's.

Then F13: a ``vectorVamana`` property of the hamming or jaccard metric is
served by the host plane on a node with a mesh, in the user's metric, as on a
node without one and on the JAX host plane.
"""

import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import semadb_tpu.cluster.shardmgr as jax_shardmgr
from semadb_tpu.cluster.hashing import rendezvous_hash
from semadb_tpu.cluster.node import ClusterNode as JaxNode
from semadb_tpu.cluster.node import ClusterNodeConfig as JaxNodeConfig
from semadb_tpu.cluster.sync import sync as jax_sync
from semadb_tpu.models import Collection as JaxCollection
from semadb_tpu.models import IndexSchema as JaxSchema
from semadb_tpu.models import Point as JaxPoint
from semadb_tpu.models import QuotaReachedError as JaxQuota
from semadb_tpu.models import SearchRequest as JaxRequest
from semadb_tpu.models import UserPlan as JaxPlan
from semadb_tpu.shard.shard import Shard as JaxShard
import semadb_tpu_torch.cluster.shardmgr as port_shardmgr
from semadb_tpu_torch.cluster.meshsearch import MeshSearcher
from semadb_tpu_torch.cluster.node import ClusterNode
from semadb_tpu_torch.cluster.node import ClusterNodeConfig
from semadb_tpu_torch.cluster.sync import sync as port_sync
from semadb_tpu_torch.models import Collection, IndexSchema, Point, QuotaReachedError, SearchRequest, UserPlan
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.parallel.mesh import shard_mesh
from semadb_tpu_torch.shard.registry import index_nbytes
from semadb_tpu_torch.shard.shard import Shard

CPU = torch.device("cpu")

PORT = SimpleNamespace(
    node=lambda cfg, **kw: ClusterNode(cfg, CPU, **kw), config=ClusterNodeConfig, collection=Collection,
    schema=IndexSchema, point=Point, request=SearchRequest, plan=UserPlan, quota=QuotaReachedError,
    manager=lambda root, **kw: port_shardmgr.ShardManager(root, CPU, **kw), shard=Shard,
)
JAX = SimpleNamespace(
    node=lambda cfg, **kw: JaxNode(cfg), config=JaxNodeConfig, collection=JaxCollection, schema=JaxSchema,
    point=JaxPoint, request=JaxRequest, plan=JaxPlan, quota=JaxQuota,
    manager=lambda root, **kw: jax_shardmgr.ShardManager(root, **kw), shard=JaxShard,
)

VAMANA = {"vector": {"type": "vectorVamana", "vectorVamana": {
    "vectorSize": 2, "distanceMetric": "euclidean", "searchSize": 36, "degreeBound": 32}},
    "n": {"type": "integer"}}


def lone_node(m, tmp_path=None, **cfg_kw):
    """A one-node cluster that routes every key to itself (no socket)."""
    cfg = m.config(root_dir=str(tmp_path) if tmp_path else "", servers=["localhost:0"], rpc_port=0,
                   shard_timeout=300, **cfg_kw)
    node = m.node(cfg)
    node.my_hostname = "localhost:0"
    node.servers = ["localhost:0"]
    return node


def served_nodes(m, tmp_path, names):
    """Nodes serving RPC on ephemeral ports, each knowing all of them."""
    nodes = []
    for name in names:
        node = m.node(m.config(root_dir=str(tmp_path / name), rpc_host="127.0.0.1", rpc_port=0))
        node.serve()
        nodes.append(node)
    servers = [n.my_hostname for n in nodes]
    for n in nodes:
        n.servers = list(servers)
    return nodes


def collection(m, cid="c1", schema=VAMANA, plan=None):
    return m.collection(user_id="u1", id=cid, index_schema=m.schema.from_dict(schema), user_plan=plan or m.plan())


def make_points(m, n, offset=0):
    return [m.point.from_map({"vector": [float(offset + i), float(offset + i)], "n": offset + i},
                             uuid.UUID(int=offset + i + 1)) for i in range(n)]


def near(m, x, limit, prop="vector", select=True):
    body = {"query": {"property": prop, "vectorVamana": {
        "vector": [x, x], "operator": "near", "searchSize": 36, "limit": limit}}, "limit": limit}
    if select:
        body["select"] = ["*"]
    return m.request.from_dict(body)


def answers(results):
    return [(r.point.id, float(r.distance)) for r in results]


def assert_same(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-6, atol=1e-6)


def test_multi_shard_distribution_matches_jax(tmp_path):
    out = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        node = lone_node(m, tmp_path / name, max_shard_point_count=10)
        try:
            col = collection(m)
            node.create_collection(col)
            pts = make_points(m, 25)
            assert node.insert_points(col, pts) == []
            col = node.get_collection("u1", "c1")
            assert len(col.shard_ids) == 3  # 10 + 10 + 5
            res = node.search_points(col, near(m, 0.0, 10))
            assert [r.point.as_map()["n"] for r in res] == list(range(10))
            assert node.delete_points(col, [pts[0].id, pts[20].id]) == []
            out[name] = (answers(res), answers(node.search_points(col, near(m, 0.0, 10))))
        finally:
            node.close()
    for got, want in zip(out["port"], out["jax"]):
        assert_same(got, want)


def test_point_quota_matches_jax(tmp_path):
    for name, m in (("jax", JAX), ("port", PORT)):
        node = lone_node(m, tmp_path / name)
        try:
            col = collection(m, plan=m.plan(max_collection_point_count=10))
            node.create_collection(col)
            with pytest.raises(m.quota):
                node.insert_points(col, make_points(m, 11))
            assert node.insert_points(col, make_points(m, 10)) == []
        finally:
            node.close()


def test_two_node_network_matches_jax(tmp_path):
    """Two nodes over the msgpack RPC: keys route to their owners, and a
    search through the node that did not insert answers as the JAX
    cluster's does."""
    out = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        node_a, node_b = served_nodes(m, tmp_path / name, ["a", "b"])
        try:
            col = collection(m)
            node_a.create_collection(col)
            assert node_b.get_collection("u1", "c1").id == "c1"
            assert node_a.insert_points(col, make_points(m, 12)) == []
            col = node_b.get_collection("u1", "c1")
            res = node_b.search_points(col, near(m, 3.3, 3))  # no two points equidistant
            assert res[0].point.as_map()["n"] == 3
            out[name] = answers(res)
        finally:
            node_a.close()
            node_b.close()
    assert_same(out["port"], out["jax"])


def _budget_run(m, tmp_path, max_cache_size, schema, fill, queries):
    """Fill shards s0.. through one manager with the budget, then one search
    a shard; returns (evictions, the answers)."""
    col = m.collection(user_id="u", id="c", index_schema=m.schema.from_dict(schema), user_plan=m.plan())
    mgr = m.manager(str(tmp_path), shard_timeout=300.0, max_cache_size=max_cache_size)
    try:
        for s, pts in enumerate(fill(m)):
            mgr.do_with_shard(col, f"s{s}", lambda sh, pts=pts: sh.insert_points(pts))
        evictions = mgr.hbm_budget.evictions
        got = [answers(mgr.do_with_shard(col, f"s{s}", lambda sh, q=q: sh.search_points(q)))
               for s, q in enumerate(queries(m))]
        return evictions, got
    finally:
        mgr.unload_all()


def _port_nbytes(tmp_path, schema, fill) -> int:
    """The port's device bytes of one shard's index after the first fill."""
    col = Collection(user_id="u", id="c", index_schema=IndexSchema.from_dict(schema), user_plan=UserPlan())
    mgr = port_shardmgr.ShardManager(str(tmp_path), CPU)
    try:
        mgr.do_with_shard(col, "s0", lambda sh: sh.insert_points(fill(PORT)[0]))
        return mgr.do_with_shard(col, "s0", lambda sh: sum(index_nbytes(i) for i in sh.device_indices.values()))
    finally:
        mgr.unload_all()


def test_device_budget_evicts_and_reloads_vamana_matches_jax(tmp_path):
    """Four shards of 20 points under a budget that holds two of the port's
    indices: the budget evicts, and every shard answers (after its reload)
    as the JAX manager's shard does."""
    schema = {"v": VAMANA["vector"]}

    def fill(m):
        return [[m.point.from_map({"v": [float(100 * s + i), float(100 * s + i)]}, uuid.UUID(int=100 * s + i + 1))
                 for i in range(20)] for s in range(4)]

    def queries(m):
        return [near(m, 100.0 * s + 7, 1, prop="v", select=False) for s in range(4)]

    one = _port_nbytes(tmp_path / "measure", schema, fill)
    evictions, got = _budget_run(PORT, tmp_path / "port", int(2.2 * one), schema, fill, queries)
    assert evictions > 0, f"a budget of {int(2.2 * one)} bytes over four indices of {one} evicted nothing"
    _, want = _budget_run(JAX, tmp_path / "jax", 40_000, schema, fill, queries)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g[0][0] == uuid.UUID(int=100 * s + 8)
        assert_same(g, w)


def test_device_budget_evicts_and_reloads_ivf_matches_jax(tmp_path):
    """The same contract for IVF shards past their fit, at 160-d (the
    projected traversal): evicted indices reload with the same answers."""
    schema = {"v": {"type": "vectorIVF", "vectorIVF": {
        "vectorSize": 160, "distanceMetric": "euclidean", "assignCopies": 2}}}
    vecs = [np.random.default_rng(5 + s).standard_normal((600, 160)).astype(np.float32) for s in range(3)]

    def fill(m):
        return [[m.point.from_map({"v": vecs[s][i].tolist()}, uuid.UUID(int=1000 * (s + 1) + i + 1))
                 for i in range(600)] for s in range(3)]

    def queries(m):
        return [m.request.from_dict({"query": {"property": "v", "vectorIVF": {
            "vector": vecs[s][7].tolist(), "limit": 1}}, "limit": 1}) for s in range(3)]

    one = _port_nbytes(tmp_path / "measure", schema, fill)
    evictions, got = _budget_run(PORT, tmp_path / "port", int(1.5 * one), schema, fill, queries)
    assert evictions > 0, f"a budget of {int(1.5 * one)} bytes over three indices of {one} evicted nothing"
    _, want = _budget_run(JAX, tmp_path / "jax", 200_000, schema, fill, queries)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g[0][0] == uuid.UUID(int=1000 * (s + 1) + 8)
        assert_same(g, w)


@pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
def test_request_during_timeout_unload_waits_for_close(tmp_path, monkeypatch, m):
    """A request that arrives while the idle cleanup is closing its shard
    waits for the close, then reloads a fresh shard and sees the persisted
    data: the same answer from both managers."""
    schema = m.schema.from_dict({"v": {"type": "vectorFlat", "vectorFlat": {
        "vectorSize": 4, "distanceMetric": "euclidean"}}})
    col = m.collection(user_id="u", id="c", index_schema=schema, user_plan=m.plan())
    mgr = m.manager(str(tmp_path), shard_timeout=0.05)
    closing_started, release_close = threading.Event(), threading.Event()
    orig_close = m.shard.close
    live = []

    def slow_close(self):
        closing_started.set()
        release_close.wait(5.0)
        orig_close(self)

    monkeypatch.setattr(m.shard, "close", slow_close)
    pts = [m.point.from_map({"v": [float(i), 0.0, 0.0, 0.0]}, uuid.UUID(int=i + 1)) for i in range(8)]
    mgr.do_with_shard(col, "s1", lambda sh: (live.append(sh), sh.insert_points(pts)))
    assert closing_started.wait(5.0)
    got = []
    sr = m.request.from_dict({"query": {"property": "v", "vectorFlat": {"vector": [3.0, 0, 0, 0], "limit": 1}},
                              "limit": 1})

    def use(sh):
        live.append(sh)
        return sh.search_points(sr)

    t = threading.Thread(target=lambda: got.append(mgr.do_with_shard(col, "s1", use)))
    t.start()
    time.sleep(0.3)
    assert t.is_alive() and len(live) == 1  # blocked on the close, no second handle
    release_close.set()
    t.join(10.0)
    assert not t.is_alive()
    assert len(live) == 2 and live[1] is not live[0]
    assert answers(got[0]) == [(uuid.UUID(int=4), 0.0)]
    mgr.unload_all()


def _owners_of(node, col) -> set:
    return {node._owner(sid) for sid in col.shard_ids}


def test_mixed_cluster_answers_as_a_jax_cluster(tmp_path):
    """A JAX node and a port node in one two-node cluster: rendezvous
    places the shards on both, every search crosses the RPC plane between
    the two packages, and the answers through either node equal a JAX-only
    cluster's on the same points."""
    jnode = JaxNode(JaxNodeConfig(root_dir=str(tmp_path / "jax"), rpc_host="127.0.0.1", rpc_port=0,
                                  max_shard_point_count=10))
    pnode = ClusterNode(ClusterNodeConfig(root_dir=str(tmp_path / "port"), rpc_host="127.0.0.1", rpc_port=0,
                                          max_shard_point_count=10), CPU)
    ref = lone_node(JAX, tmp_path / "ref", max_shard_point_count=10)
    for n in (jnode, pnode):
        n.serve()
    jnode.servers = pnode.servers = [jnode.my_hostname, pnode.my_hostname]
    try:
        pcol = collection(PORT)
        pnode.create_collection(pcol)
        rcol = collection(JAX)
        ref.create_collection(rcol)
        n = 0
        while len(_owners_of(pnode, pnode.get_collection("u1", "c1"))) < 2:  # a shard of 10 points a batch
            assert n < 200, "rendezvous kept every shard on one node"
            assert pnode.insert_points(pnode.get_collection("u1", "c1"), make_points(PORT, 10, n)) == []
            assert ref.insert_points(rcol, make_points(JAX, 10, n)) == []
            n += 10
        jcol = jnode.get_collection("u1", "c1")
        assert jcol.shard_ids == pnode.get_collection("u1", "c1").shard_ids
        assert jnode.insert_points(jcol, make_points(JAX, 15, n)) == []  # inserted through the JAX node
        assert ref.insert_points(rcol, make_points(JAX, 15, n)) == []
        n += 15
        for x in (0.0, 7.4, n / 2 + 0.3, n - 1.0):  # no two points equidistant
            want = answers(ref.search_points(ref.get_collection("u1", "c1"), near(JAX, x, 10)))
            for node, m in ((jnode, JAX), (pnode, PORT)):
                col = node.get_collection("u1", "c1")
                assert_same(answers(node.search_points(col, near(m, x, 10))), want)
                batch = node.search_points_batch(col, [near(m, x, 5), near(m, x + 3, 5)])
                assert_same(answers(batch[0]), want[:5])
        doomed = [uuid.UUID(int=i + 1) for i in range(0, n, 3)]
        assert pnode.delete_points(pnode.get_collection("u1", "c1"), doomed) == []
        assert ref.delete_points(ref.get_collection("u1", "c1"), doomed) == []
        want = answers(ref.search_points(ref.get_collection("u1", "c1"), near(JAX, 3.0, 10)))
        assert_same(answers(jnode.search_points(jnode.get_collection("u1", "c1"), near(JAX, 3.0, 10))), want)
    finally:
        for node in (jnode, pnode, ref):
            node.close()


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_mixed_cluster_sync_ships_shard_files_across_packages(tmp_path, sender):
    """One package's node fills a collection alone; the other package's node
    joins, and the first node's startup sync ships the shards the other
    now owns (xxhash-checked). The receiving package opens the other's shard
    files and the cluster answers as before the move."""
    make = {"jax": lambda root: JaxNode(JaxNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0,
                                                      max_shard_point_count=4)),
            "port": lambda root: ClusterNode(ClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=0,
                                                               max_shard_point_count=4), CPU)}
    other = "port" if sender == "jax" else "jax"
    m = JAX if sender == "jax" else PORT
    first = make[sender](str(tmp_path / sender))
    first.serve()
    first.servers = [first.my_hostname]
    second = make[other](str(tmp_path / other))
    second.serve()
    servers = [first.my_hostname, second.my_hostname]
    try:
        col = collection(m)
        first.create_collection(col)
        n = 0
        while n < 80 and all(rendezvous_hash(s, servers, 1)[0] == first.my_hostname for s in col.shard_ids):
            assert first.insert_points(col, make_points(m, 4, n)) == []
            n += 4
        moving = [s for s in col.shard_ids if rendezvous_hash(s, servers, 1)[0] != first.my_hostname]
        assert moving, "no shard hashes to the joining node"
        before = answers(first.search_points(first.get_collection("u1", "c1"), near(m, 5.3, 6)))  # no ties
        first.shard_manager.unload_all()  # every shard file complete on disk
        first.servers = second.servers = list(servers)
        stats = (jax_sync if sender == "jax" else port_sync)(first)
        assert stats["shardsMoved"] == len(moving)
        for sid in moving:
            assert (tmp_path / other / "u1" / "c1" / sid / "sharddb.sdb").exists()
            assert not (tmp_path / sender / "u1" / "c1" / sid).exists()
        for node, mm in ((first, m), (second, PORT if other == "port" else JAX)):
            got = answers(node.search_points(node.get_collection("u1", "c1"), near(mm, 5.3, 6)))
            assert_same(got, before)
    finally:
        first.close()
        second.close()


BITS = 48


def _bit_schema(metric, placement):
    return {"bits": {"type": "vectorVamana", "vectorVamana": {
        "vectorSize": BITS, "distanceMetric": metric, "searchSize": 150, "degreeBound": 16}}}


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_bit_metric_vamana_is_served_by_the_host_plane(tmp_path, metric):
    """F13: on a node with a mesh, a device-placement vectorVamana of a bit
    metric is not mesh-served (the slots walk in f32); the host plane answers
    in the user's metric, as a node without a mesh does and as the JAX host
    plane does. A BQ-quantized store stays mesh-eligible."""
    rng = np.random.default_rng(13)
    # Real-valued rows, binarized at 0.5: the f32 walk's squared euclidean
    # distances are not bit counts here (on 0/1 rows they would be)
    vecs = rng.random((120, BITS)).astype(np.float32)
    queries = rng.random((4, BITS)).astype(np.float32)

    def fill(node, m, col):
        node.create_collection(col)
        pts = [m.point.from_map({"bits": vecs[i].tolist()}, uuid.UUID(int=i + 1)) for i in range(len(vecs))]
        assert node.insert_points(col, pts) == []

    def search(node, m, col, q):
        sr = m.request.from_dict({"query": {"property": "bits", "vectorVamana": {
            "vector": q.tolist(), "operator": "near", "searchSize": 150, "limit": 10}}, "limit": 10})
        return answers(node.search_points(node.get_collection("u1", col.id), sr))

    mesh_node = ClusterNode(ClusterNodeConfig(root_dir=str(tmp_path / "mesh")), CPU, mesh=shard_mesh(devices=[CPU] * 8))
    plain_node = ClusterNode(ClusterNodeConfig(root_dir=str(tmp_path / "plain")), CPU)
    jnode = JaxNode(JaxNodeConfig(root_dir=str(tmp_path / "jax")))
    try:
        sch = IndexSchema.from_dict(_bit_schema(metric, "device"))
        dev = Collection(user_id="u1", id="bits", index_schema=sch, user_plan=UserPlan(), shard_placement="device")
        fill(mesh_node, PORT, dev)
        assert len(dev.shard_ids) == 8
        fill(plain_node, PORT, Collection(user_id="u1", id="bits", index_schema=sch, user_plan=UserPlan(),
                                          shard_placement="device"))
        fill(jnode, JAX, JaxCollection(user_id="u1", id="bits", index_schema=JaxSchema.from_dict(
            _bit_schema(metric, "host")), user_plan=JaxPlan()))
        served = []
        orig = MeshSearcher.search_batch
        mesh = mesh_node._mesh()
        mesh.search_batch = lambda *a, **kw: served.append(1) or orig(mesh, *a, **kw)
        packed = np.packbits(vecs > 0.5, axis=1)
        for q in queries:
            qb = np.packbits(q > 0.5)
            inter = np.unpackbits(packed & qb, axis=1).sum(1).astype(np.float64)
            union = np.unpackbits(packed | qb, axis=1).sum(1).astype(np.float64)
            truth = (union - inter) if metric == "hamming" else 1.0 - inter / np.maximum(union, 1.0)
            want = search(jnode, JAX, dev, q)
            for got in (search(mesh_node, PORT, dev, q), search(plain_node, PORT, dev, q)):
                errs = tie_rule_errors([d for _, d in want], [i for i, _ in want], [d for _, d in got],
                                       [i for i, _ in got], lambda pid: truth[pid.int - 1], atol=1e-6)
                assert not errs, errs
                np.testing.assert_allclose([d for _, d in got], np.sort(truth)[:10], rtol=0, atol=1e-6)
        assert not served, "a bit-metric vectorVamana query went to the mesh"
        q0 = mesh_node.get_collection("u1", "bits")
        assert mesh.eligible_query(q0, SearchRequest.from_dict({"query": {"property": "bits", "vectorVamana": {
            "vector": queries[0].tolist(), "limit": 3}}}).query) is None
        bq = IndexSchema.from_dict({"v": {"type": "vectorVamana", "vectorVamana": {
            "vectorSize": BITS, "distanceMetric": "euclidean", "quantizer": {
                "type": "binary", "binary": {"threshold": 0.5, "distanceMetric": metric}}}}})
        bq_col = Collection(user_id="u1", id="bq", index_schema=bq, user_plan=UserPlan(), shard_placement="device",
                            shard_ids=["s"])
        assert mesh.eligible_query(bq_col, SearchRequest.from_dict({"query": {"property": "v", "vectorVamana": {
            "vector": queries[0].tolist(), "limit": 3}}}).query) == "v"
    finally:
        for node in (mesh_node, plain_node, jnode):
            node.close()


def test_run_cluster_serves_the_three_node_configs(tmp_path):
    """``tools/run_cluster.py`` starts serverA, B and C as node processes (on
    the CPU here, every port rewritten to a free one): a collection made
    through A and filled through B answers through C, each node logs its
    kernel launches at shutdown and exits 0; a node that cannot reach its
    device ends the start with its exit code."""
    import json
    import urllib.request

    from semadb_tpu_torch.tools import run_cluster

    def call(base, method, path, body=None):
        req = urllib.request.Request(base + "/v2/collections" + path, method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"X-User-Id": "u1", "X-Plan-Id": "BASIC",
                                              "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    vecs = np.random.default_rng(4).standard_normal((300, 4)).astype(np.float32)
    with run_cluster.start(root=str(tmp_path / "nodes"), device="cpu", free_ports=True, timeout=120) as cl:
        a, b, c = cl.nodes
        assert [n.name for n in cl.nodes] == ["serverA", "serverB", "serverC"]
        assert len(cl.rewritten_ports) == 6 and all(n.root.startswith(str(tmp_path)) for n in cl.nodes)
        call(a.http, "POST", "", {"id": "flat", "indexSchema": {"v": {"type": "vectorFlat", "vectorFlat": {
            "vectorSize": 4, "distanceMetric": "euclidean"}}}})
        out = call(b.http, "POST", "/flat/points", {"points": [
            {"_id": str(uuid.UUID(int=i + 1)), "v": vecs[i].tolist()} for i in range(300)]})
        assert out["failedRanges"] == []
        got = call(c.http, "POST", "/flat/points/search", {"query": {"property": "v", "vectorFlat": {
            "vector": vecs[17].tolist(), "operator": "near", "limit": 1}}})["points"]
        assert got[0]["_id"] == str(uuid.UUID(int=18)) and got[0]["_distance"] == 0.0
        cl.check()
        assert cl.stop() == [0, 0, 0]
    for n in cl.nodes:
        assert n.launches() == {k: 0 for k in ("K1", "K2", "K3", "K4", "K5", "K9", "K10", "K11")}  # plain versions
        assert run_cluster.startup_sync(n)[0][0] == {"collectionsMoved": 0, "shardsMoved": 0}
    with pytest.raises(RuntimeError, match="exited with code"):
        run_cluster.start(configs=run_cluster.CONFIGS[:1], root=str(tmp_path / "cuda"), device="cuda",
                          free_ports=True, timeout=120)
