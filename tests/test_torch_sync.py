"""The port's startup sync against the JAX package's, on the CPU.

The counterpart of ``tests/test_sync.py``: a node fills a collection alone, a
second node joins, and the first node's startup sync re-homes the user
collections and ships every shard file whose rendezvous owner is now the
other node. Both packages run the same operations with the same shard ids
(``uuid.uuid4`` seeded alike for both runs) on the same two RPC ports (the
port's nodes take the ports the JAX run's nodes used), so that rendezvous
hashing gives both the same owners: the port's sync must move the same
shards to the same node, and the cluster must answer as the JAX cluster does.

Then the shard file transfer itself: several chunks (``CHUNK_SIZE`` patched
small in both packages) arrive whole, and a file whose checksum does not
match is removed and refused by both.
"""

import importlib
import os
import random
import uuid

import numpy as np
import pytest
import torch

from semadb_tpu.cluster.node import ClusterNode as JaxNode
from semadb_tpu.cluster.node import ClusterNodeConfig as JaxNodeConfig
from semadb_tpu.cluster.sync import sync as jax_sync
from semadb_tpu.models import Collection as JaxCollection
from semadb_tpu.models import IndexSchema as JaxSchema
from semadb_tpu.models import Point as JaxPoint
from semadb_tpu.models import SearchRequest as JaxRequest
from semadb_tpu.models import UserPlan as JaxPlan
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
from semadb_tpu_torch.cluster.sync import sync as port_sync
from semadb_tpu_torch.models import Collection, IndexSchema, Point, SearchRequest, UserPlan

CPU = torch.device("cpu")
SCHEMA = {"vector": {"type": "vectorVamana", "vectorVamana": {
    "vectorSize": 2, "distanceMetric": "euclidean", "searchSize": 36, "degreeBound": 32}}}
N_POINTS = 8
# The modules (the packages' cluster/__init__.py binds the name sync to the function)
JAX_SYNC = importlib.import_module("semadb_tpu.cluster.sync")
PORT_SYNC = importlib.import_module("semadb_tpu_torch.cluster.sync")


def _jax_node(root, port, **kw):
    return JaxNode(JaxNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=port, **kw))


def _port_node(root, port, **kw):
    return ClusterNode(ClusterNodeConfig(root_dir=root, rpc_host="127.0.0.1", rpc_port=port, **kw), CPU)


JAX = dict(node=_jax_node, collection=JaxCollection, schema=JaxSchema, point=JaxPoint, request=JaxRequest,
           plan=JaxPlan, sync=jax_sync)
PORT = dict(node=_port_node, collection=Collection, schema=IndexSchema, point=Point, request=SearchRequest,
            plan=UserPlan, sync=port_sync)


def _search(m, node, x):
    sr = m["request"].from_dict({"query": {"property": "vector", "vectorVamana": {
        "vector": [x, x], "operator": "near", "searchSize": 36, "limit": 3}}, "limit": 3})
    res = node.search_points(node.get_collection("u1", "c1"), sr)
    return [(r.point.id, float(r.distance)) for r in res]


def _membership_change(m, root, ports, monkeypatch):
    """Node a fills a collection of one point a shard alone; node b joins and
    a's sync runs twice. Returns the shard ids, the ports, each node's shard
    directories after the sync, both syncs' stats and the answers through
    each node."""
    seeded = random.Random(31)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=seeded.getrandbits(128), version=4))
    node_a = m["node"](str(root / "a"), ports[0], max_shard_point_count=1)
    node_a.serve()
    node_a.servers = [node_a.my_hostname]
    node_b = None
    try:
        col = m["collection"](user_id="u1", id="c1", index_schema=m["schema"].from_dict(SCHEMA),
                              user_plan=m["plan"]())
        node_a.create_collection(col)
        pts = [m["point"].from_map({"vector": [float(i), float(i)]}, uuid.UUID(int=i + 1)) for i in range(N_POINTS)]
        assert node_a.insert_points(col, pts) == []
        shard_ids = list(node_a.get_collection("u1", "c1").shard_ids)
        assert len(shard_ids) == N_POINTS
        node_a.shard_manager.unload_all()  # every shard file complete on disk
        node_b = m["node"](str(root / "b"), ports[1])
        node_b.serve()
        node_a.servers = node_b.servers = [node_a.my_hostname, node_b.my_hostname]
        stats = m["sync"](node_a)
        held = {name: sorted(os.listdir(root / name / "u1" / "c1")) if (root / name / "u1" / "c1").exists() else []
                for name in ("a", "b")}
        got = {name: _search(m, node, 4.3) for name, node in (("a", node_a), ("b", node_b))}  # no ties
        assert got["b"][0][0] == pts[4].id
        again = m["sync"](node_a)
        return {"shards": shard_ids, "ports": tuple(int(n.my_hostname.rsplit(":", 1)[1]) for n in (node_a, node_b)),
                "held": held, "stats": stats, "again": again, "answers": got}
    finally:
        node_a.close()
        if node_b is not None:
            node_b.close()


def test_sync_rehomes_after_membership_change_as_jax(tmp_path, monkeypatch):
    want = _membership_change(JAX, tmp_path / "jax", (0, 0), monkeypatch)
    got = _membership_change(PORT, tmp_path / "port", want["ports"], monkeypatch)
    assert got["ports"] == want["ports"]
    assert got["shards"] == want["shards"], "the two runs minted other shard ids"
    assert got["held"] == want["held"]  # the same shards moved to the same node
    assert got["stats"] == want["stats"]
    assert got["again"] == want["again"] == {"collectionsMoved": 0, "shardsMoved": 0}
    moved = len(want["held"]["b"])
    assert want["stats"]["shardsMoved"] == moved and sorted(want["held"]["a"] + want["held"]["b"]) == sorted(
        want["shards"])
    for name in ("a", "b"):
        assert [i for i, _ in got["answers"][name]] == [i for i, _ in want["answers"][name]]
        np.testing.assert_allclose([d for _, d in got["answers"][name]], [d for _, d in want["answers"][name]],
                                   rtol=1e-6)


@pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
def test_shard_transfer_in_chunks_and_its_checksum(tmp_path, monkeypatch, m):
    """A shard file sent in chunks of 4 KiB arrives byte for byte; a final
    chunk whose checksum disagrees removes the file and fails the call, in
    both packages."""
    import xxhash

    mod = JAX_SYNC if m is JAX else PORT_SYNC
    monkeypatch.setattr(mod, "CHUNK_SIZE", 4096)
    sender = m["node"](str(tmp_path / "s"), 0)
    receiver = m["node"](str(tmp_path / "r"), 0)
    receiver.serve()
    try:
        blob = np.random.default_rng(2).bytes(4096 * 5 + 123)
        src = tmp_path / "sharddb.sdb"
        src.write_bytes(blob)
        mod._send_shard_file(sender, receiver.my_hostname, "u1", "c1", "s1", str(src))
        assert (tmp_path / "r" / "u1" / "c1" / "s1" / "sharddb.sdb").read_bytes() == blob
        with pytest.raises(Exception, match="checksum"):
            sender._call(receiver.my_hostname, "SendShard", {
                "userId": "u1", "collectionId": "c1", "shardId": "s2", "offset": 0, "chunk": blob[:100],
                "final": True, "checksum": xxhash.xxh64(blob[:99]).intdigest()})
        assert not (tmp_path / "r" / "u1" / "c1" / "s2" / "sharddb.sdb").exists()
    finally:
        sender.close()
        receiver.close()
