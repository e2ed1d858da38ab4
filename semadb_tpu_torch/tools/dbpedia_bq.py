"""The slice's deployment, served by the port: its data, server and ingest.

The reference's published dbpedia-openai-100k-angular v2-BQ row
(``BASELINE.md:20``): 100,000 OpenAI-style 1536-d embeddings, cosine, in a
``vectorFlat`` index with a binary quantizer (hamming, threshold 0.0),
served with ``config/singleServer.yaml``. Only the root directory (a
temporary one) and the RPC and HTTP ports (0, ephemeral) differ from that
file.

The data are unit-norm vectors with an embedding-like spectrum (a decaying
low-rank part, a shared mean direction and isotropic noise), made from a
seed with numpy. ``chip_smoke.py`` checks the slice with this module and
:mod:`semadb_tpu_torch.tools.profile_slice` profiles it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
import urllib.request
import uuid
from dataclasses import dataclass

import numpy as np
import torch

from semadb_tpu_torch.cluster.node import ClusterNode
from semadb_tpu_torch.httpapi.server import HttpServer, run_http_server
from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.models import Collection, Point, UserPlan
from semadb_tpu_torch.ops.topk import tie_rule_errors
from semadb_tpu_torch.utils.config import ConfigMap, load_config

DIM = 1536
N_POINTS = 100_000
COLLECTION = "dbpedia"
INDEX_KEY = "index/vectorFlat/vector"
USER = {"X-User-Id": "smoke", "X-Plan-Id": "BASIC", "Content-Type": "application/json"}
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
CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "config", "singleServer.yaml",
)
HTTP_POINTS = 1000  # points inserted over HTTP JSON; the rest through ClusterNode.insert_points
BLOCK = 10_000  # points per insert_points call


class Embeddings:
    """Seeded embedding-like unit vectors, made in blocks of rows."""

    RANK = 128

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        self.seed = seed
        decay = 1.0 / np.sqrt(np.arange(1, self.RANK + 1, dtype=np.float32))
        self.basis = (rng.standard_normal((self.RANK, DIM), dtype=np.float32) * decay[:, None]) / np.sqrt(self.RANK)
        self.mean = rng.standard_normal(DIM, dtype=np.float32) * 0.02

    def block(self, index: int, rows: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, index])
        v = rng.standard_normal((rows, self.RANK), dtype=np.float32) @ self.basis * 3.0
        v += rng.standard_normal((rows, DIM), dtype=np.float32) * 0.02
        v += self.mean
        return v / np.linalg.norm(v, axis=1, keepdims=True)


def queries(seed: int, n: int) -> np.ndarray:
    """``n`` query vectors from the data's distribution, apart from the data."""
    return Embeddings(seed + 1).block(0, n)


def sign_words(v: np.ndarray) -> np.ndarray:
    """Sign bits as uint64 words (bit order is irrelevant to hamming)."""
    return np.packbits(v > 0.0, axis=-1).view(np.uint64)


def http_json(base: str, method: str, path: str, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method, headers=USER)
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def search_body(q: np.ndarray, limit: int) -> dict:
    return {"query": {"property": "vector", "vectorFlat": {
        "vector": q.tolist(), "operator": "near", "limit": limit}}}


def slice_config(root: str) -> ConfigMap:
    """``config/singleServer.yaml`` with ``root`` as its root directory and
    ephemeral RPC and HTTP ports."""
    cfg = load_config(CONFIG)
    cfg.cluster_node.root_dir = root
    cfg.cluster_node.rpc_port = 0
    cfg.cluster_node.servers = []  # just this node, at its ephemeral RPC port
    cfg.http_api.http_port = 0
    cfg.http_api.debug = False
    return cfg


@dataclass
class Server:
    node: ClusterNode
    http: HttpServer
    base: str  # the v2 collections URL
    plan: UserPlan
    device: torch.device

    def collection(self) -> Collection:
        col = self.node.get_collection(USER["X-User-Id"], COLLECTION)
        col.user_plan = self.plan
        return col

    def shard_indices(self) -> list[IndexFlat]:
        """Every shard's flat index, as the shard holds it on the device."""
        col = self.collection()
        return [
            self.node.shard_manager.do_with_shard(col, sid, lambda s: s.device_indices[INDEX_KEY])
            for sid in col.shard_ids
        ]


@contextlib.contextmanager
def serving(cfg: ConfigMap, device: torch.device, mesh=None):
    """The port's ClusterNode and HTTP v2 server, in-process on ``device``
    (with the shard ``mesh`` when given)."""
    node = ClusterNode(cfg.cluster_node, device, mesh=mesh)
    node.serve()
    try:
        http = run_http_server(node, cfg.http_api)
        try:
            yield Server(node, http, f"http://localhost:{http.port}/v2/collections",
                         cfg.http_api.user_plans["BASIC"], device)
        finally:
            http.shutdown()
    finally:
        node.close()


@dataclass
class Loaded:
    ids: list[str]
    words: np.ndarray  # every point's sign bits, for brute force
    shard_counts: list[int]
    store_backend: str
    seconds: float  # the whole ingest, device work included
    http_seconds: float  # the first HTTP_POINTS points, over HTTP JSON
    encode_seconds: float  # Point.from_map of the rest
    insert_seconds: float  # ClusterNode.insert_points of the rest

    @property
    def rate(self) -> float:
        return len(self.ids) / self.seconds

    @functools.cached_property
    def row_of(self) -> dict:
        return {pid: i for i, pid in enumerate(self.ids)}


def load(server: Server, seed: int, n_points: int) -> Loaded:
    """Create the collection over HTTP, insert the first ``HTTP_POINTS``
    points over HTTP JSON and the rest through ``ClusterNode.insert_points``
    (the call the v2 insert handler makes) in blocks of ``BLOCK``."""
    out = http_json(server.base, "POST", "", {"id": COLLECTION, "indexSchema": SCHEMA})
    assert out == {"message": "collection created"}, out
    emb = Embeddings(seed)
    rng = np.random.default_rng([seed, 7])
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    words = np.empty((n_points, DIM // 64), np.uint64)
    t0 = time.perf_counter()
    first = min(HTTP_POINTS, n_points)
    v = emb.block(0, BLOCK)
    words[:first] = sign_words(v[:first])
    out = http_json(server.base, "POST", f"/{COLLECTION}/points", {
        "points": [{"_id": ids[i], "vector": v[i].tolist()} for i in range(first)]})
    assert out["failedRanges"] == [], out
    t_http = time.perf_counter() - t0
    t_encode = t_insert = 0.0
    done = first
    while done < n_points:
        bi, off = divmod(done, BLOCK)
        if bi and off == 0:
            v = emb.block(bi, BLOCK)
        take = min(BLOCK - off, n_points - done)
        rows = v[off : off + take]
        words[done : done + take] = sign_words(rows)
        t1 = time.perf_counter()
        points = [Point.from_map({"vector": rows[j].tolist()}, uuid.UUID(ids[done + j])) for j in range(take)]
        t2 = time.perf_counter()
        failed = server.node.insert_points(server.collection(), points)
        t_insert += time.perf_counter() - t2
        t_encode += t2 - t1
        assert failed == [], failed
        done += take
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    seconds = time.perf_counter() - t0
    info = http_json(server.base, "GET", f"/{COLLECTION}")
    counts = [s["pointCount"] for s in info["shards"]]
    assert sum(counts) == n_points, counts
    col = server.collection()
    backend = type(server.node.shard_manager.do_with_shard(col, col.shard_ids[0], lambda s: s.db)).__name__
    return Loaded(ids, words, counts, backend, seconds, t_http, t_encode, t_insert)


def brute_force_errors(q: np.ndarray, points: list, data: Loaded, limit: int) -> list:
    """How a search's result documents break the tie rule against a numpy
    hamming scan over the sign bits of every point; empty when they agree."""
    d = np.bitwise_count(sign_words(q[None, :]) ^ data.words).sum(-1).astype(np.float64)
    order = np.argsort(d, kind="stable")[:limit]
    return tie_rule_errors(
        d[order], [data.ids[i] for i in order],
        [p["_distance"] for p in points], [p["_id"] for p in points],
        lambda pid: d[data.row_of[pid]],
    )
