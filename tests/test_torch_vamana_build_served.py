"""The port's Vamana build held against the JAX package's, on the CPU: the
real-valued build, the capacity chain, the dirty-row snapshot, the
quantized and pool builds, and ``annbench --engine vamana``.

The second half of ``tests/test_torch_vamana_build.py``'s tests, in a file
of their own so that two test workers share them (that file's docstring
gives the tolerances). On real-valued data the builds part at near-ties:
the port's graph must hold the invariants of ``tests/test_vamana.py``
(degree bound, no self or dangling edges, every live node reachable from
the start node) and its recall@10 must be within 0.005 of the JAX graph's.
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
from semadb_tpu_torch.shard import snapshot
from semadb_tpu_torch.store import open_store
from semadb_tpu_torch.utils import grow

jax_graph = sys.modules["semadb_tpu.index.vamana.graph"]
port_build = sys.modules["semadb_tpu_torch.index.vamana.build"]

CPU = torch.device("cpu")
NIL = -1
START = 1


def _pair(dim=16, metric="euclidean", search_size=36, degree=32, start=None):
    kw = dict(vector_size=dim, distance_metric=metric, search_size=search_size, degree_bound=degree)
    jidx, pidx = jax_vamana.IndexVamana(JaxParams(**kw)), port_vamana.IndexVamana(PortParams(**kw), CPU)
    if start is not None:
        st = jidx.state
        jidx.state = jax_graph.GraphState(st.vectors.at[START].set(jnp.asarray(start)), st.adjacency, st.exists)
        pidx.state.vectors[START] = torch.from_numpy(start)
    return jidx, pidx


def _invariants(pidx):
    adj = pidx.state.adjacency.numpy()
    exists = pidx.state.exists.numpy()
    R = pidx.config.degree_bound
    assert ((adj != NIL).sum(1) <= R).all()
    for u in np.nonzero(exists)[0]:
        row = adj[u][adj[u] != NIL]
        assert u not in row, f"self edge at {u}"
        assert exists[row].all(), f"dangling edge from {u}"
        assert len(set(row.tolist())) == len(row), f"repeated edge at {u}"
    reach = port_build.reachable_mask(pidx.state).numpy()
    live = exists.copy()
    live[START] = False
    assert not (live & ~reach).any(), f"{int((live & ~reach).sum())} live nodes unreachable"


@pytest.fixture()
def two_pass_small(monkeypatch):
    """The two-pass schedule at a small size, in both packages."""
    for mod in (jax_vamana, port_vamana):
        monkeypatch.setattr(mod, "TWO_PASS_MIN", 1024)
        monkeypatch.setattr(mod, "PASS2_CHUNK", 512)


def test_real_data_build_holds_invariants_and_recall(two_pass_small):
    """Real-valued vectors: the builds may part at near-ties; the port's
    graph holds the invariants and its recall@10 is within 0.005 of JAX's."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((20, 24)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 20, 2500)] + rng.standard_normal((2500, 24))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 200)] + rng.standard_normal((200, 24))).astype(np.float32)
    jidx, pidx = _pair(dim=24, search_size=40)
    for idx in (jidx, pidx):
        idx.insert_bulk(np.arange(2, 2502), vecs)
        idx.insert_update_delete([(i, None) for i in range(2, 400, 2)])
    _invariants(pidx)
    live = np.ones(2500, bool)
    live[np.arange(0, 398, 2)] = False
    d = ((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    d[:, ~live] = np.inf
    exact = np.argsort(d, axis=1)[:, :10] + 2

    def recall(idx):
        _, ids = idx.search_batch(q, 10, search_size=40)
        return np.mean([len(set(ids[b]) & set(exact[b])) / 10 for b in range(len(q))])

    assert abs(recall(pidx) - recall(jidx)) <= 0.005


def test_live_capacity_equals_reload_capacity(monkeypatch):
    """F1: the capacity a live index grew to is the one a reload of its
    row-bounded snapshot pads back to, pre-grown or not."""
    rng = np.random.default_rng(6)
    for pregrow in (0, 8192):
        monkeypatch.setattr(grow, "PREGROW_ROWS", pregrow)
        params = PortParams(vector_size=8, distance_metric="euclidean", search_size=25, degree_bound=32)
        idx = port_vamana.IndexVamana(params, CPU)
        for max_id in (50, 3000, 9000):
            idx.insert_update_delete([(max_id, rng.standard_normal(8).astype(np.float32))])
            bound = idx.snapshot_row_bounds()["vectors"]
            arrays = {k: (v[:bound] if k != "store" else v) for k, v in idx.to_arrays().items()}
            again = port_vamana.IndexVamana.from_arrays(params, arrays, CPU)
            assert again.capacity == idx.capacity, (pregrow, max_id, again.capacity, idx.capacity)
            assert np.array_equal(again.state.adjacency[:bound].numpy(), idx.state.adjacency[:bound].numpy())


def test_snapshot_writes_only_dirty_chunks(tmp_path, monkeypatch):
    """The dirty-row snapshot (chunks of 16 KiB here): after a full
    snapshot, a small insert rewrites only the chunks its rows and backedge
    targets fall in, and the result reads back equal to the live index (and
    opens in the JAX package)."""
    monkeypatch.setattr(snapshot, "CHUNK_TARGET_BYTES", 1 << 14)
    rng = np.random.default_rng(7)
    params = PortParams(vector_size=64, distance_metric="euclidean", search_size=25, degree_bound=32)
    idx = port_vamana.IndexVamana(params, CPU)
    idx.insert_update_delete(zip(range(2, 10002, 1), rng.standard_normal((10000, 64)).astype(np.float32)))
    store = open_store(str(tmp_path / "s.db"))

    def flush():
        out = []
        store.write(lambda bm: out.append(snapshot.write_snapshot(bm.get("index/vectorVamana/v"), idx)))
        return out[0]

    full = flush()
    assert full > 200
    idx.insert_update_delete([(10002, rng.standard_normal(64).astype(np.float32))])
    few = flush()
    assert 0 < few < full / 2, (few, full)
    arrays = []
    store.read(lambda bm: arrays.append(snapshot.read_snapshot(bm.get("index/vectorVamana/v"))))
    again = port_vamana.IndexVamana.from_arrays(params, arrays[0], CPU)
    for name in ("vectors", "adjacency", "exists"):
        assert torch.equal(getattr(again, name), getattr(idx, name)), name
    jidx = jax_vamana.IndexVamana.from_arrays(JaxParams(vector_size=64, distance_metric="euclidean",
                                                        search_size=25, degree_bound=32), arrays[0])
    assert np.array_equal(np.asarray(jidx.state.adjacency)[: idx.capacity], idx.adjacency.numpy())
    store.close()


def test_quantized_and_pool_builds_are_admitted_and_served():
    """A binary quantizer, the hamming metric and the pool build, once
    refused, are served: the stores fit (a fixed threshold from the start),
    points find themselves; a pool build below TWO_PASS_MIN points takes the
    two passes, as the JAX package's does."""
    from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, Quantizer

    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((60, 8)).astype(np.float32)
    q = Quantizer(type="binary", binary=BinaryQuantizerParams(threshold=0.0))
    for params, data in (
        (PortParams(vector_size=8, distance_metric="euclidean", quantizer=q), vecs),
        (PortParams(vector_size=8, distance_metric="hamming"), (vecs > 0).astype(np.float32)),
    ):
        idx = port_vamana.IndexVamana(params, CPU)
        assert idx.store.fitted and idx.store.state.codes.shape[0] == idx.capacity
        idx.insert_update_delete(zip(range(2, 62), data))
        d, i = idx.search_batch(data[:4], 3)
        assert (d[:, 0] == 0).all() and set(i[:, 0]) <= set(range(2, 62))
    idx = port_vamana.IndexVamana(PortParams(vector_size=8, distance_metric="euclidean"), CPU)
    idx.insert_bulk(np.arange(2, 62), vecs, build_mode="pool")
    assert "pass1_s" in idx.build_seconds
    _, i = idx.search_batch(vecs[:4], 1)
    assert list(i[:, 0]) == [2, 3, 4, 5]


def test_annbench_runs_the_vamana_engine_on_cpu(capsys):
    """``annbench --engine vamana`` at a small size on ``cpu``: one JSON line
    with the build's split by pass and the walk's hops."""
    import json

    from semadb_tpu_torch.tools import annbench

    assert annbench.main(["--engine", "vamana", "--device", "cpu", "--n", "3000", "--dim", "16", "--queries",
                          "96", "--batch", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == "vamana" and out["recall@10"] >= 0.95 and out["search_size"] == 40
    assert {"pass1_s", "pass2_s", "pass1_overflow_rounds"} <= set(out["build_split_s"])
    assert out["hops_per_query"] > 1
    with pytest.raises(SystemExit):
        annbench.main(["--engine", "vamana", "--device", "cpu", "--sweep", "48"])

