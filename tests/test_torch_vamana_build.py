"""The port's Vamana build, update and delete held against the JAX package's, on the CPU.

The same ids and vectors, made from a numpy seed, go through both packages'
``insert_batch``, ``IndexVamana.insert_bulk`` (the two-pass schedule, its
thresholds patched low in both so that a small corpus takes it) and
``delete_batch`` / ``insert_update_delete``.

Tolerances. On integer-valued vectors (|x| <= 8, D = 16) every distance is
exact in f32, so the graphs must be equal, adjacency and live mask; the
start node's vector (a random unit vector) is replaced by an integer one in
both packages before the build, so that its distances, and the ties it
takes part in, are exact too. On real-valued data the builds part at
near-ties: the port's graph must hold the invariants of
``tests/test_vamana.py`` (degree bound, no self or dangling edges, every live
node reachable from the start node) and its recall@10 must be within 0.005
of the JAX graph's.
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

jax_build = sys.modules["semadb_tpu.index.vamana.build"]
jax_graph = sys.modules["semadb_tpu.index.vamana.graph"]
port_build = sys.modules["semadb_tpu_torch.index.vamana.build"]
port_graph = sys.modules["semadb_tpu_torch.index.vamana.graph"]

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


def _assert_same_graph(jidx, pidx):
    for name in ("adjacency", "exists", "vectors"):
        want = np.asarray(getattr(jidx.state, name))
        got = getattr(pidx.state, name).numpy()
        n = min(len(want), len(got))  # capacities follow different chains (F1)
        assert np.array_equal(got[:n], want[:n]), name
        assert not want[n:].any() if name == "exists" else True


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


def _int_data(n, seed, dim=16):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, (n, dim)).astype(np.float32), rng.integers(-8, 9, dim).astype(np.float32)


@pytest.mark.parametrize("keep_current,intra_k,seed_own", [(False, 8, False), (True, 8, False), (True, 0, True)])
def test_insert_batch_equals_jax_on_integer_data(keep_current, intra_k, seed_own):
    """One batch into an empty graph, then batches over it: equal graphs,
    overflow rounds and all (the start node's vector integer in both)."""
    vecs, start = _int_data(1200, 0)
    jidx, pidx = _pair(start=start)
    for idx in (jidx, pidx):
        idx._ensure_capacity(1300)
    jst, pst = jidx.state, pidx.state
    for lo, hi in ((0, 64), (64, 576), (576, 1200)):
        ids = np.arange(lo + 2, hi + 2, dtype=np.int32)
        jst = jax_build.insert_batch(jst, ids, vecs[lo:hi], jidx.config, intra_k=intra_k)
        port_build.insert_batch(pst, ids, vecs[lo:hi], pidx.config, intra_k=intra_k)
    ids = np.arange(2, 502, dtype=np.int32)
    moved = vecs[:500] + 1
    jst = jax_build.insert_batch(jst, ids, moved, jidx.config, keep_current=keep_current, alpha=1.0,
                                 intra_k=intra_k, seed_own=seed_own)
    port_build.insert_batch(pst, ids, moved, pidx.config, keep_current=keep_current, alpha=1.0, intra_k=intra_k,
                            seed_own=seed_own)
    jidx.state = jst
    _assert_same_graph(jidx, pidx)


def test_insert_bulk_two_pass_and_writes_equal_jax(two_pass_small):
    """``insert_bulk`` (pass 1 at alpha 1.0 in doubling rounds, pass 2 with the
    current out-edges in the pool), then updates and deletes through
    ``insert_update_delete``: equal graphs after each step."""
    vecs, start = _int_data(2000, 1)
    jidx, pidx = _pair(start=start)
    ids = np.arange(2, 2002)
    for idx in (jidx, pidx):
        idx.insert_bulk(ids, vecs)
    assert pidx.build_seconds["pass2_batches"] == 4
    _assert_same_graph(jidx, pidx)
    rng = np.random.default_rng(2)
    changes = [(int(i), None) for i in rng.choice(ids, 300, replace=False)]
    changes += [(int(i), vecs[i - 2][::-1].copy()) for i in range(1000, 1100)]
    changes += [(i, rng.integers(-8, 9, 16).astype(np.float32)) for i in range(2002, 2102)]
    for idx in (jidx, pidx):
        idx.insert_update_delete(changes)
    _assert_same_graph(jidx, pidx)
    _invariants(pidx)
    q = rng.integers(-8, 9, (32, 16)).astype(np.float32)
    wd, wi = jidx.search_batch(q, 10)
    gd, gi = pidx.search_batch(q, 10)
    assert np.array_equal(gi, wi) and np.array_equal(gd, wd)


@pytest.mark.parametrize("seed_own", [False, True])
def test_refine_equals_jax(seed_own):
    """``refine``: every live node re-inserted with its current out-edges in
    its pool, batches of 256, seeded at its own edges or not: equal graphs."""
    vecs, start = _int_data(700, 8)
    jidx, pidx = _pair(start=start)
    for idx in (jidx, pidx):
        idx.insert_update_delete(zip(range(2, 702), vecs))
        idx.refine(batch=256, seed_own=seed_own)
    _assert_same_graph(jidx, pidx)


def test_delete_batch_equals_jax_with_component_rescue():
    """A mass delete: repair in chunks (DELETE_CHUNK patched to 64 in both),
    the stragglers' rescue into the start row and the component rescue."""
    vecs, start = _int_data(900, 3)
    jidx, pidx = _pair(start=start)
    ids = np.arange(2, 902)
    for idx in (jidx, pidx):
        idx.insert_update_delete(zip(ids.tolist(), vecs))
    _assert_same_graph(jidx, pidx)
    dels = np.arange(2, 700, dtype=np.int32)
    old = (jax_build.DELETE_CHUNK, port_build.DELETE_CHUNK)
    jax_build.DELETE_CHUNK = port_build.DELETE_CHUNK = 64
    try:
        jidx.state = jax_build.delete_batch(jidx.state, dels, jidx.config)
        port_build.delete_batch(pidx.state, dels, pidx.config)
    finally:
        jax_build.DELETE_CHUNK, port_build.DELETE_CHUNK = old
    _assert_same_graph(jidx, pidx)
    _invariants(pidx)
    # _attach_representatives alone, on a graph cut in two
    cut = pidx.state.adjacency.clone()
    jst = jax_graph.GraphState(jidx.state.vectors, jnp.asarray(cut.numpy()), jidx.state.exists)
    unreach = np.zeros(pidx.capacity, bool)
    unreach[np.nonzero(pidx.state.exists.numpy())[0][5::7]] = True
    unreach[START] = False
    want = jax_build._attach_representatives(jst, jnp.asarray(unreach), jidx.config)
    port_build._attach_representatives(pidx.state, torch.from_numpy(unreach), pidx.config)
    assert np.array_equal(pidx.state.adjacency.numpy(), np.asarray(want.adjacency))


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
