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

The real-valued build, the capacity chain, the dirty-row snapshot, the
quantized and pool builds and ``annbench --engine vamana`` are held in
``tests/test_torch_vamana_build_served.py``, so that two test workers share
the two halves.
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
