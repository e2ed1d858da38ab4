"""The port's shard and IVF engine under concurrent readers and writers, on the CPU.

The counterparts of ``tests/test_concurrency.py`` (the reference's
TestShard_SearchWhileInsert / DeleteWhileInsert / ConcurrentCRUD): threads
hammer one port ``Shard`` through its public API, and each JAX invariant
must hold in the port: no exception, no lost write, no deleted id back,
searches answer with live points, a combined query's sub-query fan-out
answers the same from every thread. The port's engines write in place (the
JAX package's buffers are immutable), which is why this matters more here.
Where the final state does not depend on the interleaving (the points that
live, the graph of one writer), the final answers must equal the JAX
shard's after the same operations.

The JAX package's donation test becomes a test that two concurrent writers
in place leave the port's IVF engine consistent: every location holds its
id, no slot holds a lost one, and every inserted point finds itself.
"""

import threading
import uuid

import msgpack
import numpy as np
import torch

from semadb_tpu.models import Collection as JaxCollection
from semadb_tpu.models import IndexSchema as JaxSchema
from semadb_tpu.models import Point as JaxPoint
from semadb_tpu.models import SearchRequest as JaxRequest
from semadb_tpu.models import UserPlan as JaxPlan
from semadb_tpu.shard import Shard as JaxShard
from semadb_tpu.store import open_store as jax_open_store
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.models import Collection, IndexSchema, Point, SearchRequest, UserPlan
from semadb_tpu_torch.models.schema import VectorIVFParams
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.store import open_store

CPU = torch.device("cpu")
SCHEMA = {"v": {"type": "vectorVamana", "vectorVamana": {
    "vectorSize": 2, "distanceMetric": "euclidean", "searchSize": 36, "degreeBound": 32}},
    "n": {"type": "integer"}}
IVF_SCHEMA = {"v": {"type": "vectorIVF", "vectorIVF": {"vectorSize": 8, "distanceMetric": "euclidean",
                                                       "assignCopies": 2}}}

PORT = dict(point=Point, request=SearchRequest,
            shard=lambda sch: Shard(open_store(""), Collection(user_id="u", id="c", index_schema=IndexSchema.from_dict(
                sch), user_plan=UserPlan()), CPU))
JAX = dict(point=JaxPoint, request=JaxRequest,
           shard=lambda sch: JaxShard(jax_open_store(""), JaxCollection(
               user_id="u", id="c", index_schema=JaxSchema.from_dict(sch), user_plan=JaxPlan())))


def pts(m, n, offset):
    return [m["point"].from_map({"v": [float(offset + i), float(offset + i)], "n": offset + i},
                                uuid.UUID(int=offset + i + 1)) for i in range(n)]


def near(m, x, limit=5):
    return m["request"].from_dict({"query": {"property": "v", "vectorVamana": {
        "vector": [x, x] if np.isscalar(x) else list(x), "operator": "near", "searchSize": 36, "limit": limit}},
        "limit": limit, "select": ["*"]})


def ids(results):
    return [r.point.id for r in results]


def run_threads(fns):
    errors = []

    def wrap(fn):
        try:
            fn()
        except Exception as e:  # collected and failed on below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, f"thread errors: {errors[:3]}"


def test_search_while_insert_matches_jax():
    """One writer streams inserts while two readers search: every answer
    holds live points with their data, no write is lost, and the final
    graph (one writer's) answers as the JAX shard's after the same inserts."""
    shard = PORT["shard"](SCHEMA)
    shard.insert_points(pts(PORT, 30, 0))
    stop = threading.Event()

    def inserter():
        for batch in range(3):
            shard.insert_points(pts(PORT, 20, 100 + batch * 20))
        stop.set()

    def searcher():
        while not stop.is_set():
            res = shard.search_points(near(PORT, 10.0))
            assert len(res) > 0
            assert all(r.point is not None and r.point.data for r in res)

    run_threads([inserter, searcher, searcher])
    assert shard.point_count() == 90
    jshard = JAX["shard"](SCHEMA)
    for n, off in ((30, 0), (20, 100), (20, 120), (20, 140)):
        jshard.insert_points(pts(JAX, n, off))
    for x in (10.3, 115.3, 151.7, 61.2):  # no two points equidistant
        assert ids(shard.search_points(near(PORT, x))) == ids(jshard.search_points(near(JAX, x)))


def test_delete_while_insert_matches_jax():
    """A delete and an insert at once: the count is exact, no deleted id
    comes back, and the live points answer as the JAX shard's."""
    shard = PORT["shard"](SCHEMA)
    shard.insert_points(pts(PORT, 50, 0))
    doomed = {uuid.UUID(int=i + 1) for i in range(0, 50, 2)}
    run_threads([lambda: shard.delete_points(doomed), lambda: shard.insert_points(pts(PORT, 30, 200))])
    assert shard.point_count() == 50 - 25 + 30
    jshard = JAX["shard"](SCHEMA)
    jshard.insert_points(pts(JAX, 50, 0))
    jshard.delete_points(doomed)
    jshard.insert_points(pts(JAX, 30, 200))
    for x in (0.3, 20.4, 210.3, 120.1):
        got = ids(shard.search_points(near(PORT, x, 10)))
        assert not doomed & set(got)
        assert got == ids(jshard.search_points(near(JAX, x, 10)))


def test_concurrent_crud_matches_jax():
    """Update, delete, insert and search at once: the count is exact, the
    updated points hold their merged data, and the filter over it answers as
    the JAX shard's after the same writes."""
    shard = PORT["shard"](SCHEMA)
    shard.insert_points(pts(PORT, 40, 0))

    def writes(m, s):
        return [
            lambda: s.update_points([m["point"].from_map({"n": 9000 + i}, uuid.UUID(int=i + 1)) for i in range(10)]),
            lambda: s.delete_points({uuid.UUID(int=i + 1) for i in range(30, 40)}),
            lambda: s.insert_points(pts(m, 20, 500)),
        ]

    def searcher():
        for _ in range(5):
            shard.search_points(near(PORT, 3.0))

    run_threads(writes(PORT, shard) + [searcher])
    assert shard.point_count() == 40 - 10 + 20
    jshard = JAX["shard"](SCHEMA)
    jshard.insert_points(pts(JAX, 40, 0))
    for fn in writes(JAX, jshard):
        fn()
    body = {"query": {"property": "n", "integer": {"value": 9000, "operator": "greaterThanOrEquals"}},
            "limit": 100, "select": ["*"]}
    got = shard.search_points(PORT["request"].from_dict(body))
    want = jshard.search_points(JAX["request"].from_dict(body))
    assert len(got) == 10
    assert sorted((r.point.id, r.point.as_map()["n"]) for r in got) == sorted(
        (r.point.id, r.point.as_map()["n"]) for r in want)
    for x in (3.3, 35.3, 510.2):
        assert ids(shard.search_points(near(PORT, x, 10))) == ids(jshard.search_points(near(JAX, x, 10)))


def test_large_insert_delete_insert_search_matches_jax():
    """shard_vector_test.go LargeInsertDeleteInsertSearch on random 2-D
    points: reinserted points are found by their own vectors, and searches
    answer with numpy's exact neighbours over the live points, as the JAX
    shard does."""
    rng = np.random.default_rng(21)
    first_v, second_v = rng.random((200, 2)).astype(np.float32), rng.random((100, 2)).astype(np.float32)
    probes = rng.random((5, 2)).astype(np.float32)

    def run(m):
        shard = m["shard"](SCHEMA)
        first = [m["point"].from_map({"v": first_v[i].tolist(), "n": i}, uuid.UUID(int=i + 1)) for i in range(200)]
        shard.insert_points(first)
        shard.delete_points({p.id for p in first[:100]})
        second = [m["point"].from_map({"v": second_v[i].tolist(), "n": 1000 + i}, uuid.UUID(int=1000 + i + 1))
                  for i in range(100)]
        shard.insert_points(second)
        assert shard.point_count() == 200
        hits = sum(ids(shard.search_points(near(m, second_v[i].tolist(), 1)))[:1] == [second[i].id]
                   for i in range(20))
        assert hits >= 19, f"reinserted points unsearchable: {20 - hits}/20 missing"
        return [ids(shard.search_points(near(m, q.tolist(), 5))) for q in probes]

    live = np.concatenate([first_v[100:], second_v]).astype(np.float64)
    live_ids = [uuid.UUID(int=i + 1) for i in range(100, 200)] + [uuid.UUID(int=1000 + i + 1) for i in range(100)]
    exact = [[live_ids[j] for j in np.argsort(((live - q) ** 2).sum(-1))[:5]] for q in probes.astype(np.float64)]
    assert run(PORT) == exact == run(JAX)


def test_ivf_search_while_insert():
    """The IVF engine through the shard: searches answer with live points
    while another thread streams inserts past the fit, and every point the
    writer inserted then finds itself at distance 0."""
    rng = np.random.default_rng(22)
    base = rng.standard_normal((700, 8)).astype(np.float32)
    more = rng.standard_normal((600, 8)).astype(np.float32)
    shard = PORT["shard"](IVF_SCHEMA)
    shard.insert_points([Point.from_map({"v": base[i].tolist()}, uuid.UUID(int=i + 1)) for i in range(700)])
    stop = threading.Event()

    def writer():
        for r in range(6):
            shard.insert_points([Point.from_map({"v": more[r * 100 + i].tolist()}, uuid.UUID(int=10_000 + r * 100 + i))
                                 for i in range(100)])
        stop.set()

    def reader():
        req = SearchRequest.from_dict({"query": {"property": "v", "vectorIVF": {"vector": [0.0] * 8, "limit": 5}},
                                       "limit": 5})
        while not stop.is_set():
            res = shard.search_points(req)
            assert 1 <= len(res) <= 5
            assert all(r.point.id is not None for r in res)

    run_threads([writer, reader, reader])
    assert shard.point_count() == 1300
    for j in range(0, 600, 37):
        res = shard.search_points(SearchRequest.from_dict({"query": {"property": "v", "vectorIVF": {
            "vector": more[j].tolist(), "limit": 1}}, "limit": 1}))
        assert [(r.point.id, r.distance) for r in res] == [(uuid.UUID(int=10_000 + j), 0.0)]
    shard.close()


def test_parallel_subquery_fanout_deterministic_matches_jax():
    """_and/_or children run in a thread pool: combined queries issued from
    four threads agree with each other, keep the AND semantics, and answer as
    the JAX shard does."""
    rng = np.random.default_rng(23)
    point_ids = [uuid.UUID(bytes=rng.bytes(16), version=4) for _ in range(40)]
    body = {"query": {"property": "_and", "_and": [
        {"property": "v", "vectorVamana": {"vector": [5.0, 5.0], "operator": "near", "searchSize": 36, "limit": 15}},
        {"property": "n", "integer": {"value": 10, "operator": "lessThan"}},
        {"property": "n", "integer": {"value": 2, "operator": "greaterThan"}},
    ]}, "limit": 10, "select": ["*"]}

    def fill(m):
        shard = m["shard"](SCHEMA)
        shard.insert_points([m["point"](id=point_ids[i], data=msgpack.packb({"v": [float(i), float(i)], "n": i}))
                             for i in range(40)])
        return shard

    shard = fill(PORT)
    req = SearchRequest.from_dict(body)
    results, errors = [], []

    def worker():
        try:
            for _ in range(5):
                results.append([str(r.point.id) for r in shard.search_points(req)])
        except Exception as e:  # collected and failed on below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 20 and all(r == results[0] for r in results), "non-deterministic fan-out"
    res = shard.search_points(req)
    assert all(2 < r.point.as_map()["n"] < 10 for r in res)
    want = fill(JAX).search_points(JaxRequest.from_dict(body))
    assert [str(r.point.id) for r in want] == results[0]


def _ivf_consistent(idx: IndexIVF) -> None:
    """Every primary location and SOAR copy holds its id; no slab slot or
    overflow slot holds an id without a location."""
    slab_ids, ovf_ids = idx.slab_ids.numpy(), idx.ovf_ids.numpy()
    held = 0
    for nid, loc in idx._loc.items():
        if loc[0] == "s":
            assert slab_ids[loc[1], loc[2]] == nid, (nid, loc)
        else:
            assert loc[1] >= 0 and ovf_ids[loc[1]] == nid, (nid, loc)
        held += 1
    for nid, copies in idx._loc2.items():
        for c, s in copies:
            assert slab_ids[c, s] == nid, (nid, c, s)
            held += 1
    assert int((slab_ids >= 0).sum()) + int((ovf_ids >= 0).sum()) == held


def test_ivf_concurrent_writers_in_place_stay_consistent():
    """Two writer threads and two searchers on one IVF engine, whose writes
    go in place: no write is lost, every location holds its id (primaries,
    copies and the overflow), and every inserted point finds itself at
    distance 0."""
    rng = np.random.default_rng(24)
    idx = IndexIVF(VectorIVFParams(vector_size=8, distance_metric="euclidean", assign_copies=2), CPU)
    base = rng.standard_normal((800, 8)).astype(np.float32)
    idx.insert_update_delete(zip(range(2, 802), base))
    assert idx._n_at_fit > 0
    written = {start: [rng.standard_normal((100, 8)).astype(np.float32) for _ in range(4)]
               for start in (20_000, 40_000)}
    errors = []

    def writer(start):
        try:
            for r, vs in enumerate(written[start]):
                idx.insert_update_delete(zip(range(start + r * 100, start + (r + 1) * 100), vs))
        except Exception as e:  # collected and failed on below
            errors.append(e)

    def searcher():
        try:
            for _ in range(25):
                d, i = idx.search_batch(base[:8], k=5)
                assert i.shape == (8, 5)
                assert (i[:, 0] == np.arange(2, 10)).all() and (d[:, 0] == 0.0).all()
        except Exception as e:  # collected and failed on below
            errors.append(e)

    ts = [threading.Thread(target=writer, args=(s,)) for s in written] + [
        threading.Thread(target=searcher) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errors, f"thread errors: {errors[:3]}"
    assert len(idx) == 800 + 2 * 400
    _ivf_consistent(idx)
    for start, batches in written.items():
        vs = np.concatenate(batches)
        d, i = idx.search_batch(vs, k=1)
        assert (i[:, 0] == np.arange(start, start + 400)).all(), f"points of the writer at {start} lost"
        assert (d[:, 0] == 0.0).all()
