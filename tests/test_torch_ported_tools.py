"""The tools, dataset functions and IVF dirty tracker the port copied last.

- ``restackbench`` builds an 8-shard IVF fleet on ``cpu`` slots and prints
  the JAX tool's JSON keys;
- ``dumpkeys`` and ``migrate`` run over a store the port wrote (``migrate``
  into the Python store format; the copy holds every key);
- ``jsonschema`` prints what the JAX tool prints;
- ``load_hdf5``, ``synthetic_clustered`` and ``embedding_like_adversarial``
  give arrays equal to the JAX package's (numpy, one seed);
- the ann-benchmarks adapter builds and queries both engines;
- the IVF and fused engines' dirty trackers: the IVF cases of
  ``tests/test_snapshot_incremental.py`` on the port (a small write rewrites
  a few chunks, a journal tail replays over an incremental snapshot, row
  growth stays incremental), and a store flushed incrementally holds the
  same bytes as one flushed in full after every write.
"""

import json
import uuid

import numpy as np
import pytest
import torch

from semadb_tpu.tools import datasets as jax_datasets
from semadb_tpu.tools import jsonschema as jax_jsonschema
from semadb_tpu_torch.models import Collection, IndexSchema, Point, SearchRequest, UserPlan
from semadb_tpu_torch.shard import Shard
from semadb_tpu_torch.shard import snapshot as snap
from semadb_tpu_torch.store import open_store
from semadb_tpu_torch.tools import datasets, dumpkeys, jsonschema, migrate, restackbench

CPU = torch.device("cpu")
DIM = 8


def test_restackbench_prints_its_keys(capsys):
    assert restackbench.main(["--n", "4000", "--shards", "8", "--device", "cpu", "--repeat", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metric", "build_s", "full_restack_s", "incremental_s", "speedup", "platform"}
    assert out["metric"] == "restack4k_x8" and out["platform"] == "cpu"
    assert len(out["full_restack_s"]) == len(out["incremental_s"]) == 2


def test_restackbench_keeps_a_servable_fleet():
    """``--data embedding`` with ``keep`` (4 shards, each past its first
    fit): the stack's fan-out equals the merge of each shard's own search
    (the contract the card checks at 1M x 8)."""
    from semadb_tpu_torch.parallel.fanout import sharded_ivf_search

    keep = {}
    restackbench.main(["--n", "2400", "--shards", "4", "--device", "cpu", "--repeat", "1", "--data", "embedding",
                       "--queries", "16"], keep=keep)
    q = keep["test"]
    p = keep["indices"][0]._num_probes(0)
    d, i, s = (x.numpy() for x in sharded_ivf_search(keep["stacked"], q, p, 10, keep["mesh"]))
    own = [idx.search_batch(q, 10, num_probes=p) for idx in keep["indices"]]
    for b in range(len(q)):
        pool = sorted((float(od[b, j]), si, int(oi[b, j])) for si, (od, oi) in enumerate(own)
                      for j in range(10) if oi[b, j] >= 0)
        assert [x[0] for x in pool[:10]] == d[b].tolist()
        assert {(x[1], x[2]) for x in pool[:10] if x[0] < pool[9][0]} == {
            (int(s[b, j]), int(i[b, j])) for j in range(10) if d[b, j] < pool[9][0]}


def _port_store(tmp_path):
    """A shard file the port wrote: an IVF collection, flushed."""
    path = str(tmp_path / "s.sdb")
    col = Collection(user_id="u1", id="c1", user_plan=UserPlan(), index_schema=IndexSchema.from_dict(
        {"emb": {"type": "vectorIVF", "vectorIVF": {"vectorSize": DIM, "distanceMetric": "euclidean"}}}))
    shard = Shard(open_store(path), col, CPU)
    rng = np.random.default_rng(0)
    shard.insert_points([Point.from_map({"emb": rng.standard_normal(DIM).tolist()}, uuid.UUID(int=i + 1))
                         for i in range(50)])
    shard.flush()
    shard.close()
    return path


def test_dumpkeys_and_migrate_over_a_port_store(tmp_path, capsys):
    path = _port_store(tmp_path)
    assert dumpkeys.main([path]) == 0
    listing = capsys.readouterr().out
    assert "[points]" in listing and "keys)" in listing
    dest = str(tmp_path / "copy.sdb")
    n = migrate.migrate_store(path, dest, dest_backend="python")
    assert n > 50
    assert dumpkeys.main([dest]) == 0
    assert capsys.readouterr().out == listing
    v1 = {"id": "c", "vectorSize": 4, "distanceMetric": "cosine"}
    out = migrate.migrate_v1_collection(v1)
    assert out["indexSchema"]["vector"]["vectorVamana"]["vectorSize"] == 4 and "vectorSize" not in out


def test_jsonschema_matches_the_jax_tool(capsys):
    assert jsonschema.main([]) == 0
    port_out = capsys.readouterr().out
    assert jax_jsonschema.main([]) == 0
    assert port_out == capsys.readouterr().out


def _same(a, b):
    assert a.name == b.name and a.metric == b.metric
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(a.test, b.test)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_dataset_generators_equal_jax(metric):
    _same(datasets.synthetic_clustered(500, 16, 20, metric=metric, seed=3),
          jax_datasets.synthetic_clustered(500, 16, 20, metric=metric, seed=3))
    _same(datasets.embedding_like_adversarial(800, 24, 30, metric=metric, seed=5),
          jax_datasets.embedding_like_adversarial(800, 24, 30, metric=metric, seed=5))


@pytest.mark.parametrize("distance", ["euclidean", "angular"])
def test_load_hdf5_equals_jax(tmp_path, distance):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / f"{distance}.hdf5")
    rng = np.random.default_rng(1)
    with h5py.File(path, "w") as f:
        f["train"] = rng.standard_normal((100, 8)).astype(np.float32)
        f["test"] = rng.standard_normal((10, 8)).astype(np.float32)
        f["neighbors"] = rng.integers(0, 100, (10, 5)).astype(np.int32)
        f.attrs["distance"] = distance
    got, want = datasets.load_hdf5(path), jax_datasets.load_hdf5(path)
    _same(got, want)
    np.testing.assert_array_equal(got.neighbors, want.neighbors)
    assert got.metric == ("cosine" if distance == "angular" else "euclidean")


@pytest.mark.parametrize("engine", ["ivf", "vamana"])
def test_ann_benchmarks_adapter(engine):
    from semadb_tpu_torch.tools.ann_benchmarks_adapter import SemaDBTPU

    ds = datasets.embedding_like(600, 16, 20, seed=2)
    algo = SemaDBTPU("euclidean", {"engine": engine, "device": "cpu", "searchSize": 40, "degreeBound": 16})
    algo.fit(ds.train)
    algo.set_query_arguments(40 if engine == "vamana" else 16)
    assert "SemaDBTPU" in str(algo)
    gt = datasets.compute_ground_truth(ds, 10)
    one = algo.query(ds.test[0], 10)
    assert len(one) == 10 and one[0] == gt[0, 0]
    algo.batch_query(ds.test, 10)
    res = algo.get_batch_results()
    recall = np.mean([len(set(r) & set(g)) / 10 for r, g in zip(res.tolist(), gt.tolist())])
    assert res.shape == (20, 10) and recall >= 0.9, recall
    algo.done()


# -- the IVF dirty tracker ---------------------------------------------------------


@pytest.fixture()
def tiny_chunks(monkeypatch):
    """Shrink the chunk grid so chunk-level behaviour shows at test scale."""
    monkeypatch.setattr(snap, "CHUNK_TARGET_BYTES", 1024)
    monkeypatch.setattr(snap, "SMALL_MAX_BYTES", 128)


def _ivf_shard(path, fused=False):
    sch = {"emb": {"type": "vectorIVF", "vectorIVF": {"vectorSize": DIM, "distanceMetric": "euclidean"}}}
    if fused:
        sch = {"emb": {"type": "vectorFused", "vectorFused": {"views": [
            {"vectorSize": 5, "distanceMetric": "euclidean"}, {"vectorSize": 3, "distanceMetric": "dot"}]}}}
    col = Collection(user_id="u1", id="c1", index_schema=IndexSchema.from_dict(sch), user_plan=UserPlan())
    return Shard(open_store(path), col, CPU)


def _points(n, offset=0, fused=False, seed=11):
    rng = np.random.default_rng(seed + offset)
    out = []
    for i in range(n):
        x = offset + i
        vec = rng.standard_normal(DIM).astype(np.float32)
        vec[0] += x  # spread so nearest-neighbour checks are stable
        val = [vec[:5].tolist(), vec[5:].tolist()] if fused else vec.tolist()
        out.append(Point.from_map({"emb": val}, uuid.UUID(int=x + 1)))
    return out


def _query(vec, limit=5, fused=False):
    if fused:
        q = {"property": "emb", "vectorFused": {"vectors": [vec[:5].tolist(), vec[5:].tolist()],
                                                "operator": "near", "limit": limit}}
    else:
        q = {"property": "emb", "vectorIVF": {"vector": vec.tolist(), "limit": limit}}
    return SearchRequest.from_dict({"query": q, "limit": limit})


def _ids(results):
    return [r.point.id for r in results]


def test_ivf_incremental_flush_writes_fewer_chunks(tmp_path, tiny_chunks):
    shard = _ivf_shard(str(tmp_path / "s.sdb"))
    shard.insert_points(_points(400))
    first = shard.flush()
    assert first > 4  # the full state really is chunked at this scale
    shard.insert_points(_points(3, offset=400))
    second = shard.flush()
    assert 0 < second < first / 2, (first, second)
    probe = np.zeros(DIM, np.float32)
    probe[0] = 200.0
    want = _ids(shard.search_points(_query(probe)))
    shard.close()
    shard2 = _ivf_shard(str(tmp_path / "s.sdb"))
    assert _ids(shard2.search_points(_query(probe))) == want
    shard2.close()


def test_crash_replay_across_incremental_snapshot(tmp_path, tiny_chunks):
    path = str(tmp_path / "s.sdb")
    shard = _ivf_shard(path)
    shard.insert_points(_points(300))
    shard.flush()
    shard.insert_points(_points(50, offset=300))  # incremental chunks
    shard.flush()
    shard.insert_points(_points(5, offset=350))  # journal only
    probe = np.zeros(DIM, np.float32)
    probe[0] = 352.0
    want = _ids(shard.search_points(_query(probe)))
    del shard  # abandon without close: the journal tail must replay
    shard2 = _ivf_shard(path)
    assert _ids(shard2.search_points(_query(probe))) == want
    shard2.close()


def test_row_growth_keeps_incremental_chunks(tmp_path, tiny_chunks):
    shard = _ivf_shard(str(tmp_path / "s.sdb"))
    shard.insert_points(_points(400))
    first = shard.flush()
    shard.insert_points(_points(6, offset=400))
    second = shard.flush()
    assert 0 < second < first / 2, (first, second)
    shard.close()
    shard2 = _ivf_shard(str(tmp_path / "s.sdb"))
    probe = np.zeros(DIM, np.float32)
    probe[0] = 405.0
    assert uuid.UUID(int=406) in _ids(shard2.search_points(_query(probe)))
    shard2.close()


def _bucket_bytes(path):
    out = {}

    def reader(bm):
        for name in bm.bucket_names():
            for k, v in bm.get(name).items():
                out[(name, bytes(k))] = bytes(v)

    store = open_store(path)
    store.read(reader)
    store.close()
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_incremental_snapshot_equals_a_full_write(tmp_path, tiny_chunks, fused):
    """Inserts, updates and deletes, flushed after each step: the store that
    wrote only dirty chunks holds the same bytes as one that rewrote every
    chunk (its tracker set to "everything" before each flush)."""
    paths = [str(tmp_path / "inc.sdb"), str(tmp_path / "full.sdb")]
    shards = [_ivf_shard(p, fused) for p in paths]
    steps = [
        lambda s: s.insert_points(_points(300, fused=fused)),  # before the first fit: overflow rows
        lambda s: s.delete_points({uuid.UUID(int=i) for i in range(10, 15)}),
        lambda s: s.insert_points(_points(400, offset=300, fused=fused)),  # the first fit
        lambda s: s.insert_points(_points(20, offset=700, fused=fused)),  # slab cells of a fitted index
        lambda s: s.update_points(_points(10, offset=100, fused=fused, seed=99)),
        lambda s: s.delete_points({uuid.UUID(int=i) for i in range(40, 60)}),
        lambda s: s.insert_points(_points(5, offset=720, fused=fused)),
    ]
    written = [[], []]
    for step in steps:
        for n, s in enumerate(shards):
            step(s)
            if n == 1:
                next(iter(s.device_indices.values())).dirty.everything()
            written[n].append(s.flush())
    assert sum(written[0]) < sum(written[1]), written
    for s in shards:
        s.close()
    inc, full = (_bucket_bytes(p) for p in paths)
    assert inc.keys() == full.keys()
    assert [k for k in inc if inc[k] != full[k]] == []
