"""The query upload (``utils/upload.py``) on the CPU.

The pinned route needs a CUDA device: here its chunk plan and its chunked
fill run on plain CPU tensors, and the engines' answers through that fill
are held equal to those of the direct ``.to(device)`` upload. The card's
own checks (pinned against pageable, no wait on the stream, no staging
buffer refilled early) are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import semadb_tpu_torch.index.ivf as ivf_mod
import semadb_tpu_torch.index.vamana as vamana_mod
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.index.vamana import IndexVamana
from semadb_tpu_torch.models.schema import VectorIVFParams, VectorVamanaParams
from semadb_tpu_torch.utils import upload

CPU = torch.device("cpu")


@pytest.mark.parametrize("dim", [100, 128, 1536])
def test_chunk_plan_covers_every_row_once_in_order(dim):
    row_bytes = 4 * dim
    per_chunk = max(1, upload.UPLOAD_CHUNK_BYTES // row_bytes)
    last = 0
    for rows in range(1, 4097):
        plan = upload.chunk_rows(rows, row_bytes)
        assert [r0 for r0, _ in plan] == [0] + [r1 for _, r1 in plan[:-1]]
        assert plan[-1][1] == rows and all(r1 > r0 for r0, r1 in plan)
        assert all((r1 - r0) * row_bytes <= upload.UPLOAD_CHUNK_BYTES for r0, r1 in plan)
        assert len(plan) == -(-rows // per_chunk) >= last  # the count follows the bytes
        last = len(plan)
    assert upload.chunk_rows(0, row_bytes) == []


def test_chunk_counts_at_the_cells_shapes():
    """A single search is one chunk, a 4,096 x 128 batch (2.1 MB) one, a
    4,096 x 1,536 batch (25.2 MB) several; a row past the chunk size is a
    chunk of its own."""
    assert len(upload.chunk_rows(1, 4 * 128)) == 1
    assert len(upload.chunk_rows(4096, 4 * 128)) == -(-4096 * 512 // upload.UPLOAD_CHUNK_BYTES)
    big = upload.chunk_rows(4096, 4 * 1536)
    assert len(big) == -(-4096 // (upload.UPLOAD_CHUNK_BYTES // 6144)) > 1
    assert upload.chunk_rows(3, upload.UPLOAD_CHUNK_BYTES + 4) == [(0, 1), (1, 2), (2, 3)]


@pytest.mark.parametrize("shape,dtype,route", [
    ((4096, 128), np.float32, "direct"),  # the 128-d cells' 2.1 MB
    ((682, 1536), np.float32, "direct"),  # just under PINNED_MIN_BYTES
    ((683, 1536), np.float32, "pinned"),  # just over it
    ((4096, 1536), np.float32, "pinned"),  # the 1,536-d cell's 25.2 MB
    ((682, 1536), np.float64, "direct"),  # counted in float32 bytes
    ((1, 1536), np.float32, "direct"),  # a single search
    ((4096, 1536), "tensor", "pinned"),  # a CPU tensor is a host batch
])
def test_route_follows_the_float32_bytes(shape, dtype, route, monkeypatch):
    """On a CUDA device a host batch takes the pinned route from
    PINNED_MIN_BYTES of float32 on, else the direct route; on the CPU every
    batch takes the direct route."""
    taken = []
    monkeypatch.setattr(upload, "_pinned", lambda src, device: taken.append(("pinned", src.shape)))
    monkeypatch.setattr(upload, "_direct", lambda queries, device: taken.append(("direct", np.shape(queries))))
    x = torch.zeros(shape) if dtype == "tensor" else np.zeros(shape, dtype)
    upload.upload_queries(x, torch.device("cuda"))
    upload.upload_queries(x, CPU)
    assert taken == [(route, shape), ("direct", shape)]
    assert (4 * np.prod(shape) >= upload.PINNED_MIN_BYTES) == (route == "pinned")


def _inputs():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((37, 24))
    return {
        "float32": base.astype(np.float32),
        "float64": base,
        "column_slice": base.astype(np.float32)[:, ::2],
        "row_stride": base[::3],
        "reversed": base[::-1],
        "fortran": np.asfortranarray(base),
        "int32": (base * 10).astype(np.int32),
        "one_row": base[0].astype(np.float32),
        "list": base[:5].tolist(),
        "tensor_f64_transposed": torch.from_numpy(base.T.copy()).T,
        "tensor_f16": torch.from_numpy(base.astype(np.float16)),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_staged_copy_delivers_float32_equal_to_the_input(name, monkeypatch):
    x = _inputs()[name]
    monkeypatch.setattr(upload, "UPLOAD_CHUNK_BYTES", 5 * 4 * 24)  # about five rows a chunk
    src = upload._host_rows(x)
    staging = torch.full(src.shape, float("nan"))
    out = torch.full(src.shape, float("nan"))
    chunks = upload._staged_copy(src, staging, out)
    want = np.atleast_2d(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32))
    assert chunks == len(upload.chunk_rows(want.shape[0], 4 * want.shape[1]))
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert np.array_equal(out.numpy(), want) and np.array_equal(staging.numpy(), want)


@pytest.mark.parametrize("name", list(_inputs()))
def test_cpu_device_takes_the_direct_route(name):
    x = _inputs()[name]
    before = dict(upload.UPLOADS)
    got = upload.upload_queries(x, CPU)
    want = np.atleast_2d(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert upload.UPLOADS == {**before, "direct": before["direct"] + 1}


def _staged_upload(queries, device):
    """The pinned route's fill on the CPU: chunked into unpinned staging."""
    src = upload._host_rows(queries)
    staging, out = torch.empty(src.shape), torch.empty(src.shape, device=device)
    upload._staged_copy(src, staging, out)
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    cents = rng.standard_normal((12, 16)).astype(np.float32) * 4
    vecs = (cents[rng.integers(0, 12, 1500)] + rng.standard_normal((1500, 16))).astype(np.float32)
    queries = rng.standard_normal((70, 16)) * 4  # float64, as a client may send them
    return vecs, queries


def test_ivf_answers_through_the_chunked_fill_equal_direct(data, monkeypatch):
    vecs, queries = data
    idx = IndexIVF(VectorIVFParams(vector_size=16, distance_metric="euclidean", assign_copies=2), CPU)
    idx.insert_bulk(np.arange(2, len(vecs) + 2), vecs)
    want = [t.numpy() for t in idx.search_batch_async(torch.from_numpy(queries.astype(np.float32)), 10)]
    monkeypatch.setattr(upload, "UPLOAD_CHUNK_BYTES", 7 * 64)
    monkeypatch.setattr(ivf_mod, "upload_queries", _staged_upload)
    got = [t.numpy() for t in idx.search_batch_async(np.asfortranarray(queries), 10)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.array_equal(idx.search_batch(queries, 10)[1], want[1])


@pytest.fixture()
def vamana(data):
    vecs, _ = data
    idx = IndexVamana(VectorVamanaParams(vector_size=16, distance_metric="euclidean", search_size=40,
                                         degree_bound=16), CPU)
    idx.insert_update_delete(zip(range(2, 402), vecs[:400]))
    return idx


def test_vamana_answers_through_the_chunked_fill_equal_direct(vamana, data, monkeypatch):
    _, queries = data
    want = [t.numpy() for t in vamana.search_batch_async(torch.from_numpy(queries.astype(np.float32)), 10)]
    before = dict(upload.UPLOADS)
    assert np.array_equal(vamana.search_batch(queries, 10)[1], want[1])
    assert upload.UPLOADS["direct"] == before["direct"] + 1  # search_batch uploads once
    monkeypatch.setattr(upload, "UPLOAD_CHUNK_BYTES", 7 * 64)
    monkeypatch.setattr(vamana_mod, "upload_queries", _staged_upload)
    got = [t.numpy() for t in vamana.search_batch_async(queries, 10)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    walk = vamana.query_walk(queries, 40)
    assert walk.cand_ids.shape == (len(queries), 40)


def test_vamana_seed_tensor_is_dropped_on_writes(vamana, data):
    vecs, queries = data

    def searched():
        vamana.search_batch_async(queries[:3], 5)
        seeds = vamana._entry_seeds_dev
        assert seeds is not None and torch.equal(seeds, torch.as_tensor(vamana._get_entry_seeds()))
        return seeds

    first = searched()
    assert searched() is first  # kept while the graph stands
    vamana.insert_update_delete(zip(range(402, 452), vecs[400:450]))
    assert vamana._entry_seeds_dev is None
    searched()
    vamana.insert_update_delete([(i, None) for i in range(2, 300, 3)])
    assert vamana._entry_seeds_dev is None
    after = searched()
    assert not np.isin(after.numpy(), np.arange(2, 300, 3)).any()
