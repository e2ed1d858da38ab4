"""K1-K4, the flat index and the IVF index on a CUDA card (skipped without one).

These need the card: the CUDA kernels have no CPU mode. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: K1 and K2 exact. K1's counts are integers and jaccard is one
IEEE f32 division of two of them on both sides, on either route; the gather
copies bits. K3 and K4 sum in another order than their plain versions:
distances within 1e-5 of the summed terms' magnitude, ids by the tie rule at
that tolerance.
"""

import numpy as np
import pytest
import torch

from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, Quantizer
from semadb_tpu_torch.models.schema import VectorFlatParams, VectorIVFParams
from semadb_tpu_torch.ops.kernels import gather, hamming, ivf_rerank, ivf_scan
from semadb_tpu_torch.ops.topk import pool_errors, tie_rule_errors

CASES = [
    (1, 1, 1), (2, 130, 9), (7, 511, 5), (8, 129, 8), (15, 1000, 48), (16, 4099, 48),
    (17, 333, 3), (33, 700, 48), (64, 4099, 48), (65, 1000, 128), (300, 1000, 3),
    (4096, 32768, 48), (65537, 64, 5),
]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _codes(gen, rows, w):
    c = torch.randint(-2**31, 2**31 - 1, (rows, w), generator=gen, dtype=torch.int64)
    c = c.to(torch.int32)
    c[0] = 0  # zero rows: jaccard's empty union
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "cuda_core", "tensor_core"])
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
@pytest.mark.parametrize("b,n,w", CASES)
def test_kernel_matches_plain(cuda, b, n, w, metric, route):
    gen = torch.Generator().manual_seed(b * 1000 + n + w)
    q, x = _codes(gen, b, w).to(cuda), _codes(gen, n, w).to(cuda)
    if b > 1:
        q[1] = -1  # an all-ones query row: the largest counts
    before = hamming.LAUNCHES
    got = hamming.pairwise_bit_distance_kernel(q, x, metric, route=route)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == before + -(-b // hamming.MAX_B_PER_LAUNCH)
    want = hamming.pairwise_bit_distance_plain(q, x, metric)
    assert got.shape == (b, n) and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_route_by_b(cuda):
    """Without a forced route, B = 1 takes the CUDA-core route and
    B >= TENSOR_MIN_B the tensor-core route; each launch is counted under its
    route and whether B is 1."""
    x = torch.zeros((100, 48), dtype=torch.int32, device=cuda)
    for b, key in ((1, ("cuda_core", True)), (hamming.TENSOR_MIN_B, ("tensor_core", False)),
                   (64, ("tensor_core", False))):
        assert hamming.route_for(b, 48) == key[0]
        before = hamming.LAUNCHES_BY[key]
        hamming.pairwise_bit_distance_kernel(torch.ones((b, 48), dtype=torch.int32, device=cuda), x, "hamming")
        assert hamming.LAUNCHES_BY[key] == before + 1


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_operands(cuda):
    q = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    x = torch.zeros((5, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        hamming.pairwise_bit_distance_kernel(q.to(torch.int64), x, "hamming")
    with pytest.raises(ValueError, match="contiguous"):
        hamming.pairwise_bit_distance_kernel(q, torch.zeros((4, 5), dtype=torch.int32, device=cuda).T, "hamming")
    with pytest.raises(ValueError, match="word counts"):
        hamming.pairwise_bit_distance_kernel(q, x[:, :3].contiguous(), "hamming")
    with pytest.raises(ValueError, match="cpu"):
        hamming.pairwise_bit_distance_kernel(q.cpu(), x, "hamming")
    with pytest.raises(ValueError, match="unknown route"):
        hamming.pairwise_bit_distance_kernel(q, x, "hamming", route="simd")


@pytest.mark.cuda
def test_flat_index_on_card_matches_cpu(cuda):
    """The binary flat index on the card goes through K1 and gives what the
    same index on the CPU (plain version) gives."""
    q = Quantizer(type="binary", binary=BinaryQuantizerParams(distance_metric="hamming", threshold=0.0))
    params = VectorFlatParams(vector_size=256, distance_metric="cosine", quantizer=q)
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((500, 256)).astype(np.float32)
    changes = list(zip(range(2, 502), vecs)) + [(40, None)]
    on_card, on_cpu = IndexFlat(params, cuda), IndexFlat(params, torch.device("cpu"))
    on_card.insert_update_delete(changes)
    on_cpu.insert_update_delete(changes)
    queries = rng.standard_normal((9, 256)).astype(np.float32)
    before = hamming.LAUNCHES
    d_card, i_card = on_card.search_batch(queries, 10)
    assert hamming.LAUNCHES > before
    d_cpu, _ = on_cpu.search_batch(queries, 10)
    np.testing.assert_array_equal(d_card, d_cpu)
    full = on_cpu.store.scan_distances(torch.from_numpy(queries), on_cpu.vectors, on_cpu.exists)
    for b in range(len(queries)):
        np.testing.assert_array_equal(full[b, i_card[b]].numpy(), d_card[b])


GATHER_CASES = [(1, 1, 1), (3, 1023, 70001), (128, 1024, 70001), (128, 5000, 1), (1536, 777, 4096)]


def _gather_ids(gen, n, cap, device):
    ids = torch.randint(0, cap, (n,), generator=gen, dtype=torch.int32)
    ids[0] = 0
    if n > 1:
        ids[-1] = cap - 1
    if n > 2:
        ids[n // 2] = ids[-1]  # a repeat
    return ids.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,cap", GATHER_CASES)
def test_gather_kernel_matches_plain(cuda, d, n, cap):
    gen = torch.Generator().manual_seed(d * 7 + n + cap)
    vectors = torch.randn((cap, d), generator=gen).to(cuda)
    ids = _gather_ids(gen, n, cap, cuda)
    before = gather.LAUNCHES
    got = gather.gather_rows_padded(vectors, ids, check=True)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(got, gather.gather_rows_plain(vectors, ids))
    if n % gather.TILE == 0:
        assert torch.equal(gather.gather_rows(vectors, ids), got)


@pytest.mark.cuda
def test_gather_kernel_unaligned_rows(cuda):
    """A base pointer off the 16-byte grid takes the 4-byte copy."""
    gen = torch.Generator().manual_seed(5)
    flat = torch.randn(1 + 300 * 128, generator=gen).to(cuda)
    vectors = flat[1:].view(300, 128)
    assert vectors.data_ptr() % 16 != 0
    ids = _gather_ids(gen, 999, 300, cuda)
    assert torch.equal(gather.gather_rows_padded(vectors, ids, check=True),
                       gather.gather_rows_plain(vectors, ids))


@pytest.mark.cuda
def test_gather_kernel_reports_bad_ids(cuda):
    vectors = torch.randn((100, 16), device=cuda)
    for bad in (100, -1):
        ids = torch.tensor([0, 5, bad, 99], dtype=torch.int32, device=cuda)
        with pytest.raises(IndexError, match=r"outside \[0, 100\)"):
            gather.gather_rows_padded(vectors, ids, check=True)
        out = gather.gather_rows_padded(vectors, ids)  # unchecked: the row is zero, nothing read
        torch.cuda.synchronize()
        assert torch.equal(out[2], torch.zeros(16, device=cuda))
        assert torch.equal(out[[0, 1, 3]], vectors[[0, 5, 99]])
    with pytest.raises(ValueError, match="multiple of 1024"):
        gather.gather_rows(vectors, torch.zeros(1000, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="cpu"):
        gather.gather_rows_padded(vectors, torch.zeros(4, dtype=torch.int32))


# (B, p, S, r, rr, bf16 slabs, mask, layout): layout None (random probes),
# "same-probes" (every query on the same probes), "copies" (ids stored in two
# clusters), "holes" (live prefixes with deleted slots), "chunked" (a small
# scratch budget: B runs in chunks)
IVF_SCAN_CASES = [
    (1, 1, 64, 3, 20, False, False, None), (7, 5, 128, 100, 64, True, True, None),
    (64, 24, 192, 128, 256, False, True, None), (64, 96, 64, 100, 64, True, False, None),
    (4096, 24, 128, 128, 64, False, False, None), (4096, 24, 128, 128, 64, True, True, None),
    (3, 40, 1024, 8, 2048, False, False, None),
    (4096, 24, 128, 128, 64, False, False, "same-probes"), (300, 24, 128, 128, 64, False, True, "copies"),
    (9, 6, 40, 100, 20, True, False, "copies"), (4096, 24, 128, 128, 64, False, True, "holes"),
    (33, 8, 192, 3, 64, True, False, "holes"), (1000, 24, 128, 128, 64, False, False, "chunked"),
    (5, 40, 1024, 8, 2048, True, True, "chunked"),
]
IVF_RTOL = 1e-5


def _pools_agree(want, got, dist_of, atol):
    """Every row of got (d, i) against want by the multiset tie rule (a pool
    may hold an id twice)."""
    wd, wi = (t.cpu() for t in want)
    gd, gi = (t.cpu() for t in got)
    assert gd.shape == wd.shape
    for b in range(wd.shape[0]):
        errs = pool_errors(wd[b].tolist(), wi[b].tolist(), gd[b].tolist(), gi[b].tolist(),
                           lambda i, b=b: dist_of(b, i), float(atol[b]))
        assert not errs, (b, errs)


def _scan_operands(gen, b, p, s, r, bf16, masked, layout):
    c = max(2 * p, 32)
    rows = torch.randn((c, s, r), generator=gen)
    ids = (torch.randperm(c * s, generator=gen).reshape(c, s) + 2).to(torch.int32)
    nil = torch.rand((c, s), generator=gen) < 0.3
    if layout == "holes":
        fill = torch.randint(s // 2, s + 1, (c, 1), generator=gen)
        nil = (torch.arange(s)[None, :] >= fill) | (torch.rand((c, s), generator=gen) < 0.1)
    ids[nil] = -1
    rows[nil] = 0.0
    if layout == "copies":
        q4 = s // 4
        ids[:, s - q4:] = ids.roll(1, dims=0)[:, :q4].clone()
        rows[:, s - q4:] = rows.roll(1, dims=0)[:, :q4].clone()
    slabs = rows.to(torch.bfloat16) if bf16 else rows
    sq = (rows * rows).sum(-1)
    qp = torch.randn((b, r), generator=gen)
    if layout == "same-probes":
        probe = torch.randperm(c, generator=gen)[:p].to(torch.int32).expand(b, p).contiguous()
    else:
        probe = torch.argsort(torch.rand((b, c), generator=gen), dim=1)[:, :p].to(torch.int32).contiguous()
    mask = (torch.rand(c * s + 2, generator=gen) < 0.5).to(torch.uint8) if masked else None
    return qp, probe, slabs, sq, ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s,r,rr,bf16,masked,layout", IVF_SCAN_CASES)
def test_ivf_probe_scan_matches_plain(cuda, b, p, s, r, rr, bf16, masked, layout, monkeypatch):
    gen = torch.Generator().manual_seed(b + 10 * p + s + r + rr)
    qp, probe, slabs, sq, ids, mask = _scan_operands(gen, b, p, s, r, bf16, masked, layout)
    if layout == "chunked":
        monkeypatch.setattr(ivf_scan, "SCRATCH_BYTES", p * s * 4 * max(1, b // 7))
        assert ivf_scan.batch_chunk(b, p, s) < b
    ops = [t if t is None else t.to(cuda) for t in (qp, probe, slabs, sq, ids, mask)]
    before = ivf_scan.LAUNCHES
    got = ivf_scan.ivf_probe_scan(*ops, rr)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == before + 1  # one a call, whatever the chunks
    want = ivf_scan.ivf_probe_scan_plain(*ops, rr)
    flat_ids = ids.reshape(-1)
    x = slabs.float().reshape(-1, r).double()

    def dist_of(bb, i):
        if i == -1:
            return float("inf")
        cell = int((flat_ids == i).nonzero()[0, 0])
        return float(sq.reshape(-1)[cell]) - 2.0 * float(x[cell] @ qp[bb].double())

    xmax = float(x.norm(dim=1).max())
    atol = IVF_RTOL * (xmax * xmax + 2.0 * xmax * qp.double().norm(dim=1))
    _pools_agree(want, got, dist_of, atol)


# K3 at the 10M cell's cluster count (131,072 clusters: 32 tiles of the
# offsets look-back scan), S = 192, r = 128, bf16 slabs
BIG_C, BIG_S, BIG_R, BIG_RR = 131_072, 192, 128, 64


@pytest.fixture(scope="module")
def big_slabs():
    """One slab set at the 10M cell's widths, made on the card from a seed
    (30% NIL slots, norms of the f32 rows), and a mask over half the ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, slabs, sq, ids, mask = ivf_scan.random_operands(BIG_C, BIG_S, BIG_R, 131072, torch.device("cuda"))
    ids_h = ids.cpu().numpy().reshape(-1)
    order = np.argsort(ids_h, kind="stable")
    yield slabs, sq, ids, mask, order, ids_h[order]
    del slabs, sq, ids, mask
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [24, 96])
@pytest.mark.parametrize("b", [1, 4096])
def test_ivf_probe_scan_at_131072_clusters(big_slabs, b, p, masked):
    slabs, sq, ids, mask, order, sorted_ids = big_slabs
    gen = torch.Generator(device="cuda").manual_seed(b + p + masked)
    qp = torch.randn((b, BIG_R), generator=gen, device="cuda")
    probe = torch.topk(torch.rand((b, BIG_C), generator=gen, device="cuda"), p, dim=1).indices.to(torch.int32)
    ops = (qp, probe.contiguous(), slabs, sq, ids, mask if masked else None, BIG_RR)
    got = ivf_scan.ivf_probe_scan(*ops)
    torch.cuda.synchronize()
    want = ivf_scan.ivf_probe_scan_plain(*ops)
    flat, flat_sq = slabs.reshape(-1, BIG_R), sq.reshape(-1)
    xmax = max(float(slabs[c0 : c0 + 8192].float().norm(dim=-1).max()) for c0 in range(0, BIG_C, 8192))
    atol = (IVF_RTOL * (xmax * xmax + 2.0 * xmax * qp.double().norm(dim=1))).cpu()

    def dist_of(bb, i):
        if i == -1:
            return float("inf")
        cell = int(order[np.searchsorted(sorted_ids, i)])
        return float(flat_sq[cell]) - 2.0 * float(flat[cell].double() @ qp[bb].double())

    wd, wi = (t.cpu() for t in want)
    gd, gi = (t.cpu() for t in got)
    assert gd.shape == wd.shape == (b, BIG_RR)
    # Rows with the same ids and distances within atol need no lookups
    differ = ((gi != wi) | ((gd - wd).abs().nan_to_num(0.0) > atol[:, None])).any(1).nonzero()[:, 0].tolist()
    for bb in differ:
        errs = pool_errors(wd[bb].tolist(), wi[bb].tolist(), gd[bb].tolist(), gi[bb].tolist(),
                           lambda i, bb=bb: dist_of(bb, i), float(atol[bb]))
        assert not errs, (bb, errs)


# (B, D, k, rr, metric, dedup, layout). Routes: bulk copies at D % 4 == 0
# on the 16-byte grid (D = 4 through 4096; stages of 64, 32, 2 and 1 rows),
# element loads at D = 3 and 100 and off the grid ("offgrid": the matrix a
# view one float in). Stage boundaries: rr = 20, 100 and 255 are no multiple
# of a stage. "copies": every id 2-3 times under dedup, so whole stages' worth
# of slots drop; "front-empty": the first half of every pool empty; "empty":
# no live slot. The warp selection at k <= 32, the block sort past it, k > rr.
IVF_RERANK_CASES = [
    (1, 3, 1, 64, "euclidean", False, None), (7, 128, 10, 64, "dot", False, None),
    (64, 1536, 100, 256, "cosine", False, None), (4096, 128, 10, 64, "euclidean", False, None),
    (33, 100, 10, 64, "euclidean", False, None), (5, 8, 100, 256, "dot", False, None),
    (4096, 128, 10, 64, "euclidean", True, None), (64, 100, 10, 64, "dot", True, None),
    (7, 1536, 100, 256, "cosine", True, None),
    (1, 128, 10, 64, "euclidean", True, None), (1, 1536, 10, 256, "euclidean", True, None),
    (9, 4, 10, 64, "dot", False, None), (3, 4096, 10, 20, "euclidean", False, None),
    (7, 128, 32, 100, "euclidean", False, None), (7, 128, 33, 100, "cosine", False, None),
    (5, 1536, 32, 255, "dot", True, None), (5, 1536, 33, 255, "euclidean", True, None),
    (7, 128, 32, 20, "euclidean", False, None), (7, 128, 100, 20, "dot", False, None),
    (2, 128, 10, 2048, "euclidean", True, None), (2, 128, 100, 2048, "euclidean", True, None),
    (64, 128, 10, 64, "euclidean", True, "offgrid"), (7, 1536, 33, 256, "dot", False, "offgrid"),
    (300, 128, 10, 64, "euclidean", True, "copies"), (7, 1536, 10, 256, "cosine", True, "copies"),
    (7, 3, 32, 20, "dot", True, "copies"), (64, 128, 10, 100, "euclidean", True, "front-empty"),
    (7, 128, 10, 64, "euclidean", True, "empty"), (1, 1536, 33, 256, "cosine", False, "empty"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,k,rr,metric,dedup,layout", IVF_RERANK_CASES)
def test_ivf_exact_rerank_matches_plain(cuda, b, d, k, rr, metric, dedup, layout):
    gen = torch.Generator().manual_seed(b + d + k + rr)
    cap = 3000
    vectors = torch.randn((cap, d), generator=gen)
    queries = torch.randn((b, d), generator=gen)
    if metric == "cosine":
        vectors = vectors / vectors.norm(dim=1, keepdim=True)
        queries = queries / queries.norm(dim=1, keepdim=True)
    pool = torch.argsort(torch.rand((b, cap), generator=gen), dim=1)[:, :rr].to(torch.int32)
    if layout == "copies":  # every id 2 or 3 times
        reps = torch.randint(2, 4, (b, rr), generator=gen).cumsum(1)
        pool = torch.gather(pool, 1, torch.searchsorted(reps, torch.arange(rr).expand(b, rr).contiguous(), right=True))
        pool = torch.gather(pool, 1, torch.argsort(torch.rand((b, rr), generator=gen), dim=1))
    elif dedup:  # a quarter of the slots repeat another slot's id
        again = torch.rand((b, rr), generator=gen) < 0.25
        pool = torch.where(again, torch.gather(pool, 1, torch.randint(0, rr, (b, rr), generator=gen)), pool)
    coarse = torch.randn((b, rr), generator=gen)
    coarse[torch.rand((b, rr), generator=gen) < 0.2] = float("inf")
    pool[torch.rand((b, rr), generator=gen) < 0.05] = -1
    if layout == "front-empty":
        coarse[:, : rr // 2] = float("inf")
    elif layout == "empty":
        coarse[:] = float("inf")
    dev = [t.to(cuda) for t in (vectors, queries, pool, coarse)]
    if layout == "offgrid":  # the same rows, one float off the 16-byte grid
        flat = torch.empty(cap * d + 1, device=cuda)
        dev[0] = flat[1:].view(cap, d)
        dev[0].copy_(vectors)
    assert ivf_rerank.route_of(dev[0]) == ("bulk" if d % 4 == 0 and layout != "offgrid" else "element")
    before = ivf_rerank.LAUNCHES
    got = ivf_rerank.ivf_exact_rerank(*dev, k, metric, dedup)
    torch.cuda.synchronize()
    assert ivf_rerank.LAUNCHES == before + 1
    want = ivf_rerank.ivf_exact_rerank_plain(*dev, k, metric, dedup)
    if layout == "empty":
        assert torch.isinf(got[0]).all() and (got[1] == -1).all()

    def dist_of(bb, i):
        if i == -1:
            return float("inf")
        x, q = vectors[i].double(), queries[bb].double()
        if metric == "euclidean":
            return float(((x - q) ** 2).sum())
        return 1.0 - float(x @ q) if metric == "cosine" else -float(x @ q)

    xmax = float(vectors.norm(dim=1).max())
    atol = IVF_RTOL * ((xmax + queries.double().norm(dim=1)) ** 2 + 1.0)
    if dedup:  # each id once; places past the live ones are -1, so compare as multisets
        gi = got[1].cpu()
        assert all(len(set(row[row >= 0].tolist())) == int((row >= 0).sum()) for row in gi)
    _pools_agree(want, got, dist_of, atol)


@pytest.mark.cuda
def test_ivf_kernel_wrappers_refuse_bad_operands(cuda):
    qp = torch.zeros((2, 8), device=cuda)
    probe = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    slabs = torch.zeros((4, 16, 8), device=cuda)
    sq = torch.zeros((4, 16), device=cuda)
    ids = torch.full((4, 16), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        ivf_scan.ivf_probe_scan(qp, probe.long(), slabs, sq, ids, None, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_scan.ivf_probe_scan(qp.cpu(), probe, slabs, sq, ids, None, 8)
    with pytest.raises(ValueError, match="rr"):
        ivf_scan.ivf_probe_scan(qp, probe, slabs, sq, ids, None, 4097)
    d, i = ivf_scan.ivf_probe_scan(qp, probe, slabs, sq, ids, None, 8)
    assert torch.isinf(d).all() and (i == -1).all()  # every slot NIL
    probe[0, 1] = 4  # outside [0, C): skipped
    ids[0] = torch.arange(16, dtype=torch.int32, device=cuda) + 2
    d, i = ivf_scan.ivf_probe_scan(qp, probe, slabs, sq, ids, None, 40)
    torch.cuda.synchronize()
    assert sorted(i[0, :32].tolist()) == sorted(list(range(2, 18)) * 2) and torch.isinf(d[0, 32:]).all()
    vectors = torch.zeros((10, 8), device=cuda)
    pool = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="metrics"):
        ivf_rerank.ivf_exact_rerank(vectors, qp, pool, torch.zeros((2, 5), device=cuda), 3, "hamming")
    with pytest.raises(ValueError, match="CUDA"):
        ivf_rerank.ivf_exact_rerank(vectors, qp.cpu(), pool, torch.zeros((2, 5), device=cuda), 3, "dot")


@pytest.mark.cuda
@pytest.mark.parametrize("copies,bf16", [(1, False), (2, False), (2, True)])
def test_ivf_index_on_card_matches_cpu(cuda, copies, bf16, monkeypatch):
    """An IVF index built on the card runs K3 and K4, and the same arrays
    loaded on the CPU (plain versions) give the same results by the tie rule."""
    import semadb_tpu_torch.index.ivf as ivf_mod

    if bf16:
        monkeypatch.setattr(ivf_mod, "SLAB_BF16_BYTES", 1)
    rng = np.random.default_rng(copies)
    cents = rng.standard_normal((40, 32)).astype(np.float32) * 4
    vecs = (cents[rng.integers(0, 40, 5000)] + rng.standard_normal((5000, 32))).astype(np.float32)
    params = VectorIVFParams(vector_size=32, distance_metric="euclidean", assign_copies=copies)
    on_card = IndexIVF(params, cuda)
    on_card.insert_bulk(np.arange(2, 5002), vecs)
    assert on_card._n_at_fit == 5000 and (on_card.slabs.dtype == torch.bfloat16) == bf16
    on_cpu = IndexIVF.from_arrays(params, on_card.to_arrays(), torch.device("cpu"))
    queries = rng.standard_normal((50, 32)).astype(np.float32) * 4
    before = (ivf_scan.LAUNCHES, ivf_rerank.LAUNCHES)
    d_card, i_card = on_card.search_batch(queries, 10)
    assert ivf_scan.LAUNCHES == before[0] + 1 and ivf_rerank.LAUNCHES == before[1] + 1
    d_cpu, i_cpu = on_cpu.search_batch(queries, 10)
    for b in range(len(queries)):
        dist = ((vecs.astype(np.float64) - queries[b]) ** 2).sum(-1)
        errs = tie_rule_errors(d_cpu[b], i_cpu[b].tolist(), d_card[b], i_card[b].tolist(),
                               lambda i: dist[i - 2], atol=1e-4 * max(1.0, float(d_cpu[b, -1])))
        assert not errs, (b, errs[:3])
