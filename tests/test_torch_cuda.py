"""K1-K4, K9-K11, the flat, IVF and Vamana indices on a CUDA card (skipped without one).

These need the card: the CUDA kernels have no CPU mode. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: K1 and K2 exact. K1's counts are integers and jaccard is one
IEEE f32 division of two of them on both sides, on either route; the gather
copies bits. K3 and K4 sum in another order than their plain versions:
distances within 1e-5 of the summed terms' magnitude, ids by the tie rule at
that tolerance. K9's ADC sums run in another order than its plain version's:
scores within 1e-5 of M · max|table|, pools by the tie rule as multisets.
K5's probe lists are held to a float64 reference: ids by the tie rule with
scores within 1e-5 of (|q| + max |c|)^2, and exactly (ties to the lower id)
where every score is an integer that float32 holds.
"""

import numpy as np
import pytest
import torch

from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, ProductQuantizerParams, Quantizer
from semadb_tpu_torch.models.schema import VectorFlatParams, VectorIVFParams
from semadb_tpu_torch.ops.kernels import gather, hamming, ivf_pq_scan, ivf_probe_topk, ivf_rerank, ivf_scan
from semadb_tpu_torch.ops.topk import pool_errors, sort_by_distance, tie_rule_errors

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
def test_exported_bit_distance_launches_the_kernel(cuda):
    """``semadb_tpu_torch.ops.pairwise_bit_distance`` on CUDA tensors is a
    launch of K1, equal to the plain version."""
    from semadb_tpu_torch import ops

    gen = torch.Generator().manual_seed(5)
    q, x = _codes(gen, 9, 48).to(cuda), _codes(gen, 1000, 48).to(cuda)
    before = hamming.LAUNCHES
    got = ops.pairwise_bit_distance(q, x, "jaccard")
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == before + 1
    assert torch.equal(got, hamming.pairwise_bit_distance_plain(q, x, "jaccard"))


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


# K5 (B, C, D, p, metric, layout): every value of B {1, 7, 64, 4096}, C {64,
# 1,000 (a ragged tile), 32,768, 131,072}, p {1, 24, 96, 256, C} and D {128,
# 194 (off the 16-byte grid), 100}, both metrics, the bench cell's and the
# 10M cell's shapes; layout "ties": integer rows with duplicates, so many
# scores are equal and the lower id must come first
PROBE_TOPK_CASES = [
    (1, 64, 128, 1, "euclidean", None), (1, 1000, 194, 24, "dot", None), (1, 32768, 100, 96, "euclidean", None),
    (1, 131072, 128, 256, "dot", None), (7, 64, 194, 64, "euclidean", None), (7, 1000, 100, 256, "dot", None),
    (7, 32768, 128, 1, "euclidean", None), (7, 131072, 194, 24, "dot", None), (64, 64, 100, 24, "dot", None),
    (64, 1000, 128, 96, "euclidean", None), (64, 32768, 194, 256, "dot", None), (64, 131072, 100, 1, "euclidean", None),
    (4096, 64, 128, 64, "euclidean", None), (4096, 1000, 194, 1, "dot", None), (4096, 32768, 128, 24, "euclidean", None),
    (4096, 131072, 128, 24, "euclidean", None), (4096, 32768, 100, 256, "dot", None),
    (4096, 1000, 128, 96, "euclidean", None), (1, 131072, 194, 96, "euclidean", "ties"),
    (7, 64, 100, 64, "euclidean", "ties"), (64, 1000, 128, 24, "dot", "ties"),
    (4096, 32768, 128, 24, "euclidean", "ties"), (4096, 32768, 194, 256, "dot", "ties"),
]
PROBE_RTOL = 1e-5


def _probe_operands(gen, b, c, d, metric, layout, device):
    if layout == "ties":  # integer rows in [-2, 2], a fifth of them copies of others
        cents = torch.randint(-2, 3, (c, d), generator=gen, device=device).float()
        dup = torch.rand(c, generator=gen, device=device) < 0.2
        cents[dup] = cents[torch.randint(0, c, (int(dup.sum()),), generator=gen, device=device)]
        queries = torch.randint(-2, 3, (b, d), generator=gen, device=device).float()
    else:
        cents = torch.randn((c, d), generator=gen, device=device)
        queries = cents[torch.randint(0, c, (b,), generator=gen, device=device)]
        queries = queries + 0.3 * torch.randn((b, d), generator=gen, device=device)
    cent_sq = (cents * cents).sum(-1) if metric == "euclidean" else torch.zeros(c, device=device)
    return queries.contiguous(), cents.contiguous(), cent_sq.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,d,p,metric,layout", PROBE_TOPK_CASES)
def test_ivf_probe_topk_matches_float64(cuda, b, c, d, p, metric, layout):
    gen = torch.Generator(device="cuda").manual_seed(b * 7 + c + d + p)
    queries, cents, cent_sq = _probe_operands(gen, b, c, d, metric, layout, cuda)
    before = (ivf_probe_topk.LAUNCHES, ivf_probe_topk.LAUNCHES_BY["kernel", b == 1])
    got = ivf_probe_topk.ivf_probe_topk(queries, cents, cent_sq, p)
    torch.cuda.synchronize()
    assert (ivf_probe_topk.LAUNCHES, ivf_probe_topk.LAUNCHES_BY["kernel", b == 1]) == (before[0] + 1, before[1] + 1)
    assert got.shape == (b, p) and got.dtype == torch.int32
    assert ((got >= 0) & (got < c)).all()
    assert (got.sort(dim=1).values.diff(dim=1) > 0).all()  # p distinct clusters a query
    score = cent_sq.double()[None, :] - 2.0 * (queries.double() @ cents.double().T)
    if layout == "ties":  # integer scores: (score, id) orders every cluster, exactly
        key = score * c + torch.arange(c, device=cuda, dtype=torch.float64)[None, :]
        want = torch.topk(key, p, dim=1, largest=False, sorted=True).indices.to(torch.int32)
        assert (score == score.round()).all()
        assert torch.equal(got, want)
        return
    want = torch.topk(score, p, dim=1, largest=False, sorted=True).indices.to(torch.int32)
    rows = (got != want).any(dim=1).nonzero()[:, 0].tolist()
    atol = PROBE_RTOL * (queries.double().norm(dim=1) + cents.double().norm(dim=1).max()) ** 2
    sc, gh, wh = score.cpu(), got.cpu(), want.cpu()
    for bb in rows:
        errs = tie_rule_errors(sc[bb, wh[bb].long()].tolist(), wh[bb].tolist(), sc[bb, gh[bb].long()].tolist(),
                               gh[bb].tolist(), lambda i, bb=bb: float(sc[bb, i]), atol=float(atol[bb]))
        assert not errs, (bb, errs[:3])


@pytest.mark.cuda
def test_select_probes_routes_past_the_cap_to_the_library(cuda):
    """p up to MAX_P launches K5; MAX_P + 1 takes the torch calls, counted
    under the library route by whether B is 1."""
    import semadb_tpu_torch.index.ivf as ivf_mod

    gen = torch.Generator(device="cuda").manual_seed(3)
    for b in (1, 64):
        queries, cents, cent_sq = _probe_operands(gen, b, 1000, 128, "euclidean", None, cuda)
        for p, route in ((ivf_probe_topk.MAX_P, "kernel"), (ivf_probe_topk.MAX_P + 1, "library")):
            before = dict(ivf_probe_topk.LAUNCHES_BY)
            got = ivf_mod._select_probes(queries, cents, cent_sq, p)
            torch.cuda.synchronize()
            grew = {k: v - before.get(k, 0) for k, v in ivf_probe_topk.LAUNCHES_BY.items() if v != before.get(k, 0)}
            assert grew == {(route, b == 1): 1} and got.shape == (b, p)
            want = ivf_probe_topk.ivf_probe_topk_plain(queries, cents, cent_sq, p)
            score = (cent_sq.double()[None, :] - 2.0 * queries.double() @ cents.double().T).cpu()
            atol = PROBE_RTOL * float((queries.norm(dim=1).max() + cents.norm(dim=1).max()) ** 2)
            for bb in range(b):
                errs = tie_rule_errors(score[bb, want[bb].long().cpu()].tolist(), want[bb].tolist(),
                                       score[bb, got[bb].long().cpu()].tolist(), got[bb].tolist(),
                                       lambda i, bb=bb: float(score[bb, i]), atol=atol)
                assert not errs, (b, p, bb, errs[:3])


@pytest.mark.cuda
def test_ivf_probe_topk_refuses_bad_operands(cuda):
    q, c, sq = torch.zeros((2, 8), device=cuda), torch.zeros((300, 8), device=cuda), torch.zeros(300, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ivf_probe_topk.ivf_probe_topk(q.double(), c, sq, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_probe_topk.ivf_probe_topk(q.cpu(), c, sq, 4)
    with pytest.raises(ValueError, match="p must"):
        ivf_probe_topk.ivf_probe_topk(q, c, sq, ivf_probe_topk.MAX_P + 1)
    with pytest.raises(ValueError, match="contiguous"):
        ivf_probe_topk.ivf_probe_topk(torch.zeros((8, 2), device=cuda).T, c, sq, 4)
    cap = ivf_probe_topk.MAX_P
    got = ivf_probe_topk.ivf_probe_topk(q, c, sq, cap)  # every score equal: the lowest ids
    torch.cuda.synchronize()
    assert torch.equal(got, torch.arange(cap, dtype=torch.int32, device=cuda).expand(2, cap))


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
    before = (ivf_scan.LAUNCHES, ivf_rerank.LAUNCHES, dict(ivf_probe_topk.LAUNCHES_BY))
    d_card, i_card = on_card.search_batch(queries, 10)
    assert ivf_scan.LAUNCHES == before[0] + 1 and ivf_rerank.LAUNCHES == before[1] + 1
    grew = {k: v - before[2].get(k, 0) for k, v in ivf_probe_topk.LAUNCHES_BY.items() if v != before[2].get(k, 0)}
    assert grew == {("kernel", False): 1}  # probe selection is K5's
    d_cpu, i_cpu = on_cpu.search_batch(queries, 10)
    for b in range(len(queries)):
        dist = ((vecs.astype(np.float64) - queries[b]) ** 2).sum(-1)
        errs = tie_rule_errors(d_cpu[b], i_cpu[b].tolist(), d_card[b], i_card[b].tolist(),
                               lambda i: dist[i - 2], atol=1e-4 * max(1.0, float(d_cpu[b, -1])))
        assert not errs, (b, errs[:3])


# K9 (B, p, S, M, K, rr, mask, offset): offset shifts the codes' base off the
# 16-byte grid, so the narrower loads run
PQ_SCAN_CASES = [
    (1, 1, 64, 2, 16, 20, False, 0), (7, 24, 128, 4, 256, 256, True, 0), (64, 96, 256, 8, 256, 256, False, 0),
    (4096, 24, 128, 8, 256, 256, False, 0), (4096, 24, 128, 8, 256, 256, True, 0), (64, 24, 64, 16, 16, 2048, True, 0),
    (7, 5, 256, 128, 256, 20, False, 0), (64, 24, 128, 8, 256, 256, False, 4), (7, 24, 64, 16, 16, 64, True, 1),
]


def _pq_operands(gen, b, p, s, m, k, masked, offset):
    c = max(2 * p, 32)
    codes = torch.randint(0, k, (c * s * m + offset,), generator=gen, dtype=torch.uint8)[offset:].view(c, s, m)
    ids = (torch.randperm(c * s, generator=gen).reshape(c, s) + 2).to(torch.int32)
    ids[torch.rand((c, s), generator=gen) < 0.3] = -1
    table = torch.randn((b, m, k), generator=gen)
    probe = torch.argsort(torch.rand((b, c), generator=gen), dim=1)[:, :p].to(torch.int32).contiguous()
    mask = (torch.rand(c * s + 2, generator=gen) < 0.5).to(torch.uint8) if masked else None
    return table, probe, codes, ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s,m,k,rr,masked,offset", PQ_SCAN_CASES)
def test_pq_probe_scan_matches_plain(cuda, b, p, s, m, k, rr, masked, offset):
    gen = torch.Generator().manual_seed(b + 10 * p + s + m + rr + offset)
    table, probe, codes, ids, mask = _pq_operands(gen, b, p, s, m, k, masked, offset)
    ops = [t if t is None else t.to(cuda) for t in (table, probe, codes, ids, mask)]
    if offset:  # keep the base off the grid on the card too
        flat = torch.empty(codes.numel() + offset, dtype=torch.uint8, device=cuda)[offset:]
        flat.copy_(codes.reshape(-1))
        ops[2] = flat.view(codes.shape)
    before = dict(ivf_pq_scan.LAUNCHES_BY)
    got = ivf_pq_scan.ivf_pq_probe_scan(*ops, rr)
    torch.cuda.synchronize()
    assert ivf_pq_scan.LAUNCHES_BY["probed"] == before.get("probed", 0) + 1
    want = ivf_pq_scan.ivf_pq_probe_scan_plain(*ops, rr)
    flat_ids = ids.reshape(-1)
    cflat = codes.reshape(-1, m).long()

    def dist_of(bb, i):
        if i == -1:
            return float("inf")
        cell = int((flat_ids == i).nonzero()[0, 0])
        return float(table[bb].double()[torch.arange(m), cflat[cell]].sum())

    atol = torch.full((b,), IVF_RTOL * m * float(table.abs().max()))
    _pools_agree(want, got, dist_of, atol)


# K9's probed entry at the layouts that stress its selection (B, p, S, M, K,
# rr, mask, layout, chunk): a cluster probed twice with probes of -1 and C;
# tie-heavy integer tables (K = 16, M = 2); negative tables; clusters with no
# live slot, and none at all; rr above the live slots (85% NIL); chunk, when
# given, patched small so that a query takes several selections
PQ_LAYOUT_CASES = [
    (7, 24, 128, 8, 256, 256, True, "dup-probes", None), (64, 24, 64, 2, 16, 256, False, "ties", None),
    (256, 24, 128, 2, 16, 2048, False, "ties", None), (7, 40, 128, 2, 16, 20, True, "ties", 256),
    (7, 24, 128, 8, 256, 64, False, "negative", None), (64, 24, 128, 8, 256, 256, True, "all-nil", None),
    (3, 24, 128, 8, 256, 256, False, "nil", None), (4096, 24, 128, 8, 256, 2048, False, "sparse", None),
    (1, 5, 64, 4, 16, 256, True, "sparse", None), (7, 24, 128, 8, 256, 256, True, None, 256),
    (64, 96, 128, 4, 16, 64, False, "negative", 512),
]


def _pq_layout(gen, table, probe, ids, layout):
    c = ids.shape[0]
    if layout == "sparse":
        ids[torch.rand(ids.shape, generator=gen) < 0.8] = -1
    elif layout == "all-nil":
        ids[torch.rand(c, generator=gen) < 0.5] = -1
    elif layout == "nil":
        ids[:] = -1
    if layout == "ties":
        table = torch.randint(-2, 3, table.shape, generator=gen).float()
    elif layout == "negative":
        table = -1.0 - table.abs()
    if layout == "dup-probes":
        probe[:, 1], probe[:, 2], probe[:, 3] = probe[:, 0], -1, c
    return table, probe, ids


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s,m,k,rr,masked,layout,chunk", PQ_LAYOUT_CASES)
def test_pq_probe_scan_layouts_match_plain(cuda, monkeypatch, b, p, s, m, k, rr, masked, layout, chunk):
    """Every layout: scores within the tolerance, pools by the tie rule, and
    exactly min(rr, live) places filled, each with an id."""
    gen = torch.Generator().manual_seed(b + 7 * p + s + m + rr)
    table, probe, codes, ids, mask = _pq_operands(gen, b, p, s, m, k, masked, 0)
    table, probe, ids = _pq_layout(gen, table, probe, ids, layout)
    if chunk:
        monkeypatch.setattr(ivf_pq_scan, "CHUNK", chunk)
    ops = [t if t is None else t.to(cuda) for t in (table, probe.contiguous(), codes, ids, mask)]
    got = ivf_pq_scan.ivf_pq_probe_scan(*ops, rr)
    torch.cuda.synchronize()
    want = ivf_pq_scan.ivf_pq_probe_scan_plain(*ops, rr)
    assert torch.equal(got[1] >= 0, torch.isfinite(got[0]))
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(want[0]))
    cell_of = {i: c for c, i in enumerate(ids.reshape(-1).tolist()) if i >= 0}
    cflat = codes.reshape(-1, m).long()
    tab = table.double()

    def dist_of(bb, i):
        return float(tab[bb][torch.arange(m), cflat[cell_of[i]]].sum())

    atol = torch.full((b,), IVF_RTOL * m * float(table.abs().max()))
    _pools_agree(want, got, dist_of, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,k,masked,offset", [
    (1, 1, 8, 256, False, 0), (3, 100003, 8, 256, True, 0), (64, 4096, 16, 16, True, 0),
    (5, 777, 4, 32, False, 2), (2, 5000, 128, 256, True, 0), (7, 1000, 2, 16, False, 1),
])
def test_pq_dense_scan_matches_plain(cuda, b, n, m, k, masked, offset):
    gen = torch.Generator().manual_seed(b + n + m + k)
    codes = torch.randint(0, k, (n * m + offset,), generator=gen, dtype=torch.uint8)[offset:].view(n, m)
    table = torch.randn((b, m, k), generator=gen).to(cuda)
    mask = (torch.rand(n, generator=gen) < 0.7).to(torch.uint8).to(cuda) if masked else None
    dev_codes = torch.empty(n * m + offset, dtype=torch.uint8, device=cuda)[offset:].view(n, m)
    dev_codes.copy_(codes)
    before = ivf_pq_scan.LAUNCHES_BY.get("dense", 0)
    got = ivf_pq_scan.pq_scan(table, dev_codes, mask)
    torch.cuda.synchronize()
    assert ivf_pq_scan.LAUNCHES_BY["dense"] == before + 1
    want = ivf_pq_scan.pq_scan_plain(table, dev_codes, mask)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=IVF_RTOL * m * float(table.abs().max()))


@pytest.mark.cuda
def test_pq_wrappers_refuse_bad_operands_on_card(cuda):
    table = torch.zeros((2, 4, 16), device=cuda)
    probe = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    codes = torch.zeros((4, 16, 4), dtype=torch.uint8, device=cuda)
    ids = torch.full((4, 16), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_pq_scan.ivf_pq_probe_scan(table.cpu(), probe, codes, ids, None, 8)
    with pytest.raises(TypeError, match="int32"):
        ivf_pq_scan.ivf_pq_probe_scan(table, probe.long(), codes, ids, None, 8)
    d, i = ivf_pq_scan.ivf_pq_probe_scan(table, probe, codes, ids, None, 8)
    torch.cuda.synchronize()
    assert torch.isinf(d).all() and (i == -1).all()  # every slot NIL
    probe[0, 1] = 4  # outside [0, C): skipped; cluster 0 probed twice counts twice
    ids[0] = torch.arange(16, dtype=torch.int32, device=cuda) + 2
    d, i = ivf_pq_scan.ivf_pq_probe_scan(table, probe, codes, ids, None, 40)
    torch.cuda.synchronize()
    assert sorted(i[0, :32].tolist()) == sorted(list(range(2, 18)) * 2) and torch.isinf(d[0, 32:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("copies", [1, 2])
def test_ivfpq_index_on_card_matches_cpu(cuda, copies):
    """An IVF-PQ index built on the card runs K9 and K4; the same arrays on
    the CPU (plain versions) give the same results by the tie rule."""
    rng = np.random.default_rng(copies + 10)
    cents = rng.standard_normal((40, 32)).astype(np.float32) * 4
    vecs = (cents[rng.integers(0, 40, 5000)] + rng.standard_normal((5000, 32))).astype(np.float32)
    q = Quantizer(type="product", product=ProductQuantizerParams(num_centroids=64, num_subvectors=8,
                                                                  trigger_threshold=1000, opq=False))
    params = VectorIVFParams(vector_size=32, distance_metric="euclidean", assign_copies=copies, quantizer=q)
    on_card = IndexIVF(params, cuda)
    on_card.insert_bulk(np.arange(2, 5002), vecs)
    assert on_card.pq_active and on_card.slabs.shape[0] == 1
    on_cpu = IndexIVF.from_arrays(params, on_card.to_arrays(), torch.device("cpu"))
    queries = rng.standard_normal((50, 32)).astype(np.float32) * 4
    before = (ivf_pq_scan.LAUNCHES_BY.get("probed", 0), ivf_rerank.LAUNCHES)
    d_card, i_card = on_card.search_batch(queries, 10)
    assert ivf_pq_scan.LAUNCHES_BY["probed"] == before[0] + 1 and ivf_rerank.LAUNCHES == before[1] + 1
    d_cpu, i_cpu = on_cpu.search_batch(queries, 10)
    for b in range(len(queries)):
        dist = ((vecs.astype(np.float64) - queries[b]) ** 2).sum(-1)
        errs = tie_rule_errors(d_cpu[b], i_cpu[b].tolist(), d_card[b], i_card[b].tolist(),
                               lambda i: dist[i - 2], atol=1e-4 * max(1.0, float(d_cpu[b, -1])))
        assert not errs, (b, errs[:3])


@pytest.mark.cuda
def test_flat_pq_on_card_matches_cpu(cuda):
    """A flat index with a product quantizer scans through K9's dense entry
    on the card and through its plain version on the CPU."""
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((3000, 64)).astype(np.float32)
    q = Quantizer(type="product", product=ProductQuantizerParams(num_centroids=32, num_subvectors=8,
                                                                  trigger_threshold=2000))
    params = VectorFlatParams(vector_size=64, distance_metric="euclidean", quantizer=q)
    on_card = IndexFlat(params, cuda)
    on_card.insert_update_delete(zip(range(2, 3002), vecs))
    assert on_card.store.fitted
    on_cpu = IndexFlat.from_arrays(params, on_card.to_arrays(), torch.device("cpu"))
    queries = rng.standard_normal((20, 64)).astype(np.float32)
    before = ivf_pq_scan.LAUNCHES_BY.get("dense", 0)
    d_card, i_card = on_card.search_batch(queries, 10)
    assert ivf_pq_scan.LAUNCHES_BY["dense"] == before + 1
    d_cpu, i_cpu = on_cpu.search_batch(queries, 10)
    full = on_cpu.store.scan_distances(torch.from_numpy(queries), on_cpu.vectors, on_cpu.exists).numpy()
    for b in range(len(queries)):
        errs = tie_rule_errors(d_cpu[b], i_cpu[b].tolist(), d_card[b], i_card[b].tolist(), full[b],
                               atol=1e-5 * 8 * float(np.abs(full[b][np.isfinite(full[b])]).max()))
        assert not errs, (b, errs[:3])


# K10 and K11 (the Vamana walk and prune). On integer-valued graphs every
# distance is exact in f32 (haversine meters are computed by the same
# operations on both sides), so every output must equal the plain version's
# bit for bit. On real-valued data the sums run in another order: the search
# results are held by the tie rule with distances within 1e-5 of the terms'
# magnitude, and recall against exact search within 0.002 of the plain
# version's.
VAMANA_RTOL = 1e-5
# (B, L, W, R, metric, seeds, track_visited)
K10_CASES = [
    (1, 25, 1, 32, "euclidean", False, True), (7, 40, 2, 64, "euclidean", False, False),
    (7, 40, 2, 64, "euclidean", True, False), (64, 75, 8, 64, "euclidean", False, True),
    (64, 75, 8, 64, "euclidean", True, True), (33, 100, 2, 32, "dot", True, False),
    (33, 75, 8, 64, "cosine", False, True), (17, 40, 2, 64, "haversine", True, True),
    (5, 512, 8, 64, "euclidean", True, True), (3, 512, 1, 32, "euclidean", False, False),
    (4096, 75, 8, 64, "euclidean", False, True),
]


def _k10_out(out):
    return [t.cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,W,R,metric,seeded,track", K10_CASES)
def test_vamana_beam_search_matches_plain(cuda, b, L, W, R, metric, seeded, track):
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    dim = 2 if metric == "haversine" else 48
    v, a = vo.random_graph(3000, dim, R, integer=True, metric=metric, seed=b + L, device=cuda)
    q = vo.random_queries(b, dim, integer=True, metric=metric, seed=W + R, device=cuda)
    seeds = vo.random_seeds(b, L, v.shape[0], seed=b, device=cuda) if seeded else None
    before = vamana_search.LAUNCHES
    got = vamana_search.vamana_beam_search(v, a, q, L, W, 0, metric, seeds=seeds, track_visited=track)
    torch.cuda.synchronize()
    assert vamana_search.LAUNCHES == before + 1
    want = vamana_search.beam_search_plain(v, a, q, L, W, 0, metric, seeds=seeds, track_visited=track)
    for name, g, w in zip(got._fields, _k10_out(got), _k10_out(want)):
        assert torch.equal(g, w), (name, (g != w).nonzero()[:5])


@pytest.mark.cuda
def test_vamana_beam_search_edge_graphs(cuda):
    """A graph of NIL rows only and a graph of one user point: the walk
    expands the start node and stops."""
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    for n, nil_rows in ((1, 0.0), (50, 1.0)):
        v, a = vo.random_graph(n, 16, 32, integer=True, metric="euclidean", seed=n, device=cuda, nil_rows=nil_rows)
        if nil_rows == 1.0:
            a[:] = -1
        q = vo.random_queries(9, 16, integer=True, metric="euclidean", seed=1, device=cuda)
        got = vamana_search.vamana_beam_search(v, a, q, 25, 8, 0, "euclidean")
        want = vamana_search.beam_search_plain(v, a, q, 25, 8, 0, "euclidean")
        for name, g, w in zip(got._fields, _k10_out(got), _k10_out(want)):
            assert torch.equal(g, w), name
        assert int(got.hops.max()) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_vamana_beam_search_real_data(cuda, metric):
    """Real-valued data: top-10 of the L = 40 walk by the tie rule, and
    recall against exact search within 0.002 of the plain version's."""
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    v, a = vo.random_graph(20000, 64, 64, integer=False, metric=metric, seed=5, device=cuda)
    q = vo.random_queries(512, 64, integer=False, metric=metric, seed=6, device=cuda)
    got = vamana_search.vamana_beam_search(v, a, q, 40, 2, 0, metric, track_visited=False)
    want = vamana_search.beam_search_plain(v, a, q, 40, 2, 0, metric, track_visited=False)
    from semadb_tpu_torch.ops.distance import pairwise_distance

    full = pairwise_distance(q, v, metric).cpu().numpy()
    mag = float(np.abs(v.cpu().numpy()).max()) ** 2 * v.shape[1]

    def top(out):
        d, i = sort_by_distance(out.cand_dists, out.cand_ids)
        return d[:, :10].cpu().numpy(), i[:, :10].cpu().numpy()

    gd, gi = top(got)
    wd, wi = top(want)
    for b in range(q.shape[0]):
        errs = tie_rule_errors(wd[b], wi[b].tolist(), gd[b], gi[b].tolist(), full[b], atol=VAMANA_RTOL * mag)
        assert not errs, (b, errs[:3])
    exact = np.argsort(np.where(np.arange(v.shape[0]) >= 2, full, np.inf), axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(ids[b]) & set(exact[b])) / 10 for b in range(len(ids))])

    assert abs(recall(gi) - recall(wi)) <= 0.002


# (B, P, R, metric, integer)
K11_CASES = [
    (1, 160, 64, "euclidean", True), (7, 224, 64, "euclidean", True), (512, 160, 64, "euclidean", True),
    (4096, 224, 64, "euclidean", True), (33, 128, 32, "dot", True), (33, 128, 64, "cosine", True),
    (17, 160, 32, "haversine", True), (9, 1500, 64, "euclidean", True), (300, 224, 64, "euclidean", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,R,metric,integer", K11_CASES)
def test_vamana_robust_prune_matches_plain(cuda, b, p, R, metric, integer):
    from semadb_tpu_torch.ops.kernels import vamana_prune
    from semadb_tpu_torch.tools import vamana_operands as vo

    dim = 2 if metric == "haversine" else 128
    v, _ = vo.random_graph(5000, dim, 8, integer=integer, metric=metric, seed=p, device=cuda)
    d, i, self_ids = vo.prune_pools(v, b, p, metric, seed=b)
    for alpha in (1.0, 1.2):
        before = vamana_prune.LAUNCHES
        got = vamana_prune.vamana_robust_prune(d, i, self_ids, v, R, R, alpha, metric)
        torch.cuda.synchronize()
        assert vamana_prune.LAUNCHES == before + 1
        want = vamana_prune.robust_prune_plain(d, i, self_ids, v, R, R, alpha, metric)
        same = (got == want).all(-1)
        if integer:
            assert bool(same.all()), (alpha, (~same).nonzero()[:5])
        else:
            # Real data: a decision at a near-tie may part; nearly every row agrees
            assert float(same.float().mean()) >= 0.99, float(same.float().mean())


# The boundaries of the second design's geometry (pick_geometry in
# csrc/vamana_search.cu; a launch whose block does not fit fails), (B, L, W,
# R, D, metric, seeds, track_visited): a batch no multiple of the 4 queries a
# block of the one-warp geometry, W*R and S at and past 128 (one warp or a
# block a query), B on either side of 1,024 (8 or 4 warps), D off the 16-byte grid (element
# loads), L = 1, W = L, D = 1,536 (several passes of a row)
K10_BOUNDARY_CASES = [
    (4097, 40, 2, 64, 128, "euclidean", True, False), (5, 40, 1, 129, 48, "euclidean", False, True),
    (9, 128, 1, 64, 48, "euclidean", True, False), (9, 129, 2, 64, 48, "euclidean", True, False),
    (1024, 75, 8, 64, 48, "euclidean", True, True), (1025, 75, 8, 64, 48, "euclidean", False, True),
    (33, 40, 2, 64, 37, "euclidean", True, False), (33, 40, 2, 64, 37, "dot", False, True),
    (17, 1, 1, 32, 48, "euclidean", False, True), (13, 30, 30, 16, 48, "dot", False, True),
    (3, 40, 2, 64, 1536, "cosine", True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,W,R,D,metric,seeded,track", K10_BOUNDARY_CASES)
def test_vamana_beam_search_boundary_shapes(cuda, b, L, W, R, D, metric, seeded, track):
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    v, a = vo.random_graph(3000, D, R, integer=True, metric=metric, seed=b + D, device=cuda)
    q = vo.random_queries(b, D, integer=True, metric=metric, seed=L, device=cuda)
    seeds = vo.random_seeds(b, L, v.shape[0], seed=W, device=cuda) if seeded else None
    got = vamana_search.vamana_beam_search(v, a, q, L, W, 0, metric, seeds=seeds, track_visited=track)
    torch.cuda.synchronize()
    want = vamana_search.beam_search_plain(v, a, q, L, W, 0, metric, seeds=seeds, track_visited=track)
    for name, g, w in zip(got._fields, _k10_out(got), _k10_out(want)):
        assert torch.equal(g, w), (name, (g != w).nonzero()[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_vamana_beam_search_real_entries_at_inf(cuda, track, seeded):
    """The start node and every 5th row at distance inf: a real entry at inf
    heads the list, so the seeds' merge (compacted) keeps every new entry and
    its holes; without seeds the walk cannot start."""
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    v, a = vo.random_graph(2000, 16, 32, integer=True, metric="euclidean", seed=9, device=cuda)
    v[1, 0] = 3e38  # (3e38 - q)^2 overflows
    v[2::5, 0] = 3e38
    q = vo.random_queries(70, 16, integer=True, metric="euclidean", seed=10, device=cuda)
    seeds = vo.random_seeds(70, 30, v.shape[0], seed=11, device=cuda) if seeded else None
    for L, W in ((30, 2), (30, 8)):
        got = vamana_search.vamana_beam_search(v, a, q, L, W, 0, "euclidean", seeds=seeds, track_visited=track)
        want = vamana_search.beam_search_plain(v, a, q, L, W, 0, "euclidean", seeds=seeds, track_visited=track)
        for name, g, w in zip(got._fields, _k10_out(got), _k10_out(want)):
            assert torch.equal(g, w), (L, W, name, (g != w).nonzero()[:5])
        assert seeded or bool(torch.isinf(got.cand_dists[:, 0]).all())


# The second K11's boundaries, (B, P, R, metric, D, r_stop): one past a panel,
# r_stop below R (mid-panel) and above it (R < 8), pools read from device
# memory by element loads (D = 131) and by 16-byte loads (P = 2,048, D =
# 1,536), pools on both sides of the stage (P = 224, real values)
K11_BOUNDARY_CASES = [
    (9, 33, 32, "euclidean", 128, 32), (33, 224, 64, "euclidean", 128, 40), (17, 100, 4, "euclidean", 128, 8),
    (9, 1500, 64, "euclidean", 131, 64), (7, 2048, 64, "dot", 128, 64), (64, 224, 64, "cosine", 1536, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,R,metric,D,r_stop", K11_BOUNDARY_CASES)
def test_vamana_robust_prune_boundary_shapes(cuda, b, p, R, metric, D, r_stop):
    from semadb_tpu_torch.ops.kernels import vamana_prune
    from semadb_tpu_torch.tools import vamana_operands as vo

    v, _ = vo.random_graph(5000, D, 8, integer=True, metric=metric, seed=p + D, device=cuda)
    d, i, self_ids = vo.prune_pools(v, b, p, metric, seed=b + r_stop)
    for alpha in (1.0, 1.2):
        got = vamana_prune.vamana_robust_prune(d, i, self_ids, v, R, r_stop, alpha, metric)
        torch.cuda.synchronize()
        want = vamana_prune.robust_prune_plain(d, i, self_ids, v, R, r_stop, alpha, metric)
        assert torch.equal(got, want), (alpha, (got != want).any(1).nonzero()[:5])


@pytest.mark.cuda
def test_vamana_kernels_raise_when_the_build_fails(cuda, monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises: a library
    that does not build is an error, never the plain version."""
    from semadb_tpu_torch.ops.kernels import vamana_prune, vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    v, a = vo.random_graph(100, 16, 32, integer=True, metric="euclidean", seed=0, device=cuda)
    q = vo.random_queries(3, 16, integer=True, metric="euclidean", seed=1, device=cuda)
    d, i, s = vo.prune_pools(v, 3, 64, "euclidean", seed=2)

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    for mod in (vamana_search, vamana_prune):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "build_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        vamana_search.vamana_beam_search(v, a, q, 25, 2, 0, "euclidean")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        vamana_prune.vamana_robust_prune(d, i, s, v, 32, 32, 1.2, "euclidean")
    with pytest.raises(ValueError, match="W\\*R"):
        vamana_search.vamana_beam_search(v, a, q, 25, 20, 0, "euclidean")


@pytest.mark.cuda
def test_vamana_index_on_card_matches_cpu(cuda):
    """The same inserts, updates and deletes on the card (K10, K11) and on
    the CPU (their plain versions) on integer vectors: equal graphs, equal
    searches."""
    from semadb_tpu_torch.index.vamana import IndexVamana
    from semadb_tpu_torch.models.schema import VectorVamanaParams
    from semadb_tpu_torch.ops.kernels import vamana_prune, vamana_search

    rng = np.random.default_rng(3)
    vecs = rng.integers(-8, 9, (3000, 32)).astype(np.float32)
    params = VectorVamanaParams(vector_size=32, distance_metric="euclidean", search_size=40, degree_bound=32)
    on_card, on_cpu = IndexVamana(params, cuda), IndexVamana(params, torch.device("cpu"))
    start = rng.integers(-8, 9, 32).astype(np.float32)
    for idx in (on_card, on_cpu):
        idx.state.vectors[1] = torch.from_numpy(start)
    before = (vamana_search.LAUNCHES, vamana_prune.LAUNCHES)
    for idx in (on_card, on_cpu):
        idx.insert_bulk(np.arange(2, 3002), vecs)
        idx.insert_update_delete([(i, None) for i in range(2, 300, 3)] + [(i, vecs[i] + 1) for i in range(400, 450)])
    assert vamana_search.LAUNCHES > before[0] and vamana_prune.LAUNCHES > before[1]
    for name in ("vectors", "adjacency", "exists"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name
    queries = rng.integers(-8, 9, (64, 32)).astype(np.float32)
    for fm in (None, np.arange(on_cpu.capacity) % 2 == 0):
        d_card, i_card = on_card.search_batch(queries, 10, filter_mask=fm)
        d_cpu, i_cpu = on_cpu.search_batch(queries, 10, filter_mask=fm)
        assert np.array_equal(i_card, i_cpu) and np.array_equal(d_card, d_cpu)


# K10's quantized routes. The bit route scores packed signs of an integer
# graph's vectors (hamming: integers; jaccard: one IEEE division, 0 where the
# union is empty: a share of the code rows and query codes is all zero); the
# ADC route random PQ codes through integer-valued tables. Both must equal
# the plain version bit for bit, ties (constant here) falling by (d, id).
# (B, L, W, R, width, route, bit metric or K, seeds, track_visited); width is
# D for the bit route (W = ceil(D / 32) words: D = 100 is 4 words, D = 200
# is 7, off the 16-byte loads; D = 40 is 2) and M for the ADC route (M = 96
# at K = 256 is a 96 KB table, read through L2; M = 12 is off the 8-byte
# loads). The first of each route is its cell's query walk; the rest the
# boundaries of pick_geometry, as K10_BOUNDARY_CASES, with and without the
# ring (without it, the hole cut).
K10_CODE_CASES = [
    (8192, 75, 2, 64, 128, "bit", "hamming", True, True), (7, 40, 2, 64, 128, "bit", "jaccard", True, False),
    (33, 75, 8, 64, 100, "bit", "hamming", False, True), (33, 75, 2, 64, 200, "bit", "jaccard", True, True),
    (9, 129, 2, 64, 40, "bit", "hamming", True, False), (1025, 75, 8, 64, 128, "bit", "hamming", False, True),
    (5, 40, 1, 129, 128, "bit", "jaccard", False, True), (17, 1, 1, 32, 128, "bit", "hamming", False, True),
    (4097, 40, 2, 64, 128, "bit", "hamming", True, False), (33, 75, 2, 64, 128, "bit", "hamming", False, False),
    (8192, 75, 2, 64, 8, "adc", 256, True, True), (33, 75, 2, 64, 4, "adc", 256, True, False),
    (33, 75, 8, 64, 16, "adc", 256, False, True), (7, 40, 2, 64, 96, "adc", 256, True, True),
    (9, 129, 2, 64, 12, "adc", 16, True, False), (1025, 75, 8, 64, 8, "adc", 256, False, True),
    (4097, 40, 2, 64, 8, "adc", 256, True, False), (17, 1, 1, 32, 8, "adc", 256, False, True),
    (5, 40, 1, 129, 8, "adc", 256, False, False),
]


def _k10_code_operands(cuda, b, L, R, width, route, param, seeded, integer=True, seed=0):
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    dim = width if route == "bit" else 16
    v, a = vo.random_graph(3000, dim, R, integer=True, metric="euclidean", seed=seed + b + L, device=cuda)
    q = vo.random_queries(b, dim, integer=True, metric="euclidean", seed=seed + R, device=cuda)
    if route == "bit":
        c, p = vo.bit_codes(v, q, zero_rows=0.05 if param == "jaccard" else 0.0, seed=seed + L)
        codes = vamana_search.Codes("binary", c, p, param)
    else:
        c, p = vo.adc_codes(v.shape[0], b, width, param, integer=integer, seed=seed + b, device=cuda)
        codes = vamana_search.Codes("product", c, p)
    seeds = vo.random_seeds(b, L, v.shape[0], seed=seed + b, device=cuda) if seeded else None
    return v, a, q, seeds, codes


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,W,R,width,route,param,seeded,track", K10_CODE_CASES)
def test_vamana_beam_search_codes_match_plain(cuda, b, L, W, R, width, route, param, seeded, track):
    from semadb_tpu_torch.ops.kernels import vamana_search

    v, a, q, seeds, codes = _k10_code_operands(cuda, b, L, R, width, route, param, seeded)
    before = dict(vamana_search.LAUNCHES_BY)
    got = vamana_search.vamana_beam_search(v, a, q, L, W, 0, "euclidean", seeds=seeds, track_visited=track,
                                           codes=codes)
    torch.cuda.synchronize()
    assert vamana_search.LAUNCHES_BY[route] == before.get(route, 0) + 1
    want = vamana_search.beam_search_plain(v, a, q, L, W, 0, "euclidean", seeds=seeds, track_visited=track,
                                           codes=codes)
    for name, g, w in zip(got._fields, _k10_out(got), _k10_out(want)):
        assert torch.equal(g, w), (name, (g != w).nonzero()[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 8, 16, 96])
def test_vamana_beam_search_adc_real_tables(cuda, m):
    """Real-valued tables: the kernel's list distances are the plain ADC sums
    of its ids within 1e-6 of the summed terms, and its top-10 recall against
    the exact ADC ranking within 0.01 of the plain version's (walks may part
    at a near-tie)."""
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.vectorstore.store import pq_gather_distance, pq_scan_distance

    v, a, q, _, codes = _k10_code_operands(cuda, 256, 40, 64, m, "adc", 256, False, integer=False, seed=m)
    got = vamana_search.vamana_beam_search(v, a, q, 40, 2, 0, "euclidean", track_visited=True, codes=codes)
    want = vamana_search.beam_search_plain(v, a, q, 40, 2, 0, "euclidean", track_visited=True, codes=codes)
    ok = got.cand_ids >= 0
    ref = pq_gather_distance(codes.codes, got.cand_ids.clamp(min=0), codes.prepared, 256)
    assert float((got.cand_dists - ref).abs()[ok].max()) <= 1e-6 * 4 * m
    full = pq_scan_distance(codes.codes, torch.ones(v.shape[0], dtype=torch.bool, device=cuda), codes.prepared,
                            256)
    full[:, :2] = float("inf")
    exact = torch.topk(full, 10, dim=1, largest=False).indices

    def recall(out):
        d, i = sort_by_distance(out.cand_dists, out.cand_ids.masked_fill(out.cand_ids == 1, -1))
        return float((i[:, :10, None] == exact[:, None, :]).any(-1).float().mean())

    assert abs(recall(got) - recall(want)) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["binary", "hamming"])
def test_vamana_quantized_index_on_card_matches_cpu(cuda, kind):
    """A binary quantizer with a fixed threshold (fitted from the start) and
    the user hamming metric on 0/1 vectors, the same writes on the card (K10's
    bit route, K11, K4) and on the CPU: equal graphs and codes, equal
    searches, filtered and not."""
    from semadb_tpu_torch.index.vamana import IndexVamana
    from semadb_tpu_torch.models.schema import VectorVamanaParams
    from semadb_tpu_torch.ops.kernels import ivf_rerank, vamana_search

    rng = np.random.default_rng(4)
    if kind == "hamming":
        vecs = rng.integers(0, 2, (3000, 64)).astype(np.float32)
        params = VectorVamanaParams(vector_size=64, distance_metric="hamming", search_size=40, degree_bound=32)
        queries = rng.integers(0, 2, (64, 64)).astype(np.float32)
    else:
        vecs = rng.integers(-8, 9, (3000, 64)).astype(np.float32)
        q = Quantizer(type="binary", binary=BinaryQuantizerParams(threshold=0.5, distance_metric="hamming"))
        params = VectorVamanaParams(vector_size=64, distance_metric="euclidean", search_size=40, degree_bound=32,
                                    quantizer=q)
        queries = rng.integers(-8, 9, (64, 64)).astype(np.float32)
    on_card, on_cpu = IndexVamana(params, cuda), IndexVamana(params, torch.device("cpu"))
    start = rng.integers(0, 2, 64).astype(np.float32)
    for idx in (on_card, on_cpu):
        idx.state.vectors[1] = torch.from_numpy(start)
        idx.insert_bulk(np.arange(2, 3002), vecs)
        idx.insert_update_delete([(i, None) for i in range(2, 300, 3)] + [(i, vecs[i + 1]) for i in range(400, 450)])
    for name in ("vectors", "adjacency", "exists"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name
    assert torch.equal(on_card.store.state.codes.cpu(), on_cpu.store.state.codes)
    before = (vamana_search.LAUNCHES_BY["bit"], ivf_rerank.LAUNCHES)
    for fm in (None, np.arange(on_cpu.capacity) % 2 == 0):
        d_card, i_card = on_card.search_batch(queries, 10, filter_mask=fm)
        d_cpu, i_cpu = on_cpu.search_batch(queries, 10, filter_mask=fm)
        if kind == "hamming" or fm is not None:
            assert np.array_equal(i_card, i_cpu) and np.array_equal(d_card, d_cpu)
        else:  # K4's rerank: exact integer distances, ties in any order
            full = ((queries[:, None, :] - on_cpu.vectors.numpy()[None]) ** 2).sum(-1)
            for b in range(len(queries)):
                errs = tie_rule_errors(d_cpu[b], i_cpu[b].tolist(), d_card[b], i_card[b].tolist(), full[b])
                assert not errs, (b, errs[:3])
    assert vamana_search.LAUNCHES_BY["bit"] >= before[0] + 2
    assert ivf_rerank.LAUNCHES == before[1] + (0 if kind == "hamming" else 1)


@pytest.mark.cuda
def test_vamana_pool_build_on_card(cuda):
    """The pool build on the card (its products, K11, the backedges): the
    graph's invariants and recall@10 >= 0.98, as on the CPU."""
    from semadb_tpu_torch.index.vamana import IndexVamana
    from semadb_tpu_torch.models.schema import VectorVamanaParams
    from semadb_tpu_torch.tools.datasets import embedding_like

    n = 20000
    ds = embedding_like(n, 32, 256, latent=16, seed=9, spread=0.5)
    idx = IndexVamana(VectorVamanaParams(vector_size=32, distance_metric="euclidean", search_size=75,
                                         degree_bound=32, alpha=1.2), cuda)
    idx.insert_bulk(np.arange(2, n + 2), ds.train, build_mode="pool")
    assert "pass2.0_s" in idx.build_seconds
    d = ((ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64)) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10] + 2
    _, ids = idx.search_batch(ds.test, 10, search_size=75)
    assert np.mean([len(set(ids[b]) & set(gt[b])) / 10 for b in range(len(gt))]) >= 0.98
    adj = idx.adjacency.cpu().numpy()
    ex = idx.exists.cpu().numpy()
    rows = adj[2 : n + 2]
    assert ((rows == -1) | ex[np.clip(rows, 0, len(ex) - 1)]).all()
    assert not (rows == np.arange(2, n + 2)[:, None]).any()
    from semadb_tpu_torch.index.vamana.build import reachable_mask

    assert bool((reachable_mask(idx.state) | ~idx.exists).all())


# P3: the kernels whose blocks may take more than the 48 KB a launch gets
# without an opt-in, launched from two host threads at once, each thread at
# its own shared-memory size (one of them past 48 KB), as a node's HTTP, RPC
# and fan-out threads launch them. Each kernel is opted in once to the card's
# maximum (csrc/smem_optin.cuh): an opt-in to one call's own size could be
# lowered by the other thread between that call's opt-in and its launch,
# which then fails. Each pair is one template instance of its kernel, so the
# two threads share its opt-in.
P3_ROUNDS = 300


def _canonical(out):
    """A pool sorted by (distance, id): equal pools compare equal whatever
    order a kernel wrote them in."""
    d, i = (t.cpu() for t in out)
    by_id = torch.argsort(i, dim=1, stable=True)
    d, i = torch.gather(d, 1, by_id), torch.gather(i, 1, by_id)
    by_d = torch.argsort(d, dim=1, stable=True)
    return torch.gather(d, 1, by_d), torch.gather(i, 1, by_d)


def _p3_k3(cuda, small):
    # the scoring kernel's staged queries, both on 16-byte loads of f32 rows
    # of at most 1,024 columns: about 27 KB a block at r = 128, 64 KB at r = 1,024
    b, p, s, r, rr = (64, 24, 128, 128, 64) if small else (8, 8, 64, 1024, 64)
    gen = torch.Generator().manual_seed(b + rr)
    qp, probe, slabs, sq, ids, _ = _scan_operands(gen, b, p, s, r, False, False, None)
    ops = [t.to(cuda) for t in (qp, probe, slabs, sq, ids)] + [None]
    flat_ids, x = ids.reshape(-1), slabs.reshape(-1, r).double()

    def dist_of(bb, i):
        if i == -1:
            return float("inf")
        cell = int((flat_ids == i).nonzero()[0, 0])
        return float(sq.reshape(-1)[cell]) - 2.0 * float(x[cell] @ qp[bb].double())

    xmax = float(x.norm(dim=1).max())
    atol = IVF_RTOL * (xmax * xmax + 2.0 * xmax * qp.double().norm(dim=1))
    return (lambda: ivf_scan.ivf_probe_scan(*ops, rr), lambda: ivf_scan.ivf_probe_scan_plain(*ops, rr),
            lambda want, got: _pools_agree(want, got, dist_of, atol))


def _p3_k4(cuda, small):
    # bulk copies: two stages of 16 KB at B = 4,096, four of 48 KB at B = 1
    b, d, k, rr = (4096, 128, 10, 64) if small else (1, 128, 10, 64)
    gen = torch.Generator().manual_seed(b + d)
    vectors, queries = torch.randn((3000, d), generator=gen), torch.randn((b, d), generator=gen)
    pool = torch.argsort(torch.rand((b, 3000), generator=gen), dim=1)[:, :rr].to(torch.int32)
    coarse = torch.randn((b, rr), generator=gen)
    dev = [t.to(cuda) for t in (vectors, queries, pool, coarse)]

    def dist_of(bb, i):
        return float("inf") if i == -1 else float(((vectors[i].double() - queries[bb].double()) ** 2).sum())

    atol = IVF_RTOL * ((float(vectors.norm(dim=1).max()) + queries.double().norm(dim=1)) ** 2 + 1.0)
    return (lambda: ivf_rerank.ivf_exact_rerank(*dev, k, "euclidean", False),
            lambda: ivf_rerank.ivf_exact_rerank_plain(*dev, k, "euclidean", False),
            lambda want, got: _pools_agree(want, got, dist_of, atol))


def _p3_k9(cuda, small):
    # 16-byte code loads both: tables of 16 x 16 (20 KB a block) and 32 x 256 (53 KB)
    b, p, s, m, k, rr = (64, 24, 128, 16, 16, 256) if small else (7, 24, 128, 32, 256, 256)
    gen = torch.Generator().manual_seed(b + m + k)
    table, probe, codes, ids, _ = _pq_operands(gen, b, p, s, m, k, False, 0)
    ops = [t.to(cuda) for t in (table, probe, codes, ids)] + [None]
    flat_ids, cflat = ids.reshape(-1), codes.reshape(-1, m).long()

    def dist_of(bb, i):
        if i == -1:
            return float("inf")
        cell = int((flat_ids == i).nonzero()[0, 0])
        return float(table[bb].double()[torch.arange(m), cflat[cell]].sum())

    atol = torch.full((b,), IVF_RTOL * m * float(table.abs().max()))
    return (lambda: ivf_pq_scan.ivf_pq_probe_scan(*ops, rr), lambda: ivf_pq_scan.ivf_pq_probe_scan_plain(*ops, rr),
            lambda want, got: _pools_agree(want, got, dist_of, atol))


def _p3_k9_dense(cuda, small):
    # the staged table: 1 KB (16 x 16) against 64 KB (64 x 256)
    b, n, m, k = (3, 5000, 16, 16) if small else (3, 5000, 64, 256)
    gen = torch.Generator().manual_seed(n + m + k)
    codes = torch.randint(0, k, (n, m), generator=gen, dtype=torch.uint8).to(cuda)
    table = torch.randn((b, m, k), generator=gen).to(cuda)
    atol = IVF_RTOL * m * float(table.abs().max())
    return (lambda: ivf_pq_scan.pq_scan(table, codes, None), lambda: ivf_pq_scan.pq_scan_plain(table, codes, None),
            lambda want, got: torch.testing.assert_close(got, want, rtol=0, atol=atol))


def _p3_k10(cuda, small):
    # one warp a query, four queries a block: about 12 KB at L = 40, past 48 KB at L = 512
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import vamana_operands as vo

    b, L, W, R = (64, 40, 2, 64) if small else (8, 512, 1, 64)
    v, a = vo.random_graph(3000, 48, R, integer=True, metric="euclidean", seed=L, device=cuda)
    q = vo.random_queries(b, 48, integer=True, metric="euclidean", seed=b, device=cuda)

    def agree(want, got):
        for name, g, w in zip(got._fields, _k10_out(got), _k10_out(want)):
            assert torch.equal(g, w), name

    return (lambda: vamana_search.vamana_beam_search(v, a, q, L, W, 0, "euclidean", track_visited=True),
            lambda: vamana_search.beam_search_plain(v, a, q, L, W, 0, "euclidean", track_visited=True), agree)


def _p3_k11(cuda, small):
    # the staged rows: 8-d rows (a few KB) against the 128-d cell's (about 112 KB)
    from semadb_tpu_torch.ops.kernels import vamana_prune
    from semadb_tpu_torch.tools import vamana_operands as vo

    b, p, R, dim = (64, 160, 32, 8) if small else (64, 224, 64, 128)
    v, _ = vo.random_graph(5000, dim, 8, integer=True, metric="euclidean", seed=p, device=cuda)
    d, i, self_ids = vo.prune_pools(v, b, p, "euclidean", seed=dim)
    return (lambda: vamana_prune.vamana_robust_prune(d, i, self_ids, v, R, R, 1.2, "euclidean"),
            lambda: vamana_prune.robust_prune_plain(d, i, self_ids, v, R, R, 1.2, "euclidean"),
            lambda want, got: torch.testing.assert_close(got, want, rtol=0, atol=0))


def _p3_same(kernel, first, got):
    """Whether a repeat launch gave the first launch's result: pools as
    (distance, id) multisets, the walk's lists and the pruned rows bit for bit."""
    if kernel in ("k3", "k4", "k9"):  # k9_dense writes scores, compared below
        return all(torch.equal(x, y) for x, y in zip(_canonical(first), _canonical(got)))
    if kernel == "k10":
        return all(torch.equal(x, y) for x, y in zip(_k10_out(first), _k10_out(got)))
    return torch.equal(first, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k3", "k4", "k9", "k9_dense", "k10", "k11"])
def test_shared_memory_opt_in_across_threads(cuda, kernel):
    """Two threads launch one kernel P3_ROUNDS times each, at two
    shared-memory sizes: every launch succeeds and gives the result of the
    first launch at its size, which matches the plain version."""
    import threading

    make = {"k3": _p3_k3, "k4": _p3_k4, "k9": _p3_k9, "k9_dense": _p3_k9_dense, "k10": _p3_k10,
            "k11": _p3_k11}[kernel]
    cases = [make(cuda, small) for small in (True, False)]
    firsts = []
    for launch, plain, agree in cases:
        first = launch()
        torch.cuda.synchronize()
        agree(plain(), first)
        firsts.append(first)
    failures, outs, start = [], ([], []), threading.Barrier(2)

    def hammer(launch, kept):
        start.wait()  # results are read after both threads are done, so the launches overlap
        for n in range(P3_ROUNDS):
            try:
                kept.append(launch())
            except RuntimeError as e:
                failures.append(f"round {n}: {e}")
        torch.cuda.synchronize()

    threads = [threading.Thread(target=hammer, args=(c[0], kept)) for c, kept in zip(cases, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, failures[:5]
    for first, kept in zip(firsts, outs):
        assert len(kept) == P3_ROUNDS
        assert all(_p3_same(kernel, first, got) for got in kept)


# The query upload (utils/upload.py): host batches from PINNED_MIN_BYTES on
# reach the card through pinned staging, chunk by chunk, with no wait on the
# stream; smaller ones take the pageable .to()
UPLOAD_SHAPES = [(1, 128), (1, 1536), (4096, 128), (682, 1536), (683, 1536), (4096, 1536), (11000, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", UPLOAD_SHAPES)
@pytest.mark.parametrize("layout", ["float32", "float64", "strided", "tensor"])
def test_pinned_upload_equals_pageable(cuda, b, d, layout):
    """Either route's device tensor is bitwise the pageable ``.to()``'s, and
    is counted under its route, the pinned one with its bytes and chunks."""
    from semadb_tpu_torch.utils import upload

    rng = np.random.default_rng(b + d)
    x = rng.standard_normal((b, 2 * d) if layout == "strided" else (b, d))
    x = {"float32": x.astype(np.float32), "float64": x, "strided": x[:, ::2],
         "tensor": torch.from_numpy(x.astype(np.float32))}[layout]
    want = (x if layout == "tensor" else torch.from_numpy(np.asarray(x, np.float32))).to(cuda)
    pinned = b * d * 4 >= upload.PINNED_MIN_BYTES
    before = dict(upload.UPLOADS)
    got = upload.upload_queries(x, cuda)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    if pinned:
        assert upload.UPLOADS == {**before, "pinned": before["pinned"] + 1, "bytes": before["bytes"] + b * d * 4,
                                  "chunks": before["chunks"] + len(upload.chunk_rows(b, d * 4))}
    else:
        assert upload.UPLOADS == {**before, "direct": before["direct"] + 1}
    assert torch.equal(upload.upload_queries(want, cuda), want)  # a device tensor takes the direct route
    assert upload.UPLOADS["direct"] == before["direct"] + 1 + (not pinned)


# Rows of 32 floats: a batch of PINNED_ROWS takes the pinned route
PINNED_ROWS = 32768


@pytest.fixture(scope="module")
def upload_engines():
    """A small IVF and a small unrouted Vamana index on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from semadb_tpu_torch.index.vamana import IndexVamana
    from semadb_tpu_torch.models.schema import VectorVamanaParams
    from semadb_tpu_torch.utils import upload

    assert PINNED_ROWS * 32 * 4 >= upload.PINNED_MIN_BYTES
    cuda = torch.device("cuda")
    rng = np.random.default_rng(24)
    cents = rng.standard_normal((40, 32)).astype(np.float32) * 4
    vecs = (cents[rng.integers(0, 40, 5000)] + rng.standard_normal((5000, 32))).astype(np.float32)
    ivf = IndexIVF(VectorIVFParams(vector_size=32, distance_metric="euclidean", assign_copies=2), cuda)
    ivf.insert_bulk(np.arange(2, 5002), vecs)
    vam = IndexVamana(VectorVamanaParams(vector_size=32, distance_metric="euclidean", search_size=75,
                                         degree_bound=32), cuda)
    vam.insert_update_delete(zip(range(2, 2002), vecs[:2000]))
    return {"ivf": ivf, "vamana": vam}, rng


def _answers(handle):
    return [t.cpu().numpy() for t in handle]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["ivf", "vamana"])
def test_search_async_does_not_wait_on_the_stream(upload_engines, engine):
    """``search_batch_async`` of a host batch on the pinned route returns
    while work queued ahead of it still runs: nothing on its path waits for
    the stream."""
    from semadb_tpu_torch.utils import upload

    engines, rng = upload_engines
    idx = engines[engine]
    q = (rng.standard_normal((PINNED_ROWS, 32)) * 4).astype(np.float32)
    want = _answers(idx.search_batch_async(q, 10))  # warm: kernels, caches, pinned blocks
    torch.cuda.synchronize()
    before = upload.UPLOADS["pinned"]
    torch.cuda._sleep(2_000_000_000)  # about a second of the card's clock
    handle = idx.search_batch_async(q, 10)
    still_running = not torch.cuda.current_stream().query()
    got = _answers(handle)
    assert still_running and upload.UPLOADS["pinned"] == before + 1
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["ivf", "vamana"])
def test_staging_is_not_refilled_before_its_copy(upload_engines, engine):
    """32 distinct pinned-route batches submitted behind a sleeping stream,
    before any readback, each give the answer the same batch gives alone,
    and 32 uploads queued the same way arrive intact."""
    from semadb_tpu_torch.utils import upload

    engines, rng = upload_engines
    idx = engines[engine]
    batches = [(rng.standard_normal((PINNED_ROWS, 32)) * 4).astype(np.float32) for _ in range(32)]
    alone = [_answers(idx.search_batch_async(q, 10)) for q in batches]
    torch.cuda.synchronize()
    before = upload.UPLOADS["pinned"]
    torch.cuda._sleep(500_000_000)
    handles = [idx.search_batch_async(q, 10) for q in batches]
    torch.cuda._sleep(500_000_000)
    uploads = [upload.upload_queries(q, torch.device("cuda")) for q in batches]
    assert upload.UPLOADS["pinned"] == before + 64
    for h, want in zip(handles, alone):
        assert all(np.array_equal(g, w) for g, w in zip(_answers(h), want))
    for u, q in zip(uploads, batches):
        assert np.array_equal(u.cpu().numpy(), q)


@pytest.mark.cuda
def test_vamana_seed_tensor_stays_on_the_card(upload_engines):
    """The unrouted walk's entry seeds are uploaded once a graph state, and
    equal a fresh upload of the host seeds."""
    engines, rng = upload_engines
    vam = engines["vamana"]
    vam.search_batch_async(rng.standard_normal((8, 32)).astype(np.float32), 10)
    seeds = vam._entry_seeds_dev
    assert seeds is not None and seeds.device.type == "cuda"
    assert torch.equal(seeds.cpu(), torch.as_tensor(vam._get_entry_seeds()))
    vam.search_batch_async(rng.standard_normal((8, 32)).astype(np.float32), 10)
    assert vam._entry_seeds_dev is seeds
