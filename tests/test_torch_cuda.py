"""K1, K2 and the flat index on a CUDA card (skipped without one).

These need the card: the CUDA kernels have no CPU mode. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: exact throughout. K1's counts are integers and jaccard is one
IEEE f32 division of two of them on both sides, on either route; the gather
copies bits.
"""

import numpy as np
import pytest
import torch

from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.models.quantizer import BinaryQuantizerParams, Quantizer
from semadb_tpu_torch.models.schema import VectorFlatParams
from semadb_tpu_torch.ops.kernels import gather, hamming

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
