"""Port ops (semadb_tpu_torch.ops) held against the JAX package's ops.

The same seeded numpy inputs go through ``semadb_tpu.ops`` (JAX on the CPU)
and ``semadb_tpu_torch.ops`` (PyTorch on the CPU). Tolerances:
  - bit packing and bit distances: exact (integer arithmetic; jaccard is one
    IEEE f32 division on both sides);
  - float distances: rtol 1e-5, atol 1e-4 (f32 products summed in another
    order by XLA and by torch);
  - top-k: the tie rule (ops.topk.tie_rule_errors), since the two top-k
    routines order equal distances differently.
K1's plain version is held against both the XLA ``pairwise_bit_distance``
and the Pallas kernel's own body, run in interpret mode.
"""

import functools
import unittest.mock

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import semadb_tpu.ops.pallas.hamming as pallas_hamming
from semadb_tpu.models import constants as C
from semadb_tpu.ops import bitops as jbitops
from semadb_tpu.ops.distance import (
    BIT_METRICS,
    FLOAT_METRICS,
    is_bit_metric,
    pairwise_bit_distance,
    pairwise_distance,
)
from semadb_tpu.ops import topk as jtopk
from semadb_tpu_torch.ops import bitops, distance, topk
from semadb_tpu_torch.ops.kernels import hamming

RNG = np.random.default_rng(1234)


def _codes(rows, w, zero_rows=()):
    c = RNG.integers(0, 2**32, (rows, w), dtype=np.uint32)
    for r in zero_rows:
        c[r] = 0
    return c


def _t(codes_u32):
    return torch.from_numpy(codes_u32.view(np.int32))


# -- bitops -----------------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 31, 32, 100, 1536])
def test_bitops_match_jax(dim):
    v = RNG.standard_normal((9, dim)).astype(np.float32)
    thr = RNG.standard_normal(dim).astype(np.float32) * 0.1
    want = np.asarray(jbitops.binarize(v, thr, dim))
    got = bitops.binarize(torch.from_numpy(v), torch.from_numpy(thr), dim)
    assert got.dtype == torch.int32 and bitops.packed_width(dim) == jbitops.packed_width(dim)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        bitops.unpack_bits(got, dim).numpy(), np.asarray(jbitops.unpack_bits(want, dim))
    )
    np.testing.assert_array_equal(bitops.unpack_bits(got, dim).numpy(), v > thr)


# -- float distances ----------------------------------------------------------


@pytest.mark.parametrize(
    "metric", [C.DISTANCE_EUCLIDEAN, C.DISTANCE_DOT, C.DISTANCE_COSINE, C.DISTANCE_HAVERSINE]
)
def test_pairwise_distance_matches_jax(metric):
    dim = 2 if metric == C.DISTANCE_HAVERSINE else 96
    q = RNG.standard_normal((5, dim)).astype(np.float32)
    x = RNG.standard_normal((300, dim)).astype(np.float32)
    if metric == C.DISTANCE_COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    if metric == C.DISTANCE_HAVERSINE:
        q, x = q * 40, x * 40
    want = np.asarray(pairwise_distance(q, x, metric))
    got = distance.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_metric_helpers_match_jax():
    for m in (*FLOAT_METRICS, *BIT_METRICS):
        distance.validate_metric(m)
        assert distance.is_bit_metric(m) == is_bit_metric(m)
    with pytest.raises(ValueError, match="unknown distance function"):
        distance.validate_metric("manhattan")


# -- top-k --------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 17])
def test_top_k_smallest_tie_rule(k):
    # Small integer distances: many ties, as hamming distances have
    d = RNG.integers(0, 12, (6, 40)).astype(np.float32)
    jv, ji = (np.asarray(a) for a in jtopk.top_k_smallest(d, k))
    tv, ti = (a.numpy() for a in topk.top_k_smallest(torch.from_numpy(d), k))
    for b in range(d.shape[0]):
        assert topk.tie_rule_errors(jv[b], ji[b], tv[b], ti[b], d[b]) == []


def test_masked_top_k_tie_rule():
    d = RNG.integers(0, 8, (4, 30)).astype(np.float32)
    mask = RNG.random((4, 30)) < 0.5
    jv, ji = (np.asarray(a) for a in jtopk.masked_top_k(d, mask, 6))
    tv, ti = (a.numpy() for a in topk.masked_top_k(torch.from_numpy(d), torch.from_numpy(mask), 6))
    masked = np.where(mask, d, np.inf)
    for b in range(4):
        assert topk.tie_rule_errors(jv[b], ji[b], tv[b], ti[b], masked[b]) == []


def test_sort_dedup_merge_match_jax():
    da = RNG.integers(0, 5, (3, 8)).astype(np.float32)
    db = RNG.integers(0, 5, (3, 8)).astype(np.float32)
    ia = RNG.integers(-1, 10, (3, 8)).astype(np.int32)
    ib = RNG.integers(-1, 10, (3, 8)).astype(np.int32)
    ta, tb = torch.from_numpy(da), torch.from_numpy(db)
    tia, tib = torch.from_numpy(ia), torch.from_numpy(ib)
    # These orders are fully determined (ties broken by id / position)
    for want, got in (
        (jtopk.sort_by_distance(da, ia), topk.sort_by_distance(ta, tia)),
        (jtopk.dedup_by_id(da, ia), topk.dedup_by_id(ta, tia)),
        (jtopk.merge_topk(da, ia, db, ib, 6), topk.merge_topk(ta, tia, tb, tib, 6)),
    ):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_tie_rule_catches_wrong_results():
    dists = {1: 0.0, 2: 1.0, 3: 1.0, 4: 2.0}
    assert topk.tie_rule_errors([0, 1], [1, 2], [0, 1], [1, 3], dists) == []
    assert topk.tie_rule_errors([0, 1], [1, 2], [0, 1], [4, 2], dists) != []
    assert topk.tie_rule_errors([0, 1], [1, 2], [0, 2], [1, 4], dists) != []


# -- K1: bit distance -----------------------------------------------------------

BIT_CASES = [
    (1, 1, 1),
    (7, 511, 5),
    (33, 700, 48),
    (3, 129, 48),
]


@pytest.mark.parametrize("metric", [C.DISTANCE_HAMMING, C.DISTANCE_JACCARD])
@pytest.mark.parametrize("b,n,w", BIT_CASES)
def test_bit_distance_plain_matches_xla(b, n, w, metric):
    # zero rows on both sides give the jaccard empty-union case
    q = _codes(b, w, zero_rows=[0])
    x = _codes(n, w, zero_rows=[0, n - 1])
    want = np.asarray(pairwise_bit_distance(q, x, metric))
    got = hamming.pairwise_bit_distance_kernel(_t(q), _t(x), metric)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if metric == C.DISTANCE_JACCARD:
        assert got[0, 0].item() == 0.0  # empty union


@pytest.mark.parametrize("metric", [C.DISTANCE_HAMMING, C.DISTANCE_JACCARD])
def test_exported_bit_distance_is_the_kernel_wrapper(metric):
    """``semadb_tpu_torch.ops.pairwise_bit_distance`` is K1's wrapper, which
    launches the kernel on CUDA tensors (or raises) and runs the plain
    version only on CPU tensors; here it equals the plain version and the
    XLA function."""
    from semadb_tpu_torch import ops

    assert ops.pairwise_bit_distance is hamming.pairwise_bit_distance_kernel
    assert distance.pairwise_bit_distance is hamming.pairwise_bit_distance_kernel
    q = _codes(7, 5, zero_rows=[0])
    x = _codes(300, 5, zero_rows=[0, 299])
    got = ops.pairwise_bit_distance(_t(q), _t(x), metric)
    assert torch.equal(got, hamming.pairwise_bit_distance_plain(_t(q), _t(x), metric))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pairwise_bit_distance(q, x, metric)))


@pytest.mark.parametrize("metric", [C.DISTANCE_HAMMING, C.DISTANCE_JACCARD])
@pytest.mark.parametrize("b,n,w", BIT_CASES[:3])
def test_bit_distance_plain_matches_pallas_interpret(b, n, w, metric):
    q = _codes(b, w, zero_rows=[0])
    x = _codes(n, w, zero_rows=[0])
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with unittest.mock.patch.object(pallas_hamming.pl, "pallas_call", interpret):
        want = np.asarray(pallas_hamming.pairwise_bit_distance_pallas(q, x, metric))
    got = hamming.pairwise_bit_distance_plain(_t(q), _t(x), metric)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bit_distance_plain_blocks_over_n(monkeypatch):
    """The plain version's N blocking (bounded intermediate) is exact."""
    q, x = _codes(4, 6), _codes(300, 6)
    whole = hamming.pairwise_bit_distance_plain(_t(q), _t(x), C.DISTANCE_JACCARD)
    monkeypatch.setattr(hamming, "_PLAIN_BLOCK_BYTES", 4 * 6 * 4 * 7)  # 7 rows a step
    np.testing.assert_array_equal(
        hamming.pairwise_bit_distance_plain(_t(q), _t(x), C.DISTANCE_JACCARD).numpy(),
        whole.numpy(),
    )


def test_kernel_wrapper_never_falls_back_off_cpu():
    """A non-CPU tensor goes to the kernel path (here: refused), never to the
    plain version; bad operands are refused before any launch."""
    launches = hamming.LAUNCHES
    meta = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        hamming.pairwise_bit_distance_kernel(meta, meta, C.DISTANCE_HAMMING)
    with pytest.raises(ValueError, match="unknown bit distance"):
        hamming.pairwise_bit_distance_kernel(meta, meta, "cosine")
    assert hamming.LAUNCHES == launches
