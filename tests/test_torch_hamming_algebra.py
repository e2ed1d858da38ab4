"""The arithmetic of K1's tensor-core route, held against the JAX package.

The tensor-core route of ``semadb_tpu_torch/csrc/hamming.cu`` does not
compute popcount(q XOR x) or popcount(q OR x). It counts
``inter = |q AND x|`` in 256-bit k-steps (8 words, the W words padded with
zero words up to a multiple of 8), and derives

    hamming = |q| + |x| - 2 inter
    jaccard = 1 - inter / (|q| + |x| - inter), and 0 where that union is 0

from the row popcounts |q| and |x|. :func:`algebra_distance` below is that
arithmetic in plain PyTorch, written for this test and independent of the
port. It is compared, exactly, with the XLA ``pairwise_bit_distance`` and
with the Pallas kernel's own body run in interpret mode. Exact is right:
every count is an integer, and jaccard is one IEEE f32 division of two
integers below 2^24 on both sides.
"""

import functools
import unittest.mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import semadb_tpu.ops.pallas.hamming as pallas_hamming
from semadb_tpu.models import constants as C
from semadb_tpu.ops.distance import pairwise_bit_distance
from semadb_tpu_torch.ops.kernels import hamming

WORDS = [1, 5, 8, 9, 48]
METRICS = [C.DISTANCE_HAMMING, C.DISTANCE_JACCARD]
K_STEP_WORDS = 8  # 256 bits: the depth of one m16n8k256 b1 MMA


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Popcount of each int32 word's 32 bits, as int64 (SWAR)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def algebra_distance(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """i32[B, W] x i32[N, W] -> f32[B, N] by the tensor-core route's algebra."""
    w = q.shape[1]
    pad = -w % K_STEP_WORDS  # zero words, as in the kernel's shared rows
    qp, xp = F.pad(q, (0, pad)), F.pad(x, (0, pad))
    inter = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.int64)
    for k0 in range(0, w + pad, K_STEP_WORDS):
        step = slice(k0, k0 + K_STEP_WORDS)
        inter += _popcount(qp[:, None, step] & xp[None, :, step]).sum(-1)
    both = _popcount(qp).sum(-1)[:, None] + _popcount(xp).sum(-1)[None, :]
    if metric == C.DISTANCE_HAMMING:
        return (both - 2 * inter).to(torch.float32)
    union = both - inter
    d = 1.0 - inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
    return torch.where(union == 0, 0.0, d)


def _operands(b: int, n: int, w: int, seed: int):
    """Random u32 words from a numpy seed, with the edge rows: zero rows on
    both sides (the empty union) and all-ones rows (the largest counts)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint32)
    x = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    q[0] = 0
    x[0] = x[n - 1] = 0
    q[1] = 0xFFFFFFFF
    x[1] = 0xFFFFFFFF
    return q, x


def _t(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words_u32.view(np.int32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("w", WORDS)
def test_algebra_matches_xla(w, metric):
    q, x = _operands(17, 300, w, seed=w)
    want = np.asarray(pairwise_bit_distance(q, x, metric))
    got = algebra_distance(_t(q), _t(x), metric)
    np.testing.assert_array_equal(got.numpy(), want)
    if metric == C.DISTANCE_JACCARD:
        assert got[0, 0].item() == 0.0  # empty union
        assert got[1, 1].item() == 0.0  # identical all-ones rows


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("w", WORDS)
def test_algebra_matches_pallas_interpret(w, metric):
    q, x = _operands(9, 130, w, seed=100 + w)
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with unittest.mock.patch.object(pallas_hamming.pl, "pallas_call", interpret):
        want = np.asarray(pallas_hamming.pairwise_bit_distance_pallas(q, x, metric))
    got = algebra_distance(_t(q), _t(x), metric)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("w", WORDS)
def test_algebra_matches_port_plain(w, metric):
    """The plain version, which the card holds both routes to, computes
    the same numbers as the algebra."""
    q, x = _operands(33, 257, w, seed=200 + w)
    got = algebra_distance(_t(q), _t(x), metric)
    np.testing.assert_array_equal(
        hamming.pairwise_bit_distance_plain(_t(q), _t(x), metric).numpy(), got.numpy()
    )


def test_route_by_b():
    """The wrapper's route: B alone, apart from codes too wide for the
    tensor-core route's shared memory."""
    w = hamming.TENSOR_MAX_W
    assert hamming.route_for(hamming.TENSOR_MIN_B - 1, w) == "cuda_core"
    assert hamming.route_for(hamming.TENSOR_MIN_B, w) == "tensor_core"
    assert hamming.route_for(4096, 48) == "tensor_core"
    assert hamming.route_for(4096, w + 1) == "cuda_core"
    assert set(hamming.ROUTES) == {"cuda_core", "tensor_core"}


def test_unknown_route_refused():
    q = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown route"):
        hamming.pairwise_bit_distance_kernel(q, q, C.DISTANCE_HAMMING, route="simd")
