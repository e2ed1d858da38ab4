"""Batched distance functions.

Port of ``semadb_tpu/ops/distance.py`` (float metrics and the bit metrics;
``pairwise_bit_distance`` is K1's wrapper, ``ops/kernels/hamming.py``).
Semantics as there:
  - ``euclidean``  → *squared* euclidean (no sqrt)
  - ``dot``        → negated dot product (lower is better)
  - ``cosine``     → ``1 - dot`` (assumes normalized vectors)
  - ``haversine``  → meters on Earth's surface for [lat, lon] degrees
  - ``hamming``    → popcount of XOR over bit-packed vectors
  - ``jaccard``    → ``1 - |and| / |or|`` over bit-packed vectors

The float products are ``torch.matmul`` in full f32: TF32 is off for
matmuls by default (``torch.backends.cuda.matmul.allow_tf32`` is False), and
:func:`pairwise_distance` refuses to run if someone turned it on, since
candidate order depends on the low bits.
"""

from __future__ import annotations

import math

import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.ops.kernels.hamming import (
    pairwise_bit_distance_kernel as pairwise_bit_distance,
)
from semadb_tpu_torch.ops.kernels.hamming import popcount_sum

EARTH_RADIUS = 6371000.0
_DEG_TO_RAD = math.pi / 180.0

FLOAT_METRICS = (C.DISTANCE_EUCLIDEAN, C.DISTANCE_DOT, C.DISTANCE_COSINE, C.DISTANCE_HAVERSINE)
BIT_METRICS = (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD)

__all__ = [
    "pairwise_distance", "gather_distance", "pairwise_bit_distance", "gather_bit_distance", "is_bit_metric",
    "validate_metric",
]


def _haversine_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    latx, lonx = x[..., 0] * _DEG_TO_RAD, x[..., 1] * _DEG_TO_RAD
    laty, lony = y[..., 0] * _DEG_TO_RAD, y[..., 1] * _DEG_TO_RAD
    sin_dlat = torch.sin((latx - laty) / 2)
    sin_dlon = torch.sin((lonx - lony) / 2)
    a = sin_dlat * sin_dlat + torch.cos(latx) * torch.cos(laty) * sin_dlon * sin_dlon
    return EARTH_RADIUS * (2.0 * torch.asin(torch.sqrt(a.clamp(0.0, 1.0))))


def _cross(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("distance matmuls need full f32; TF32 matmuls are enabled")
    return queries @ corpus.T


def pairwise_distance(queries: torch.Tensor, corpus: torch.Tensor, metric: str) -> torch.Tensor:
    """All-pairs distance matrix ``f32[B, N]`` for float metrics.

    ``queries``: f32[B, D]; ``corpus``: f32[N, D]. Euclidean uses the
    ``|q|^2 - 2 q.x + |x|^2`` expansion so it is one matmul too."""
    if metric == C.DISTANCE_EUCLIDEAN:
        q2 = (queries * queries).sum(-1, keepdim=True)
        x2 = (corpus * corpus).sum(-1)[None, :]
        # Squared euclidean can go slightly negative from rounding; clamp.
        return (q2 - 2.0 * _cross(queries, corpus) + x2).clamp(min=0.0)
    if metric in (C.DISTANCE_DOT, C.DISTANCE_COSINE):
        cross = _cross(queries, corpus)
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross
    if metric == C.DISTANCE_HAVERSINE:
        return _haversine_pair(queries[:, None, :], corpus[None, :, :])
    raise ValueError(f"unknown float32 distance function: {metric}")


def gather_distance(
    vectors: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor, metric: str
) -> torch.Tensor:
    """Per-query distances to gathered candidate rows: ``vectors`` f32[cap, D],
    ``ids`` [B, K] (in range; the caller clips), ``queries`` f32[B, D] →
    f32[B, K]. Euclidean is taken directly, ``sum (c - q)^2``, not by the
    norm expansion (the JAX package's ``gather_distance``)."""
    cand = vectors[ids.long()]  # [B, K, D]
    if metric == C.DISTANCE_EUCLIDEAN:
        diff = cand - queries[:, None, :]
        return (diff * diff).sum(-1)
    if metric in (C.DISTANCE_DOT, C.DISTANCE_COSINE):
        cross = (cand * queries[:, None, :]).sum(-1)
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross
    if metric == C.DISTANCE_HAVERSINE:
        return _haversine_pair(queries[:, None, :], cand)
    raise ValueError(f"unknown float32 distance function: {metric}")


def gather_bit_distance(
    codes: torch.Tensor, ids: torch.Tensor, query_code: torch.Tensor, metric: str
) -> torch.Tensor:
    """Per-query bit distances to gathered codes: ``codes`` i32[cap, W] (the
    JAX package's u32 words), ``ids`` [B, K] (in range; the caller clips),
    ``query_code`` i32[B, W] → f32[B, K]. Hamming is the popcount of the
    xor; jaccard ``1 - |and| / |or|``, and 0 where ``|or| == 0``."""
    cand = codes[ids.long()]  # [B, K, W]
    q = query_code[:, None, :]
    if metric == C.DISTANCE_HAMMING:
        return popcount_sum(q ^ cand).to(torch.float32)
    if metric == C.DISTANCE_JACCARD:
        inter = popcount_sum(q & cand)
        union = popcount_sum(q | cand)
        d = 1.0 - inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
        return torch.where(union == 0, 0.0, d)
    raise ValueError(f"unknown bit distance function: {metric}")


def is_bit_metric(metric: str) -> bool:
    return metric in BIT_METRICS


def validate_metric(metric: str) -> None:
    if metric not in FLOAT_METRICS and metric not in BIT_METRICS:
        raise ValueError(f"unknown distance function: {metric}")
