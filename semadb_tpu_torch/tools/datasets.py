"""Datasets for the port's benchmarks.

Copies of ``semadb_tpu/tools/datasets.py``'s host generators and exact
ground truth (``AnnDataset``, ``embedding_like``, ``compute_ground_truth``;
numpy, so one seed gives bit-identical data in both packages), plus
:func:`compute_ground_truth_device` and :func:`embedding_like_device` in
torch. The device generator draws the host generator's mixture from a
``torch.Generator`` on the device: JAX's random numbers cannot be
reproduced, so its data match the JAX package's in distribution, not in
bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from semadb_tpu_torch.ops.distance import pairwise_distance

# Rows the device generator makes at a time: its noise, ``z @ emb.T`` and
# their sum never exist at full size (each would be 5.12 GB at 10M x 128)
GEN_BLOCK_ROWS = 1 << 20
# Floats in one [query chunk, corpus block] distance block of the device
# ground truth (1 GiB)
GT_BLOCK_FLOATS = 1 << 28


@dataclass
class AnnDataset:
    name: str
    metric: str  # euclidean | cosine
    train: np.ndarray  # f32[N, D]
    test: np.ndarray  # f32[Q, D]
    neighbors: Optional[np.ndarray] = None  # i32[Q, K] ground truth (train indices)



def embedding_like(
    n: int,
    dim: int,
    n_queries: int,
    latent: int = 64,
    cluster_size: int = 100,
    spread: float = 0.9,
    ambient: float = 0.25,
    metric: str = "euclidean",
    seed: int = 42,
) -> AnnDataset:
    """Synthetic data with real-embedding-like neighbour margins.

    Real ann-benchmarks sets (SIFT/MNIST/DBpedia) are samples from a
    low-dimensional manifold embedded in D dims: local neighbourhoods are
    dense (recall@10 well-defined) but margins are moderate — the 10th
    neighbour is a sizable fraction of a random pair's distance, unlike
    jittered-copy generators where queries sit on top of train points.

    Model: a Gaussian mixture in an r-dim latent space (centers N(0, I_r),
    within-cluster spread ``spread``), embedded by a fixed orthonormal
    D x r map, plus isotropic ambient noise. Queries are HELD-OUT samples
    of the same mixture (ann-benchmarks protocol), never copies of train
    points — an index cannot score recall 1.0 by exact-match alone.

    Default parameters are calibrated HARDER than SIFT-like margins:
    measured d(10th NN)/d(random pair) ≈ 0.63 at 20k x 128d (SIFT sits
    near 0.4-0.5) — quantized-recall numbers on this set are a floor, not
    a friendly-data artefact.
    """
    rng = np.random.default_rng(seed)
    # Narrow corpora (glove-25-angular analog): the orthonormal embedding
    # needs latent <= dim; clamping keeps the same mixture model with a
    # full-rank map instead of crashing the QR.
    latent = min(latent, dim)
    n_clusters = max(n // cluster_size, 2)
    centers = rng.standard_normal((n_clusters, latent), dtype=np.float32)
    # Orthonormal embedding map D x r
    a = rng.standard_normal((dim, latent), dtype=np.float32)
    q_, _ = np.linalg.qr(a)
    emb = q_.astype(np.float32)  # [D, r]

    def sample(m: int, seed_off: int) -> np.ndarray:
        r2 = np.random.default_rng(seed + seed_off)
        assign = r2.integers(0, n_clusters, m)
        z = centers[assign] + spread * r2.standard_normal((m, latent), dtype=np.float32)
        x = z @ emb.T + ambient * r2.standard_normal((m, dim), dtype=np.float32)
        return x.astype(np.float32)

    train = sample(n, 1)
    test = sample(n_queries, 2)
    if metric == "cosine":
        train = train / np.maximum(np.linalg.norm(train, axis=1, keepdims=True), 1e-12)
        test = test / np.maximum(np.linalg.norm(test, axis=1, keepdims=True), 1e-12)
    return AnnDataset(
        name=f"embedding-like-{n}x{dim}", metric=metric, train=train, test=test
    )


def compute_ground_truth(ds: AnnDataset, k: int, block: int = 256) -> np.ndarray:
    """Exact top-k train indices per test query (host, float64 accurate)."""
    out = np.empty((len(ds.test), k), np.int32)
    # np.asarray first: device-resident datasets would otherwise silently
    # stay f32 (jax has no f64 by default) — this path is the f64-exact one
    tr = np.asarray(ds.train).astype(np.float64)
    tr_sq = (tr * tr).sum(-1)
    for i in range(0, len(ds.test), block):
        q = np.asarray(ds.test[i : i + block]).astype(np.float64)
        if ds.metric == "cosine":
            d = 1.0 - q @ tr.T
        else:
            d = (q * q).sum(-1)[:, None] - 2.0 * (q @ tr.T) + tr_sq[None, :]
        # argpartition + local sort: O(N) per query instead of a full sort
        part = np.argpartition(d, k, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        out[i : i + block] = np.take_along_axis(part, np.argsort(pd, axis=1), axis=1)
    return out



def compute_ground_truth_device(
    ds: AnnDataset, k: int, device, qchunk: int = 0
) -> np.ndarray:
    """Exact top-k train indices per test query, computed on ``device``:
    [qchunk, corpus block] f32 distance blocks of ``GT_BLOCK_FLOATS``
    (``torch.matmul`` in full f32, TF32 off), each block's ``torch.topk``,
    and a merge of the blocks' candidates per query chunk. ``ds.train`` / ``ds.test`` may be numpy arrays or tensors
    (a tensor on ``device`` is used where it lies). At 1M x 128 and 32,768
    queries the host f64 version takes hours on one core; f32's relative
    error (~1e-6) is far below any neighbour margin, and ann-benchmarks'
    ground truth is f32 too. Blocking the corpus too keeps each query chunk
    wide at any N: the corpus is read once per chunk of queries."""
    device = torch.device(device)
    corpus = _as_tensor(ds.train, device)
    test = _as_tensor(ds.test, device)
    n = corpus.shape[0]
    if not qchunk:
        qchunk = min(len(test), 4096)
    nchunk = max(GT_BLOCK_FLOATS // qchunk, k)
    outs = []
    for i in range(0, len(test), qchunk):
        q = test[i : i + qchunk]
        best_d = best_i = None
        for j in range(0, n, nchunk):
            d = pairwise_distance(q, corpus[j : j + nchunk], ds.metric)
            v, pos = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
            if best_d is None:
                best_d, best_i = v, pos + j
            else:
                v, sel = torch.topk(torch.cat([best_d, v], 1), k, dim=1, largest=False, sorted=True)
                best_i = torch.gather(torch.cat([best_i, pos + j], 1), 1, sel)
                best_d = v
        outs.append(best_i.to(torch.int32).cpu())
    return torch.cat(outs).numpy()


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def embedding_like_device(
    n: int,
    dim: int,
    n_queries: int,
    latent: int = 64,
    cluster_size: int = 100,
    spread: float = 0.9,
    ambient: float = 0.25,
    metric: str = "euclidean",
    seed: int = 42,
    device="cuda",
) -> AnnDataset:
    """:func:`embedding_like`, generated on ``device`` (JAX
    ``embedding_like_device``): the same mixture in an r-dim latent space
    (``n // cluster_size`` centres, within-cluster ``spread``), the same
    orthonormal D x r embedding, ambient noise and cosine normalisation,
    drawn from a ``torch.Generator`` on ``device`` seeded by ``seed``. Train
    and test come back as tensors on ``device``. Rows are made
    ``GEN_BLOCK_ROWS`` at a time into one preallocated tensor."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    latent = min(latent, dim)  # same clamp as the host generator
    n_clusters = max(n // cluster_size, 2)
    centers = torch.randn((n_clusters, latent), generator=gen, device=device)
    emb, _ = torch.linalg.qr(torch.randn((dim, latent), generator=gen, device=device))  # [D, r]

    def sample(m: int) -> torch.Tensor:
        out = torch.empty((m, dim), dtype=torch.float32, device=device)
        for lo in range(0, m, GEN_BLOCK_ROWS):
            rows = min(GEN_BLOCK_ROWS, m - lo)
            assign = torch.randint(0, n_clusters, (rows,), generator=gen, device=device)
            z = centers[assign] + spread * torch.randn((rows, latent), generator=gen, device=device)
            noise = torch.randn((rows, dim), generator=gen, device=device)
            torch.addmm(noise, z, emb.T, beta=ambient, out=out[lo : lo + rows])
            if metric == "cosine":
                blk = out[lo : lo + rows]
                blk /= torch.linalg.vector_norm(blk, dim=1, keepdim=True).clamp(min=1e-12)
        return out

    train = sample(n)
    test = sample(n_queries)
    return AnnDataset(name=f"embedding-like-dev-{n}x{dim}", metric=metric, train=train, test=test)
