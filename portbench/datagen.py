"""Seeded embedding-like rows, made on the device in blocks.

A copy of ``semadb_tpu_torch/tools/datasets.py``'s ``embedding_like_device``
(a Gaussian mixture in a ``latent``-dim space, ``n_points // cluster_size``
centres, within-cluster ``spread``, embedded by a fixed orthonormal
``dim`` x ``latent`` map, plus isotropic ``ambient`` noise), with the seed a
parameter and every block of ``BLOCK`` rows drawn from a generator of its
own. A row is therefore fixed by (seed, stream, index) alone: the corpus
and the queries are two streams, and the reference regenerates any row
without the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 16  # rows a generator draws at once
CORPUS, QUERIES = 0, 2  # the streams (1 is kept for the rows that writes insert)


def _seed(*words: int) -> int:
    """A 63-bit generator seed from any whole numbers (the run's seed may
    exceed 32 bits)."""
    return int(np.random.SeedSequence([int(w) % 2**64 for w in words]).generate_state(1, np.uint64)[0] >> 1)


class Mixture:
    """The mixture of one run: ``gen`` is the configuration's ``generator``
    entry, ``n_points`` its corpus size, which fixes the number of centres."""

    def __init__(self, seed: int, dim: int, n_points: int, gen: dict, metric: str, device):
        self.seed, self.dim, self.metric = int(seed), int(dim), metric
        self.device = torch.device(device)
        self.spread, self.ambient = float(gen["spread"]), float(gen["ambient"])
        self.latent = min(int(gen["latent"]), self.dim)
        self.n_clusters = max(int(n_points) // int(gen["cluster_size"]), 2)
        g = torch.Generator(device=self.device).manual_seed(_seed(self.seed, 99))
        self.centers = torch.randn((self.n_clusters, self.latent), generator=g, device=self.device)
        emb, _ = torch.linalg.qr(torch.randn((self.dim, self.latent), generator=g, device=self.device))
        self.emb_t = emb.T.contiguous()  # [latent, dim]

    def _block(self, stream: int, b: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(_seed(self.seed, stream, b))
        assign = torch.randint(0, self.n_clusters, (BLOCK,), generator=g, device=self.device)
        z = self.centers[assign] + self.spread * torch.randn((BLOCK, self.latent), generator=g, device=self.device)
        noise = torch.randn((BLOCK, self.dim), generator=g, device=self.device)
        x = torch.addmm(noise, z, self.emb_t, beta=self.ambient)
        if self.metric == "cosine":
            x /= torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
        return x

    def rows(self, stream: int, start: int, count: int) -> torch.Tensor:
        """Rows ``start .. start + count - 1`` of ``stream``, f32[count, dim]
        on the device."""
        out = torch.empty((count, self.dim), dtype=torch.float32, device=self.device)
        pos = 0
        while pos < count:
            b, off = divmod(start + pos, BLOCK)
            take = min(BLOCK - off, count - pos)
            out[pos : pos + take] = self._block(stream, b)[off : off + take]
            pos += take
        return out
