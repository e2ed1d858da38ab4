"""The control and the planted faults that the comparison must catch.

``TF32Exact`` is the plain reference put in the program's place one
precision below what the configurations state: exact nearest neighbours,
with the distance product in TF32 (the configurations state returned
distances in float32 with TF32 off). The faults wrap a real engine and
break what it answers: ``HalfLeftOut`` (half of every batch comes back
empty) and ``Altered`` (one answer of each request is changed where it is
produced).

``tf32_matmuls`` and ``bf16_slabs`` switch on the program's own paths below
float32 (its cuBLAS products, the IVF probe GEMM among them, in TF32; its
IVF slabs in bf16, the route it takes past ``SLAB_BF16_BYTES``). They touch
no returned distance, which K4 and K10 take in float32: they are read for
the record, not as the control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ROW_CHUNK = 1 << 17  # rows a distance block of the control holds


class TF32Exact:
    """A brute-force store with the engines' interface."""

    def __init__(self, schema: dict, device):
        self.device = torch.device(device)

    def insert_bulk(self, ids, vecs, defer_fit: bool = False) -> None:
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        vecs = torch.as_tensor(vecs).to(self.device, torch.float32)
        self.vectors = vecs.new_zeros((int(ids.max()) + 1, vecs.shape[1]))
        self.live = torch.zeros(len(self.vectors), dtype=torch.bool, device=self.device)
        self.vectors[ids] = vecs
        self.live[ids] = True

    def flush_pending(self) -> None:
        pass

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def search_batch_async(self, queries, k: int):
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            best_d = torch.full((len(q), k), float("inf"), device=self.device)
            best_i = torch.full((len(q), k), -1, dtype=torch.int64, device=self.device)
            qsq = (q * q).sum(1, keepdim=True)
            for r in range(0, len(self.live), ROW_CHUNK):
                x = self.vectors[r : r + ROW_CHUNK]
                d = qsq - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
                d.masked_fill_(~self.live[r : r + ROW_CHUNK][None, :], float("inf"))
                v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
                v, pos = torch.topk(torch.cat([best_d, v], 1), k, dim=1, largest=False)
                best_i = torch.gather(torch.cat([best_i, i + r], 1), 1, pos)
                best_d = v
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
        return best_d, best_i.masked_fill(~torch.isfinite(best_d), -1).to(torch.int32)


class _Wrapped:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)


class HalfLeftOut(_Wrapped):
    """The second half of each search batch comes back empty."""

    def search_batch_async(self, queries, k: int, *args, **kwargs):
        d, i = self._inner.search_batch_async(queries, k, *args, **kwargs)
        h = len(d) // 2
        return torch.cat([d[:h], torch.full_like(d[h:], float("inf"))]), torch.cat([i[:h], torch.full_like(i[h:], -1)])


class Altered(_Wrapped):
    """The nearest answer of each request's first query comes back under the
    id of its k-th (its distance kept)."""

    def search_batch_async(self, queries, k: int, *args, **kwargs):
        d, i = self._inner.search_batch_async(queries, k, *args, **kwargs)
        i = i.clone()
        i[0, 0] = i[0, -1]
        return d, i


@contextlib.contextmanager
def tf32_matmuls():
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


@contextlib.contextmanager
def bf16_slabs():
    from semadb_tpu_torch.index import ivf

    keep = ivf.SLAB_BF16_BYTES
    ivf.SLAB_BF16_BYTES = 0
    try:
        yield
    finally:
        ivf.SLAB_BF16_BYTES = keep
