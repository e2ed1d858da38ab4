"""Flat (brute-force exact) vector index.

Port of ``semadb_tpu/index/flat.py``: a full scan through the vector store
(a float matmul, or the binary kernel when quantized) plus top-k. Vectors,
the live mask and the codes are tensors on the index's device, updated in
place (``index_copy_`` / ``index_fill_``) where the JAX package made copies.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from semadb_tpu_torch.models.schema import VectorFlatParams
from semadb_tpu_torch.ops.topk import top_k_smallest
from semadb_tpu_torch.utils.grow import initial_capacity, next_capacity
from semadb_tpu_torch.vectorstore import QuantConfig, VectorStore
from semadb_tpu_torch.vectorstore.store import host_tensor

MIN_CAPACITY = 128


class IndexFlat:
    """Exact top-k index over device-resident vectors: insert/update/delete
    over (id, vector|None) changes, and search with an optional filter mask."""

    def __init__(self, params: VectorFlatParams, device: torch.device, capacity: int = MIN_CAPACITY):
        self.params = params
        self.device = torch.device(device)
        self.capacity = max(capacity, initial_capacity(params.vector_size * 4, MIN_CAPACITY))
        self.vectors = torch.zeros(
            (self.capacity, params.vector_size), dtype=torch.float32, device=self.device
        )
        self.exists = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        self._max_seen = 0  # snapshot row bound (highest id ever written)
        self.store = VectorStore(
            QuantConfig.from_params(params.quantizer, params.vector_size, params.distance_metric),
            self.device,
        )

    def __len__(self) -> int:
        return int(self.exists.sum())

    def _ensure_capacity(self, max_id: int) -> None:
        self._max_seen = max(self._max_seen, int(max_id))
        if max_id < self.capacity:
            return
        new_cap = next_capacity(self.capacity, max_id, self.params.vector_size * 4)
        vectors = torch.zeros(
            (new_cap, self.params.vector_size), dtype=torch.float32, device=self.device
        )
        vectors[: self.capacity] = self.vectors
        exists = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
        exists[: self.capacity] = self.exists
        self.vectors, self.exists, self.capacity = vectors, exists, new_cap

    def insert_update_delete(self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]) -> None:
        ups: list[tuple[int, np.ndarray]] = []
        dels: list[int] = []
        max_id = 0
        for node_id, vec in changes:
            if node_id in (0, 1):
                raise ValueError(f"cannot modify point with reserved id: {node_id}")
            max_id = max(max_id, node_id)
            if vec is None:
                dels.append(node_id)
            else:
                ups.append((node_id, vec))
        self._ensure_capacity(max_id)
        if ups:
            ids_np = np.array([u[0] for u in ups], np.int64)
            ids = torch.from_numpy(ids_np).to(self.device)
            vecs = np.stack([np.asarray(u[1], np.float32) for u in ups])
            self.vectors.index_copy_(0, ids, torch.from_numpy(vecs).to(self.device))
            self.exists.index_fill_(0, ids, True)
            if self.store.fitted:
                self.store.encode_rows(self.vectors, ids_np)
        if dels:
            ids = torch.as_tensor(dels, dtype=torch.int64, device=self.device)
            self.exists.index_fill_(0, ids, False)
        self.store.maybe_fit(self.vectors, self.exists)

    def search_batch(
        self, queries: np.ndarray, k: int, filter_mask: Optional[np.ndarray] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: (dists f32[B,k], ids i32[B,k]); empty → (inf, -1)."""
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        mask = self.exists
        if filter_mask is not None:
            fm = np.zeros(self.capacity, bool)
            fm_in = np.asarray(filter_mask, bool)[: self.capacity]
            fm[: fm_in.shape[0]] = fm_in
            mask = mask & torch.from_numpy(fm).to(self.device)
        d = self.store.scan_distances(q, self.vectors, mask)
        vals, idx = top_k_smallest(d, min(k, self.capacity))
        idx = torch.where(torch.isfinite(vals), idx, -1)
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    # -- persistence -------------------------------------------------------
    def to_arrays(self) -> dict:
        """Host arrays in the JAX package's ``IndexFlat.to_arrays`` layout."""
        return {
            "vectors": self.vectors.cpu().numpy(),
            "exists": self.exists.cpu().numpy(),
            "store": self.store.to_arrays(),
        }

    def device_arrays(self) -> dict:
        """Device-resident view (no readback) for the snapshot writer."""
        return {"vectors": self.vectors, "exists": self.exists, "store": self.store.device_arrays()}

    def snapshot_row_bounds(self) -> dict:
        """Used-row bounds for the incremental snapshot writer."""
        b = min(self.capacity, int(self._max_seen) + 1)
        return {"vectors": b, "exists": b, "store/codes": b}

    @classmethod
    def from_arrays(cls, params: VectorFlatParams, arrays: dict, device: torch.device) -> "IndexFlat":
        """Load what either package's ``to_arrays`` (or a snapshot) holds.

        Row-bounded snapshots persist only used rows; the rows are re-padded
        along the pregrow-aware growth chain (seeded at the pregrow
        capacity, so a growth-bucket overshoot cannot beat the deliberate
        pregrow shape), as the JAX package does."""
        rows = int(arrays["vectors"].shape[0])
        row_bytes = params.vector_size * 4
        base = initial_capacity(row_bytes, MIN_CAPACITY)
        target = max(next_capacity(base, rows - 1, row_bytes) if rows else base, rows)
        idx = cls(params, device, capacity=target)
        idx.vectors[:rows] = host_tensor(arrays["vectors"], np.float32).to(idx.device)
        idx.exists[:rows] = host_tensor(arrays["exists"], bool).to(idx.device)
        idx._max_seen = max(rows - 1, 0)
        idx.store.load_arrays(arrays.get("store", {}))
        idx.store.ensure_rows(target)
        return idx
