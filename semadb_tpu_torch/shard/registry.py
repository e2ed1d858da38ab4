"""Device-index registry with an LRU device-memory budget.

Port of ``semadb_tpu/shard/registry.py`` (the reference's shared cache
manager, shard/cache/manager.go:39-120): one device index per bucket per
shard, pruned least-recently-accessed past ``maxCacheSize``. Eviction drops
the handle; the per-txn delta journal (shard.py) makes every committed
write recoverable, so the next access reloads snapshot + journal.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch


_ARRAYS = (
    "vectors", "adjacency", "exists", "centroids", "slabs", "slab_sq", "slab_ids", "ovf_vecs", "ovf_ids",
    "slab_codes", "ovf_codes",
)


def index_nbytes(idx) -> int:
    """Device bytes held by an index: a flat index's vectors, live mask and
    vector store, a Vamana index's vectors, adjacency and live mask, an IVF index's vectors, centroids, slabs (or PQ codes) and
    overflow, a fused index's inner IVF index (``Tensor.nbytes``, no
    transfers)."""
    inner = getattr(idx, "index", None)
    if inner is not None:  # FusedHybridIVF wraps an IndexIVF
        idx = inner
    total = 0
    for name in _ARRAYS:
        arr = getattr(idx, name, None)
        if isinstance(arr, torch.Tensor):
            total += arr.nbytes
    state = getattr(getattr(idx, "store", None), "state", None)
    if state is not None:
        total += sum(t.nbytes for t in state if isinstance(t, torch.Tensor))
    return total


class HBMBudget:
    """Shared LRU budget across all registries of a ShardManager.

    ``max_bytes <= 0`` disables enforcement (reference default when
    maxCacheSize is unset).
    """

    def __init__(self, max_bytes: int = 0):
        self.max_bytes = max_bytes
        self._mu = threading.Lock()
        # insertion-ordered dict as LRU: key -> (registry, name)
        self._lru: dict = {}
        self.evictions = 0

    def _key(self, registry: "DeviceRegistry", name: str):
        return (id(registry), name)

    def touch(self, registry: "DeviceRegistry", name: str) -> None:
        if self.max_bytes <= 0:
            return
        with self._mu:
            k = self._key(registry, name)
            self._lru.pop(k, None)
            self._lru[k] = (registry, name)
            self._evict_locked(exclude=k)

    def forget(self, registry: "DeviceRegistry", name: str) -> None:
        if self.max_bytes <= 0:
            return
        with self._mu:
            self._lru.pop(self._key(registry, name), None)

    def _evict_locked(self, exclude) -> None:
        def total() -> int:
            t = 0
            for reg, name in list(self._lru.values()):
                idx = dict.get(reg, name)
                if idx is not None:
                    t += index_nbytes(idx)
            return t

        while total() > self.max_bytes:
            victim = None
            for k in self._lru:  # insertion order = LRU order
                if k != exclude:
                    victim = k
                    break
            if victim is None:
                return  # only the just-touched entry remains; never evict it
            reg, name = self._lru.pop(victim)
            dict.pop(reg, name, None)
            self.evictions += 1


class DeviceRegistry(dict):
    """Per-shard view: dict of bucket name → device index, with lazy reload
    through ``loader`` on miss and LRU budget accounting on access."""

    def __init__(
        self,
        loader: Optional[Callable[[str], object]] = None,
        budget: Optional[HBMBudget] = None,
    ):
        super().__init__()
        self._loader = loader
        self._budget = budget

    def get(self, name: str, default=None):
        idx = dict.get(self, name)
        if idx is None and self._loader is not None:
            idx = self._loader(name)
            if idx is not None:
                self[name] = idx  # routes through __setitem__ → budget
                return idx
        if idx is not None and self._budget is not None:
            self._budget.touch(self, name)
        return idx if idx is not None else default

    def __setitem__(self, name: str, idx) -> None:
        dict.__setitem__(self, name, idx)
        if self._budget is not None:
            self._budget.touch(self, name)

    def clear(self) -> None:
        if self._budget is not None:
            for name in list(self.keys()):
                self._budget.forget(self, name)
        dict.clear(self)
