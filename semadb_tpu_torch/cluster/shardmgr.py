"""Shard manager: load/unload shards with idle cleanup and backup hooks.

Port of ``semadb_tpu/cluster/shardmgr.py`` over the port's Shard: every
shard it loads puts its device indices on the manager's ``device``. Unlike
the reference, an entry has one idle timer at a time and a cleanup acts
only on the entry whose timer fired: in the reference, two overlapping
requests arm two timers, and both cleanups close the same shard.

Parity reference: cluster/shardmgr.go — DoWithShard(collection, shardId, fn)
loads the shard on demand, holds a read lock during the operation (so a
cleanup can't unload mid-flight), restarts an idle-timeout timer after each
use, and on unload optionally writes a timestamped backup gated by the user
plan (shardmgr.go:59-173; backup: utils/backup.go).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from semadb_tpu_torch.models.collection import Collection
from semadb_tpu_torch.shard.registry import HBMBudget
from semadb_tpu_torch.shard.shard import Shard
from semadb_tpu_torch.store.diskstore import open_store

SHARD_DB_FILE = "sharddb.sdb"


@dataclass
class ManagedShard:
    shard: Shard
    lock: threading.RLock = field(default_factory=threading.RLock)
    timer: Optional[threading.Timer] = None
    last_used: float = 0.0
    in_use: int = 0  # requests holding this shard; guarded by ShardManager._mu
    # Set (under _mu) when an idle-timeout cleanup committed to closing
    # this entry; do_with_shard must then WAIT for closed_ev instead of
    # loading a second Shard on the same store file while the first one
    # is still flushing (close-time compaction of a large shard is slow).
    closing: bool = False
    closed_ev: threading.Event = field(default_factory=threading.Event)


class ShardManager:
    def __init__(
        self,
        root_dir: str,
        device: torch.device,
        shard_timeout: float = 300.0,
        backup_fn: Optional[Callable[[Shard, Collection], None]] = None,
        max_cache_size: int = 0,
    ):
        self.root_dir = root_dir
        self.device = torch.device(device)
        self.shard_timeout = shard_timeout
        self.backup_fn = backup_fn
        self._shards: Dict[str, ManagedShard] = {}
        self._mu = threading.Lock()
        # Shared device-memory budget across all loaded shards' indices
        # (shardmgr.go:46-54 shares one cache.Manager with maxCacheSize).
        self.hbm_budget = HBMBudget(max_cache_size)

    def shard_dir(self, col: Collection, shard_id: str) -> str:
        return os.path.join(self.root_dir, col.user_id, col.id, shard_id)

    def shard_path(self, col: Collection, shard_id: str) -> str:
        return os.path.join(self.shard_dir(col, shard_id), SHARD_DB_FILE)

    def _load(self, col: Collection, shard_id: str) -> ManagedShard:
        path = ""
        if self.root_dir:
            d = self.shard_dir(col, shard_id)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, SHARD_DB_FILE)
        shard = Shard(open_store(path), col, self.device, hbm_budget=self.hbm_budget)
        return ManagedShard(shard=shard, last_used=time.monotonic())

    def do_with_shard(self, col: Collection, shard_id: str, fn: Callable[[Shard], object]):
        """shardmgr.go DoWithShard: load if needed, run under the shard lock,
        reset the cleanup timer.

        The in_use count (incremented under _mu while we still hold the
        entry) closes the race where a fired-but-blocked cleanup timer
        survives cancel(), wins ms.lock after we release _mu, and closes
        the shard under our feet: _cleanup re-checks in_use under _mu and
        skips entries acquired since the timer fired."""
        while True:
            with self._mu:
                ms = self._shards.get(shard_id)
                if ms is None:
                    ms = self._load(col, shard_id)
                    self._shards[shard_id] = ms
                if not ms.closing:
                    if ms.timer is not None:
                        ms.timer.cancel()
                    ms.in_use += 1
                    break
                ev = ms.closed_ev
            # A timeout-unload is mid-close (possibly a multi-minute
            # compaction at scale): wait for it to finish, then reload —
            # two live Shard handles on one store file would race the
            # flush against the fresh load.
            ev.wait()
        try:
            with ms.lock:
                ms.last_used = time.monotonic()
                return fn(ms.shard)
        finally:
            with self._mu:
                ms.in_use -= 1
                if self._shards.get(shard_id) is ms:
                    # One idle timer an entry: a timer left armed by an
                    # overlapping request would fire a second cleanup
                    # that closes the shard twice
                    if ms.timer is not None:
                        ms.timer.cancel()
                    t = threading.Timer(
                        self.shard_timeout, self._cleanup, args=(col, shard_id, ms)
                    )
                    t.daemon = True
                    ms.timer = t
                    t.start()

    def _cleanup(self, col: Collection, shard_id: str, ms: ManagedShard) -> None:
        """Idle unload + backup hook (shardmgr.go cleanupRoutine + backup on
        unload gated by plan, shardmgr.go:134-138) of the entry whose timer
        fired. A timer that fired but lost the race to cancel() finds its
        entry busy, closing, or gone, and does nothing."""
        with self._mu:
            if self._shards.get(shard_id) is not ms or ms.in_use > 0 or ms.closing:
                return  # busy: the active request re-arms the timer on exit
            # Keep the entry visible but marked: a request arriving during
            # the (possibly long) close below waits on closed_ev instead
            # of opening a second store handle on the same file.
            ms.closing = True
        try:
            with ms.lock:
                if self.backup_fn is not None:
                    try:
                        self.backup_fn(ms.shard, col)
                    except Exception:
                        pass
                ms.shard.close()
        finally:
            with self._mu:
                if self._shards.get(shard_id) is ms:
                    self._shards.pop(shard_id)
            ms.closed_ev.set()

    def unload_all(self) -> None:
        with self._mu:
            items = list(self._shards.items())
            self._shards.clear()
        for _, ms in items:
            if ms.closing:
                # A timeout cleanup is already closing it; don't double-close
                ms.closed_ev.wait()
                continue
            if ms.timer is not None:
                ms.timer.cancel()
            with ms.lock:
                ms.shard.close()

    def delete_collection_shards(self, col: Collection) -> list[str]:
        """Unload + remove shard directories for a collection
        (shardmgr.go DeleteCollectionShards:175-249). Returns deleted ids."""
        deleted = []
        base = os.path.join(self.root_dir, col.user_id, col.id) if self.root_dir else None
        # Unload any loaded shards of this collection
        with self._mu:
            for sid in list(self._shards.keys()):
                ms = self._shards[sid]
                if (
                    ms.shard.collection.user_id == col.user_id
                    and ms.shard.collection.id == col.id
                ):
                    if ms.timer is not None:
                        ms.timer.cancel()
                    if not ms.closing:
                        # (a closing entry is being closed by the cleanup
                        # thread, which holds ms.lock — waiting for it
                        # here while holding _mu would deadlock; the
                        # files are removed below regardless)
                        with ms.lock:
                            ms.shard.db.close()
                    del self._shards[sid]
                    deleted.append(sid)
        if base and os.path.isdir(base):
            import shutil

            for sid in os.listdir(base):
                if sid not in deleted:
                    deleted.append(sid)
            shutil.rmtree(base, ignore_errors=True)
        return deleted
