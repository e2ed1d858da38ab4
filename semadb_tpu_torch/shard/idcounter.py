"""Persistent node-id allocator with free-list reuse.

Parity reference: shard/idcounter.go — recycled ids keep the id space
compact, which is what lets the device side use node ids directly as dense
array row indices (graph.py). Ids 0 (nil) and 1 (graph start) are reserved.
"""

from __future__ import annotations

import struct
from typing import List

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.store.diskstore import Bucket

FREE_IDS_KEY = b"freeNodeIds"
NEXT_FREE_ID_KEY = b"nextFreeNodeId"


class IdCounter:
    def __init__(self, bucket: Bucket):
        self._bucket = bucket
        raw = bucket.get(FREE_IDS_KEY)
        self._free: List[int] = (
            list(struct.unpack(f"<{len(raw)//8}Q", raw)) if raw else []
        )
        raw_next = bucket.get(NEXT_FREE_ID_KEY)
        # First user id is 2 (idcounter.go:11-23: 0 nil, 1 start node)
        self._next = struct.unpack("<Q", raw_next)[0] if raw_next else C.START_NODE_ID + 1
        self._dirty = False

    def max_id(self) -> int:
        return self._next - 1

    def next_id(self) -> int:
        self._dirty = True
        if self._free:
            return self._free.pop()
        nid = self._next
        self._next += 1
        return nid

    def free_id(self, node_id: int) -> None:
        self._dirty = True
        self._free.append(node_id)

    def flush(self) -> None:
        if not self._dirty:
            return
        self._bucket.put(FREE_IDS_KEY, struct.pack(f"<{len(self._free)}Q", *self._free))
        self._bucket.put(NEXT_FREE_ID_KEY, struct.pack("<Q", self._next))
        self._dirty = False
