"""The shard mesh: an ordered tuple of device slots.

Port of ``semadb_tpu/parallel/mesh.py``. The JAX package lays the shards
along one axis of a ``jax.sharding.Mesh`` that a single controller process
owns. The port keeps the single process: a :class:`ShardMesh` is the ordered
list of ``torch.device`` slots a stack's shard views live on, one shard a
slot. No process group is involved; a slot is launched on from the calling
thread, and slots on different cards run at once because nothing on the path
reads back between them.

A device may stand in several slots. On the CPU that is the counterpart of
the JAX tests' 8 virtual CPU devices; on one card it runs the mesh path with
every slot on that card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

SHARD_AXIS = "shard"


@dataclass(frozen=True)
class ShardMesh:
    """Device slots along the shard axis (``SHARD_AXIS``); ``size`` stands
    where the JAX code reads ``mesh.devices.size``."""

    slots: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def first(self) -> torch.device:
        """The slot the cross-shard merge runs on."""
        return self.slots[0]


def shard_mesh(n_devices: int = 0, devices: Optional[Sequence] = None) -> ShardMesh:
    """1-D mesh over the shard axis: by default every visible card (the first
    ``n_devices`` of them when given), else the named ``devices``, which may
    repeat one device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: name the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices:
            devices = devices[:n_devices]
    slots = tuple(torch.device(d) for d in devices)
    if not slots:
        raise ValueError("a shard mesh needs at least one device")
    return ShardMesh(slots)
