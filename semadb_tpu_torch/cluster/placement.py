"""Shard placement: greedy fill of points into shards.

Parity reference: cluster/placement.go distributePoints — fill existing
shards in order respecting maxShardSize (bytes) and maxShardPointCount,
creating new shards on demand via callback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from semadb_tpu_torch.models.point import Point


@dataclass
class ShardInfo:
    id: str
    size: int = 0
    point_count: int = 0


def distribute_points(
    shards: List[ShardInfo],
    points: List[Point],
    max_shard_size: int,
    max_shard_point_count: int,
    create_shard_fn: Callable[[], str],
) -> Dict[str, Tuple[int, int]]:
    """Returns shardId → [start, end) range into the sorted points list."""
    assignments: Dict[str, Tuple[int, int]] = {}
    shards = list(shards)
    if not shards and points:
        shards.append(ShardInfo(id=create_shard_fn()))
    last = 0
    i = 0
    while i < len(shards):
        shard = shards[i]
        j = last
        running_size = shard.size
        running_count = shard.point_count
        while j < len(points):
            running_size += len(points[j].data) + 16  # uuid bytes
            running_count += 1
            if running_size > max_shard_size or running_count > max_shard_point_count:
                break
            j += 1
        if j > last:
            assignments[shard.id] = (last, j)
        last = j
        if i == len(shards) - 1 and last < len(points):
            shards.append(ShardInfo(id=create_shard_fn()))
        i += 1
    return assignments


def distribute_points_spread(
    shards: List[ShardInfo],
    points: List[Point],
    n_targets: int,
    create_shard_fn: Callable[[], str],
) -> Dict[str, Tuple[int, int]]:
    """Shard-per-device placement (``shardPlacement: "device"`` — beyond
    reference): balance points EVENLY over exactly ``n_targets`` shards so
    every mesh device carries equal search work, instead of the reference's
    fill-first policy (placement.go:9-52) which leaves trailing devices
    empty. Shards missing up to ``n_targets`` are created eagerly; the
    batch is split to equalise final per-shard counts."""
    if not points:
        return {}
    shards = list(shards)
    while len(shards) < max(n_targets, 1):
        shards.append(ShardInfo(id=create_shard_fn()))
    total = sum(s.point_count for s in shards) + len(points)
    target = -(-total // len(shards))  # ceil
    assignments: Dict[str, Tuple[int, int]] = {}
    last = 0
    for shard in shards:
        take = min(max(target - shard.point_count, 0), len(points) - last)
        if take > 0:
            assignments[shard.id] = (last, last + take)
            last += take
        if last == len(points):
            break
    if last < len(points):  # rounding remainder → last shard
        sid = shards[-1].id
        lo, _ = assignments.get(sid, (last, last))
        assignments[sid] = (lo, len(points))
    return assignments
