"""Point data model: user-facing maps and internal msgpack-encoded points.

Parity reference: models/point.go (Point, PointAsMap, ExtractIdField,
GetField).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any

import msgpack

from semadb_tpu_torch.models.errors import ValidationError

# User-facing point type: arbitrary JSON-like dict ("PointAsMap").
PointAsMap = dict


def extract_id_field(point_map: dict, create_new: bool) -> uuid.UUID:
    """Pop and parse the ``_id`` field; mint a fresh UUID when allowed.

    Mirrors models/point.go:16-37: the ``_id`` key is removed from the map
    because it is internal metadata, not point data.
    """
    if "_id" not in point_map:
        if create_new:
            return uuid.uuid4()
        raise ValidationError("missing _id field")
    raw = point_map.pop("_id")
    if not isinstance(raw, str):
        raise ValidationError(f"invalid id type, expected string got {type(raw).__name__}")
    try:
        return uuid.UUID(raw)
    except ValueError as e:
        raise ValidationError(f"invalid id format, {e}") from e


@dataclass
class Point:
    """Internal point: UUID + msgpack-encoded data blob.

    Reference: models/point.go:41-45. Keeping the data opaque (bytes) lets
    the shard store/ship documents without decoding, exactly like the
    reference; vector extraction happens once at index-dispatch time.
    """

    id: uuid.UUID
    data: bytes = b""

    @classmethod
    def from_map(cls, point_map: dict, point_id: uuid.UUID) -> "Point":
        return cls(id=point_id, data=encode_point_data(point_map))

    def as_map(self) -> dict:
        return decode_point_data(self.data)

    def get_field(self, name: str) -> Any:
        """Fetch one (possibly nested ``a.b.c``) field from the encoded data.

        Reference: models/point.go:47-56 uses msgpack streaming query; here
        we decode once — documents are small (MaxPointSize quota).
        """
        return access_nested(self.as_map(), name)


def encode_point_data(point_map: dict) -> bytes:
    return msgpack.packb(point_map, use_bin_type=True)


def decode_point_data(data: bytes) -> dict:
    if not data:
        return {}
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


def access_nested(m: Any, prop: str) -> Any:
    """Access a nested property like ``a.b.c``; None when missing.

    Reference: utils/compare.go AccessNestedProperty (compare.go:12-35).
    """
    parts = prop.split(".")
    cur = m
    for part in parts:
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


@dataclass
class SearchResult:
    """Ordered search result (reference: models/search.go SearchResult).

    ``distance`` comes from vector indices (lower is better), ``score`` from
    generic indices (higher is better), ``hybrid_score`` is the combined
    weighted value used for final ordering.
    """

    point: Point
    node_id: int = 0
    decoded_data: dict | None = None
    distance: float | None = None
    score: float | None = None
    hybrid_score: float = 0.0
    # Populated by the shard final-stage for user response
    extra: dict = field(default_factory=dict)

    def to_user_dict(self) -> dict:
        out = dict(self.decoded_data if self.decoded_data is not None else self.point.as_map())
        out["_id"] = str(self.point.id)
        if self.distance is not None:
            out["_distance"] = self.distance
        if self.score is not None:
            out["_score"] = self.score
        out["_hybridScore"] = self.hybrid_score
        return out


def result_doc(r: SearchResult) -> dict:
    """Wire/user document for a search result — the reference's response
    shape (handlers.go:461-487): data fields re-injected with ``_id`` /
    ``_distance`` / ``_score`` / ``_hybridScore`` metadata. Tolerates a
    missing point (id-only results mid-pipeline). The id-only serving
    fast path (Shard.search_points_batch_wire) emits this shape directly
    from arrays; this function is the object-path equivalent."""
    doc = (
        dict(r.decoded_data)
        if r.decoded_data is not None
        else (r.point.as_map() if r.point is not None and r.point.data else {})
    )
    if r.point is not None:
        doc["_id"] = str(r.point.id)
    if r.distance is not None:
        doc["_distance"] = r.distance
    if r.score is not None:
        doc["_score"] = r.score
    doc["_hybridScore"] = r.hybrid_score
    return doc
