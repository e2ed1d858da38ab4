"""HTTP v1 API: legacy pure-vector collections.

Parity reference: httpapi/v1/handlers.go — collections carry only
vectorSize + distanceMetric; internally wrapped as a fixed vamana schema on
property "vector" with searchSize 75 / degreeBound 64 / alpha 1.2
(v1/handlers.go:89-109, 545-556); points are {id?, vector, metadata}.
"""

from __future__ import annotations

import re
import uuid as uuid_mod

from semadb_tpu_torch.cluster.node import ClusterNode
from semadb_tpu_torch.httpapi.middleware import HttpError, RequestContext
from semadb_tpu_torch.models import (
    Collection,
    ExistsError,
    IndexSchema,
    NotFoundError,
    Point,
    QuotaReachedError,
    SearchRequest,
    ShardUnavailableError,
    ValidationError,
)

_ID_RE = re.compile(r"^[A-Za-z0-9]{3,16}$")
V1_METRICS = ("euclidean", "cosine", "dot")


def v1_schema(vector_size: int, distance_metric: str) -> IndexSchema:
    """Fixed vamana schema wrap (v1/handlers.go:545-556)."""
    return IndexSchema.from_dict(
        {
            "vector": {
                "type": "vectorVamana",
                "vectorVamana": {
                    "vectorSize": vector_size,
                    "distanceMetric": distance_metric,
                    "searchSize": 75,
                    "degreeBound": 64,
                    "alpha": 1.2,
                },
            }
        }
    )


class V1Handlers:
    def __init__(self, node: ClusterNode):
        self.node = node

    def _get_collection(self, ctx: RequestContext) -> Collection:
        col_id = ctx.params["collectionId"]
        try:
            col = self.node.get_collection(ctx.user_id, col_id)
        except NotFoundError:
            raise HttpError(404, f"collection {col_id} not found")
        col.user_plan = ctx.user_plan
        return col

    @staticmethod
    def _v1_params(col: Collection):
        p = col.index_schema.get("vector")
        return p.vector_vamana

    def ping(self, ctx, body) -> tuple[int, dict]:
        return 200, {"message": "pong from semadb"}

    def create_collection(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col_id = body.get("id", "")
        if not _ID_RE.match(col_id or ""):
            raise HttpError(400, "collection id must be alphanumeric, 3-16 chars")
        vector_size = int(body.get("vectorSize", 0))
        metric = body.get("distanceMetric", "")
        if metric not in V1_METRICS:
            raise HttpError(400, f"distanceMetric must be one of {V1_METRICS}")
        if not (1 <= vector_size <= 2000):
            raise HttpError(400, "vectorSize must be 1-2000")
        col = Collection(
            user_id=ctx.user_id,
            id=col_id,
            index_schema=v1_schema(vector_size, metric),
            user_plan=ctx.user_plan,
        )
        try:
            self.node.create_collection(col)
        except QuotaReachedError:
            raise HttpError(403, "quota reached")
        except ExistsError:
            raise HttpError(409, "collection exists")
        return 200, {"message": "collection created"}

    def list_collections(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        cols = self.node.list_collections(ctx.user_id)
        out = []
        for c in cols:
            p = self._v1_params(c) if "vector" in c.index_schema else None
            if p is None:
                continue  # v2 collections not visible through v1
            out.append(
                {
                    "id": c.id,
                    "vectorSize": p.vector_size,
                    "distanceMetric": p.distance_metric,
                }
            )
        return 200, {"collections": out}

    def get_collection(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col = self._get_collection(ctx)
        p = self._v1_params(col)
        try:
            shards = self.node.get_shards_info(col)
        except ShardUnavailableError as e:
            raise HttpError(503, str(e))
        return 200, {
            "id": col.id,
            "vectorSize": p.vector_size,
            "distanceMetric": p.distance_metric,
            "shards": [{"id": s.id, "pointCount": s.point_count} for s in shards],
        }

    def delete_collection(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col = self._get_collection(ctx)
        self.node.delete_collection(col)
        return 200, {"message": "collection deleted"}

    def _to_point(self, pm: dict, col: Collection, i: int, require_id: bool) -> Point:
        pid_raw = pm.get("id")
        if pid_raw:
            try:
                pid = uuid_mod.UUID(pid_raw)
            except ValueError as e:
                raise HttpError(400, f"invalid id for point {i}, {e}")
        elif require_id:
            raise HttpError(400, f"missing id for point {i}")
        else:
            pid = uuid_mod.uuid4()
        data = {"vector": pm.get("vector")}
        if pm.get("metadata") is not None:
            data["metadata"] = pm["metadata"]
        try:
            col.index_schema.check_compatible_map(data)
        except ValidationError as e:
            raise HttpError(400, f"invalid point data for point {i}, {e}")
        return Point.from_map(data, pid)

    def insert_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        raw = body.get("points")
        if not raw or len(raw) > 10000:
            raise HttpError(400, "points must be 1-10000 items")
        col = self._get_collection(ctx)
        points = [self._to_point(pm, col, i, False) for i, pm in enumerate(raw)]
        try:
            failed = self.node.insert_points(col, points)
        except QuotaReachedError:
            raise HttpError(403, "quota reached")
        return 200, {
            "message": "insertion successful" if not failed else "partial success",
            "failedRanges": [f.to_dict() for f in failed],
        }

    def update_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        raw = body.get("points")
        if not raw or len(raw) > 100:
            raise HttpError(400, "points must be 1-100 items")
        col = self._get_collection(ctx)
        points = [self._to_point(pm, col, i, True) for i, pm in enumerate(raw)]
        failed = self.node.update_points(col, points)
        return 200, {
            "message": "update successful" if not failed else "partial success",
            "failedPoints": [f.to_dict() for f in failed],
        }

    def delete_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        ids = body.get("ids")
        if not ids or len(ids) > 100:
            raise HttpError(400, "ids must be 1-100 items")
        try:
            parsed = [uuid_mod.UUID(i) for i in ids]
        except ValueError as e:
            raise HttpError(400, f"invalid uuid: {e}")
        col = self._get_collection(ctx)
        failed = self.node.delete_points(col, parsed)
        return 200, {
            "message": "deletion successful" if not failed else "partial success",
            "failedPoints": [f.to_dict() for f in failed],
        }

    def search_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        vector = body.get("vector")
        if not vector or len(vector) > 2000:
            raise HttpError(400, "vector must be 1-2000 floats")
        limit = int(body.get("limit") or 10)
        col = self._get_collection(ctx)
        sr = SearchRequest.from_dict(
            {
                "query": {
                    "property": "vector",
                    "vectorVamana": {
                        "vector": vector,
                        "operator": "near",
                        "searchSize": 75,
                        "limit": max(min(limit, 75), 1),
                    },
                },
                "limit": max(min(limit, 75), 1),
                # handlers.go:555 — v1 selects metadata explicitly; without
                # a select, the shard returns id/distance only.
                "select": ["metadata"],
            }
        )
        try:
            sr.query.validate_schema(col.index_schema)
        except ValidationError as e:
            raise HttpError(400, str(e))
        results = self.node.search_points(col, sr)
        out = []
        for r in results:
            m = r.decoded_data if r.decoded_data is not None else (
                r.point.as_map() if r.point is not None else {}
            )
            out.append(
                {
                    "id": str(r.point.id) if r.point else "",
                    "distance": r.distance,
                    "metadata": m.get("metadata"),
                }
            )
        return 200, {"points": out}


def register_routes(router, node: ClusterNode, prefix: str = "/v1"):
    h = V1Handlers(node)
    router.add("GET", f"{prefix}/ping", h.ping, auth=False)
    router.add("GET", f"{prefix}/collections", h.list_collections)
    router.add("POST", f"{prefix}/collections", h.create_collection)
    router.add("GET", f"{prefix}/collections/{{collectionId}}", h.get_collection)
    router.add("DELETE", f"{prefix}/collections/{{collectionId}}", h.delete_collection)
    router.add("POST", f"{prefix}/collections/{{collectionId}}/points", h.insert_points)
    router.add("PUT", f"{prefix}/collections/{{collectionId}}/points", h.update_points)
    router.add(
        "DELETE", f"{prefix}/collections/{{collectionId}}/points", h.delete_points
    )
    router.add(
        "POST", f"{prefix}/collections/{{collectionId}}/points/search", h.search_points
    )
