"""HTTP v2 API: collection/point handlers.

Port of ``semadb_tpu/httpapi/v2.py``. Creating a collection whose schema
names an index type the port does not serve yet is refused with 400.

Parity reference: httpapi/v2/handlers.go — create/list/get/delete
collection, batch insert (≤10000) / update (≤100) / delete (≤100) points,
search; responses re-inject ``_id``/``_distance``/``_score``/
``_hybridScore`` into the returned documents (handlers.go:461-487).
"""

from __future__ import annotations

import re
import uuid as uuid_mod
from typing import List

from semadb_tpu_torch.cluster.node import ClusterNode
from semadb_tpu_torch.httpapi.middleware import HttpError, RequestContext
from semadb_tpu_torch.index.manager import check_supported
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
    extract_id_field,
)

_ID_RE = re.compile(r"^[A-Za-z0-9]{3,24}$")


class V2Handlers:
    def __init__(self, node: ClusterNode):
        self.node = node

    # -- helpers -----------------------------------------------------------
    def _get_collection(self, ctx: RequestContext) -> Collection:
        col_id = ctx.params["collectionId"]
        try:
            col = self.node.get_collection(ctx.user_id, col_id)
        except NotFoundError:
            raise HttpError(404, f"collection {col_id} not found")
        col.user_plan = ctx.user_plan
        return col

    # -- collections -------------------------------------------------------
    def create_collection(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col_id = body.get("id", "")
        if not _ID_RE.match(col_id or ""):
            raise HttpError(400, "collection id must be alphanumeric, 3-24 chars")
        try:
            schema = IndexSchema.from_dict(body.get("indexSchema") or {})
            schema.validate()
            check_supported(schema)
        except (ValidationError, KeyError, TypeError) as e:
            raise HttpError(400, f"invalid index schema: {e}")
        placement = body.get("shardPlacement", "host")
        if placement not in ("host", "device"):
            raise HttpError(400, "shardPlacement must be 'host' or 'device'")
        col = Collection(
            user_id=ctx.user_id,
            id=col_id,
            index_schema=schema,
            user_plan=ctx.user_plan,
            shard_placement=placement,
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
        return 200, {"collections": [{"id": c.id} for c in cols]}

    def get_collection(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col = self._get_collection(ctx)
        try:
            shards = self.node.get_shards_info(col)
        except ShardUnavailableError as e:
            raise HttpError(503, str(e))
        return 200, {
            "id": col.id,
            "indexSchema": col.index_schema.to_dict(),
            "shards": [{"id": s.id, "pointCount": s.point_count} for s in shards],
        }

    def delete_collection(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col = self._get_collection(ctx)
        self.node.delete_collection(col)
        return 200, {"message": "collection deleted"}

    # -- points ------------------------------------------------------------
    def insert_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        raw_points = body.get("points")
        if not raw_points or len(raw_points) > 10000:
            raise HttpError(400, "points must be 1-10000 items")
        col = self._get_collection(ctx)
        points: List[Point] = []
        for i, pm in enumerate(raw_points):
            pm = dict(pm)
            try:
                pid = extract_id_field(pm, create_new=True)
            except ValidationError as e:
                raise HttpError(400, f"invalid id for point {i}, {e}")
            try:
                col.index_schema.check_compatible_map(pm)
            except ValidationError as e:
                raise HttpError(400, f"invalid point data for point {i}, {e}")
            p = Point.from_map(pm, pid)
            if len(p.data) > ctx.user_plan.max_point_size:
                raise HttpError(400, f"point {i} exceeds max point size")
            points.append(p)
        try:
            failed = self.node.insert_points(col, points)
        except QuotaReachedError:
            raise HttpError(403, "quota reached")
        except ShardUnavailableError as e:
            raise HttpError(503, str(e))
        return 200, {
            "message": "insertion successful" if not failed else "partial success",
            "failedRanges": [f.to_dict() for f in failed],
        }

    def update_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        raw_points = body.get("points")
        if not raw_points or len(raw_points) > 100:
            raise HttpError(400, "points must be 1-100 items")
        col = self._get_collection(ctx)
        points: List[Point] = []
        for i, pm in enumerate(raw_points):
            pm = dict(pm)
            try:
                pid = extract_id_field(pm, create_new=False)
            except ValidationError as e:
                raise HttpError(400, f"invalid id for point {i}, {e}")
            try:
                col.index_schema.check_compatible_map(pm)
            except ValidationError as e:
                raise HttpError(400, f"invalid point data for point {i}, {e}")
            points.append(Point.from_map(pm, pid))
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
        except (ValueError, AttributeError) as e:
            raise HttpError(400, f"invalid uuid: {e}")
        col = self._get_collection(ctx)
        failed = self.node.delete_points(col, parsed)
        return 200, {
            "message": "deletion successful" if not failed else "partial success",
            "failedPoints": [f.to_dict() for f in failed],
        }

    def search_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        col = self._get_collection(ctx)
        try:
            sr = SearchRequest.from_dict(body)
            sr.validate()
            sr.query.validate_schema(col.index_schema)
        except (ValidationError, KeyError, TypeError) as e:
            raise HttpError(400, f"invalid search request: {e}")
        try:
            rows = self.node.search_points_batch_wire(col, [sr])
        except ShardUnavailableError as e:
            raise HttpError(503, str(e))
        return 200, {"points": rows[0]}

    # Batch cap: one [B, D] device dispatch per shard.
    MAX_BATCH_QUERIES = 4096

    def batch_search_points(self, ctx: RequestContext, body: dict) -> tuple[int, dict]:
        """POST .../points/search/batch {"queries": [<search request>...]}.

        Beyond-reference endpoint: N search requests ride ONE RPC per
        shard and (when homogeneous) ONE [B, D] device dispatch per
        shard, instead of N full HTTP→cluster→shard round trips. Response
        order matches request order."""
        col = self._get_collection(ctx)
        reqs = body.get("queries")
        if not isinstance(reqs, list) or not reqs:
            raise HttpError(400, "queries must be a non-empty list")
        if len(reqs) > self.MAX_BATCH_QUERIES:
            raise HttpError(
                400, f"at most {self.MAX_BATCH_QUERIES} queries per batch"
            )
        srs = []
        # Validation memo: serving batches are homogeneous except for the
        # vector payload, and validate()/validate_schema() outcomes depend
        # only on the request SHAPE (property, operator, limits, weight,
        # vector length) — so each distinct shape is validated once per
        # batch instead of once per query. Filters / _and / _or / sort fall
        # back to full per-request validation.
        seen_shapes: set = set()
        try:
            for d in reqs:
                sr = SearchRequest.from_dict(d)
                q = sr.query
                vo = q.vector_flat
                key = None
                if (
                    vo is not None and not q.and_ and not q.or_
                    and vo.filter is None and not sr.sort
                ):
                    key = (
                        q.property, vo.operator, vo.limit, vo.weight,
                        len(vo.vector), sr.offset, sr.limit,
                    )
                if key is None or key not in seen_shapes:
                    sr.validate()
                    sr.query.validate_schema(col.index_schema)
                    if key is not None:
                        seen_shapes.add(key)
                srs.append(sr)
        except (ValidationError, KeyError, TypeError) as e:
            raise HttpError(400, f"invalid search request: {e}")
        try:
            batched = self.node.search_points_batch_wire(col, srs)
        except ShardUnavailableError as e:
            raise HttpError(503, str(e))
        return 200, {"results": [{"points": one} for one in batched]}


def register_routes(router, node: ClusterNode, prefix: str = "/v2"):
    h = V2Handlers(node)
    # /v2/ping (handlers.go:32 handlePing — same payload as v1's)
    router.add(
        "GET", f"{prefix}/ping",
        lambda ctx, body: (200, {"message": "pong from semadb"}),
        auth=False,
    )
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
        "POST",
        f"{prefix}/collections/{{collectionId}}/points/search/batch",
        h.batch_search_points,
    )
    router.add(
        "POST", f"{prefix}/collections/{{collectionId}}/points/search", h.search_points
    )
