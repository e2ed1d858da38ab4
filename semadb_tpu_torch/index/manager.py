"""Index manager: schema-driven dispatch of point changes + query execution.

Port of ``semadb_tpu/index/manager.py`` for the index types the port has:
``vectorFlat`` and ``vectorIVF``. A schema naming any other index type, or a
product quantizer, is refused with a ``ValidationError`` that names it
(:func:`check_supported`, called where a collection is created and where a
shard is opened).

Dispatch: for every schema property, diff the old/new msgpack documents to
classify insert/update/delete/skip, then route the change batch to that
property's index (bucket ``index/<type>/<property>``). Search: ``_and`` /
``_or`` combine child result sets and sum hybrid scores, ``_id`` resolves
UUIDs directly, and vector queries compute their filter subquery first and
hand the allowed-id set to the index as a mask.

Device indices live across transactions in a host-side registry owned by
the Shard; new ones are created on the manager's ``device``.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.errors import NotFoundError, ValidationError
from semadb_tpu_torch.models.point import SearchResult, access_nested, decode_point_data
from semadb_tpu_torch.models.query import Query
from semadb_tpu_torch.models.schema import IndexSchema
from semadb_tpu_torch.shard import pointstore
from semadb_tpu_torch.store.diskstore import BucketManager
from semadb_tpu_torch.vectorstore import PRODUCT, QuantConfig

OP_INSERT = "insert"
OP_UPDATE = "update"
OP_DELETE = "delete"
OP_SKIP = "skip"

# The engine that serves each vector index type: the attribute that holds
# its parameters in the schema entry and its options in a query, and the
# device index class
_ENGINES = {
    C.INDEX_TYPE_VECTOR_FLAT: ("vector_flat", IndexFlat),
    C.INDEX_TYPE_VECTOR_IVF: ("vector_ivf", IndexIVF),
}
SUPPORTED_INDEX_TYPES = tuple(_ENGINES)


def check_supported(schema: IndexSchema) -> None:
    """Refuse a schema the port cannot serve yet, naming what is missing."""
    for prop, params in schema.items():
        if params.type not in SUPPORTED_INDEX_TYPES:
            raise ValidationError(
                f"index type {params.type} (property {prop}) is not supported by "
                f"semadb_tpu_torch yet; supported: {', '.join(SUPPORTED_INDEX_TYPES)}"
            )
        p = _vector_params(params)
        cfg = QuantConfig.from_params(p.quantizer, p.vector_size, p.distance_metric)
        if cfg.kind == PRODUCT:
            raise ValidationError(
                f"product quantizer on {params.type} (property {prop}) is not supported by "
                "semadb_tpu_torch yet"
            )


def _vector_params(params):
    """The engine parameters of a vector index's schema entry."""
    return getattr(params, _ENGINES[params.type][0])


def _vector_options(params, q: Query):
    """The query options for a vector index's type (None when absent)."""
    engine = _ENGINES.get(params.type)
    return None if engine is None else getattr(q, engine[0])


def _filters_equal(a, b) -> bool:
    """Structural equality of two optional filter Query trees, tolerant of
    ndarray vector fields: an ambiguous comparison means the batch falls
    back to the per-query path — correct, only slower."""
    if a is None or b is None:
        return a is b
    try:
        return bool(a == b)
    except ValueError:
        return False


def get_operation(prop: str, prev_data: Optional[bytes], new_data: Optional[bytes]):
    """(prev_value, new_value, op) for one property."""
    prev = access_nested(decode_point_data(prev_data), prop) if prev_data else None
    cur = access_nested(decode_point_data(new_data), prop) if new_data else None
    if prev is None and cur is not None:
        return prev, cur, OP_INSERT
    if prev is not None and cur is not None:
        return prev, cur, OP_UPDATE
    if prev is not None and cur is None:
        return prev, cur, OP_DELETE
    return prev, cur, OP_SKIP


class IndexPointChange:
    __slots__ = ("node_id", "previous_data", "new_data")

    def __init__(self, node_id: int, previous_data: Optional[bytes], new_data: Optional[bytes]):
        self.node_id = node_id
        self.previous_data = previous_data
        self.new_data = new_data


class IndexManager:
    def __init__(
        self,
        bm: BucketManager,
        schema: IndexSchema,
        device_registry: Dict[str, object],
        device: torch.device,
    ):
        self.bm = bm
        self.schema = schema
        self.devices = device_registry  # bucket_name → IndexFlat | IndexIVF
        self.device = torch.device(device)

    @staticmethod
    def bucket_name(itype: str, prop: str) -> str:
        return f"index/{itype}/{prop}"

    def _device_index(self, prop: str, params, register: bool = False):
        """The device index of a property (``params``: its schema entry),
        created on the manager's device when there is none."""
        name = self.bucket_name(params.type, prop)
        idx = self.devices.get(name)
        if idx is None:
            idx = _ENGINES[params.type][1](_vector_params(params), self.device)
            # Only the write path registers new indices: a search racing a
            # scrap-and-reload must not shadow the reloaded index.
            if register:
                self.devices[name] = idx
        return idx

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, changes: List[IndexPointChange]) -> Dict[str, list]:
        """Route changes to per-property indices. Returns the device-index
        deltas applied ({bucket_name: [(node_id, vector|None), ...]}) so the
        caller can journal them in the same store txn."""
        per_property: Dict[str, list] = {}
        for ch in changes:
            for prop, _ in self.schema.items():
                prev, cur, op = get_operation(prop, ch.previous_data, ch.new_data)
                if op == OP_SKIP:
                    continue
                per_property.setdefault(prop, []).append((ch.node_id, cur, op))
        device_deltas: Dict[str, list] = {}
        for prop, items in per_property.items():
            params = self.schema.get(prop)
            idx = self._device_index(prop, params, register=True)
            delta = [
                (nid, np.asarray(cur, np.float32) if op != OP_DELETE else None)
                for nid, cur, op in items
            ]
            idx.insert_update_delete(delta)
            device_deltas[self.bucket_name(params.type, prop)] = delta
        return device_deltas

    # -- search ------------------------------------------------------------
    def search(self, q: Query) -> Tuple[Set[int], List[SearchResult]]:
        if q.property == "_and":
            return self._search_combined(q.and_, disjunction=False)
        if q.property == "_or":
            return self._search_combined(q.or_, disjunction=True)
        if q.property == "_id":
            return self._search_by_id(q)
        params = self.schema.get(q.property)
        if params is None:
            raise ValidationError(f"property {q.property} not found in index schema")
        opts = _vector_options(params, q)
        if opts is None:
            raise ValidationError(f"search not supported for type {params.type}")
        filter_set = None
        if opts.filter is not None:
            filter_set, _ = self.search(opts.filter)
        idx = self._device_index(q.property, params)
        d, i = self._index_search(
            idx, opts, np.asarray(opts.vector, np.float32)[None, :], filter_set
        )
        w = opts.weight if opts.weight is not None else 1.0
        rset: Set[int] = set()
        results: List[SearchResult] = []
        for dist, nid in zip(d[0], i[0]):
            if nid < 0 or not np.isfinite(dist):
                continue
            rset.add(int(nid))
            results.append(
                SearchResult(
                    point=None, node_id=int(nid), distance=float(dist),
                    hybrid_score=-float(dist) * w,
                )
            )
        return rset, results

    def _index_search(self, idx, opts, vecs: np.ndarray, filter_set: Optional[Set[int]]):
        """One search call on a vector index (the flat index ignores the
        probe count)."""
        fm = self._filter_mask(idx, filter_set)
        probes = getattr(opts, "num_probes", 0)
        return idx.search_batch(vecs, k=opts.limit, num_probes=probes, filter_mask=fm)

    @staticmethod
    def _filter_mask(idx, filter_set: Optional[Set[int]]) -> Optional[np.ndarray]:
        if filter_set is None:
            return None
        mask = np.zeros(idx.capacity, bool)
        mask[[i for i in filter_set if i < idx.capacity]] = True
        return mask

    def search_batch(self, queries: List[Query]) -> List[Tuple[Set[int], List[SearchResult]]]:
        """Batched search: ONE device dispatch for a homogeneous query
        list, per-query fallback otherwise."""
        if len(queries) == 1:
            return [self.search(queries[0])]
        arrs = self.search_batch_arrays(queries)
        if arrs is None:
            return [self.search(q) for q in queries]
        d_host, i_host, valid, w = arrs
        out: List[Tuple[Set[int], List[SearchResult]]] = []
        for db, ib, vb in zip(d_host.tolist(), i_host.tolist(), valid.tolist()):
            results = [
                SearchResult(point=None, node_id=nid, distance=dist, hybrid_score=-dist * w)
                for dist, nid, ok in zip(db, ib, vb)
                if ok
            ]
            out.append(({r.node_id for r in results}, results))
        return out

    def search_batch_arrays(self, queries: List[Query]):
        """Array core of :meth:`search_batch`: ``(d f32[B,K], i i32[B,K],
        valid bool[B,K], weight)`` host arrays for a homogeneous vector
        batch, or None when no batch plan applies. The id-only serving path
        (Shard.search_points_batch_wire) consumes the arrays directly."""
        plan = self._batch_plan(queries)
        if plan is None:
            return None
        prop, params, opts_list = plan
        o0 = opts_list[0]
        filter_set = None
        if o0.filter is not None:
            filter_set, _ = self.search(o0.filter)
        idx = self._device_index(prop, params)
        vecs = np.stack([np.asarray(o.vector, np.float32) for o in opts_list])
        d, i = self._index_search(idx, o0, vecs, filter_set)
        valid = (i >= 0) & np.isfinite(d)
        w = o0.weight if o0.weight is not None else 1.0
        return d, i, valid, w

    def _batch_plan(self, queries: List[Query]):
        """(property, params, [opts]) when every query hits the same vector
        index with equal non-vector options; None otherwise."""
        q0 = queries[0]
        if q0.property in ("_and", "_or", "_id"):
            return None
        params = self.schema.get(q0.property)
        if params is None or _vector_options(params, q0) is None:
            return None
        o0 = _vector_options(params, q0)
        opts_list = []
        for q in queries:
            o = _vector_options(params, q)
            if q.property != q0.property or o is None:
                return None
            if not (
                o.limit == o0.limit
                and o.weight == o0.weight
                and _filters_equal(o.filter, o0.filter)
                and getattr(o, "num_probes", 0) == getattr(o0, "num_probes", 0)
            ):
                return None
            opts_list.append(o)
        return q0.property, params, opts_list

    def _search_by_id(self, q: Query) -> Tuple[Set[int], List[SearchResult]]:
        """Direct UUID → node id lookup; malformed or missing ids match
        nothing."""
        bucket = self.bm.get(pointstore.POINTS_BUCKET_NAME)
        if q.string is not None:
            if q.string.operator != C.OPERATOR_EQUALS:
                raise ValidationError("only equals operator supported for _id")
            ids = [q.string.value]
        elif q.string_array is not None:
            if q.string_array.operator != C.OPERATOR_CONTAINS_ANY:
                raise ValidationError("only containsAny operator supported for _id")
            ids = q.string_array.value
        else:
            raise ValidationError("only string/stringArray queries supported for _id")
        rset: Set[int] = set()
        for v in ids:
            try:
                rset.add(pointstore.get_point_node_id_by_uuid(bucket, uuid_mod.UUID(v)))
            except (ValueError, NotFoundError):
                continue
        return rset, []

    def _search_combined(self, queries: List[Query], disjunction: bool):
        """AND/OR the children's sets and dedup results, summing hybrid
        scores; results merge in query order (deterministic)."""
        outs = [self.search(sub) for sub in queries]
        if len(outs) == 1:
            return outs[0]
        final: Set[int] = set(outs[0][0])
        for s, _ in outs[1:]:
            final = (final | s) if disjunction else (final & s)
        merged: Dict[int, SearchResult] = {}
        order: List[int] = []
        for _, results in outs:
            for r in results:
                if not disjunction and r.node_id not in final:
                    continue
                if r.node_id not in merged:
                    merged[r.node_id] = r
                    order.append(r.node_id)
                else:
                    m = merged[r.node_id]
                    m.hybrid_score += r.hybrid_score
                    if m.distance is None and r.distance is not None:
                        m.distance = r.distance
                    if m.score is None and r.score is not None:
                        m.score = r.score
        return final, sorted((merged[n] for n in order), key=lambda r: -r.hybrid_score)
