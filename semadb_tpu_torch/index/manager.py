"""Index manager: schema-driven dispatch of point changes + query execution.

Port of ``semadb_tpu/index/manager.py`` for the index types the port has:
the vector engines ``vectorFlat`` and ``vectorIVF`` (each with or without a
product quantizer), ``vectorFused`` and ``vectorVamana`` (plain, with a
binary or product quantizer, or with the hamming or jaccard metric) on the
device, and the host indices ``text``, ``string``, ``integer``, ``float``
and ``stringArray`` (inverted postings and TF-IDF text over the store). Any
other index type is refused with a ``ValidationError`` that names the
supported ones (:func:`check_supported`, called where a collection is
created and where a shard is opened).

Dispatch: for every schema property, diff the old/new msgpack documents to
classify insert/update/delete/skip, then route the change batch to that
property's index (bucket ``index/<type>/<property>``). Search: ``_and`` /
``_or`` combine child result sets and sum hybrid scores, ``_id`` resolves
UUIDs directly, and vector queries compute their filter subquery first and
hand the allowed-id set to the index as a mask.

Device indices live across transactions in a host-side registry owned by
the Shard; new ones are created on the manager's ``device``. The host
indices are built over their bucket in each transaction; their decoded
postings survive transactions in the Shard's ``host_caches``.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from semadb_tpu_torch.index.flat import IndexFlat
from semadb_tpu_torch.index.fused import FusedHybridIVF
from semadb_tpu_torch.index.inverted import IndexInverted, IndexInvertedArray, PostingsCache
from semadb_tpu_torch.index.ivf import IndexIVF
from semadb_tpu_torch.index.text import IndexText, TextCaches, _doc_codec, _postings_codec
from semadb_tpu_torch.index.vamana import IndexVamana
from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.errors import NotFoundError, ValidationError
from semadb_tpu_torch.models.point import SearchResult, access_nested, decode_point_data
from semadb_tpu_torch.models.query import Query
from semadb_tpu_torch.models.schema import IndexSchema
from semadb_tpu_torch.store.diskstore import BucketManager
from semadb_tpu_torch.utils.itemcache import ItemCache

OP_INSERT = "insert"
OP_UPDATE = "update"
OP_DELETE = "delete"
OP_SKIP = "skip"

# The engine that serves each vector index type: the attribute that holds
# its parameters in the schema entry and its options in a query, and what
# makes the device index from (parameters, device)
_ENGINES = {
    C.INDEX_TYPE_VECTOR_FLAT: ("vector_flat", IndexFlat),
    C.INDEX_TYPE_VECTOR_IVF: ("vector_ivf", IndexIVF),
    C.INDEX_TYPE_VECTOR_FUSED: ("vector_fused", FusedHybridIVF.from_params),
    C.INDEX_TYPE_VECTOR_VAMANA: ("vector_vamana", IndexVamana),
}
VECTOR_INDEX_TYPES = tuple(_ENGINES)
# The host index types (no device state): the attribute of a query that
# holds a type's options. string, integer and float name their
# IndexInverted kind too.
_HOST_TYPES = {
    C.INDEX_TYPE_TEXT: "text",
    C.INDEX_TYPE_STRING: "string",
    C.INDEX_TYPE_INTEGER: "integer",
    C.INDEX_TYPE_FLOAT: "float_",
    C.INDEX_TYPE_STRING_ARRAY: "string_array",
}
SUPPORTED_INDEX_TYPES = VECTOR_INDEX_TYPES + tuple(_HOST_TYPES)


def check_supported(schema: IndexSchema) -> None:
    """Refuse a schema the port cannot serve yet, naming what is missing."""
    for prop, params in schema.items():
        if params.type in _HOST_TYPES:
            continue
        if params.type not in VECTOR_INDEX_TYPES:
            raise ValidationError(
                f"index type {params.type} (property {prop}) is not supported by "
                f"semadb_tpu_torch yet; supported: {', '.join(SUPPORTED_INDEX_TYPES)}"
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
        host_caches: Dict[str, object],
    ):
        self.bm = bm
        self.schema = schema
        self.devices = device_registry  # bucket_name → IndexFlat | IndexIVF | FusedHybridIVF | IndexVamana
        self.device = torch.device(device)
        # bucket_name → PostingsCache | TextCaches: decoded postings owned by
        # the Shard, which outlive this per-transaction manager
        self.host_caches = host_caches

    def _postings_cache(self, bucket_name: str):
        cache = self.host_caches.get(bucket_name)
        if cache is None:
            cache = self.host_caches[bucket_name] = PostingsCache()
        return cache

    def _text_cache(self, bucket_name: str, bucket):
        cache = self.host_caches.get(bucket_name)
        if cache is None:
            cache = self.host_caches[bucket_name] = TextCaches(
                postings=ItemCache(bucket, _postings_codec()),
                docs=ItemCache(bucket, _doc_codec()),
            )
        return cache

    def _host_index(self, prop: str, params):
        """The text or inverted index of a property over its bucket."""
        name = self.bucket_name(params.type, prop)
        bucket = self.bm.get(name)
        if params.type == C.INDEX_TYPE_TEXT:
            return IndexText(bucket, params.text.analyser, cache=self._text_cache(name, bucket))
        cache = self._postings_cache(name)
        if params.type == C.INDEX_TYPE_STRING_ARRAY:
            case_sensitive = params.string_array.case_sensitive if params.string_array else False
            return IndexInvertedArray(bucket, case_sensitive, cache=cache)
        case_sensitive = params.string.case_sensitive if params.type == C.INDEX_TYPE_STRING and params.string else True
        return IndexInverted(bucket, params.type, case_sensitive, cache=cache)

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
                per_property.setdefault(prop, []).append((ch.node_id, prev, cur, op))
        device_deltas: Dict[str, list] = {}
        for prop, items in per_property.items():
            params = self.schema.get(prop)
            if params.type in _HOST_TYPES:
                self._dispatch_host(prop, params, items)
                continue
            idx = self._device_index(prop, params, register=True)
            if params.type == C.INDEX_TYPE_VECTOR_FUSED:
                # Wire format: the views concatenated into one flat f32 row
                # (journal-compatible; fused.py _split_flat)
                delta = [
                    (nid, np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in cur])
                     if op != OP_DELETE else None)
                    for nid, _, cur, op in items
                ]
            else:
                delta = [
                    (nid, np.asarray(cur, np.float32) if op != OP_DELETE else None)
                    for nid, _, cur, op in items
                ]
            idx.insert_update_delete(delta)
            device_deltas[self.bucket_name(params.type, prop)] = delta
        return device_deltas

    def _dispatch_host(self, prop: str, params, items: list) -> None:
        """Apply one property's changes to its text or inverted index. An
        inverted index finds the postings to leave by the old value; the
        text index keeps each document's terms itself."""
        idx = self._host_index(prop, params)
        by_value = params.type != C.INDEX_TYPE_TEXT
        for nid, prev, cur, op in items:
            key = (nid, prev) if by_value else (nid,)
            if op == OP_INSERT:
                idx.insert(nid, cur)
            elif op == OP_UPDATE:
                idx.update(*key, cur)
            else:
                idx.delete(*key)
        idx.flush()  # cached mutations persist once per batch

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
        if params.type in _HOST_TYPES:
            return self._search_host(q, params)
        opts = _vector_options(params, q)
        if opts is None:
            raise ValidationError(f"search not supported for type {params.type}")
        filter_set = None
        if opts.filter is not None:
            filter_set, _ = self.search(opts.filter)
        idx = self._device_index(q.property, params)
        d, i = self._index_search(idx, opts, [opts], filter_set)
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

    def _search_host(self, q: Query, params) -> Tuple[Set[int], List[SearchResult]]:
        """A text search (scored results, after its own filter) or an
        inverted-index lookup (a set of node ids, no results)."""
        opts = getattr(q, _HOST_TYPES[params.type])
        if opts is None:
            raise ValidationError(f"a query on {q.property} needs {params.type} options")
        idx = self._host_index(q.property, params)
        if params.type == C.INDEX_TYPE_TEXT:
            filter_set = None if opts.filter is None else self.search(opts.filter)[0]
            return idx.search(opts, filter_set)
        if params.type == C.INDEX_TYPE_STRING_ARRAY:
            return idx.search(opts.value, opts.operator), []
        return idx.search(opts.value, opts.end_value, opts.operator), []

    def _index_search(self, idx, opts, opts_list: list, filter_set: Optional[Set[int]]):
        """One search call on a vector index for the queries of
        ``opts_list``, with the shared options ``opts`` (the flat index
        ignores the probe count; a fused index takes one batch a view and
        the per-view weights)."""
        fm = self._filter_mask(idx, filter_set)
        probes = getattr(opts, "num_probes", 0)
        if isinstance(idx, FusedHybridIVF):
            qviews = [
                np.stack([np.asarray(o.vectors[v], np.float32) for o in opts_list])
                for v in range(len(opts.vectors))
            ]
            return idx.search_batch(qviews, opts.limit, weights=opts.weights, num_probes=probes, filter_mask=fm)
        vecs = np.stack([np.asarray(o.vector, np.float32) for o in opts_list])
        if isinstance(idx, IndexVamana):
            return idx.search_batch(vecs, k=opts.limit, search_size=opts.search_size, filter_mask=fm)
        return idx.search_batch(vecs, k=opts.limit, num_probes=probes, filter_mask=fm)

    @staticmethod
    def _filter_mask(idx, filter_set: Optional[Set[int]]) -> Optional[np.ndarray]:
        if filter_set is None:
            return None
        ids = np.fromiter(filter_set, np.int64, len(filter_set))
        mask = np.zeros(idx.capacity, bool)
        mask[ids[ids < idx.capacity]] = True
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
        d, i = self._index_search(idx, o0, opts_list, filter_set)
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
                and getattr(o, "search_size", 0) == getattr(o0, "search_size", 0)
                and getattr(o, "weights", None) == getattr(o0, "weights", None)
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


# Last: the shard package imports this module, so importing it before the
# names above exist would fail when this module is imported first (the JAX
# package's manager has that cycle)
from semadb_tpu_torch.shard import pointstore  # noqa: E402
