"""Search query AST and request models.

Parity reference: models/search.go (SearchRequest, Query, per-type search
options, SortOption) including validation and schema validation semantics.
"""

from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import List, Optional

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.errors import ValidationError


def decode_vector(v):
    """Accept a query vector as a JSON/msgpack float list OR packed
    little-endian f32 bytes (msgpack ``bin``). The packed form is the
    fast wire encoding for batched search: 1024 x 128-d query vectors
    decode with one ``frombuffer`` instead of 131k float boxes
    (beyond-reference; the reference only takes float arrays,
    models/search.go). The packed path keeps the numpy array end to
    end — ``np.asarray``/``np.stack`` on it is free, where a per-query
    list→array conversion measured ~0.2 ms on the 1-vCPU serving host
    (the dominant host cost of a 1024-query batch call)."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        import numpy as _np

        return _np.frombuffer(bytes(v), dtype="<f4")
    return list(v)


@dataclass
class SortOption:
    """Reference: models/search.go SortOption."""

    property: str
    descending: bool = False

    def validate(self) -> None:
        if not self.property:
            raise ValidationError("sorting property cannot be empty")

    @classmethod
    def from_dict(cls, d: dict) -> "SortOption":
        return cls(property=d["property"], descending=bool(d.get("descending", False)))


@dataclass
class VectorVamanaOptions:
    """Reference: models/search.go SearchVectorVamanaOptions."""

    vector: list
    operator: str = C.OPERATOR_NEAR
    search_size: int = 75
    limit: int = 10
    filter: Optional["Query"] = None
    weight: Optional[float] = None

    def validate(self) -> None:
        if not (1 <= len(self.vector) <= 4096):
            raise ValidationError(
                f"query vector length must be between 1 and 4096, got {len(self.vector)}"
            )
        if self.operator != C.OPERATOR_NEAR:
            raise ValidationError(
                f"invalid operator {self.operator} for vector query, expected {C.OPERATOR_NEAR}"
            )
        if not (25 <= self.search_size <= 75):
            raise ValidationError(
                f"invalid searchSize {self.search_size} for vector query, expected 25-75"
            )
        if not (1 <= self.limit <= 75):
            raise ValidationError(f"invalid limit {self.limit} for vector query, expected 1-75")
        if self.search_size < self.limit:
            raise ValidationError("searchSize must be greater than or equal to limit")
        if self.filter is not None:
            self.filter.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "VectorVamanaOptions":
        return cls(
            vector=decode_vector(d["vector"]),
            operator=d.get("operator", C.OPERATOR_NEAR),
            search_size=int(d.get("searchSize", 75)),
            limit=int(d.get("limit", 10)),
            filter=Query.from_dict(d["filter"]) if d.get("filter") else None,
            weight=d.get("weight"),
        )


@dataclass
class VectorFlatOptions:
    """Reference: models/search.go SearchVectorFlatOptions."""

    vector: list
    operator: str = C.OPERATOR_NEAR
    limit: int = 10
    filter: Optional["Query"] = None
    weight: Optional[float] = None

    def validate(self) -> None:
        if not (1 <= len(self.vector) <= 4096):
            raise ValidationError(
                f"query vector length must be between 1 and 4096, got {len(self.vector)}"
            )
        if self.operator != C.OPERATOR_NEAR:
            raise ValidationError(
                f"invalid operator {self.operator} for vector query, expected {C.OPERATOR_NEAR}"
            )
        if not (1 <= self.limit <= 75):
            raise ValidationError(f"invalid limit {self.limit} for vector query, expected 1-75")
        if self.filter is not None:
            self.filter.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "VectorFlatOptions":
        return cls(
            vector=decode_vector(d["vector"]),
            operator=d.get("operator", C.OPERATOR_NEAR),
            limit=int(d.get("limit", 10)),
            filter=Query.from_dict(d["filter"]) if d.get("filter") else None,
            weight=d.get("weight"),
        )


@dataclass
class TextOptions:
    """Reference: models/search.go SearchTextOptions."""

    value: str
    operator: str = C.OPERATOR_CONTAINS_ANY
    limit: int = 10
    filter: Optional["Query"] = None
    weight: Optional[float] = None

    def validate(self) -> None:
        if not self.value:
            raise ValidationError("text query value cannot be empty")
        if self.operator not in (C.OPERATOR_CONTAINS_ALL, C.OPERATOR_CONTAINS_ANY):
            raise ValidationError(
                f"invalid operator {self.operator} for text query, expected"
                f" {C.OPERATOR_CONTAINS_ALL} or {C.OPERATOR_CONTAINS_ANY}"
            )
        if not (1 <= self.limit <= 75):
            raise ValidationError(f"invalid limit {self.limit} for text query, expected 1-75")
        if self.filter is not None:
            self.filter.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "TextOptions":
        return cls(
            value=d["value"],
            operator=d.get("operator", C.OPERATOR_CONTAINS_ANY),
            limit=int(d.get("limit", 10)),
            filter=Query.from_dict(d["filter"]) if d.get("filter") else None,
            weight=d.get("weight"),
        )


@dataclass
class StringOptions:
    """Reference: models/search.go SearchStringOptions."""

    value: str
    operator: str = C.OPERATOR_EQUALS
    end_value: str = ""

    def validate(self) -> None:
        if not self.value:
            raise ValidationError("string query value cannot be empty")
        valid = C.RANGE_OPERATORS | {C.OPERATOR_STARTS_WITH}
        if self.operator not in valid:
            raise ValidationError(f"invalid operator {self.operator} for string query")
        if self.operator == C.OPERATOR_IN_RANGE and self.end_value <= self.value:
            raise ValidationError("endValue must be greater than value for string range query")

    @classmethod
    def from_dict(cls, d: dict) -> "StringOptions":
        return cls(
            value=d["value"],
            operator=d.get("operator", C.OPERATOR_EQUALS),
            end_value=d.get("endValue", ""),
        )


@dataclass
class IntegerOptions:
    """Reference: models/search.go SearchIntegerOptions."""

    value: int
    operator: str = C.OPERATOR_EQUALS
    end_value: int = 0

    def validate(self) -> None:
        if self.operator not in C.RANGE_OPERATORS:
            raise ValidationError(f"invalid operator {self.operator} for integer query")
        if self.operator == C.OPERATOR_IN_RANGE and self.end_value <= self.value:
            raise ValidationError("endValue must be greater than value for integer range query")

    @classmethod
    def from_dict(cls, d: dict) -> "IntegerOptions":
        return cls(
            value=int(d["value"]),
            operator=d.get("operator", C.OPERATOR_EQUALS),
            end_value=int(d.get("endValue", 0)),
        )


@dataclass
class FloatOptions:
    """Reference: models/search.go SearchFloatOptions."""

    value: float
    operator: str = C.OPERATOR_EQUALS
    end_value: float = 0.0

    def validate(self) -> None:
        if self.operator not in C.RANGE_OPERATORS:
            raise ValidationError(f"invalid operator {self.operator} for float query")
        if self.operator == C.OPERATOR_IN_RANGE and self.end_value <= self.value:
            raise ValidationError("endValue must be greater than value for float range query")

    @classmethod
    def from_dict(cls, d: dict) -> "FloatOptions":
        return cls(
            value=float(d["value"]),
            operator=d.get("operator", C.OPERATOR_EQUALS),
            end_value=float(d.get("endValue", 0.0)),
        )


@dataclass
class StringArrayOptions:
    """Reference: models/search.go SearchStringArrayOptions."""

    value: list
    operator: str = C.OPERATOR_CONTAINS_ANY

    def validate(self) -> None:
        if not self.value:
            raise ValidationError("stringArray query value cannot be empty")
        if self.operator not in (C.OPERATOR_CONTAINS_ALL, C.OPERATOR_CONTAINS_ANY):
            raise ValidationError(
                f"invalid operator {self.operator} for stringArray query, expected"
                f" {C.OPERATOR_CONTAINS_ALL} or {C.OPERATOR_CONTAINS_ANY}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "StringArrayOptions":
        return cls(value=list(d["value"]), operator=d.get("operator", C.OPERATOR_CONTAINS_ANY))


@dataclass
class VectorIVFOptions:
    """Query options for the TPU-native vectorIVF index (no reference
    counterpart). ``numProbes`` overrides the index's probe count."""

    vector: list
    operator: str = C.OPERATOR_NEAR
    num_probes: int = 0
    limit: int = 10
    filter: Optional["Query"] = None
    weight: Optional[float] = None

    def validate(self) -> None:
        if not (1 <= len(self.vector) <= 4096):
            raise ValidationError(
                f"query vector length must be between 1 and 4096, got {len(self.vector)}"
            )
        if self.operator != C.OPERATOR_NEAR:
            raise ValidationError(
                f"invalid operator {self.operator} for vector query, expected {C.OPERATOR_NEAR}"
            )
        if self.num_probes and not (1 <= self.num_probes <= 1024):
            raise ValidationError(
                f"invalid numProbes {self.num_probes} for vector query, expected 1-1024"
            )
        if not (1 <= self.limit <= 75):
            raise ValidationError(f"invalid limit {self.limit} for vector query, expected 1-75")
        if self.filter is not None:
            self.filter.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "VectorIVFOptions":
        return cls(
            vector=decode_vector(d["vector"]),
            operator=d.get("operator", C.OPERATOR_NEAR),
            num_probes=int(d.get("numProbes", 0)),
            limit=int(d.get("limit", 10)),
            filter=Query.from_dict(d["filter"]) if d.get("filter") else None,
            weight=d.get("weight"),
        )


@dataclass
class VectorFusedOptions:
    """Query options for the TPU-native vectorFused index (no reference
    counterpart): one query vector per view, optional per-query fusion
    weight overrides (defaults come from the schema's view weights)."""

    vectors: list  # List[List[float]], one per view
    operator: str = C.OPERATOR_NEAR
    weights: Optional[list] = None  # per-view overrides
    num_probes: int = 0
    limit: int = 10
    filter: Optional["Query"] = None
    weight: Optional[float] = None  # outer hybrid weight (_and/_or fusion)

    def validate(self) -> None:
        if not (2 <= len(self.vectors) <= 8):
            raise ValidationError(
                f"fused query needs between 2 and 8 view vectors, got {len(self.vectors)}"
            )
        for i, v in enumerate(self.vectors):
            if not (1 <= len(v) <= 4096):
                raise ValidationError(
                    f"view {i} query vector length must be between 1 and 4096,"
                    f" got {len(v)}"
                )
        if self.operator != C.OPERATOR_NEAR:
            raise ValidationError(
                f"invalid operator {self.operator} for vector query, expected {C.OPERATOR_NEAR}"
            )
        if self.weights is not None:
            if len(self.weights) != len(self.vectors):
                raise ValidationError(
                    "fused query weights length must match the view count,"
                    f" got {len(self.weights)} weights for {len(self.vectors)} views"
                )
            if any(not (0 < float(w) <= 100) for w in self.weights):
                raise ValidationError("fused query weights must be in (0, 100]")
        if self.num_probes and not (1 <= self.num_probes <= 1024):
            raise ValidationError(
                f"invalid numProbes {self.num_probes} for vector query, expected 1-1024"
            )
        if not (1 <= self.limit <= 75):
            raise ValidationError(f"invalid limit {self.limit} for vector query, expected 1-75")
        if self.filter is not None:
            self.filter.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "VectorFusedOptions":
        return cls(
            vectors=[decode_vector(v) for v in d["vectors"]],
            operator=d.get("operator", C.OPERATOR_NEAR),
            weights=[float(w) for w in d["weights"]] if d.get("weights") else None,
            num_probes=int(d.get("numProbes", 0)),
            limit=int(d.get("limit", 10)),
            filter=Query.from_dict(d["filter"]) if d.get("filter") else None,
            weight=d.get("weight"),
        )


_QUERY_OPTION_FIELDS = (
    ("vectorIVF", ("vector_ivf", VectorIVFOptions)),
    ("vectorVamana", ("vector_vamana", VectorVamanaOptions)),
    ("vectorFlat", ("vector_flat", VectorFlatOptions)),
    ("vectorFused", ("vector_fused", VectorFusedOptions)),
    ("text", ("text", TextOptions)),
    ("string", ("string", StringOptions)),
    ("integer", ("integer", IntegerOptions)),
    ("float", ("float_", FloatOptions)),
    ("stringArray", ("string_array", StringArrayOptions)),
)


@dataclass
class Query:
    """Recursive query AST node (models/search.go Query).

    Special properties: ``_and``/``_or`` combine subqueries; ``_id`` looks up
    points directly by UUID.
    """

    property: str
    vector_flat: Optional[VectorFlatOptions] = None
    vector_vamana: Optional[VectorVamanaOptions] = None
    vector_ivf: Optional[VectorIVFOptions] = None
    vector_fused: Optional[VectorFusedOptions] = None
    text: Optional[TextOptions] = None
    string: Optional[StringOptions] = None
    integer: Optional[IntegerOptions] = None
    float_: Optional[FloatOptions] = None
    string_array: Optional[StringArrayOptions] = None
    and_: List["Query"] = field(default_factory=list)
    or_: List["Query"] = field(default_factory=list)

    def validate(self) -> None:
        if not self.property:
            raise ValidationError("query property cannot be empty")
        for opts in (
            self.vector_flat,
            self.vector_vamana,
            self.vector_ivf,
            self.vector_fused,
            self.text,
            self.string,
            self.integer,
            self.float_,
            self.string_array,
        ):
            if opts is not None:
                opts.validate()
        if self.property == "_and" and not self.and_:
            raise ValidationError("and query must have at least one subquery")
        if self.property == "_or" and not self.or_:
            raise ValidationError("or query must have at least one subquery")
        for i, sub in enumerate(self.and_):
            try:
                sub.validate()
            except ValidationError as e:
                raise ValidationError(f"and[{i}] validation failed: {e}") from e
        for i, sub in enumerate(self.or_):
            try:
                sub.validate()
            except ValidationError as e:
                raise ValidationError(f"or[{i}] validation failed: {e}") from e
        if self.property == "_id":
            # Either string equals or stringArray containsAny of UUIDs
            if self.string is not None:
                if self.string.operator != C.OPERATOR_EQUALS:
                    raise ValidationError(
                        f"invalid operator {self.string.operator} for _id,"
                        f" expected {C.OPERATOR_EQUALS}"
                    )
                _parse_uuid(self.string.value)
            elif self.string_array is not None:
                if self.string_array.operator != C.OPERATOR_CONTAINS_ANY:
                    raise ValidationError(
                        f"invalid operator {self.string_array.operator} for _id,"
                        f" expected {C.OPERATOR_CONTAINS_ANY}"
                    )
                for v in self.string_array.value:
                    _parse_uuid(v)
            else:
                raise ValidationError("invalid query for _id, expected string or stringArray")

    def validate_schema(self, schema) -> None:
        """Cross-check query against the collection IndexSchema
        (models/search.go Query.ValidateSchema)."""
        if self.property == "_and":
            for sub in self.and_:
                sub.validate_schema(schema)
            return
        if self.property == "_or":
            for sub in self.or_:
                sub.validate_schema(schema)
            return
        if self.property == "_id":
            return
        value = schema.get(self.property)
        if value is None:
            raise ValidationError(
                f"property {self.property} not found in index schema, cannot query"
            )
        t = value.type
        if t == C.INDEX_TYPE_VECTOR_FLAT:
            if self.vector_flat is None:
                raise ValidationError(
                    f"vectorFlat query options not provided for property {self.property}"
                )
            if len(self.vector_flat.vector) != value.vector_flat.vector_size:
                raise ValidationError(
                    f"vectorFlat query vector length mismatch for property {self.property},"
                    f" expected {value.vector_flat.vector_size} got {len(self.vector_flat.vector)}"
                )
            if self.vector_flat.filter is not None:
                self.vector_flat.filter.validate_schema(schema)
        elif t == C.INDEX_TYPE_VECTOR_VAMANA:
            if self.vector_vamana is None:
                raise ValidationError(
                    f"vectorVamana query options not provided for property {self.property}"
                )
            if len(self.vector_vamana.vector) != value.vector_vamana.vector_size:
                raise ValidationError(
                    f"vectorVamana query vector length mismatch for property {self.property},"
                    f" expected {value.vector_vamana.vector_size}"
                    f" got {len(self.vector_vamana.vector)}"
                )
            if self.vector_vamana.filter is not None:
                self.vector_vamana.filter.validate_schema(schema)
        elif t == C.INDEX_TYPE_VECTOR_IVF:
            if self.vector_ivf is None:
                raise ValidationError(
                    f"vectorIVF query options not provided for property {self.property}"
                )
            if len(self.vector_ivf.vector) != value.vector_ivf.vector_size:
                raise ValidationError(
                    f"vectorIVF query vector length mismatch for property {self.property},"
                    f" expected {value.vector_ivf.vector_size}"
                    f" got {len(self.vector_ivf.vector)}"
                )
            if self.vector_ivf.filter is not None:
                self.vector_ivf.filter.validate_schema(schema)
        elif t == C.INDEX_TYPE_VECTOR_FUSED:
            if self.vector_fused is None:
                raise ValidationError(
                    f"vectorFused query options not provided for property {self.property}"
                )
            views = value.vector_fused.views
            if len(self.vector_fused.vectors) != len(views):
                raise ValidationError(
                    f"vectorFused query view count mismatch for property {self.property},"
                    f" expected {len(views)} got {len(self.vector_fused.vectors)}"
                )
            for i, (qv, vp) in enumerate(zip(self.vector_fused.vectors, views)):
                if len(qv) != vp.vector_size:
                    raise ValidationError(
                        f"vectorFused view {i} query vector length mismatch for"
                        f" property {self.property}, expected {vp.vector_size}"
                        f" got {len(qv)}"
                    )
            if self.vector_fused.filter is not None:
                self.vector_fused.filter.validate_schema(schema)
        elif t == C.INDEX_TYPE_TEXT:
            if self.text is None:
                raise ValidationError(
                    f"text query options not provided for property {self.property}"
                )
            if self.text.filter is not None:
                self.text.filter.validate_schema(schema)
        elif t == C.INDEX_TYPE_STRING:
            if self.string is None:
                raise ValidationError(
                    f"string query options not provided for property {self.property}"
                )
        elif t == C.INDEX_TYPE_STRING_ARRAY:
            if self.string_array is None:
                raise ValidationError(
                    f"stringArray query options not provided for property {self.property}"
                )
        elif t == C.INDEX_TYPE_INTEGER:
            if self.integer is None:
                raise ValidationError(
                    f"integer query options not provided for property {self.property}"
                )
        elif t == C.INDEX_TYPE_FLOAT:
            if self.float_ is None:
                raise ValidationError(
                    f"float query options not provided for property {self.property}"
                )
        else:
            raise ValidationError(f"unknown index type {t}")

    @classmethod
    def from_dict(cls, d: dict) -> "Query":
        # Serving fast path: the overwhelmingly common wire query is
        # {"property": ..., "<oneOptionKey>": {...}} — skip the 11
        # conditional gets + full-kwarg dataclass init (~2x parse cost at
        # 4k-query batches on a 1-vCPU host). Falls through for every
        # other shape, including _and/_or composites.
        if len(d) == 2 and "property" in d:
            for k, fld in _QUERY_OPTION_FIELDS:
                v = d.get(k)
                if v is not None:
                    q = cls(property=d["property"])
                    setattr(q, fld[0], fld[1].from_dict(v))
                    return q
        return cls(
            property=d["property"],
            vector_flat=VectorFlatOptions.from_dict(d["vectorFlat"]) if d.get("vectorFlat") else None,
            vector_vamana=(
                VectorVamanaOptions.from_dict(d["vectorVamana"]) if d.get("vectorVamana") else None
            ),
            vector_ivf=VectorIVFOptions.from_dict(d["vectorIVF"]) if d.get("vectorIVF") else None,
            vector_fused=(
                VectorFusedOptions.from_dict(d["vectorFused"]) if d.get("vectorFused") else None
            ),
            text=TextOptions.from_dict(d["text"]) if d.get("text") else None,
            string=StringOptions.from_dict(d["string"]) if d.get("string") else None,
            integer=IntegerOptions.from_dict(d["integer"]) if d.get("integer") else None,
            float_=FloatOptions.from_dict(d["float"]) if d.get("float") else None,
            string_array=(
                StringArrayOptions.from_dict(d["stringArray"]) if d.get("stringArray") else None
            ),
            and_=[Query.from_dict(q) for q in d.get("_and", [])],
            or_=[Query.from_dict(q) for q in d.get("_or", [])],
        )


def _parse_uuid(v: str) -> uuid_mod.UUID:
    try:
        return uuid_mod.UUID(v)
    except (ValueError, AttributeError, TypeError) as e:
        raise ValidationError(f"invalid UUID {v} for _id, {e}") from e


@dataclass
class SearchRequest:
    """Reference: models/search.go SearchRequest."""

    query: Query
    select: List[str] = field(default_factory=list)
    sort: List[SortOption] = field(default_factory=list)
    offset: int = 0
    limit: int = 10

    def validate(self) -> None:
        self.query.validate()
        if len(self.sort) > 10:
            raise ValidationError("sort options exceed maximum of 10")
        for s in self.sort:
            s.validate()
        if self.offset < 0:
            raise ValidationError("offset must be greater than or equal to 0")
        if not (1 <= self.limit <= 100):
            raise ValidationError("limit must be between 1 and 100")

    @classmethod
    def from_dict(cls, d: dict) -> "SearchRequest":
        return cls(
            query=Query.from_dict(d["query"]),
            select=list(d.get("select") or []),
            sort=[SortOption.from_dict(s) for s in (d.get("sort") or [])],
            offset=int(d.get("offset", 0)),
            limit=int(d.get("limit", 10)),
        )
