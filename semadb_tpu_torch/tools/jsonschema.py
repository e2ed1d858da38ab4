"""Generate JSON Schema documents for the public API types.

Parity reference: internal/generateJSONSchema — emits machine-readable
schemas of the request bodies so clients can validate before sending.

Usage: python -m semadb_tpu.tools.jsonschema [out-dir]
"""

from __future__ import annotations

import json
import os
import sys

VECTOR = {"type": "array", "items": {"type": "number"}, "minItems": 1, "maxItems": 4096}

QUANTIZER = {
    "type": "object",
    "properties": {
        "type": {"enum": ["none", "binary", "product"]},
        "binary": {
            "type": "object",
            "properties": {
                "threshold": {"type": "number"},
                "triggerThreshold": {"type": "integer", "minimum": 0, "maximum": 50000},
                "distanceMetric": {"enum": ["hamming", "jaccard"]},
            },
            "required": ["distanceMetric"],
        },
        "product": {
            "type": "object",
            "properties": {
                "numCentroids": {"type": "integer", "minimum": 2, "maximum": 256},
                "numSubVectors": {"type": "integer", "minimum": 2},
                "triggerThreshold": {"type": "integer", "minimum": 1000, "maximum": 10000},
                "opq": {"type": "boolean"},
            },
            "required": ["numCentroids", "numSubVectors", "triggerThreshold"],
        },
    },
    "required": ["type"],
}

INDEX_SCHEMA = {
    "type": "object",
    "additionalProperties": {
        "type": "object",
        "properties": {
            "type": {
                "enum": [
                    "vectorFlat", "vectorVamana", "vectorIVF", "vectorFused",
                    "text", "string", "integer", "float", "stringArray",
                ]
            },
            "vectorFlat": {
                "type": "object",
                "properties": {
                    "vectorSize": {"type": "integer", "minimum": 1, "maximum": 4096},
                    "distanceMetric": {
                        "enum": ["euclidean", "cosine", "dot", "hamming", "jaccard", "haversine"]
                    },
                    "quantizer": QUANTIZER,
                },
                "required": ["vectorSize", "distanceMetric"],
            },
            "vectorVamana": {
                "type": "object",
                "properties": {
                    "vectorSize": {"type": "integer", "minimum": 1, "maximum": 4096},
                    "distanceMetric": {
                        "enum": ["euclidean", "cosine", "dot", "hamming", "jaccard", "haversine"]
                    },
                    "searchSize": {"type": "integer", "minimum": 25, "maximum": 75},
                    "degreeBound": {"type": "integer", "minimum": 32, "maximum": 64},
                    "alpha": {"type": "number", "minimum": 1.1, "maximum": 1.5},
                    "quantizer": QUANTIZER,
                },
                "required": ["vectorSize", "distanceMetric"],
            },
            "vectorIVF": {
                "type": "object",
                "properties": {
                    "vectorSize": {"type": "integer", "minimum": 1, "maximum": 4096},
                    "distanceMetric": {"enum": ["euclidean", "cosine", "dot"]},
                    "numProbes": {"type": "integer", "minimum": 1, "maximum": 1024},
                    "slabSize": {"type": "integer", "minimum": 8, "maximum": 1024},
                    "projDim": {"type": "integer", "minimum": 32, "maximum": 4096},
                    "quantizer": QUANTIZER,
                },
                "required": ["vectorSize", "distanceMetric"],
            },
            "vectorFused": {
                "type": "object",
                "properties": {
                    "views": {
                        "type": "array",
                        "minItems": 2,
                        "maxItems": 8,
                        "items": {
                            "type": "object",
                            "properties": {
                                "vectorSize": {
                                    "type": "integer", "minimum": 1, "maximum": 4096
                                },
                                "distanceMetric": {
                                    "enum": ["euclidean", "cosine", "dot"]
                                },
                                "weight": {
                                    "type": "number",
                                    "exclusiveMinimum": 0,
                                    "maximum": 100,
                                },
                            },
                            "required": ["vectorSize", "distanceMetric"],
                        },
                    },
                    "numProbes": {"type": "integer", "minimum": 1, "maximum": 1024},
                    "numClusters": {"type": "integer", "minimum": 16, "maximum": 262144},
                    "assignCopies": {"type": "integer", "minimum": 1, "maximum": 4},
                },
                "required": ["views"],
            },
            "text": {
                "type": "object",
                "properties": {"analyser": {"enum": ["standard"]}},
            },
            "string": {
                "type": "object",
                "properties": {"caseSensitive": {"type": "boolean"}},
            },
            "stringArray": {
                "type": "object",
                "properties": {"caseSensitive": {"type": "boolean"}},
            },
        },
        "required": ["type"],
    },
}

QUERY: dict = {
    "type": "object",
    "properties": {
        "property": {"type": "string"},
        "vectorVamana": {
            "type": "object",
            "properties": {
                "vector": VECTOR,
                "operator": {"enum": ["near"]},
                "searchSize": {"type": "integer", "minimum": 25, "maximum": 75},
                "limit": {"type": "integer", "minimum": 1, "maximum": 75},
                "filter": {"$ref": "#"},
                "weight": {"type": "number"},
            },
            "required": ["vector", "operator", "searchSize", "limit"],
        },
        "vectorFlat": {
            "type": "object",
            "properties": {
                "vector": VECTOR,
                "operator": {"enum": ["near"]},
                "limit": {"type": "integer", "minimum": 1, "maximum": 75},
                "filter": {"$ref": "#"},
                "weight": {"type": "number"},
            },
            "required": ["vector", "operator", "limit"],
        },
        "vectorIVF": {
            "type": "object",
            "properties": {
                "vector": VECTOR,
                "operator": {"enum": ["near"]},
                "numProbes": {"type": "integer", "minimum": 1, "maximum": 1024},
                "limit": {"type": "integer", "minimum": 1, "maximum": 75},
                "filter": {"$ref": "#"},
                "weight": {"type": "number"},
            },
            "required": ["vector", "operator", "limit"],
        },
        "vectorFused": {
            "type": "object",
            "properties": {
                "vectors": {"type": "array", "minItems": 2, "maxItems": 8,
                            "items": VECTOR},
                "operator": {"enum": ["near"]},
                "weights": {
                    "type": "array",
                    "items": {"type": "number", "exclusiveMinimum": 0, "maximum": 100},
                },
                "numProbes": {"type": "integer", "minimum": 1, "maximum": 1024},
                "limit": {"type": "integer", "minimum": 1, "maximum": 75},
                "filter": {"$ref": "#"},
                "weight": {"type": "number"},
            },
            "required": ["vectors", "operator", "limit"],
        },
        "text": {
            "type": "object",
            "properties": {
                "value": {"type": "string"},
                "operator": {"enum": ["containsAll", "containsAny"]},
                "limit": {"type": "integer", "minimum": 1, "maximum": 75},
                "filter": {"$ref": "#"},
                "weight": {"type": "number"},
            },
            "required": ["value", "operator", "limit"],
        },
        "string": {
            "type": "object",
            "properties": {
                "value": {"type": "string"},
                "operator": {
                    "enum": [
                        "equals", "notEquals", "startsWith", "greaterThan",
                        "greaterThanOrEquals", "lessThan", "lessThanOrEquals", "inRange",
                    ]
                },
                "endValue": {"type": "string"},
            },
            "required": ["value", "operator"],
        },
        "integer": {
            "type": "object",
            "properties": {
                "value": {"type": "integer"},
                "operator": {
                    "enum": [
                        "equals", "notEquals", "greaterThan", "greaterThanOrEquals",
                        "lessThan", "lessThanOrEquals", "inRange",
                    ]
                },
                "endValue": {"type": "integer"},
            },
            "required": ["value", "operator"],
        },
        "float": {
            "type": "object",
            "properties": {
                "value": {"type": "number"},
                "operator": {
                    "enum": [
                        "equals", "notEquals", "greaterThan", "greaterThanOrEquals",
                        "lessThan", "lessThanOrEquals", "inRange",
                    ]
                },
                "endValue": {"type": "number"},
            },
            "required": ["value", "operator"],
        },
        "stringArray": {
            "type": "object",
            "properties": {
                "value": {"type": "array", "items": {"type": "string"}},
                "operator": {"enum": ["containsAll", "containsAny"]},
            },
            "required": ["value", "operator"],
        },
        "_and": {"type": "array", "items": {"$ref": "#"}},
        "_or": {"type": "array", "items": {"$ref": "#"}},
    },
    "required": ["property"],
}

SEARCH_REQUEST = {
    "type": "object",
    "properties": {
        "query": QUERY,
        "select": {"type": "array", "items": {"type": "string"}},
        "sort": {
            "type": "array",
            "maxItems": 10,
            "items": {
                "type": "object",
                "properties": {
                    "property": {"type": "string"},
                    "descending": {"type": "boolean"},
                },
                "required": ["property"],
            },
        },
        "offset": {"type": "integer", "minimum": 0},
        "limit": {"type": "integer", "minimum": 1, "maximum": 100},
    },
    "required": ["query", "limit"],
}

CREATE_COLLECTION = {
    "type": "object",
    "properties": {
        "id": {"type": "string", "pattern": "^[A-Za-z0-9]{3,24}$"},
        "indexSchema": INDEX_SCHEMA,
    },
    "required": ["id", "indexSchema"],
}

ALL = {
    "createCollectionRequest": CREATE_COLLECTION,
    "indexSchema": INDEX_SCHEMA,
    "query": QUERY,
    "searchRequest": SEARCH_REQUEST,
    "quantizer": QUANTIZER,
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    out_dir = argv[0] if argv else ""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name, schema in ALL.items():
            with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                json.dump(schema, f, indent=2)
        print(f"wrote {len(ALL)} schemas to {out_dir}", file=sys.stderr)
    else:
        json.dump(ALL, sys.stdout, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
