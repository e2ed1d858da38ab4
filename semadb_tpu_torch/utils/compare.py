"""Generic value comparison and multi-key result sorting.

Parity reference: utils/compare.go — CompareAny over mixed dynamic types,
nested ``a.b.c`` property access, multi-key sort with missing values last
(compare.go:12-89).
"""

from __future__ import annotations

from typing import Any, List

from semadb_tpu_torch.models.point import SearchResult, access_nested
from semadb_tpu_torch.models.query import SortOption


def compare_any(a: Any, b: Any) -> int:
    """-1/0/1 ordering over dynamic values; cross-type falls back to type
    name ordering so the sort is total (compare.go CompareAny)."""
    if a is None and b is None:
        return 0
    if a is None:
        return 1  # missing values last
    if b is None:
        return -1
    if isinstance(a, bool) or isinstance(b, bool):
        a, b = int(bool(a)), int(bool(b))
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return (a > b) - (a < b)
    if isinstance(a, str) and isinstance(b, str):
        return (a > b) - (a < b)
    ta, tb = type(a).__name__, type(b).__name__
    return (ta > tb) - (ta < tb)


def sort_search_results(results: List[SearchResult], sort_opts: List[SortOption]) -> None:
    """Stable multi-key in-place sort (compare.go SortSearchResults)."""
    import functools

    def get_value(r: SearchResult, prop: str):
        src = r.decoded_data if r.decoded_data is not None else (
            r.point.as_map() if r.point is not None else {}
        )
        if prop == "_distance":
            return r.distance
        if prop == "_score":
            return r.score
        if prop == "_hybridScore":
            return r.hybrid_score
        return access_nested(src, prop)

    def cmp(x: SearchResult, y: SearchResult) -> int:
        for opt in sort_opts:
            c = compare_any(get_value(x, opt.property), get_value(y, opt.property))
            if c != 0:
                return -c if opt.descending else c
        return 0

    results.sort(key=functools.cmp_to_key(cmp))
