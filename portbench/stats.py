"""Window arithmetic: a tail over every sample of the window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(samples: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest sample that at least
    q% of all samples do not exceed."""
    if not samples:
        raise ValueError("no samples")
    s = sorted(samples)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


def p95(samples: Sequence[float]) -> float:
    return percentile(samples, 95.0)


def median(samples: Sequence[float]) -> float:
    return percentile(samples, 50.0)
