"""Concrete indices: flat, IVF, inverted, text + the dispatch/search
manager."""

from semadb_tpu_torch.index.flat import IndexFlat  # noqa: F401
from semadb_tpu_torch.index.ivf import IndexIVF  # noqa: F401
