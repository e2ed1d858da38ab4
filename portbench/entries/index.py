"""The entry that ann-benchmarks drives: one vector index of the port,
in-process, as a shard holds it.

The engine is made by the port's own table of vector index types
(``semadb_tpu_torch.index.manager._ENGINES``) from the configuration's v2
``schema`` value, validated as a collection's would be, and bulk-loaded
with the corpus as a shard's first bulk write loads it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def make(schema: dict, device):
    """A fresh engine for a v2 index schema value, such as ``{"type":
    "vectorIVF", "vectorIVF": {...}}``."""
    from semadb_tpu_torch.index import manager
    from semadb_tpu_torch.models.schema import IndexSchemaValue

    value = IndexSchemaValue.from_dict(schema)
    value.validate()
    if value.type not in manager._ENGINES:
        raise ValueError(f"{value.type!r} is not a vector index type of the port: {list(manager._ENGINES)}")
    attr, engine = manager._ENGINES[value.type]
    return engine(getattr(value, attr), torch.device(device))


def load(engine, corpus: torch.Tensor, first_id: int) -> dict:
    """Bulk-load ``corpus`` (on the engine's device) under ids ``first_id``
    on; returns the build's seconds and the engine's own split of them.
    Engines with ``insert_bulk(ids, vecs, defer_fit)``: vectorIVF and
    vectorVamana. One that loads otherwise (vectorFused takes its views)
    is given an entry of its own."""
    ids = np.arange(first_id, first_id + len(corpus), dtype=np.int64)
    t0 = time.perf_counter()
    engine.insert_bulk(ids, corpus, defer_fit=True)
    engine.flush_pending()
    engine.sync()
    split = dict(getattr(engine, "refit_seconds", None) or getattr(engine, "build_seconds", None) or {})
    return {"build_s": time.perf_counter() - t0, "split": split}
