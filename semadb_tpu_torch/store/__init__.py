"""Persistence: transactional KV store (memory / file / native C++ backends)."""

from semadb_tpu_torch.store.diskstore import (  # noqa: F401
    Bucket,
    BucketManager,
    DiskStore,
    open_store,
)
