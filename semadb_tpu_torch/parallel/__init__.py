"""Device-mesh parallelism: one shard a device slot, and the fan-out.

Port of ``semadb_tpu/parallel``. Where SemaDB broadcasts a query to shard
servers over net/rpc and merges the per-shard top-k on the host
(cluster/actions.go:267-378), the shards' copies live one a slot of a
:class:`~semadb_tpu_torch.parallel.mesh.ShardMesh` and one merge on the first
slot's device gives the global top-k (``fanout.py``).
"""

from semadb_tpu_torch.parallel.fanout import (  # noqa: F401
    sharded_delete_step,
    sharded_insert_step,
    sharded_ivf_search,
    sharded_search,
    stack_ivf_states,
    stack_states,
)
from semadb_tpu_torch.parallel.mesh import ShardMesh, shard_mesh  # noqa: F401
