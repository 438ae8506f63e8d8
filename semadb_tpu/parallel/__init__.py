"""Device-mesh parallelism: shard-per-device layout + collective fan-out.

Device-side replacement for the reference's cluster data plane: where SemaDB
broadcasts a query to shard servers over net/rpc and merges the per-shard
top-k host-side (cluster/actions.go:267-378), here the shards live one per
device on a ``jax.sharding.Mesh`` and the merge is an ``all_gather`` +
top-k over the device interconnect.
"""

from semadb_tpu.parallel.fanout import (  # noqa: F401
    sharded_delete_step,
    sharded_insert_step,
    sharded_ivf_search,
    sharded_search,
    stack_ivf_states,
    stack_states,
)
from semadb_tpu.parallel.mesh import shard_mesh  # noqa: F401
