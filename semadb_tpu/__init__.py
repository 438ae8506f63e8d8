"""semadb_tpu — a multi-index hybrid vector database for JAX accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of SemaDB
(reference: Semafind/semadb, pure Go): DiskANN/Vamana graph ANN search,
flat exact search, inverted/text indices, binary & product quantization,
hybrid query AST with weighted score fusion, multi-tenant collections and
a sharded cluster mode with scatter-gather search.

Architecture (accelerator-first, not a translation):
  - Vector state lives device-resident as dense, padded, fixed-shape arrays
    (vectors ``f32[cap, D]``, adjacency ``i32[cap, R]``) and is updated
    functionally inside ``jit``.
  - Distance evaluation is blocked matmuls; beam search is a batched
    frontier loop under ``lax.while_loop``; quantizer training (k-means) and
    ADC search run on device.
  - Sharding maps to a ``jax.sharding.Mesh`` ("shard" axis); fan-out search
    is ``shard_map`` + cross-device top-k merge, replacing the reference's
    net/rpc scatter-gather (reference: cluster/actions.go).
  - The document store, inverted/text indices and the cluster control plane
    are host-side; only node-id bitmasks and top-k lists cross the boundary.
"""

__version__ = "0.1.0"

from semadb_tpu.models import (  # noqa: F401
    Collection,
    ExistsError,
    IndexSchema,
    NotFoundError,
    Point,
    Query,
    QuotaReachedError,
    SearchRequest,
    SemaDBError,
    UserPlan,
    ValidationError,
)
