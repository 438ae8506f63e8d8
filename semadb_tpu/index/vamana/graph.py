"""Device-resident Vamana graph state.

The reference stores the graph as bbolt pages — per-node edge lists under
``n<id>e`` keys (shard/index/vamana/node.go:89-128) and vectors under
``n<id>v`` (shard/vectorstore/plain.go:103-147), mutated under per-node
RWMutexes. The device-side design replaces all of that with two dense,
fixed-shape arrays resident in HBM, updated functionally under ``jit``:

  - ``vectors    f32[cap, D]``   — slot 0 reserved (nil id), slot 1 = start
  - ``adjacency  i32[cap, R]``   — fixed degree bound R, ``-1`` padded
  - ``exists     bool[cap]``     — slot holds a live node (start included)

Node ids are the array row indices; the shard's id counter recycles freed
ids (reference: shard/idcounter.go:11-23) precisely so this dense layout
stays compact. Capacity grows host-side by padding to the next power of
two; all kernels take static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from semadb_tpu.models import constants as C
from semadb_tpu.utils.grow import next_capacity

NIL = -1  # adjacency padding sentinel
START_ID = C.START_NODE_ID  # row 1, entry point; never a user point

MIN_CAPACITY = 128


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Static (hashable) parameters baked into the compiled kernels.

    Mirrors models.VectorVamanaParams
    (reference: models/index.go IndexVectorVamanaParameters).
    """

    dim: int
    metric: str = C.DISTANCE_EUCLIDEAN
    degree_bound: int = 64
    search_size: int = 75
    alpha: float = 1.2


class GraphState(NamedTuple):
    """Pure pytree; everything lives on device."""

    vectors: jax.Array  # f32[cap, D]
    adjacency: jax.Array  # i32[cap, R]
    exists: jax.Array  # bool[cap]

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]


def make_start_vector(dim: int, seed: int = 0) -> np.ndarray:
    """Random unit vector for the start node (vamana.go:93-120)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


def init_graph(config: GraphConfig, capacity: int = MIN_CAPACITY, seed: int = 0) -> GraphState:
    from semadb_tpu.utils.grow import initial_capacity

    row_bytes = (config.dim + config.degree_bound) * 4
    capacity = max(int(capacity), MIN_CAPACITY, initial_capacity(row_bytes, MIN_CAPACITY))
    vectors = jnp.zeros((capacity, config.dim), dtype=jnp.float32)
    vectors = vectors.at[START_ID].set(jnp.asarray(make_start_vector(config.dim, seed)))
    adjacency = jnp.full((capacity, config.degree_bound), NIL, dtype=jnp.int32)
    exists = jnp.zeros((capacity,), dtype=bool).at[START_ID].set(True)
    return GraphState(vectors=vectors, adjacency=adjacency, exists=exists)


def grow_graph(state: GraphState, new_capacity: int) -> GraphState:
    """Host-side capacity growth (pad arrays; cheap, rare)."""
    cap = state.capacity
    if new_capacity <= cap:
        return state
    return GraphState(
        vectors=jnp.pad(state.vectors, ((0, new_capacity - cap), (0, 0))),
        adjacency=jnp.pad(
            state.adjacency, ((0, new_capacity - cap), (0, 0)), constant_values=NIL
        ),
        exists=jnp.pad(state.exists, (0, new_capacity - cap)),
    )


def required_capacity(max_id: int, config: "GraphConfig | None" = None) -> int:
    """Capacity holding ``max_id`` under the shared growth policy
    (floor bucket then ×factor — see utils/grow.py). ``config`` sizes
    the per-row bytes (vector + adjacency) so wide rows get a lower
    floor."""
    row_bytes = (
        (config.dim + config.degree_bound) * 4 if config is not None else 512
    )
    return next_capacity(MIN_CAPACITY, max_id, row_bytes)


@jax.jit
def edge_counts(adjacency: jax.Array) -> jax.Array:
    """Number of valid (non-NIL) edges per node: i32[cap]."""
    return jnp.sum(adjacency != NIL, axis=-1).astype(jnp.int32)


@jax.jit
def live_count(state: GraphState) -> jax.Array:
    """Number of user points (excludes the start node)."""
    return jnp.sum(state.exists) - 1
