"""Top-k selection and sorted-list merge primitives.

These replace the reference's DistSet insertion-sort candidate array
(shard/index/vamana/distset.go:120-238) with XLA-friendly sorted merges of
static-shape tiles, and its per-shard result merge (cluster/actions.go:352-378)
with a concatenate + top_k.

Convention everywhere: distances, smaller is better; invalid slots carry
``INF`` distance and id ``-1``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

INF = jnp.float32(jnp.inf)
INVALID_ID = -1


@functools.partial(jax.jit, static_argnames=("k",))
def top_k_smallest(dists: jax.Array, k: int):
    """Smallest-k along the last axis → (values, indices)."""
    neg_vals, idx = jax.lax.top_k(-dists, k)
    return -neg_vals, idx


@jax.jit
def sort_by_distance(dists: jax.Array, ids: jax.Array):
    """Sort (dist, id) pairs ascending by distance along the last axis.

    Ties broken by id for determinism (mirrors the stable ordering the
    reference gets from its insertion sort).
    """
    order = jnp.lexsort((ids, dists))
    return jnp.take_along_axis(dists, order, axis=-1), jnp.take_along_axis(ids, order, axis=-1)


@functools.partial(jax.jit, static_argnames=("k",))
def merge_topk(dists_a, ids_a, dists_b, ids_b, k: int):
    """Merge two candidate sets and keep the k smallest, dropping duplicate
    ids (keeps the first/best occurrence).

    Used for the beam-search L-list merge and for cross-shard top-k.
    """
    dists = jnp.concatenate([dists_a, dists_b], axis=-1)
    ids = jnp.concatenate([ids_a, ids_b], axis=-1)
    dists, ids = dedup_by_id(dists, ids)
    dists, ids = sort_by_distance(dists, ids)
    return dists[..., :k], ids[..., :k]


@jax.jit
def dedup_by_id(dists: jax.Array, ids: jax.Array):
    """Invalidate duplicate ids (set dist=INF, id=-1), keeping the smallest
    distance per id. Operates on the last axis with static shapes.

    O(K^2) mask compare — K is the candidate-list size (<= ~256), cheap on
    the device, no sort-by-id needed.
    """
    same = ids[..., :, None] == ids[..., None, :]  # [.., K, K]
    better = (dists[..., None, :] < dists[..., :, None]) | (
        (dists[..., None, :] == dists[..., :, None])
        & (jnp.arange(ids.shape[-1])[None, :] < jnp.arange(ids.shape[-1])[:, None])
    )
    dup = jnp.any(same & better, axis=-1) | (ids == INVALID_ID)
    return jnp.where(dup, INF, dists), jnp.where(dup, INVALID_ID, ids)


@functools.partial(jax.jit, static_argnames=("k",))
def masked_top_k(dists: jax.Array, mask: jax.Array, k: int):
    """Top-k smallest among entries where ``mask`` is True."""
    return top_k_smallest(jnp.where(mask, dists, INF), k)
