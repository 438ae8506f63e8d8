"""Batched distance kernels — the matmul replacement for the reference's AVX2 asm.

The reference computes one pair at a time through hand-written AVX2/FMA
assembly (distance/asm/dot.s, distance/asm/euclidean.s, dispatched in
distance/distance_amd64.go:19-27). On an accelerator the equivalent of that
SIMD kernel is the matrix unit itself: distances for whole query batches
against whole corpus blocks are a single ``q @ X.T`` matmul, so every
function here is batched and jit-friendly.

Semantics parity (distance/distance.go:14-67):
  - ``euclidean``  → *squared* euclidean (monotonic, no sqrt)
  - ``dot``        → negated dot product (lower is better)
  - ``cosine``     → ``1 - dot`` (assumes normalized vectors)
  - ``haversine``  → meters on Earth's surface for [lat, lon] degrees
  - ``hamming``    → popcount of XOR over bit-packed vectors
  - ``jaccard``    → ``1 - |and| / |or|`` over bit-packed vectors
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from semadb_tpu.models import constants as C

# Distance matmuls run at HIGHEST precision: XLA's default low-precision
# (bf16-pass) matmul introduces ~1e-2 absolute error which perturbs candidate
# ordering; the reference computes pure float32 (distance/puredist.go).
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

EARTH_RADIUS = 6371000.0
_DEG_TO_RAD = jnp.pi / 180.0

FLOAT_METRICS = (C.DISTANCE_EUCLIDEAN, C.DISTANCE_DOT, C.DISTANCE_COSINE, C.DISTANCE_HAVERSINE)
BIT_METRICS = (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD)


def _haversine_pair(x: jax.Array, y: jax.Array) -> jax.Array:
    """Haversine in meters for one [lat, lon] pair (distance.go:36-45)."""
    latx, lonx = x[..., 0] * _DEG_TO_RAD, x[..., 1] * _DEG_TO_RAD
    laty, lony = y[..., 0] * _DEG_TO_RAD, y[..., 1] * _DEG_TO_RAD
    dlat, dlon = latx - laty, lonx - lony
    sin_dlat = jnp.sin(dlat / 2)
    sin_dlon = jnp.sin(dlon / 2)
    a = sin_dlat * sin_dlat + jnp.cos(latx) * jnp.cos(laty) * sin_dlon * sin_dlon
    # Clamp for numerical safety before asin
    c = 2.0 * jnp.arcsin(jnp.sqrt(jnp.clip(a, 0.0, 1.0)))
    return EARTH_RADIUS * c


@functools.partial(jax.jit, static_argnames=("metric",))
def pairwise_distance(queries: jax.Array, corpus: jax.Array, metric: str) -> jax.Array:
    """All-pairs distance matrix ``[B, N]`` for float metrics.

    ``queries``: f32[B, D]; ``corpus``: f32[N, D]. The dot products run
    as a single blocked matmul; euclidean uses the
    ``|q|^2 - 2 q.x + |x|^2`` expansion so it is also one matmul.
    """
    if metric == C.DISTANCE_EUCLIDEAN:
        q2 = jnp.sum(queries * queries, axis=-1, keepdims=True)  # [B,1]
        x2 = jnp.sum(corpus * corpus, axis=-1)[None, :]  # [1,N]
        cross = jax.lax.dot_general(
            queries,
            corpus,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=MATMUL_PRECISION,
            preferred_element_type=jnp.float32,
        )
        # Squared euclidean can go slightly negative from rounding; clamp.
        return jnp.maximum(q2 - 2.0 * cross + x2, 0.0)
    if metric in (C.DISTANCE_DOT, C.DISTANCE_COSINE):
        cross = jax.lax.dot_general(
            queries,
            corpus,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=MATMUL_PRECISION,
            preferred_element_type=jnp.float32,
        )
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross
    if metric == C.DISTANCE_HAVERSINE:
        return _haversine_pair(queries[:, None, :], corpus[None, :, :])
    raise ValueError(f"unknown float32 distance function: {metric}")


@functools.partial(jax.jit, static_argnames=("metric",))
def distance(x: jax.Array, y: jax.Array, metric: str) -> jax.Array:
    """Single-pair distance, for parity tests against the reference kernels."""
    x = jnp.atleast_2d(x)
    y = jnp.atleast_2d(y)
    return pairwise_distance(x, y, metric)[0, 0]


@functools.partial(jax.jit, static_argnames=("metric",))
def gather_distance(
    vectors: jax.Array, ids: jax.Array, queries: jax.Array, metric: str
) -> jax.Array:
    """Per-query distances to gathered candidate vectors.

    ``vectors``: f32[cap, D] corpus; ``ids``: i32[B, K] candidate ids per
    query (clipped by caller); ``queries``: f32[B, D]. Returns f32[B, K].

    This is the hot op of beam search (reference hot loop:
    shard/index/vamana/search.go:63-98 bottoming out in asm kernels). The
    gather and the distance contraction fuse into one device program.
    """
    cand = vectors[ids]  # [B, K, D]
    if metric == C.DISTANCE_EUCLIDEAN:
        diff = cand - queries[:, None, :]
        return jnp.sum(diff * diff, axis=-1)
    if metric in (C.DISTANCE_DOT, C.DISTANCE_COSINE):
        cross = jnp.einsum(
            "bkd,bd->bk",
            cand,
            queries,
            precision=MATMUL_PRECISION,
            preferred_element_type=jnp.float32,
        )
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross
    if metric == C.DISTANCE_HAVERSINE:
        return _haversine_pair(queries[:, None, :], cand)
    raise ValueError(f"unknown float32 distance function: {metric}")


# ---------------------------------------------------------------------------
# Bit-packed metrics (binary quantization / user hamming metrics)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("metric",))
def pairwise_bit_distance(queries: jax.Array, corpus: jax.Array, metric: str) -> jax.Array:
    """All-pairs bit distances over packed ``uint32[B, W]`` vs ``uint32[N, W]``.

    Reference: distance/distance.go:47-67 over []uint64 words; we pack to
    uint32, the native integer width of the device's vector units. On the
    GPU the flat index's scan runs the blocked Pallas-Triton kernel
    (``ops/pallas/hamming.py``) instead; this is its reference.
    """
    q = queries[:, None, :]
    x = corpus[None, :, :]
    if metric == C.DISTANCE_HAMMING:
        return jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(q, x)), axis=-1
        ).astype(jnp.float32)
    if metric == C.DISTANCE_JACCARD:
        inter = jnp.sum(jax.lax.population_count(jnp.bitwise_and(q, x)), axis=-1)
        union = jnp.sum(jax.lax.population_count(jnp.bitwise_or(q, x)), axis=-1)
        return jnp.where(
            union == 0, 0.0, 1.0 - inter.astype(jnp.float32) / jnp.maximum(union, 1)
        )
    raise ValueError(f"unknown bit distance function: {metric}")


@functools.partial(jax.jit, static_argnames=("metric",))
def gather_bit_distance(
    codes: jax.Array, ids: jax.Array, query_code: jax.Array, metric: str
) -> jax.Array:
    """Per-query bit distances to gathered codes: ``codes`` uint32[cap, W],
    ``ids`` i32[B, K], ``query_code`` uint32[B, W] → f32[B, K]."""
    cand = codes[ids]  # [B, K, W]
    q = query_code[:, None, :]
    if metric == C.DISTANCE_HAMMING:
        return jnp.sum(jax.lax.population_count(jnp.bitwise_xor(q, cand)), axis=-1).astype(
            jnp.float32
        )
    if metric == C.DISTANCE_JACCARD:
        inter = jnp.sum(jax.lax.population_count(jnp.bitwise_and(q, cand)), axis=-1)
        union = jnp.sum(jax.lax.population_count(jnp.bitwise_or(q, cand)), axis=-1)
        return jnp.where(
            union == 0, 0.0, 1.0 - inter.astype(jnp.float32) / jnp.maximum(union, 1)
        )
    raise ValueError(f"unknown bit distance function: {metric}")


def is_bit_metric(metric: str) -> bool:
    return metric in BIT_METRICS


def validate_metric(metric: str) -> None:
    if metric not in FLOAT_METRICS and metric not in BIT_METRICS:
        raise ValueError(f"unknown distance function: {metric}")
