"""Pallas-Triton kernel: blocked hamming/jaccard distance scan.

Each program scores one ``(TB, TN)`` tile of the ``[B, N]`` output. The
packed codes are passed word-major (``[W, B]`` and ``[W, N]``) so that the
loop over the W words loads one contiguous row of TB query words and one of
TN corpus words per step; the xor/and/or and popcounts accumulate in
registers and the tile is written once as float32. The words are
reinterpreted as int32, whose popcount Triton lowers to ``__nv_popc``.

Semantics equal :func:`semadb_tpu.ops.distance.pairwise_bit_distance`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from semadb_tpu.models import constants as C

# Output tile per program. (64, 128) was among the fastest of five
# power-of-two tiles tried end to end on an H100 for both metrics at
# W = 4 and W = 48; wider tiles lost on jaccard (two accumulators).
TILE_B = 64
TILE_N = 128


def _bit_kernel(qt_ref, xt_ref, o_ref, *, metric, b, n, w):
    tb, tn = TILE_B, TILE_N
    i, j = pl.program_id(0), pl.program_id(1)
    rows = i * tb + jnp.arange(tb)
    cols = j * tn + jnp.arange(tn)
    rmask, cmask = rows < b, cols < n

    def words(k):
        q = plgpu.load(qt_ref.at[k, pl.ds(i * tb, tb)], mask=rmask, other=0)
        x = plgpu.load(xt_ref.at[k, pl.ds(j * tn, tn)], mask=cmask, other=0)
        return q[:, None], x[None, :]

    popc = jax.lax.population_count

    zero = jnp.zeros((tb, tn), jnp.int32)
    if metric == C.DISTANCE_HAMMING:
        def body(k, acc):
            q, x = words(k)
            return acc + popc(q ^ x)

        out = jax.lax.fori_loop(0, w, body, zero).astype(jnp.float32)
    else:
        def body(k, carry):
            inter, union = carry
            q, x = words(k)
            return inter + popc(q & x), union + popc(q | x)

        inter, union = jax.lax.fori_loop(0, w, body, (zero, zero))
        out = jnp.where(
            union == 0,
            0.0,
            1.0 - inter.astype(jnp.float32) / jnp.maximum(union, 1).astype(jnp.float32),
        )
    plgpu.store(
        o_ref.at[pl.ds(i * tb, tb), pl.ds(j * tn, tn)],
        out,
        mask=rmask[:, None] & cmask[None, :],
    )


@functools.partial(jax.jit, static_argnames=("metric", "interpret"))
def pairwise_bit_distance_pallas(
    queries: jax.Array, corpus: jax.Array, metric: str, interpret: bool = False
) -> jax.Array:
    """``queries`` u32[B, W], ``corpus`` u32[N, W] → f32[B, N].

    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); on the GPU it compiles through Triton, and a compile failure
    raises."""
    if metric not in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
        raise ValueError(f"unknown bit distance function: {metric}")
    b, w = queries.shape
    n = corpus.shape[0]
    return pl.pallas_call(
        functools.partial(_bit_kernel, metric=metric, b=b, n=n, w=w),
        grid=(pl.cdiv(b, TILE_B), pl.cdiv(n, TILE_N)),
        out_shape=jax.ShapeDtypeStruct((b, n), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name=f"bit_distance_{metric}",
    )(
        # int32 words: Triton lowers popcount of int32 to __nv_popc but
        # cannot legalize it for uint32.
        jax.lax.bitcast_convert_type(queries.T, jnp.int32),
        jax.lax.bitcast_convert_type(corpus.T, jnp.int32),
    )
