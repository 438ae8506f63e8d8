"""Bit packing utilities for binary quantization.

Reference behavior: shard/vectorstore/binary.go:103-184 packs
``vector[i] > threshold`` bits into []uint64. Here we pack into uint32 words
(32-bit words, the native integer width of the accelerator's vector
units), little-endian bit order within a word. The word
width is padded up so the packed array keeps a static lane-friendly shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

WORD_BITS = 32


def packed_width(dim: int) -> int:
    """Number of uint32 words needed for ``dim`` bits."""
    return (dim + WORD_BITS - 1) // WORD_BITS


@functools.partial(jax.jit, static_argnames=("dim",))
def pack_bits(bits: jax.Array, dim: int) -> jax.Array:
    """Pack boolean ``[..., dim]`` into ``uint32[..., ceil(dim/32)]``.

    Bit ``i`` of the flat vector lands in word ``i // 32`` at position
    ``i % 32`` (LSB first).
    """
    w = packed_width(dim)
    pad = w * WORD_BITS - dim
    b = bits.astype(jnp.uint32)
    if pad:
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    b = b.reshape(b.shape[:-1] + (w, WORD_BITS))
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("dim",))
def unpack_bits(words: jax.Array, dim: int) -> jax.Array:
    """Inverse of :func:`pack_bits`; returns bool ``[..., dim]``."""
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    bits = (words[..., :, None] >> shifts) & jnp.uint32(1)
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return flat[..., :dim].astype(jnp.bool_)


@functools.partial(jax.jit, static_argnames=("dim",))
def binarize(vectors: jax.Array, threshold: jax.Array, dim: int) -> jax.Array:
    """Threshold + pack: ``f32[..., dim] → uint32[..., ceil(dim/32)]``.

    ``threshold`` may be a scalar or per-dimension ``f32[dim]``
    (binary.go:103-129 uses a scalar; we also support the per-dim mean fit).
    """
    return pack_bits(vectors > threshold, dim)
