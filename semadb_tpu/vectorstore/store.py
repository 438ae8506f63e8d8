"""Pluggable vector store: plain / binary / product quantization.

Reference surface: shard/vectorstore/vectorstore.go VectorStore interface
(Exists/Get/Set/Delete/Fit/DistanceFromFloat/DistanceFromPoint/Flush) with
three backends (plain.go, binary.go, product.go). Device-side redesign:

  - vectors and codes are dense device arrays indexed by node id (the same
    id space as the Vamana graph rows)
  - ``fit`` is one device program: per-dimension mean threshold for binary
    (binary.go:145-185), vmapped per-subvector k-means for product
    (product.go:175-236)
  - query preparation happens once per batch: binarize for BQ, ADC lookup
    tables (one ``[M, K]`` table per query, product.go:254-276) for PQ
  - distance evaluation during search is a gather over codes — 32x less
    device-memory traffic for BQ, D/M·4x less for PQ — the entire point of
    quantization on a bandwidth-bound device

Like the reference, raw float vectors are retained alongside codes (the
reference stores both in the bucket; memory-saving reads are an
optimisation, product.go:349-369).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from semadb_tpu.models import constants as C
from semadb_tpu.models.quantizer import Quantizer
from semadb_tpu.ops import bitops
from semadb_tpu.ops.distance import (
    gather_bit_distance,
    gather_distance,
    pairwise_bit_distance,
)
from semadb_tpu.vectorstore.kmeans import kmeans_fit_subvectors

PLAIN = "plain"
BINARY = "binary"
PRODUCT = "product"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantizer parameters (hashable, baked into kernels)."""

    kind: str  # plain | binary | product
    dim: int
    metric: str  # float metric of the index
    # binary
    bit_metric: str = C.DISTANCE_HAMMING
    threshold: Optional[float] = None  # fixed threshold; None = fit mean
    trigger: int = 0
    # product
    num_subvectors: int = 8
    num_centroids: int = 256
    # OPQ: learn an orthonormal rotation before the subvector split
    # (quantizer.py ProductQuantizerParams.opq rationale)
    opq: bool = False
    # True when the *user's* index metric is hamming/jaccard (the store is a
    # forced binary wrapper, vectorstore.go:56-67) — search must NOT rerank
    # with a float metric in that case.
    user_bit_metric: bool = False

    @property
    def subvector_len(self) -> int:
        return self.dim // self.num_subvectors

    @classmethod
    def from_params(cls, q: Optional[Quantizer], dim: int, metric: str) -> "QuantConfig":
        # Hamming/jaccard as user metrics: overwrite with a fixed-threshold
        # binary store — users send float 0/1 vectors which are binarised
        # (vectorstore.go:56-67, threshold 0.5).
        if metric in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
            return cls(
                kind=BINARY,
                dim=dim,
                metric=C.DISTANCE_EUCLIDEAN,  # internal float metric for build
                bit_metric=metric,
                threshold=0.5,
                user_bit_metric=True,
            )
        if q is None or q.type == C.QUANTIZER_NONE:
            return cls(kind=PLAIN, dim=dim, metric=metric)
        if q.type == C.QUANTIZER_BINARY:
            b = q.binary
            return cls(
                kind=BINARY,
                dim=dim,
                metric=metric,
                bit_metric=b.distance_metric,
                threshold=b.threshold,
                trigger=b.trigger_threshold,
            )
        if q.type == C.QUANTIZER_PRODUCT:
            p = q.product
            if dim % p.num_subvectors != 0:
                raise ValueError(
                    f"vector size {dim} not divisible by numSubVectors {p.num_subvectors}"
                )
            return cls(
                kind=PRODUCT,
                dim=dim,
                metric=metric,
                trigger=p.trigger_threshold,
                num_subvectors=p.num_subvectors,
                num_centroids=p.num_centroids,
                opq=getattr(p, "opq", False),
            )
        raise ValueError(f"unknown quantizer type {q.type}")


class QuantState(NamedTuple):
    """Fitted quantizer state + codes (device pytree).

    binary: codes u32[cap, ceil(D/32)], aux = threshold f32[D]
    product: codes u8[cap, M], aux = codebooks f32[M, K, D/M],
             rot = optional OPQ rotation f32[D, D] (codes/codebooks live
             in the rotated space; queries rotate once per batch)
    """

    codes: jax.Array
    aux: jax.Array
    rot: Optional[jax.Array] = None


# ---------------------------------------------------------------------------
# Binary quantization kernels
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("dim",))
def bq_fit_threshold(vectors: jax.Array, mask: jax.Array, dim: int) -> jax.Array:
    """Per-dimension mean over live rows (binary.go:152-173)."""
    m = mask.astype(jnp.float32)[:, None]
    s = jnp.sum(vectors * m, axis=0)
    n = jnp.maximum(jnp.sum(m), 1.0)
    return s / n


@functools.partial(jax.jit, static_argnames=("dim",))
def bq_encode(vectors: jax.Array, threshold: jax.Array, dim: int) -> jax.Array:
    return bitops.binarize(vectors, threshold, dim)


def bit_scan(codes_q: jax.Array, codes: jax.Array, metric: str) -> jax.Array:
    """All-pairs bit distances for the flat index's binary-quantized scan:
    the Pallas-Triton kernel on the GPU, the XLA formulation elsewhere."""
    if jax.default_backend() == "gpu":
        from semadb_tpu.ops.pallas.hamming import pairwise_bit_distance_pallas

        return pairwise_bit_distance_pallas(codes_q, codes, metric)
    return pairwise_bit_distance(codes_q, codes, metric)


# ---------------------------------------------------------------------------
# Product quantization kernels
# ---------------------------------------------------------------------------


# Codebook fits need ~1k samples per centroid, not the corpus: call sites
# stride-subsample past this many rows (the encode still covers every live
# row). At 256k samples the codebooks are statistically identical to a
# full-N fit (1024 samples/centroid at K=256).
PQ_FIT_SAMPLE = 262144


@functools.partial(jax.jit, static_argnames=("m", "k", "stride", "max_iter"))
def pq_fit(
    vectors: jax.Array, mask: jax.Array, m: int, k: int, seed: int = 0,
    stride: int = 1, max_iter: int = 100,
):
    """Fit codebooks on live rows. Masked rows are replaced by the mean live
    row so they never become centroids of interest (the reference fits on
    exactly the live set; dead rows here are rare padding). ``stride``
    subsamples the fit set (PQ_FIT_SAMPLE rationale above) — static so the
    sliced shape stays compile-time known."""
    d = vectors.shape[1]
    dsub = d // m
    mean = jnp.sum(vectors * mask[:, None], axis=0) / jnp.maximum(jnp.sum(mask), 1)
    filled = jnp.where(mask[:, None], vectors, mean[None, :])
    if stride > 1:
        filled = filled[::stride]
    sub = filled.reshape(-1, m, dsub).transpose(1, 0, 2)  # [M, N, dsub]
    centroids, _ = kmeans_fit_subvectors(sub, k, seed, max_iter)
    return centroids  # [M, k, dsub]


@jax.jit
def _pq_decode(codes: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Reconstruct rows from codes: u8[N, M] + f32[M, K, dsub] → f32[N, D]."""
    n, m = codes.shape
    rec = jnp.take_along_axis(
        codebooks[None, :, :, :],
        codes[:, :, None, None].astype(jnp.int32),
        axis=2,
    )[:, :, 0, :]
    return rec.reshape(n, -1)


def opq_fit(
    vectors: jax.Array, mask: jax.Array, m: int, k: int,
    iters: int = 6, seed: int = 0,
):
    """OPQ-NP (Ge et al., CVPR 2013): jointly learn an orthonormal rotation
    R and the codebooks by alternating (a) PQ fit+encode in the rotated
    space, (b) the Procrustes update R = U Vᵀ from SVD(Xᵀ·recon). The
    rotation decorrelates dimensions across subvectors, which plain PQ
    (product.go:136-305) cannot — ADC error drops at identical code size.

    The iteration runs on a ≤64k-row subsample with capped Lloyd rounds
    (codebooks need ~256 samples per centroid, not the corpus); the final
    codebooks are refit on a ≤PQ_FIT_SAMPLE-row subsample in rotated space
    (a full-N final fit costs build time for no recall change). The
    [D, D] SVD runs on host (D ≤ a few thousand, microseconds), everything
    else on device.

    Returns (R f32[D, D], codebooks f32[M, K, dsub]).
    """
    n, d = vectors.shape
    mean = jnp.sum(vectors * mask[:, None], axis=0) / jnp.maximum(jnp.sum(mask), 1)
    filled = jnp.where(mask[:, None], vectors, mean[None, :])
    stride = max(n // 65536, 1)
    X = filled[::stride]
    ones = jnp.ones((X.shape[0],), bool)
    R = jnp.eye(d, dtype=jnp.float32)
    for _ in range(iters):
        Y = X @ R
        cb = pq_fit(Y, ones, m, k, seed, max_iter=25)
        codes = pq_encode(Y, cb, m, k, C.DISTANCE_EUCLIDEAN)
        recon = _pq_decode(codes, cb)
        mm = jax.lax.dot_general(
            X, recon, dimension_numbers=(((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        u, _, vt = np.linalg.svd(np.asarray(mm).astype(np.float64))
        R = jnp.asarray((u @ vt).astype(np.float32))
    cb = pq_fit(filled @ R, mask, m, k, seed, stride=max(n // PQ_FIT_SAMPLE, 1))
    return R, cb


@functools.partial(jax.jit, static_argnames=("m", "k", "metric"))
def pq_encode(
    vectors: jax.Array, codebooks: jax.Array, m: int, k: int, metric: str,
    row_ids=None,
):
    """Assign each subvector to its nearest centroid **by the index metric**
    (product.go:136-158 uses pq.distFn). Returns u8[N, M].

    Blocked over rows past ~256 MB of [N, M, K] distance tensor: at
    1M x 1536d (M=96, K=256) the unblocked tensor is 98 GB. With
    ``row_ids``, `vectors` is the full backing matrix and rows gather per
    block (avoids a second [N, D] copy at peak HBM)."""
    n = row_ids.shape[0] if row_ids is not None else vectors.shape[0]
    d = vectors.shape[1]
    if row_ids is not None or n * m * k > 2**26:
        nb = max(2**26 // (m * k), 256)
        nblk = -(-n // nb)
        npad = nblk * nb
        if row_ids is not None:
            rpad = row_ids if npad == n else jnp.pad(row_ids, (0, npad - n))
            _, codes = jax.lax.scan(
                lambda _, r: (None, _pq_encode_block(vectors[r], codebooks, m, k, metric)),
                None, rpad.reshape(nblk, nb),
            )
        else:
            vpad = vectors if npad == n else jnp.pad(vectors, ((0, npad - n), (0, 0)))
            _, codes = jax.lax.scan(
                lambda _, v: (None, _pq_encode_block(v, codebooks, m, k, metric)),
                None, vpad.reshape(nblk, nb, d),
            )
        return codes.reshape(npad, m)[:n]
    return _pq_encode_block(vectors, codebooks, m, k, metric)


def _pq_encode_block(vectors: jax.Array, codebooks: jax.Array, m: int, k: int, metric: str):
    n, d = vectors.shape
    dsub = d // m
    sub = vectors.reshape(n, m, dsub)
    if metric in (C.DISTANCE_DOT, C.DISTANCE_COSINE):
        cross = jnp.einsum(
            "nmd,mkd->nmk", sub, codebooks,
            precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
        )
        dist = (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross
    else:  # euclidean default
        sq_s = jnp.sum(sub * sub, axis=-1)[:, :, None]
        sq_c = jnp.sum(codebooks * codebooks, axis=-1)[None, :, :]
        cross = jnp.einsum(
            "nmd,mkd->nmk", sub, codebooks,
            precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
        )
        dist = sq_s - 2.0 * cross + sq_c
    return jnp.argmin(dist, axis=-1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("m", "k", "metric"))
def pq_query_table(queries: jax.Array, codebooks: jax.Array, m: int, k: int, metric: str):
    """ADC tables: distance of each query subvector to every centroid
    (product.go:254-268). Returns f32[B, M, K]."""
    b, d = queries.shape
    dsub = d // m
    sub = queries.reshape(b, m, dsub)
    if metric in (C.DISTANCE_DOT, C.DISTANCE_COSINE):
        cross = jnp.einsum(
            "bmd,mkd->bmk", sub, codebooks,
            precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
        )
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross
    sq_s = jnp.sum(sub * sub, axis=-1)[:, :, None]
    sq_c = jnp.sum(codebooks * codebooks, axis=-1)[None, :, :]
    cross = jnp.einsum(
        "bmd,mkd->bmk", sub, codebooks,
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
    )
    return sq_s - 2.0 * cross + sq_c


@functools.partial(jax.jit, static_argnames=("k",))
def pq_gather_distance(codes: jax.Array, ids: jax.Array, table: jax.Array, k: int):
    """ADC distance to gathered candidates: codes u8[cap, M], ids i32[B, Kc],
    table f32[B, M, K] → f32[B, Kc] (product.go:269-276 lookup-accumulate)."""
    b, m, _ = table.shape
    cand = codes[ids].astype(jnp.int32)  # [B, Kc, M]
    flat_idx = (jnp.arange(m, dtype=jnp.int32)[None, None, :] * k + cand).reshape(
        b, -1
    )  # [B, Kc*M]
    flat_table = table.reshape(b, m * k)
    vals = jnp.take_along_axis(flat_table, flat_idx, axis=1)
    return jnp.sum(vals.reshape(b, cand.shape[1], m), axis=-1)


@functools.partial(jax.jit, static_argnames=("k",))
def pq_scan_distance(codes: jax.Array, mask: jax.Array, table: jax.Array, k: int):
    """Full ADC scan (flat index): codes u8[N, M], mask bool[N],
    table f32[B, M, K] → f32[B, N]; masked rows get +inf."""
    b, m, _ = table.shape
    n = codes.shape[0]
    flat_idx = (
        jnp.arange(m, dtype=jnp.int32)[None, :] * k + codes.astype(jnp.int32)
    ).reshape(-1)  # [N*M]
    flat_table = table.reshape(b, m * k)
    vals = flat_table[:, flat_idx].reshape(b, n, m)
    d = jnp.sum(vals, axis=-1)
    return jnp.where(mask[None, :], d, jnp.inf)


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------


class VectorStore:
    """Host handle pairing raw vectors (owned by the graph/flat index) with
    quantizer state and fit triggers.

    Parity: vectorstore.New (vectorstore.go:47-96) + Fit trigger semantics
    (binary.go:145-151, product.go:175-183): fit once, when the live count
    reaches the trigger threshold.
    """

    def __init__(self, config: QuantConfig):
        self.config = config
        self.state: Optional[QuantState] = None
        if config.kind == BINARY and config.threshold is not None:
            # Fixed threshold → fitted from the start with an empty code table
            thr = jnp.full((config.dim,), config.threshold, jnp.float32)
            self.state = QuantState(
                codes=jnp.zeros((0, bitops.packed_width(config.dim)), jnp.uint32),
                aux=thr,
            )

    @property
    def kind(self) -> str:
        return self.config.kind

    @property
    def fitted(self) -> bool:
        return self.state is not None

    def search_kind(self) -> str:
        """Distance mode the search path should use right now."""
        return self.config.kind if self.fitted else PLAIN

    def maybe_fit(self, vectors: jax.Array, exists_mask: jax.Array) -> bool:
        """Fit trigger check; encodes ALL live vectors on (re)fit.

        Returns True if a fit happened.
        """
        if self.config.kind == PLAIN or self.fitted:
            return False
        live = int(jnp.sum(exists_mask))
        if live < max(self.config.trigger, 1):
            return False
        if self.config.kind == BINARY:
            thr = bq_fit_threshold(vectors, exists_mask, self.config.dim)
            codes = bq_encode(vectors, thr, self.config.dim)
            self.state = QuantState(codes=codes, aux=thr)
        else:
            rot = None
            if self.config.opq:
                rot, cb = opq_fit(
                    vectors, exists_mask,
                    self.config.num_subvectors, self.config.num_centroids,
                )
            else:
                cb = pq_fit(
                    vectors, exists_mask,
                    self.config.num_subvectors, self.config.num_centroids,
                    stride=max(vectors.shape[0] // PQ_FIT_SAMPLE, 1),
                )
            enc_in = vectors if rot is None else vectors @ rot
            codes = pq_encode(
                enc_in, cb, self.config.num_subvectors, self.config.num_centroids,
                self.config.metric,
            )
            self.state = QuantState(codes=codes, aux=cb, rot=rot)
        return True

    def encode_rows(self, vectors: jax.Array, row_ids: np.ndarray) -> None:
        """Encode newly written rows into the code table (post-fit inserts)."""
        if not self.fitted or self.config.kind == PLAIN:
            return
        codes = self.state.codes
        if codes.shape[0] < vectors.shape[0]:
            # capacity grew (or fixed-threshold empty table): pad codes
            pad = vectors.shape[0] - codes.shape[0]
            codes = jnp.pad(codes, ((0, pad), (0, 0)))
        ids = jnp.asarray(row_ids, jnp.int32)
        if self.config.kind == BINARY:
            new = bq_encode(vectors[ids], self.state.aux, self.config.dim)
        else:
            rows = vectors[ids]
            if self.state.rot is not None:
                rows = rows @ self.state.rot
            new = pq_encode(
                rows, self.state.aux,
                self.config.num_subvectors, self.config.num_centroids,
                self.config.metric,
            )
        self.state = QuantState(
            codes=codes.at[ids].set(new), aux=self.state.aux, rot=self.state.rot
        )

    # -- query-side helpers -------------------------------------------------
    def prepare_queries(self, queries: jax.Array):
        """Per-batch query prep: BQ → packed codes; PQ → ADC tables."""
        if not self.fitted:
            return None
        if self.config.kind == BINARY:
            return bq_encode(queries, self.state.aux, self.config.dim)
        if self.config.kind == PRODUCT:
            q = queries if self.state.rot is None else queries @ self.state.rot
            return pq_query_table(
                q, self.state.aux,
                self.config.num_subvectors, self.config.num_centroids,
                self.config.metric,
            )
        return None

    def scan_distances(self, queries: jax.Array, vectors: jax.Array, mask: jax.Array):
        """Exact full-scan distances for the flat index, through the active
        quantization (flat.go does its scan via the vectorstore)."""
        from semadb_tpu.ops.distance import pairwise_distance
        from semadb_tpu.ops.topk import INF

        if not self.fitted or self.config.kind == PLAIN:
            d = pairwise_distance(queries, vectors, self.config.metric)
            return jnp.where(mask[None, :], d, INF)
        if self.config.kind == BINARY:
            qc = bq_encode(queries, self.state.aux, self.config.dim)
            d = bit_scan(qc, self.state.codes, self.config.bit_metric)
            return jnp.where(mask[None, :], d, INF)
        q = queries if self.state.rot is None else queries @ self.state.rot
        table = pq_query_table(
            q, self.state.aux,
            self.config.num_subvectors, self.config.num_centroids, self.config.metric,
        )
        return pq_scan_distance(
            self.state.codes, mask, table, self.config.num_centroids
        )

    # -- persistence --------------------------------------------------------
    def to_arrays(self) -> dict:
        return {
            k: np.asarray(v) if hasattr(v, "shape") else v
            for k, v in self.device_arrays().items()
        }

    def device_arrays(self) -> dict:
        """Device-resident view (no readback) for the incremental
        snapshot writer (shard/snapshot.py)."""
        out = {"kind": self.config.kind, "fitted": self.fitted}
        if self.fitted:
            out["codes"] = self.state.codes
            out["aux"] = self.state.aux
            if self.state.rot is not None:
                out["rot"] = self.state.rot
        return out

    def ensure_rows(self, n: int) -> None:
        """Pad the code table to at least ``n`` rows (row-bounded
        snapshots persist only used rows; search kernels index codes with
        node ids up to the engine's capacity)."""
        if self.fitted and self.state.codes.shape[0] < n:
            self.state = QuantState(
                codes=jnp.pad(
                    self.state.codes,
                    ((0, n - self.state.codes.shape[0]), (0, 0)),
                ),
                aux=self.state.aux,
                rot=self.state.rot,
            )

    def load_arrays(self, arrays: dict) -> None:
        if arrays.get("fitted"):
            self.state = QuantState(
                codes=jnp.asarray(arrays["codes"]),
                aux=jnp.asarray(arrays["aux"]),
                rot=jnp.asarray(arrays["rot"]) if "rot" in arrays else None,
            )
