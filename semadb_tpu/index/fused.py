"""Fused multi-vector hybrid search: exact weighted score fusion as ONE
inner-product search in an augmented space.

The reference fuses multi-index hybrid queries by summing the scores a
candidate happened to earn in each child index's own top list
(/root/reference/shard/index/search.go:211-298) — partial-score fusion
that mis-ranks candidates strong in the COMBINED score but mediocre in
every single view. Our round-2/3 pooled-rerank hybrid (bench.py
_run_hybrid) fixes the ranking but still only sees candidates surfaced
by some single view, capping measured recall at ~0.985-0.99 vs the
exact combined-score ground truth.

This module removes the structural miss entirely:
for weighted sums of per-view distances the fused score is LINEAR in an
augmented point feature, so one matmul computes exact fused scores
for arbitrary *per-query* weights:

  euclidean view i:  w_i * |x_i - q_i|^2
                   = w_i*|x_i|^2 - 2*w_i*(x_i . q_i) + w_i*|q_i|^2
  dot view i:        w_i * -(x_i . q_i)
  cosine view i:     w_i * (1 - x_i . q_i)        (normalized inputs)

Per-query constants (w_i*|q_i|^2, w_i) never change ranks, so with

  phi(x)  = [ a_1*x_1, ..., a_V*x_V,  s_i*|x_i|^2 for euclidean views ]
  psi(q,w)= [ c_i*(w_i/a_i)*q_i ... ,  w_i/s_i    for euclidean views ]
            c_i = -2 for euclidean, -1 for dot/cosine

the fused distance is  phi(x) . psi(q,w) + const(q, w)  exactly — i.e.
hybrid search IS single-vector search with metric "dot" over phi. All
of IndexIVF's machinery (SOAR copies, spill relocation, PCA-128
traversal when dim(phi) > 128, bf16 slabs, exact f32 rerank, filters,
async batching) applies unchanged; the exact rerank runs in phi space,
so returned scores are exact fused distances up to the per-query
constant (which ``search_batch`` adds back for reporting parity).

Scaling knobs (both fixed at build time, persisted):
- a_i = sqrt(default_weight_i): bakes the *default* weighting into the
  clustering geometry so k-means partitions by expected fused distance;
  queries remain exact for any weights because psi divides a_i back out.
- s_i = 1/(2*mean|x_i|) from the first fitted batch: brings the norm
  column to coordinate scale so it neither dominates nor vanishes in
  the k-means objective and the PCA traversal basis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from semadb_tpu.models import constants as C
from semadb_tpu.models.errors import ValidationError
from semadb_tpu.models.schema import VectorIVFParams

from .ivf import IndexIVF

_EUCL = C.DISTANCE_EUCLIDEAN
_VIEW_METRICS = (C.DISTANCE_EUCLIDEAN, C.DISTANCE_DOT, C.DISTANCE_COSINE)


class FusedHybridIVF:
    """Multi-view vector index with exact weighted score fusion.

    ``view_dims``/``view_metrics`` describe the per-view embedding
    spaces; ``default_weights`` set the clustering geometry (and the
    query-time default). Search accepts per-query weight overrides.
    """

    def __init__(
        self,
        view_dims: Sequence[int],
        view_metrics: Sequence[str],
        default_weights: Optional[Sequence[float]] = None,
        num_probes: int = 0,
        num_clusters: int = 0,
        assign_copies: int = 2,
    ):
        if len(view_dims) < 2:
            raise ValidationError("fused hybrid index needs >= 2 views")
        if len(view_metrics) != len(view_dims):
            raise ValidationError("view_metrics length must match view_dims")
        for m in view_metrics:
            if m not in _VIEW_METRICS:
                raise ValidationError(f"unsupported fused view metric {m}")
        self.view_dims = [int(d) for d in view_dims]
        self.view_metrics = list(view_metrics)
        w = (
            [float(x) for x in default_weights]
            if default_weights is not None
            else [1.0] * len(view_dims)
        )
        if len(w) != len(view_dims) or any(x <= 0 for x in w):
            raise ValidationError("default_weights must be positive, one per view")
        self.default_weights = w
        self._a = np.sqrt(np.asarray(w, np.float64)).astype(np.float32)
        # Norm-column scales; fixed once the first batch is seen.
        self._s = np.array(
            [1.0 if m == _EUCL else 0.0 for m in self.view_metrics], np.float32
        )
        self._s_fixed = False
        self._eucl = [i for i, m in enumerate(self.view_metrics) if m == _EUCL]
        self.aug_dim = sum(self.view_dims) + len(self._eucl)
        self.index = IndexIVF(
            VectorIVFParams(
                vector_size=self.aug_dim,
                distance_metric=C.DISTANCE_DOT,
                num_probes=num_probes,
                num_clusters=num_clusters,
                assign_copies=assign_copies,
                # Full-dim traversal: the concatenated views are NOT
                # low-rank (each view carries independent structure), so
                # the default PCA-128 traversal loses real neighbourhood
                # energy — measured 0.976 recall at 1M x (128+64) vs
                # 1.000 for the single-view engine; probe sweeps saturate
                # at 0.991. Slab bandwidth scales only by aug_dim/128.
                proj_dim=self.aug_dim,
            )
        )

    @classmethod
    def from_params(cls, params) -> "FusedHybridIVF":
        """Construct from a schema ``VectorFusedParams``."""
        return cls(
            [v.vector_size for v in params.views],
            [v.distance_metric for v in params.views],
            [v.weight for v in params.views],
            num_probes=params.num_probes,
            num_clusters=params.num_clusters,
            assign_copies=params.assign_copies,
        )

    def _split_flat(self, row: np.ndarray) -> List[np.ndarray]:
        """Split a flat concatenated row [x_1 | ... | x_V] into views —
        the journal/dispatch wire format (a single f32 vector, so the
        shard's delta records pack identically to the other engines)."""
        row = np.asarray(row, np.float32).reshape(-1)
        if row.shape[0] != sum(self.view_dims):
            raise ValidationError(
                f"flat fused row length {row.shape[0]} !="
                f" sum of view dims {sum(self.view_dims)}"
            )
        out, off = [], 0
        for d in self.view_dims:
            out.append(row[off : off + d][None, :])
            off += d
        return out

    # -- feature maps --------------------------------------------------------
    def _check_views(self, views: Sequence[np.ndarray]) -> List[np.ndarray]:
        if len(views) != len(self.view_dims):
            raise ValidationError(
                f"expected {len(self.view_dims)} views, got {len(views)}"
            )
        out = []
        for i, v in enumerate(views):
            v = np.atleast_2d(np.asarray(v, np.float32))
            if v.shape[1] != self.view_dims[i]:
                raise ValidationError(
                    f"view {i}: dim {v.shape[1]} != schema {self.view_dims[i]}"
                )
            out.append(v)
        return out

    def _fix_scales(self, views: List[np.ndarray]) -> None:
        if self._s_fixed:
            return
        for i in self._eucl:
            mean_sq = float(np.mean(np.sum(views[i] ** 2, axis=-1)))
            self._s[i] = 1.0 / max(2.0 * np.sqrt(mean_sq), 1e-6)
        self._s_fixed = True

    def _phi(self, views: Sequence[np.ndarray]) -> np.ndarray:
        views = self._check_views(views)
        self._fix_scales(views)
        cols = [self._a[i] * v for i, v in enumerate(views)]
        for i in self._eucl:
            cols.append(self._s[i] * np.sum(views[i] ** 2, -1, keepdims=True))
        return np.concatenate(cols, axis=-1)

    def _psi(
        self, qviews: Sequence[np.ndarray], weights: Optional[Sequence[float]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (psi [B, aug_dim], per-query rank constant [B])."""
        qviews = self._check_views(qviews)
        w = (
            np.asarray(weights, np.float32)
            if weights is not None
            else np.asarray(self.default_weights, np.float32)
        )
        if w.shape != (len(self.view_dims),) or np.any(w <= 0):
            raise ValidationError("weights must be positive, one per view")
        # Sign convention: the dot-metric engine MINIMIZES -(phi . psi),
        # i.e. maximizes phi . psi — so psi is built such that
        # phi . psi = const - fused_distance, making the engine's
        # returned distance exactly fused - const.
        cols, const = [], 0.0
        for i, q in enumerate(qviews):
            c = 2.0 if self.view_metrics[i] == _EUCL else 1.0
            cols.append((c * w[i] / self._a[i]) * q)
            if self.view_metrics[i] == _EUCL:
                const = const + w[i] * np.sum(q * q, axis=-1)
            elif self.view_metrics[i] == C.DISTANCE_COSINE:
                const = const + w[i]
        for i in self._eucl:
            col = np.full((qviews[0].shape[0], 1), -w[i] / self._s[i], np.float32)
            cols.append(col)
        B = qviews[0].shape[0]
        return (
            np.concatenate(cols, axis=-1),
            np.broadcast_to(np.asarray(const, np.float32), (B,)).astype(np.float32),
        )

    def _fix_probe_centroids(self) -> None:
        """Replace the centroid norm-column entries (mean of member
        ``s_i|x_i|^2``) with ``s_i|c_i|^2`` of the centroid's own view
        coordinates. Probe selection scores clusters by ``psi . c``; with
        member-mean norms that equals centroid-distance PLUS the
        intra-cluster variance (E|x-q|^2 = |c-q|^2 + E|x-c|^2), which
        demotes wide clusters even when they sit right next to the query.
        With centroid-coordinate norms it is exactly the weighted
        euclidean centroid distance — the probe rule the single-view
        engine uses (and that reaches recall 1.0 at 1M). Slab/overflow/
        rerank scores use per-point norms and are untouched. Idempotent
        (reads only the coordinate part); must re-run after every refit."""
        if not self._eucl:
            return
        cents = self.index.centroids
        if cents.shape[0] <= 1 or cents.shape[1] != self.aug_dim:
            return  # pre-fit placeholder
        if id(cents) == getattr(self, "_cent_fixed_id", None):
            return  # no refit since the last surgery
        import jax.numpy as jnp

        view_off, off = {}, 0
        for i, d in enumerate(self.view_dims):
            view_off[i] = off
            off += d
        ncol_base = off  # norm columns follow the coordinates
        new_cols = []
        for i in self._eucl:
            o = view_off[i]
            coords = cents[:, o : o + self.view_dims[i]]
            ncol = (
                (self._s[i] / (self._a[i] ** 2))
                * jnp.sum(coords * coords, axis=-1)
            )
            new_cols.append(ncol)
        self.index.centroids = jnp.concatenate(
            [cents[:, :ncol_base]] + [c[:, None] for c in new_cols], axis=-1
        )
        self._cent_fixed_id = id(self.index.centroids)

    # -- CRUD ----------------------------------------------------------------
    def insert_bulk(self, ids, views: Sequence[np.ndarray]) -> None:
        self.index.insert_bulk(ids, self._phi(views))
        self._fix_probe_centroids()

    def insert_update_delete(self, changes) -> None:
        """changes: iterable of (id, value|None); value is either a
        tuple/list of per-view arrays or a flat concatenated row (the
        dispatch/journal wire format, see ``_split_flat``)."""
        mapped = []
        for nid, views in changes:
            if views is None:
                mapped.append((nid, None))
                continue
            if isinstance(views, np.ndarray) and views.ndim == 1:
                views = self._split_flat(views)
            else:
                views = [np.atleast_2d(np.asarray(v, np.float32)) for v in views]
            mapped.append((nid, self._phi(views)[0]))
        self.index.insert_update_delete(mapped)
        self._fix_probe_centroids()

    def __len__(self) -> int:
        return len(self.index)

    def sync(self) -> None:
        """Build-completion barrier (see IndexIVF.sync)."""
        self.index.sync()

    @property
    def capacity(self) -> int:
        return self.index.capacity

    # -- search --------------------------------------------------------------
    def search_batch(
        self,
        qviews: Sequence[np.ndarray],
        k: int,
        weights: Optional[Sequence[float]] = None,
        num_probes: int = 0,
        filter_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        psi, const = self._psi(qviews, weights)
        d, i = self.index.search_batch(psi, k, num_probes, filter_mask)
        d = np.asarray(d)
        # engine distance = -(phi . psi); true fused distance adds the
        # per-query constant (rank-invariant, reported for parity with
        # summing the per-view distances on host).
        return np.where(np.isfinite(d), d + const[:, None], d), np.asarray(i)

    def search_batch_async(
        self,
        qviews: Sequence[np.ndarray],
        k: int,
        weights: Optional[Sequence[float]] = None,
        num_probes: int = 0,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Device-array variant for pipelined batching: returns the raw
        engine scores (fused distance minus the per-query constant) and
        ids without forcing a host readback."""
        psi, _ = self._psi(qviews, weights)
        return self.index.search_batch_async(psi, k, num_probes, filter_mask)

    # -- persistence ---------------------------------------------------------
    def to_arrays(self) -> dict:
        out = self.index.to_arrays()
        # to_arrays may flush deferred fits (a refit), replacing the
        # centroids after the last surgery — re-apply so the snapshot
        # probes by centroid distance from its first post-load search.
        self._fix_probe_centroids()
        out["centroids"] = np.asarray(self.index.centroids)
        out["fused_meta"] = np.array(
            [len(self.view_dims)] + self.view_dims, np.int64
        )
        out["fused_metrics"] = np.array(
            [_VIEW_METRICS.index(m) for m in self.view_metrics], np.int64
        )
        out["fused_weights"] = np.asarray(self.default_weights, np.float32)
        out["fused_scales"] = self._s.copy()
        return out

    def capture_stack_view(self):
        """Consistent snapshot for the mesh fan-out (see
        IndexIVF.capture_stack_view): the inner engine's stackable array
        view plus a frozen psi mapper. The psi mapping is PER SHARD — it
        bakes in this shard's fitted norm scales (_s), so the mesh path
        must map queries with each shard's own capture and add each
        shard's rank constant before the cross-shard top-k merge (raw
        engine scores are only comparable within one shard)."""
        import types

        inner = self.index.capture_stack_view()
        ps = types.SimpleNamespace(
            view_dims=list(self.view_dims),
            view_metrics=list(self.view_metrics),
            default_weights=list(self.default_weights),
            _a=self._a.copy(),
            _s=self._s.copy(),
            _eucl=list(self._eucl),
        )
        ps._check_views = lambda qv: FusedHybridIVF._check_views(ps, qv)
        ps.psi = lambda qviews, weights=None: FusedHybridIVF._psi(
            ps, qviews, weights
        )
        return inner, ps

    def device_arrays(self) -> dict:
        """Device-resident snapshot view for the incremental snapshot
        writer (see IndexIVF.device_arrays) — the inner engine's arrays
        (derived slabs elided, vectors row-bounded) plus the fused
        metadata, with the probe-centroid surgery re-applied exactly as
        in :meth:`to_arrays`."""
        out = self.index.device_arrays()
        self._fix_probe_centroids()
        self.index.dirty.all("centroids")  # surgery rewrote them
        out["centroids"] = self.index.centroids
        out["fused_meta"] = np.array(
            [len(self.view_dims)] + self.view_dims, np.int64
        )
        out["fused_metrics"] = np.array(
            [_VIEW_METRICS.index(m) for m in self.view_metrics], np.int64
        )
        out["fused_weights"] = np.asarray(self.default_weights, np.float32)
        out["fused_scales"] = self._s.copy()
        return out

    def snapshot_row_bounds(self) -> dict:
        return self.index.snapshot_row_bounds()

    @property
    def dirty(self):
        return self.index.dirty

    @property
    def _write_lock(self):
        return self.index._write_lock

    def _has_placeholders(self) -> bool:
        return self.index._has_placeholders()

    def flush_pending(self) -> None:
        self.index.flush_pending()

    @classmethod
    def from_arrays(cls, arrays: dict, params=None) -> "FusedHybridIVF":
        """Rebuild from a snapshot. ``params`` (schema VectorFusedParams)
        is accepted for loader-signature parity but the persisted
        ``fused_*`` arrays are authoritative — the index must score the
        slabs it was built with even if the schema copy drifted."""
        meta = np.asarray(arrays["fused_meta"])
        nviews = int(meta[0])
        dims = [int(x) for x in meta[1 : 1 + nviews]]
        metrics = [
            _VIEW_METRICS[int(x)] for x in np.asarray(arrays["fused_metrics"])
        ]
        obj = cls(dims, metrics, [float(x) for x in arrays["fused_weights"]])
        obj._s = np.asarray(arrays["fused_scales"], np.float32).copy()
        obj._s_fixed = True
        obj.index = IndexIVF.from_arrays(obj.index.params, arrays)
        obj._fix_probe_centroids()  # idempotent; covers pre-surgery snapshots
        return obj
