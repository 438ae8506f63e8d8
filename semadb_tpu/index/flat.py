"""Flat (brute-force exact) vector index.

Reference: shard/index/flat/flat.go — a full scan with insertion-sort top-K
and filter bitmap check, sharing the vectorstore (and thus quantizers) with
the vamana index. On the device the scan is one blocked distance matmul (or
a bit/ADC scan when quantized) plus ``top_k``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from semadb_tpu.models.schema import VectorFlatParams
from semadb_tpu.ops.topk import top_k_smallest
from semadb_tpu.vectorstore import QuantConfig, VectorStore
from semadb_tpu.utils.grow import next_capacity

MIN_CAPACITY = 128


class IndexFlat:
    """Exact top-k index over device-resident vectors.

    Surface parity with flat.go: InsertUpdateDelete over (id, vector|None)
    changes + Search with optional filter mask; shares vamana's
    IndexVectorChange input type in the reference (flat.go:41-74).
    """

    def __init__(self, params: VectorFlatParams, capacity: int = MIN_CAPACITY):
        from semadb_tpu.utils.grow import initial_capacity

        self.params = params
        self.capacity = max(
            capacity, initial_capacity(params.vector_size * 4, MIN_CAPACITY)
        )
        self.vectors = jnp.zeros((self.capacity, params.vector_size), jnp.float32)
        self.exists = jnp.zeros((self.capacity,), bool)
        self._max_seen = 0  # snapshot row bound (highest id ever written)
        self.store = VectorStore(
            QuantConfig.from_params(
                params.quantizer, params.vector_size, params.distance_metric
            )
        )

    def __len__(self) -> int:
        return int(jnp.sum(self.exists))

    def _ensure_capacity(self, max_id: int) -> None:
        self._max_seen = max(self._max_seen, int(max_id))
        if max_id < self.capacity:
            return
        new_cap = next_capacity(
            self.capacity, max_id, self.params.vector_size * 4
        )
        self.vectors = jnp.pad(self.vectors, ((0, new_cap - self.capacity), (0, 0)))
        self.exists = jnp.pad(self.exists, (0, new_cap - self.capacity))
        self.capacity = new_cap

    def insert_update_delete(
        self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]
    ) -> None:
        ups: list[tuple[int, np.ndarray]] = []
        dels: list[int] = []
        max_id = 0
        for node_id, vec in changes:
            if node_id in (0, 1):
                raise ValueError(f"cannot modify point with reserved id: {node_id}")
            max_id = max(max_id, node_id)
            if vec is None:
                dels.append(node_id)
            else:
                ups.append((node_id, vec))
        self._ensure_capacity(max_id)
        if ups:
            ids = np.array([u[0] for u in ups], np.int32)
            vecs = np.stack([np.asarray(u[1], np.float32) for u in ups])
            self.vectors = self.vectors.at[ids].set(jnp.asarray(vecs))
            self.exists = self.exists.at[ids].set(True)
            if self.store.fitted:
                self.store.encode_rows(self.vectors, ids)
        if dels:
            ids = np.array(dels, np.int32)
            self.exists = self.exists.at[ids].set(False)
        self.store.maybe_fit(self.vectors, self.exists)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: (dists f32[B,k], ids i32[B,k]); empty → (inf, -1)."""
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        mask = self.exists
        if filter_mask is not None:
            fm = jnp.asarray(filter_mask, bool)
            if fm.shape[0] < self.capacity:
                fm = jnp.pad(fm, (0, self.capacity - fm.shape[0]))
            mask = mask & fm
        d = self.store.scan_distances(q, self.vectors, mask)
        k = min(k, self.capacity)
        vals, idx = top_k_smallest(d, k)
        idx = jnp.where(jnp.isfinite(vals), idx, -1)
        return np.asarray(vals), np.asarray(idx, np.int32)

    # -- persistence -------------------------------------------------------
    def to_arrays(self) -> dict:
        return {
            "vectors": np.asarray(self.vectors),
            "exists": np.asarray(self.exists),
            "store": self.store.to_arrays(),
        }

    def snapshot_row_bounds(self) -> dict:
        """Used-row bounds for the incremental snapshot writer (see
        IndexIVF.snapshot_row_bounds)."""
        b = min(self.capacity, int(self._max_seen) + 1)
        return {"vectors": b, "exists": b, "store/codes": b}

    @classmethod
    def from_arrays(cls, params: VectorFlatParams, arrays: dict) -> "IndexFlat":
        rows = int(arrays["vectors"].shape[0])
        idx = cls(params, capacity=rows)
        # Row-bounded snapshots persist only used rows; re-pad on device
        # along the PREGROW-AWARE growth chain so write shapes match the
        # pre-crash process (seeding the chain at 128 and max()ing with
        # pregrow lets a growth-bucket overshoot beat the deliberate
        # pregrow shape — the 10M reopen OOM, see IndexIVF.from_arrays).
        from semadb_tpu.utils.grow import initial_capacity

        base = initial_capacity(params.vector_size * 4, MIN_CAPACITY)
        target = max(
            next_capacity(base, rows - 1, params.vector_size * 4)
            if rows
            else base,
            rows,
        )
        vec = jnp.asarray(arrays["vectors"])
        ex = jnp.asarray(arrays["exists"])
        if target > rows:
            vec = jnp.pad(vec, ((0, target - rows), (0, 0)))
            ex = jnp.pad(ex, (0, target - rows))
        idx.vectors = vec
        idx.exists = ex
        idx.capacity = target
        idx._max_seen = max(rows - 1, 0)
        idx.store.load_arrays(arrays.get("store", {}))
        idx.store.ensure_rows(target)
        return idx
