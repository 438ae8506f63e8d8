"""Vamana (DiskANN-style) graph ANN index, device-resident.

Host wrapper over the functional kernels in graph/search/build. Parity
surface mirrors shard/index/vamana/vamana.go: InsertUpdateDelete over
(id, vector|None) changes, Search with options + optional filter,
persistence via array snapshots.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from semadb_tpu.index.vamana import build, graph, search as search_mod
from semadb_tpu.index.vamana.build import delete_batch, insert_batch, robust_prune_batch  # noqa: F401
from semadb_tpu.index.vamana.graph import (  # noqa: F401
    NIL,
    START_ID,
    GraphConfig,
    GraphState,
    grow_graph,
    init_graph,
    required_capacity,
)
from semadb_tpu.index.vamana.search import (  # noqa: F401
    beam_search,
    exact_search,
    search,
    search_filtered,
)
from semadb_tpu.models import constants as C
from semadb_tpu.models.schema import VectorVamanaParams

# Insert chunk size: large enough to fill the device, small enough that the
# parallel-batch approximation of sequential insertion stays benign.
INSERT_CHUNK = 512


import functools as _functools

import jax as _jax


@_functools.partial(_jax.jit, static_argnames=("metric", "s"))
def _route_seeds(cents, reps, exists, q, metric: str, s: int):
    """Per-query entry seeds: the live representatives of the ``s``
    nearest pool-build clusters — one [B, C] matmul + top_k.
    Dead representatives (deleted since the build) degrade to NIL seeds,
    which the beam search ignores."""
    from semadb_tpu.ops.distance import pairwise_distance

    d = pairwise_distance(q, cents, metric)  # [B, C]
    _, top = _jax.lax.top_k(-d, s)
    seeds = reps[top]  # [B, s] — or [B, s, m] with multi-rep routing
    if seeds.ndim == 3:
        seeds = seeds.reshape(seeds.shape[0], -1)
    ok = exists[jnp.clip(seeds, 0, exists.shape[0] - 1)] & (seeds >= 0)
    return jnp.where(ok, seeds, NIL)

import os as _os

# Two-pass bulk build (DiskANN's canonical schedule): pass 1 builds the
# whole graph incrementally at alpha=1.0; pass 2 re-inserts every point
# against the COMPLETE graph at the configured alpha, with candidate pool
# = fresh visited set ∪ the node's current out-edges. The reference builds
# single-pass incrementally (vamana.go:190-253) and publishes 0.999 recall
# on SIFT1M; single-pass batched building plateaued at 0.9960 here.
TWO_PASS = _os.environ.get("SEMADB_VAMANA_TWO_PASS", "1") != "0"
# Below this corpus size the single-pass build already reaches the recall
# ceiling and the second pass is wasted work.
TWO_PASS_MIN = int(_os.environ.get("SEMADB_VAMANA_TWO_PASS_MIN", 4096))
# Pass-2 batches can be larger: every point already exists in the graph,
# so the parallel-batch approximation concern (late inserts not seeing
# earlier in-batch points) doesn't apply — fewer dispatches, same math.
PASS2_CHUNK = int(_os.environ.get("SEMADB_VAMANA_PASS2_CHUNK", 4096))
# Build-cost knobs: per-pass search-list overrides (0 = the index's
# searchSize). The build is search-dominated; a narrower pass-1 list
# cheapens the scaffold pass.
PASS1_L = int(_os.environ.get("SEMADB_VAMANA_PASS1_L", 0))
PASS2_L = int(_os.environ.get("SEMADB_VAMANA_PASS2_L", 0))
# Bulk-build strategy: "search" = the beam-search two-pass schedule above;
# "pool" = matmul-built per-cluster exact-kNN candidate pools (fastbuild.py)
# — no graph walks during construction at all. Applies to fresh graphs
# only; incremental writes always use the beam-search path.
BUILD_MODE = _os.environ.get("SEMADB_VAMANA_BUILD", "search")


class IndexVamana:
    """Stateful host handle on a device-resident Vamana graph.

    Reference: shard/index/vamana/vamana.go IndexVamana. Quantized search
    (binary/product) plugs in through the vectorstore layer.
    """

    def __init__(self, params: VectorVamanaParams, capacity: int = graph.MIN_CAPACITY):
        from semadb_tpu.vectorstore import QuantConfig, VectorStore

        self.params = params
        # Bit metrics (hamming/jaccard) use euclidean as the internal float
        # metric for graph construction: on 0/1 vectors squared euclidean
        # equals hamming exactly; search distances come from the forced
        # binary store (vectorstore.go:56-67).
        internal_metric = params.distance_metric
        if internal_metric in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
            internal_metric = C.DISTANCE_EUCLIDEAN
        self.config = GraphConfig(
            dim=params.vector_size,
            metric=internal_metric,
            degree_bound=params.degree_bound,
            search_size=params.search_size,
            alpha=params.alpha,
        )
        self.state = init_graph(self.config, capacity)
        # Quantizer (vectorstore.go:47-96): plain unless params.quantizer set
        self.store = VectorStore(
            QuantConfig.from_params(params.quantizer, params.vector_size, params.distance_metric)
        )
        # Entry seeds: a small spread of live nodes used as extra search
        # entry points alongside the start node — cuts the initial descent
        # hops (the start node is a random unit vector, far from the data).
        self._entry_seeds: Optional[np.ndarray] = None
        # Query-routed entry (pool builds): k-means centroids + one live
        # representative node per cluster. Searches seed their beam at the
        # nearest clusters' representatives (one [B, C] matmul), so deep
        # recall rests on LOCAL graph quality instead of long-range
        # navigation from the start node — the batched replacement
        # for the navigable-highway edges an incremental beam build grows
        # (vamana.go:93-120's random start + organic backedges).
        self._route: Optional[tuple] = None  # (cents f32[C,D], reps i32[C])
        # Dirty-row tracking for incremental snapshots (shard/snapshot.py).
        from semadb_tpu.utils.dirty import DirtyTracker

        self.dirty = DirtyTracker()
        # Highest node id ever written — the snapshot row bound (rows
        # past it are capacity padding that never needs to leave the
        # device). START_ID is always live.
        self._max_seen = graph.START_ID
        # Grow-ahead bookkeeping (_maybe_grow_ahead)
        self._grow_thread = None
        self._warm_target = 0

    # -- persistence -------------------------------------------------------
    def to_arrays(self) -> dict:
        out = {
            "vectors": np.asarray(self.state.vectors),
            "adjacency": np.asarray(self.state.adjacency),
            "exists": np.asarray(self.state.exists),
        }
        if self._route is not None:
            out["route_cents"] = np.asarray(self._route[0])
            out["route_reps"] = np.asarray(self._route[1])
        out["store"] = self.store.to_arrays()
        return out

    def device_arrays(self) -> dict:
        """Device-resident snapshot view (no readback) for the incremental
        snapshot writer (shard/snapshot.py)."""
        out = {
            "vectors": self.state.vectors,
            "adjacency": self.state.adjacency,
            "exists": self.state.exists,
            "store": self.store.device_arrays(),
        }
        if self._route is not None:
            out["route_cents"] = self._route[0]
            out["route_reps"] = self._route[1]
        return out

    @classmethod
    def from_arrays(cls, params: VectorVamanaParams, arrays: dict) -> "IndexVamana":
        rows = int(arrays["vectors"].shape[0])
        idx = cls(params, capacity=rows)
        state = GraphState(
            vectors=jnp.asarray(arrays["vectors"]),
            adjacency=jnp.asarray(arrays["adjacency"]),
            exists=jnp.asarray(arrays["exists"]),
        )
        # Row-bounded snapshots persist only used rows; re-pad on device
        # along the PREGROW-AWARE growth chain (seeding the chain at the
        # 128 floor and max()ing with pregrow lets a growth-bucket
        # overshoot beat the deliberate pregrow shape — the 10M reopen
        # OOM class, see IndexIVF.from_arrays).
        from semadb_tpu.utils.grow import initial_capacity, next_capacity

        row_bytes = (idx.config.dim + idx.config.degree_bound) * 4
        base = max(
            graph.MIN_CAPACITY, initial_capacity(row_bytes, graph.MIN_CAPACITY)
        )
        target = max(
            next_capacity(base, max(rows - 1, 0), row_bytes),
            rows,
        )
        if state.capacity < target:
            state = grow_graph(state, target)
        idx.state = state
        idx._max_seen = max(rows - 1, graph.START_ID)
        if "route_cents" in arrays:
            idx._route = (
                jnp.asarray(arrays["route_cents"]),
                jnp.asarray(arrays["route_reps"]),
            )
        if "store" in arrays:
            idx.store.load_arrays(arrays["store"])
            idx.store.ensure_rows(idx.state.capacity)
        # Loaded state matches the snapshot it came from: nothing dirty.
        idx.dirty.clear()
        return idx

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return int(graph.live_count(self.state))

    def exists_id(self, node_id: int) -> bool:
        if not (0 <= node_id < self.state.capacity):
            return False
        return bool(self.state.exists[node_id]) and node_id != START_ID

    def snapshot_row_bounds(self) -> dict:
        """Used-row bounds for the incremental snapshot writer (see
        IndexIVF.snapshot_row_bounds): graph arrays are capacity-padded;
        from_arrays re-pads to the policy bucket on device."""
        b = min(self.state.capacity, int(self._max_seen) + 1)
        return {
            "vectors": b, "adjacency": b, "exists": b, "store/codes": b,
        }

    def _ensure_capacity(self, max_id: int) -> None:
        self._max_seen = max(self._max_seen, int(max_id))
        if max_id >= self.state.capacity:
            self.state = grow_graph(self.state, required_capacity(max_id))
            # Shape change: every capacity-shaped array rewrites in full
            # (the quantizer code table pads lazily on the next encode).
            for name in ("vectors", "adjacency", "exists", "store/codes"):
                self.dirty.all(name)

    def _mark_write(self, ids: np.ndarray) -> None:
        """Mark the rows one insert batch touched: the batch's own rows
        plus its backedge targets — exactly the entries of the freshly
        written adjacency rows (phase-A appends and overflow re-prunes
        both land on those targets). One [B, R] readback per batch, only
        when fine-grained marks matter (a fresh bulk build is already
        whole-state dirty and skips this)."""
        self.dirty.rows("vectors", ids)
        self.dirty.rows("exists", ids)
        self.dirty.rows("store/codes", ids)
        rows = np.asarray(self.state.adjacency[jnp.asarray(ids)])
        targets = rows[rows != graph.NIL]
        self.dirty.rows("adjacency", np.concatenate([ids, targets]))

    # -- writes ------------------------------------------------------------
    def insert_update_delete(
        self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]
    ) -> None:
        """Apply (id, vector|None) changes.

        Semantics parity with vamana.go insertUpdateDelete:
          - unknown id + vector  → insert
          - known id + vector    → update (remove inbound edges, re-insert)
          - known id + None      → delete
          - unknown id + None    → skip
        Updates/deletes repair the graph before re-insertion so updated
        points get fresh neighbourhoods.
        """
        inserts: list[tuple[int, np.ndarray]] = []
        updates: list[tuple[int, np.ndarray]] = []
        deletes: list[int] = []
        max_id = 0
        # One bulk host copy of the existence bitmap: classifying per point
        # via device scalar reads costs a roundtrip each (dominates large
        # builds).
        exists_np = np.asarray(self.state.exists)
        for node_id, vec in changes:
            if node_id in (0, START_ID):
                raise ValueError(f"cannot modify point with reserved id: {node_id}")
            max_id = max(max_id, node_id)
            known = 0 <= node_id < exists_np.shape[0] and bool(exists_np[node_id])
            if not known and vec is None:
                continue
            if not known:
                inserts.append((node_id, vec))
            elif vec is not None:
                updates.append((node_id, vec))
            else:
                deletes.append(node_id)
        self._ensure_capacity(max_id)

        # Stage-duration logging parity: vamana.go:255 logs insert/delete
        # phase timings at debug level.
        from semadb_tpu.index.vamana.build import _logger

        if inserts:
            with _logger().timed("vamana insert batch", count=len(inserts)):
                self._insert_chunked(inserts)
        # Updates re-insert with fresh neighbourhoods: treat as delete+insert
        # (vamana.go:150-170, 236-253 — inbound edges removed via the same
        # scan as deletes, then re-inserted).
        if updates or deletes:
            repair_ids = np.array([i for i, _ in updates] + deletes, dtype=np.int32)
            with _logger().timed("vamana delete repair", count=len(repair_ids)):
                self.state = delete_batch(self.state, repair_ids, self.config)
            # Repair re-prunes arbitrary rows (selected on device) and the
            # finalize/rescue rewrites the start row: whole array dirty.
            self.dirty.all("adjacency")
            self.dirty.rows("exists", repair_ids)
        if updates:
            self._insert_chunked(updates)
        # Quantizer fit trigger at the end of the write, then flush
        # (vamana.go:255-276: vecStore.Fit() before flush).
        if self.store.maybe_fit(self.state.vectors, self.state.exists):
            for name in ("store/codes", "store/aux", "store/rot"):
                self.dirty.all(name)
        self._entry_seeds = None  # recompute lazily after any write
        self._maybe_grow_ahead()

    # -- grow-ahead: keep bucket-crossing compiles out of user write txns ----
    def _maybe_grow_ahead(self) -> None:
        """Warm the NEXT capacity bucket's write kernels on a daemon
        thread once occupancy passes SEMADB_GROW_AHEAD_FRAC.

        Unlike IndexIVF's grower this does NOT pad live arrays in the
        background: graph writes are serialized by the Shard (the engine
        has no write lock to pad under), so the bucket crossing itself
        stays synchronous in ``_ensure_capacity`` — but once the warm has
        populated the persistent compile cache, that crossing costs a pad
        dispatch plus ~100 ms of re-tracing instead of the full XLA
        compile of the insert kernel at the new shape (the same class of
        write-txn stall as on the IVF side). Stands down under
        SEMADB_PREGROW_ROWS for the same reason IVF's does: a pre-grown
        deployment filling up is the expected state, not a growth
        signal."""
        import threading

        from semadb_tpu.utils.grow import GROW_AHEAD_FRAC, PREGROW_ROWS

        if GROW_AHEAD_FRAC <= 0 or PREGROW_ROWS > 0:
            return
        if self._grow_thread is not None:
            return
        cap = self.state.capacity
        if self._max_seen < GROW_AHEAD_FRAC * cap:
            return
        target = required_capacity(cap, self.config)
        if target <= self._warm_target:
            return  # this bucket's kernels are already warm

        def _run():
            try:
                self.warm_capacity_shapes(target)
                self._warm_target = max(self._warm_target, target)
            except Exception as e:  # pragma: no cover - never break writes
                build._logger().warn(
                    "vamana grow-ahead warm failed", error=str(e)
                )
            finally:
                self._grow_thread = None

        t = threading.Thread(target=_run, daemon=True)
        self._grow_thread = t
        t.start()

    def warm_capacity_shapes(self, capacity: int = 0, buckets=(64, 512)) -> None:
        """Populate the persistent XLA compile cache for the incremental
        write kernel (``_insert_step``: beam search + prune + backedges +
        overflow loop) at ``capacity`` without touching live arrays: AOT
        lower+compile on ShapeDtypeStructs, mirroring
        :meth:`IndexIVF.warm_capacity_shapes`. ``buckets`` are the
        write-path batch shapes (build._bucket_size's first two)."""
        from semadb_tpu.index.vamana.build import (
            BUILD_W,
            OVERFLOW_CHUNK,
            _insert_step,
        )

        cap = capacity or self.state.capacity
        cfg = self.config
        st = GraphState(
            vectors=_jax.ShapeDtypeStruct((cap, cfg.dim), jnp.float32),
            adjacency=_jax.ShapeDtypeStruct(
                (cap, cfg.degree_bound), jnp.int32
            ),
            exists=_jax.ShapeDtypeStruct((cap,), jnp.bool_),
        )
        chunk = min(OVERFLOW_CHUNK, cap)
        alpha = _jax.ShapeDtypeStruct((), jnp.float32)
        for b in buckets:
            _insert_step.lower(
                st,
                _jax.ShapeDtypeStruct((b,), jnp.int32),
                _jax.ShapeDtypeStruct((b, cfg.dim), jnp.float32),
                _jax.ShapeDtypeStruct((b,), jnp.bool_),
                cfg,
                self.params.search_size,
                8,  # intra_k: insert_batch's default, the incremental path
                chunk,
                False,
                alpha,
                None,
                None,
                BUILD_W,
                False,
            ).compile()

    def _insert_chunked(self, items: Sequence[Tuple[int, np.ndarray]]) -> None:
        """Insert in growing rounds.

        The sequential reference lets every insert see all prior points; a
        parallel batch sees only the pre-batch graph. Keeping each batch no
        larger than the current graph (doubling rounds, capped at
        INSERT_CHUNK) bounds that approximation — the standard batch-build
        schedule for Vamana-family indices.
        """
        i = 0
        # Track the live count on host: len(self) is a device readback
        # and inserts only grow it.
        live = max(len(self), 32)
        while i < len(items):
            step = min(INSERT_CHUNK, max(32, live))
            chunk = items[i : i + step]
            i += step
            live += len(chunk)
            ids = np.array([c[0] for c in chunk], dtype=np.int32)
            vecs = np.stack([np.asarray(c[1], dtype=np.float32) for c in chunk])
            self.state = insert_batch(
                self.state, ids, vecs, self.config, self.params.search_size
            )
            if self.dirty.active:
                self._mark_write(ids)
            # Keep the code table current for post-fit inserts
            # (binary.go/product.go Set encodes when already fitted)
            if self.store.fitted:
                self.store.encode_rows(self.state.vectors, ids)

    def insert_bulk(
        self, ids, vecs, defer_fit: bool = False, build_mode: str | None = None
    ) -> None:
        """Array bulk build with the two-pass alpha schedule.

        Pass 1: incremental doubling-round insertion at alpha=1.0 — the
        low alpha keeps MORE edges per node early (nothing is pruned as a
        "detour"), giving pass 2 rich candidate pools. Pass 2: re-insert
        every point in insertion order against the complete graph at the
        configured alpha, candidate pool = visited ∪ current out-edges
        (build.robustPrune keep_current). This is DiskANN's published
        build schedule; the reference's single-pass incremental build
        (vamana.go:190-253) is the pass-1-only special case.

        ``defer_fit`` is accepted for interface parity with IndexIVF and
        ignored (the graph build has no deferred stage; quantizer fits
        run at the end either way — call :meth:`flush_pending` freely).
        Batches containing existing ids fall back to
        :meth:`insert_update_delete`.

        ``build_mode`` overrides SEMADB_VAMANA_BUILD for this call:
        "search" = beam-search two-pass schedule; "pool" = the matmul-built
        per-cluster kNN pool build (fastbuild.py) for fresh graphs.
        """
        import jax

        ids_np = np.asarray(ids, np.int64)
        n = len(ids_np)
        if n == 0:
            return
        if (ids_np <= 1).any():
            raise ValueError("cannot modify point with reserved id")
        exists_np = np.asarray(self.state.exists)
        in_cap = ids_np[ids_np < exists_np.shape[0]]
        if len(np.unique(ids_np)) != n or exists_np[in_cap].any():
            self.insert_update_delete(
                zip(ids_np.tolist(), np.asarray(jax.device_get(vecs)))
            )
            return
        pool_mode = (
            (build_mode or BUILD_MODE) == "pool"
            and len(self) == 0
            and n >= TWO_PASS_MIN
            and self.config.metric in ("euclidean", "cosine", "dot")
        )
        if pool_mode and not isinstance(vecs, np.ndarray):
            # Memory-lean bulk build: keep a device-resident corpus ON
            # device — fastbuild adopts it straight into the graph matrix
            # (a 5 GB host round-trip at 10M otherwise, plus a second
            # corpus copy in HBM during the pool build).
            vec_np = vecs
        else:
            vec_np = np.asarray(jax.device_get(vecs), np.float32)
        self._ensure_capacity(int(ids_np.max()))
        # A bulk build's beam searches roam the whole graph and its
        # backedge scatters land anywhere: the next snapshot is full.
        self.dirty.everything()
        ids32 = ids_np.astype(np.int32)
        two_pass = TWO_PASS and n >= TWO_PASS_MIN
        a1 = 1.0 if two_pass else None

        from semadb_tpu.index.vamana.build import _logger

        l1 = (PASS1_L if two_pass else 0) or self.params.search_size
        l2 = PASS2_L or self.params.search_size

        # Matmul-built pool build: fresh graphs only (pools are computed over
        # the batch; a non-empty graph needs the beam searches to see the
        # existing points), metrics with a dense contraction only.
        if pool_mode:
            from semadb_tpu.index.vamana import fastbuild

            fastbuild.bulk_build_pools(self, ids32, vec_np, l2)
            did_fit = self.store.maybe_fit(self.state.vectors, self.state.exists)
            if self.store.fitted and not did_fit:
                self.store.encode_rows(self.state.vectors, ids32)
            self._entry_seeds = None
            return

        with _logger().timed("vamana bulk pass1", count=n):
            live = max(len(self), 32)
            i = 0
            while i < n:
                step = min(INSERT_CHUNK, max(32, live))
                self.state = insert_batch(
                    self.state, ids32[i : i + step], vec_np[i : i + step],
                    self.config, l1, alpha=a1,
                )
                live += step
                i += step
        if two_pass:
            with _logger().timed("vamana bulk pass2", count=n):
                for i in range(0, n, PASS2_CHUNK):
                    self.state = insert_batch(
                        self.state, ids32[i : i + PASS2_CHUNK],
                        vec_np[i : i + PASS2_CHUNK], self.config,
                        l2, keep_current=True,
                    )
        did_fit = self.store.maybe_fit(self.state.vectors, self.state.exists)
        if self.store.fitted and not did_fit:
            self.store.encode_rows(self.state.vectors, ids32)
        self._entry_seeds = None

    def flush_pending(self) -> None:
        """Interface parity with IndexIVF's deferred refit — no-op here."""

    def sync(self) -> None:
        """Block until every queued device mutation of this index has
        executed. Build timers must call this or they measure dispatch,
        not execution."""
        jax.block_until_ready(self.state)

    def refine(
        self,
        passes: int = 1,
        batch: int = PASS2_CHUNK,
        search_size: int = 0,
        seed_own: bool = False,
    ) -> None:
        """Re-run the insert procedure (greedy search → robustPrune →
        backedges) for every live node on the current graph, with each
        node's CURRENT out-edges kept in its candidate pool.

        History: the naive variant (pool = fresh visited set only) made
        recall WORSE at 1M (0.9962 → 0.9911 measured, round 2) — it
        stripped the long-range edges the incremental build kept. The
        keep_current pool (DiskANN second-pass rule, V ∪ N_out) fixes
        that; :meth:`insert_bulk` runs this as its pass 2. Also useful to
        re-link a graph degraded by mass deletes.
        """
        exists = np.asarray(self.state.exists)
        ids = np.nonzero(exists)[0].astype(np.int32)
        ids = ids[ids != START_ID]
        if not len(ids):
            return
        self.dirty.all("adjacency")  # re-prunes every live row + backedges
        # One bulk readback of the live vectors (per-chunk device slicing
        # would cost a host↔device roundtrip per chunk).
        vecs = np.asarray(self.state.vectors[jnp.asarray(ids)])
        for _ in range(passes):
            for i in range(0, len(ids), batch):
                self.state = insert_batch(
                    self.state, ids[i : i + batch], vecs[i : i + batch],
                    self.config, search_size or self.params.search_size,
                    keep_current=True, seed_own=seed_own,
                )
        self._entry_seeds = None

    # -- reads -------------------------------------------------------------
    def search_batch_async(
        self,
        queries,
        k: int,
        search_size: int = 0,
    ):
        """Dispatch a search without synchronising: returns device arrays
        (dists f32[B,k], ids i32[B,k]).

        Serving-throughput entry point: the caller can enqueue many batches
        (overlapping query upload with compute) and materialise results at
        the end.
        ``queries`` may be a numpy array (padded + uploaded here) or an
        already device-resident f32[B, D] array used as-is.
        """
        search_size = search_size or self.params.search_size
        search_size = max(search_size, k)
        if isinstance(queries, jnp.ndarray) and queries.ndim == 2:
            q = queries
            Bp = q.shape[0]
        else:
            q_np = np.atleast_2d(np.asarray(queries, np.float32))
            B = q_np.shape[0]
            for Bp in (8, 64, 256, 1024):
                if B <= Bp:
                    break
            else:
                Bp = ((B + 1023) // 1024) * 1024
            if Bp != B:
                q_np = np.concatenate(
                    [q_np, np.zeros((Bp - B, q_np.shape[1]), np.float32)]
                )
            q = jnp.asarray(q_np)
        quant = None
        qcodes = qquery = None
        if self.store.fitted and self.store.kind != "plain":
            quant = self.store.config
            qcodes = self.store.state.codes
            if qcodes.shape[0] < self.state.capacity:
                qcodes = jnp.pad(
                    qcodes, ((0, self.state.capacity - qcodes.shape[0]), (0, 0))
                )
            qquery = self.store.prepare_queries(q)
        seed_arr = self._routed_seed_arr(q)
        if seed_arr is None:
            seeds = self._get_entry_seeds()
            if seeds is not None:
                seed_arr = jnp.broadcast_to(
                    jnp.asarray(seeds, jnp.int32)[None, :], (Bp, len(seeds))
                )
        return search_mod.search(
            self.state, q, self.config, search_size, k,
            quant=quant, qcodes=qcodes, qquery=qquery, seed_ids=seed_arr,
        )

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        search_size: int = 0,
        filter_mask: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k ids+distances for a batch of queries.

        Returns (dists f32[B,k], ids i32[B,k]); empty slots are (inf, -1).
        """
        search_size = search_size or self.params.search_size
        search_size = max(search_size, k)
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        B = q_np.shape[0]
        # Pad the query batch to one of a few canonical sizes so compiled
        # kernels are reused across batch sizes (every shape = a recompile).
        for Bp in (8, 64, 256, 1024):
            if B <= Bp:
                break
        else:
            Bp = ((B + 1023) // 1024) * 1024
        if Bp != B:
            q_np = np.concatenate([q_np, np.zeros((Bp - B, q_np.shape[1]), np.float32)])
        q = jnp.asarray(q_np)
        if filter_mask is not None:
            # Quantized search path when the store is fitted (vectorstore
            # dispatch, vectorstore.go:23-43): distances become hamming/ADC
            quant = None
            qcodes = qquery = None
            if self.store.fitted and self.store.kind != "plain":
                quant = self.store.config
                qcodes = self.store.state.codes
                if qcodes.shape[0] < self.state.capacity:
                    qcodes = jnp.pad(
                        qcodes, ((0, self.state.capacity - qcodes.shape[0]), (0, 0))
                    )
                qquery = self.store.prepare_queries(q)
            fm = jnp.asarray(filter_mask, bool)
            if fm.shape[0] < self.state.capacity:
                fm = jnp.pad(fm, (0, self.state.capacity - fm.shape[0]))
            d, i = search_filtered(
                self.state, q, fm, self.config, search_size, k,
                quant=quant, qcodes=qcodes, qquery=qquery,
            )
        else:
            d, i = self.search_batch_async(q, k, search_size)
        return np.asarray(d)[:B], np.asarray(i)[:B]

    N_ENTRY_SEEDS = 16

    N_ROUTE_SEEDS = 8

    def set_query_routing(self, cents, reps) -> None:
        """Install query-routed entry: ``cents`` f32[C, D] cluster
        centroids (the pool build's k-means) and ``reps`` i32[C] one live
        node id per cluster. Cleared by nothing — stale reps are masked
        by the exists bits at query time, so incremental writes/deletes
        only dilute routing quality, never correctness."""
        self._route = (jnp.asarray(cents, jnp.float32), jnp.asarray(reps, jnp.int32))
        self.dirty.all("route_cents")
        self.dirty.all("route_reps")

    def _routed_seed_arr(self, q) -> Optional[jnp.ndarray]:
        if self._route is None:
            return None
        cents, reps = self._route
        return _route_seeds(
            cents, reps, self.state.exists, q, self.config.metric,
            self.N_ROUTE_SEEDS,
        )

    def _get_entry_seeds(self) -> Optional[np.ndarray]:
        if self._entry_seeds is None:
            live = np.nonzero(np.asarray(self.state.exists))[0]
            live = live[live != START_ID]
            if len(live) == 0:
                return None
            sel = live[
                np.linspace(0, len(live) - 1, min(self.N_ENTRY_SEEDS, len(live))).astype(int)
            ]
            self._entry_seeds = sel.astype(np.int32)
        return self._entry_seeds
