"""Batched Vamana graph construction, update and delete repair.

Reference algorithm (shard/index/vamana/insert.go, prune.go):
  - insertSinglePoint: greedy-search the new point (k=1, L=searchSize), use
    the visited set as robust-prune candidates for the new node's edges,
    then add bidirectional edges — appending when the neighbour has room,
    otherwise robust-pruning the neighbour's list with the new point added
    (insert.go:16-68). Parallelised over NumCPU-1 workers with per-node
    locks.
  - robustPrune: take closest remaining candidate, drop later candidates
    within ``alpha`` detour of it, stop at degreeBound (search.go:106-138).
  - delete: scan all edges; nodes pointing at deleted nodes re-prune over
    their own surviving edges plus the deleted neighbours' surviving edges
    (one level); nodes left with no inbound edges are re-attached to the
    start node (prune.go:12-154, vamana.go:140-253).

Batched reformulation: inserts arrive in batches. All searches run as one
batched beam-search on the pre-batch graph; all new rows are robust-pruned by
one vmapped kernel; bidirectional edge backfill becomes a conflict-free
scatter — each (target, slot) pair is unique by construction (slot = current
edge count + rank of the inbound edge among same-target entries) — with
overflowing targets merged-and-pruned in fixed-size chunks. Deviations from
the sequential reference are documented inline; the correctness invariants
(degree bound, connectivity via start node, no self/dangling edges) are
preserved and tested.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from semadb_tpu.index.vamana.graph import (
    NIL,
    START_ID,
    GraphConfig,
    GraphState,
    edge_counts,
)
from semadb_tpu.index.vamana.search import beam_search
from semadb_tpu.ops.distance import gather_distance
from semadb_tpu.ops.topk import INF, sort_by_distance

# Chunk sizes for fixed-shape repair kernels (host loops over chunks)
OVERFLOW_CHUNK = 1024
# Forward-edge slack: robustPrune stops at degree_bound - FWD_SLACK edges,
# leaving reserved row slots for symmetric backedges (inbound edges are
# what make a point FINDABLE; when fresh rows are full, backedges go
# through the overflow re-prune, which can drop them). Experiment knob.
import os as _os

FWD_SLACK = int(_os.environ.get("SEMADB_VAMANA_FWD_SLACK", 0))
# Beam expand-width W for BUILD-time searches. W=8 fills the device at the
# incremental path's small batches; at batch >= 4096 hop cost scales with
# W once parallelism saturates, so the query path uses W=2 (tuned on the
# TPU; ROADMAP S6 re-tests it) — bulk builds at 4096+ chunks set this down.
BUILD_W = int(_os.environ.get("SEMADB_VAMANA_BUILD_W", 8))
DELETE_CHUNK = 256

# Build counters for the bench/profiling harness (the reference logs
# per-stage durations at debug level, vamana.go:255). No device syncs here:
# every host↔device roundtrip stalls the queue, so the build path is
# designed to enqueue work without ever reading back.
BUILD_TIMERS = {"batches": 0}
# Per-node cap on expanded deleted neighbours during delete repair
DELETE_EXPAND_MAX = 8


def _pairwise_among(vectors: jax.Array, cand_ids: jax.Array, metric: str) -> jax.Array:
    """Pairwise distances among gathered candidates: ids i32[B, C] → f32[B, C, C]."""
    cap = vectors.shape[0]
    cv = vectors[jnp.clip(cand_ids, 0, cap - 1)]  # [B, C, D]
    if metric == "euclidean":
        sq = jnp.sum(cv * cv, axis=-1)
        cross = jnp.einsum(
            "bcd,bed->bce", cv, cv, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return jnp.maximum(sq[:, :, None] - 2.0 * cross + sq[:, None, :], 0.0)
    cross = jnp.einsum(
        "bcd,bed->bce", cv, cv, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    if metric == "cosine":
        return 1.0 - cross
    if metric == "dot":
        return -cross
    # haversine: elementwise over [B, C, 2] pairs
    from semadb_tpu.ops.distance import _haversine_pair

    return _haversine_pair(cv[:, :, None, :], cv[:, None, :, :])


@functools.partial(jax.jit, static_argnames=("config",))
def robust_prune_batch(
    cand_d: jax.Array,  # f32[B, C] sorted ascending
    cand_i: jax.Array,  # i32[B, C]
    cand_pd: jax.Array,  # f32[B, C, C] pairwise among candidates
    self_ids: jax.Array,  # i32[B]
    config: GraphConfig,
    alpha=None,  # optional traced f32 override (two-pass alpha schedule)
) -> jax.Array:
    """Vectorised robustPrune (search.go:106-138) over a batch of nodes.

    Returns new adjacency rows i32[B, R]. Candidates must be sorted by
    distance to the owning node; NIL/INF slots are ignored. ``alpha``
    overrides ``config.alpha`` as a TRACED scalar so the two-pass build
    (pass 1 at alpha=1.0) reuses the compiled kernels.
    """
    B, C = cand_i.shape
    R = config.degree_bound
    r_stop = max(R - FWD_SLACK, 8)
    alpha = jnp.float32(config.alpha) if alpha is None else alpha
    jidx = jnp.arange(C, dtype=jnp.int32)

    # Self / NIL / non-finite candidates are dead from the start; the loop
    # then jumps straight to each row's next live candidate instead of
    # scanning every index, so iterations ≈ edges kept (≤ R), not C.
    dead0 = (
        (cand_i == NIL)
        | (cand_i == self_ids[:, None])
        | ~jnp.isfinite(cand_d)
    )

    def not_done(carry):
        dead, count, adj = carry
        return jnp.any(~dead & (count < r_stop)[:, None])

    def body(carry):
        dead, count, adj = carry
        live = ~dead & (count < r_stop)[:, None]
        sel = jnp.any(live, axis=-1)  # [B]
        pos = jnp.argmax(live, axis=-1)  # first live candidate per row
        cid = jnp.take_along_axis(cand_i, pos[:, None], axis=-1)[:, 0]
        slot = jax.nn.one_hot(count, R, dtype=bool) & sel[:, None]
        adj = jnp.where(slot, cid[:, None], adj)
        count = count + sel.astype(jnp.int32)
        # alpha-detour prune of later candidates (search.go:126-136)
        pd_row = jnp.take_along_axis(
            cand_pd, pos[:, None, None], axis=1
        )[:, 0, :]  # [B, C]
        pruned = (alpha * pd_row < cand_d) & (jidx[None, :] > pos[:, None])
        dead = dead | (sel[:, None] & pruned)
        # consume the selected candidate
        dead = dead | (jax.nn.one_hot(pos, C, dtype=bool) & sel[:, None])
        return dead, count, adj

    adj0 = jnp.full((B, R), NIL, jnp.int32)
    _, _, adj = jax.lax.while_loop(
        not_done, body, (dead0, jnp.zeros(B, jnp.int32), adj0)
    )
    return adj


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "search_size", "intra_k", "keep_current", "expand_width",
        "seed_own",
    ),
)
def _insert_core(
    state: GraphState,
    new_ids: jax.Array,  # i32[B]
    new_vecs: jax.Array,  # f32[B, D]
    valid: jax.Array,  # bool[B] (padding rows are False)
    config: GraphConfig,
    search_size: int,
    intra_k: int,
    keep_current: bool = False,
    alpha=None,  # traced f32 override for the prune
    pool_d=None,  # optional f32[B, P] precomputed candidate pool distances
    pool_i=None,  # optional i32[B, P] precomputed candidate pool ids
    expand_width: int = 8,  # beam W during build searches
    seed_own: bool = False,  # seed the beam at the node's current edges
):
    """Search + prune new rows + phase-A backedge scatter.

    ``seed_own`` (keep_current re-insertion passes only): start the beam
    at the node's CURRENT out-edges instead of navigating from the start
    node — the search begins inside the target neighbourhood, collapsing
    the hop count (a local-join refinement; candidates the full descent
    would contribute are already in the keep_current pool).

    ``keep_current``: union the node's EXISTING out-edges into its prune
    candidate pool (V ∪ N_out(p), the canonical DiskANN second-pass rule).
    A re-prune from the fresh visited set alone strips the long-range
    edges the incremental build kept — measured 0.9962 → 0.9911 recall at
    1M (the refuted naive refine); keeping them in the pool lets alpha
    decide, which is the whole point of the two-pass schedule.

    ``pool_d``/``pool_i``: when given, SKIP the beam search and use this
    precomputed candidate pool instead (NIL-padded, any order). This is
    the matmul-built bulk-build path (fastbuild.py): pools come from
    per-cluster exact kNN matmuls plus random long-range candidates, so
    graph construction never walks the graph at all. The alpha prune
    handles duplicate pool entries natively (a duplicate has pairwise
    distance 0 to its twin and is always dominated).

    Returns (state', flat_targets i32[E], flat_sources i32[E], inbound_rank
    i32[E]) for the host-driven overflow phase.
    """
    cap = state.capacity
    B = new_ids.shape[0]
    R = config.degree_bound
    safe_ids = jnp.where(valid, new_ids, 0)
    # Existing rows must be read BEFORE this batch rewrites them
    own_edges = state.adjacency[safe_ids] if keep_current else None  # [B, R]

    # 1. Write vectors; mark existence. New nodes have no inbound edges yet
    #    so searches cannot reach them (mirrors insert.go:35-37 note).
    vectors = state.vectors.at[safe_ids].set(
        jnp.where(valid[:, None], new_vecs, state.vectors[safe_ids])
    )
    exists = state.exists.at[safe_ids].set(valid | state.exists[safe_ids])
    state = GraphState(vectors=vectors, adjacency=state.adjacency, exists=exists)

    # 2. Candidate sets: batched greedy search on the pre-batch graph, or
    #    the caller's precomputed pool (fast bulk build).
    if pool_i is not None:
        pi = jnp.where(valid[:, None], pool_i, NIL)
        pd_ = jnp.where(pi != NIL, pool_d, INF)
        from semadb_tpu.ops.topk import dedup_by_id as _dedup

        cand_d, cand_i = _dedup(pd_, pi)
        cand_d, cand_i = sort_by_distance(cand_d, cand_i)
    else:
        seeds = own_edges if (seed_own and keep_current) else None
        res = beam_search(
            state, new_vecs, config, search_size, expand_width=expand_width,
            seed_ids=seeds,
        )
        cand_d, cand_i = res.visited_dists, res.visited_ids  # [B, V] sorted

    # 3. Intra-batch candidates: the sequential reference lets later inserts
    #    see earlier ones; in a parallel batch we approximate that by adding
    #    each point's nearest in-batch peers to its candidate pool.
    if intra_k > 0:
        from semadb_tpu.ops.distance import pairwise_distance

        bb = pairwise_distance(new_vecs, new_vecs, config.metric)  # [B, B]
        eye = jnp.eye(B, dtype=bool)
        bb = jnp.where(eye | ~valid[None, :] | ~valid[:, None], INF, bb)
        nb_d, nb_j = jax.lax.top_k(-bb, min(intra_k, B))
        nb_d = -nb_d
        nb_i = jnp.where(jnp.isfinite(nb_d), safe_ids[nb_j], NIL)
        cand_d = jnp.concatenate([cand_d, nb_d], axis=-1)
        cand_i = jnp.concatenate([cand_i, nb_i], axis=-1)
        cand_d, cand_i = sort_by_distance(cand_d, cand_i)

    if keep_current:
        from semadb_tpu.ops.topk import dedup_by_id

        own_ok = (own_edges != NIL) & valid[:, None]
        od = gather_distance(
            state.vectors, jnp.clip(own_edges, 0, cap - 1), new_vecs,
            config.metric,
        )
        od = jnp.where(own_ok, od, INF)
        oi = jnp.where(own_ok, own_edges, NIL)
        cand_d = jnp.concatenate([cand_d, od], axis=-1)
        cand_i = jnp.concatenate([cand_i, oi], axis=-1)
        # Old edges can also appear in the visited set: dedup before prune
        # (duplicate candidates would otherwise fill two row slots).
        cand_d, cand_i = dedup_by_id(cand_d, cand_i)
        cand_d, cand_i = sort_by_distance(cand_d, cand_i)

    # 4. Robust prune → new adjacency rows
    pd = _pairwise_among(state.vectors, cand_i, config.metric)
    new_rows = robust_prune_batch(
        cand_d, cand_i, pd, safe_ids, config, alpha
    )  # [B, R]
    new_rows = jnp.where(valid[:, None], new_rows, NIL)
    adjacency = state.adjacency.at[safe_ids].set(
        jnp.where(valid[:, None], new_rows, state.adjacency[safe_ids])
    )

    # 5. Backedges, phase A (append when room). Conflict-free scatter: the
    #    slot for inbound edge e→t is edge_count[t] + rank(e among edges→t).
    targets = new_rows.reshape(-1)  # [E]
    sources = jnp.repeat(safe_ids, R)  # [E]
    tvalid = (targets != NIL) & jnp.repeat(valid, R)
    tsafe = jnp.where(tvalid, targets, cap - 1)

    E = targets.shape[0]
    sort_key = jnp.where(tvalid, targets, jnp.int32(2**30))
    order = jnp.argsort(sort_key)
    st = sort_key[order]
    seg_new = jnp.concatenate([jnp.array([True]), st[1:] != st[:-1]])
    seg_start = jnp.where(seg_new, jnp.arange(E), 0)
    seg_start = jax.lax.associative_scan(jnp.maximum, seg_start)
    rank_sorted = jnp.arange(E) - seg_start
    rank = jnp.zeros(E, jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))

    # Skip backedges whose source is already in the target's row — happens
    # for intra-batch pairs where the prune already created the edge both
    # ways (the sequential reference can't hit this: backedge targets are
    # always pre-existing nodes).
    dup_edge = jnp.any(adjacency[tsafe] == sources[:, None], axis=-1)
    counts = edge_counts(adjacency)  # [cap]
    slot = counts[tsafe] + rank
    fits = tvalid & ~dup_edge & (slot < R)
    # Route non-appending writes out of bounds → dropped by scatter
    t_idx = jnp.where(fits, targets, cap)
    adjacency = adjacency.at[t_idx, jnp.where(fits, slot, 0)].set(
        sources, mode="drop"
    )

    state = GraphState(vectors=state.vectors, adjacency=adjacency, exists=state.exists)
    # Hand the overflow phase target-sorted edge arrays so it can locate each
    # target's inbound segment with one searchsorted instead of an O(chunk*E)
    # comparison matrix.
    sorted_t = sort_key[order]
    sorted_src = sources[order]
    pending = (tvalid & ~dup_edge & ~fits)[order]
    return state, sorted_t, sorted_src, pending


def _overflow_body(
    state: GraphState,
    targets: jax.Array,  # i32[E] backedge targets
    sources: jax.Array,  # i32[E]
    pending: jax.Array,  # bool[E] — backedges not yet applied
    config: GraphConfig,
    chunk: int,
    k_in: int,
    alpha=None,  # traced f32 override for the prune
):
    """Merge-and-prune one chunk of overflowing backedge targets.

    For each selected target t: candidates = t's current edges ∪ pending
    inbound sources for t; if the merged count fits the degree bound the
    result is a plain append, otherwise robustPrune — matching
    insert.go:44-63.
    """
    cap = state.capacity
    R = config.degree_bound
    E = targets.shape[0]

    # Select up to `chunk` distinct pending targets (ascending id)
    t_mask = jnp.zeros(cap + 1, bool).at[
        jnp.where(pending, jnp.clip(targets, 0, cap - 1), cap)
    ].set(True, mode="drop")[:cap]
    score = jnp.where(t_mask, -jnp.arange(cap, dtype=jnp.float32), -jnp.inf)
    _, sel_t = jax.lax.top_k(score, chunk)
    sel_valid = t_mask[sel_t]
    sel_t = jnp.where(sel_valid, sel_t.astype(jnp.int32), NIL)
    sel_safe = jnp.where(sel_valid, sel_t, 0)

    # Targets arrive sorted, so each selected target's inbound edges are one
    # contiguous segment located by searchsorted — O(chunk * k_in) gathers
    # instead of an O(chunk * E) comparison matrix.
    starts = jnp.searchsorted(targets, sel_safe)  # [chunk]
    win = jnp.clip(starts[:, None] + jnp.arange(k_in)[None, :], 0, E - 1)
    in_seg = (targets[win] == sel_safe[:, None]) & pending[win] & sel_valid[:, None]
    inb = jnp.where(in_seg, sources[win], NIL)  # [chunk, k_in]

    # Candidate pool: existing edges + inbound
    own = state.adjacency[sel_safe]  # [chunk, R]
    cand = jnp.concatenate([own, inb], axis=-1)  # [chunk, R+k_in]
    cvalid = cand != NIL
    tvec = state.vectors[sel_safe]  # [chunk, D]
    cd = gather_distance(state.vectors, jnp.clip(cand, 0, cap - 1), tvec, config.metric)
    cd = jnp.where(cvalid, cd, INF)
    ci = jnp.where(cvalid, cand, NIL)
    # Dedup: an inbound source can already sit in the target's row (partial
    # phase-A append) and duplicate edges must never form.
    from semadb_tpu.ops.topk import dedup_by_id

    cd, ci = dedup_by_id(cd, ci)
    cd, ci = sort_by_distance(cd, ci)

    n_cand = jnp.sum(ci != NIL, axis=-1)
    pd = _pairwise_among(state.vectors, ci, config.metric)
    pruned = robust_prune_batch(cd, ci, pd, sel_safe, config, alpha)  # [chunk, R]
    # Plain append when the pool fits (insert.go:58-62): the sorted pool's
    # first R entries ARE the appended list in that case.
    appended = jnp.where(jnp.arange(R + k_in)[None, :] < R, ci, NIL)[:, :R]
    new_rows = jnp.where((n_cand <= R)[:, None], appended, pruned)

    t_idx = jnp.where(sel_valid, sel_t, cap)
    adjacency = state.adjacency.at[t_idx].set(new_rows, mode="drop")
    # Clear pending for every edge of a processed target (edges beyond the
    # k_in window are dropped — the prune keeps only the nearest R anyway)
    processed_t = jnp.zeros(cap + 1, bool).at[jnp.where(sel_valid, sel_t, cap)].set(
        True, mode="drop"
    )[:cap]
    pending = pending & ~processed_t[jnp.clip(targets, 0, cap - 1)]
    state = GraphState(vectors=state.vectors, adjacency=adjacency, exists=state.exists)
    return state, pending


@functools.partial(jax.jit, static_argnames=("config", "chunk", "k_in"))
def _overflow_chunk(
    state: GraphState,
    targets: jax.Array,
    sources: jax.Array,
    pending: jax.Array,
    config: GraphConfig,
    chunk: int,
    k_in: int,
):
    """One overflow round as a standalone kernel (used by the sharded
    insert step in parallel/fanout.py)."""
    return _overflow_body(state, targets, sources, pending, config, chunk, k_in)



@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "search_size", "intra_k", "chunk", "keep_current",
        "expand_width", "seed_own",
    ),
)
def _insert_step(
    state: GraphState,
    new_ids: jax.Array,
    new_vecs: jax.Array,
    valid: jax.Array,
    config: GraphConfig,
    search_size: int,
    intra_k: int,
    chunk: int,
    keep_current: bool = False,
    alpha=None,  # traced f32 override for the prune (two-pass schedule)
    pool_d=None,
    pool_i=None,
    expand_width: int = 8,
    seed_own: bool = False,
):
    """Full insert step: search + prune + backedges + ALL overflow rounds.

    The overflow resolution loops on device (``lax.while_loop``) instead of
    the host: each host-side ``while pending: ...`` iteration would cost a
    host↔device roundtrip. One dispatch per batch, no host readbacks.
    """
    state, targets, sources, pending = _insert_core(
        state, new_ids, new_vecs, valid, config, search_size, intra_k,
        keep_current, alpha, pool_d, pool_i, expand_width, seed_own,
    )
    k_in = config.degree_bound

    def cond(carry):
        _, pending = carry
        return jnp.any(pending)

    def body(carry):
        adjacency, pending = carry
        st = GraphState(
            vectors=state.vectors, adjacency=adjacency, exists=state.exists
        )
        st, pending = _overflow_body(
            st, targets, sources, pending, config, chunk, k_in, alpha
        )
        return st.adjacency, pending

    adjacency, _ = jax.lax.while_loop(cond, body, (state.adjacency, pending))
    return GraphState(
        vectors=state.vectors, adjacency=adjacency, exists=state.exists
    )


def _bucket_size(n: int) -> int:
    """Canonical padded batch sizes. Two buckets only — every extra shape
    costs a full recompile of the insert kernels (beam search + prune +
    scatter)."""
    if n <= 64:
        return 64
    if n <= 512:
        return 512
    p = 1024
    while p < n:
        p *= 2
    return p


def insert_batch(
    state: GraphState,
    new_ids: np.ndarray,
    new_vecs: np.ndarray,
    config: GraphConfig,
    search_size: int = 0,
    intra_k: int = 8,
    keep_current: bool = False,
    alpha: float | None = None,
    pool_d: np.ndarray | None = None,
    pool_i: np.ndarray | None = None,
    expand_width: int = 0,
    seed_own: bool = False,
) -> GraphState:
    """Insert a batch of points (host orchestration of jitted kernels).

    ``new_ids`` i32[B] must be unique, != 0/1, within capacity. The batch is
    padded to a power-of-two size so kernel shapes (and hence XLA
    compilations) are reused across calls. ``alpha`` overrides the prune
    alpha as a traced scalar (no recompile across the two-pass schedule).
    ``pool_d``/``pool_i`` skip the beam search (see ``_insert_core``).
    """
    search_size = search_size or config.search_size
    expand_width = expand_width or BUILD_W
    B = int(new_ids.shape[0])
    if B == 0:
        return state
    Bp = _bucket_size(B)
    ids = np.zeros(Bp, np.int32)
    ids[:B] = new_ids
    vecs = np.zeros((Bp, new_vecs.shape[1]), np.float32)
    vecs[:B] = new_vecs
    valid = np.zeros(Bp, bool)
    valid[:B] = True
    pd = pi = None
    if pool_i is not None:
        # Pools are usually device-resident slices of one big [N, P] array
        # (fastbuild) — pad on device, never round-trip through the host.
        pd = jnp.pad(
            jnp.asarray(pool_d, jnp.float32), ((0, Bp - B), (0, 0)),
            constant_values=np.inf,
        )
        pi = jnp.pad(
            jnp.asarray(pool_i, jnp.int32), ((0, Bp - B), (0, 0)),
            constant_values=NIL,
        )
    chunk = min(OVERFLOW_CHUNK, state.capacity)
    state = _insert_step(
        state,
        jnp.asarray(ids),
        jnp.asarray(vecs),
        jnp.asarray(valid),
        config,
        search_size,
        intra_k,
        chunk,
        keep_current,
        jnp.float32(config.alpha if alpha is None else alpha),
        pd,
        pi,
        expand_width,
        seed_own,
    )
    BUILD_TIMERS["batches"] += 1
    return state


# ---------------------------------------------------------------------------
# Delete path
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("config", "chunk", "expand_max"))
def _delete_repair_chunk(
    state: GraphState,
    del_mask: jax.Array,  # bool[cap]
    processed: jax.Array,  # bool[cap] — repaired already
    config: GraphConfig,
    chunk: int,
    expand_max: int,
):
    """Repair one chunk of nodes that point at deleted nodes.

    pruneDeleteNeighbour semantics (prune.go:12-95): candidates = own
    surviving edges ∪ surviving edges of deleted neighbours (one level);
    append when within bound else robustPrune. Deviation: at most
    ``expand_max`` deleted neighbours are expanded per node and the merged
    pool is clipped to the nearest 2R candidates before pruning (bounded
    shapes); both caps exceed typical counts by a wide margin.
    """
    cap = state.capacity
    R = config.degree_bound
    adj = state.adjacency
    safe_adj = jnp.clip(adj, 0, cap - 1)
    edge_del = (adj != NIL) & del_mask[safe_adj]
    needs = state.exists & ~del_mask & jnp.any(edge_del, axis=-1) & ~processed

    score = jnp.where(needs, -jnp.arange(cap, dtype=jnp.float32), -jnp.inf)
    _, sel = jax.lax.top_k(score, chunk)
    sel_valid = needs[sel]
    sel = jnp.where(sel_valid, sel.astype(jnp.int32), NIL)
    sel_safe = jnp.where(sel_valid, sel, 0)

    own = adj[sel_safe]  # [chunk, R]
    own_del = (own != NIL) & del_mask[jnp.clip(own, 0, cap - 1)]
    keep = jnp.where((own != NIL) & ~own_del, own, NIL)

    # Expand up to expand_max deleted neighbours
    del_rank = jnp.cumsum(own_del, axis=-1) - 1
    exp_ids = jnp.full((chunk, expand_max), NIL, jnp.int32)
    col = jnp.where(own_del & (del_rank < expand_max), del_rank, expand_max)
    exp_ids = exp_ids.at[
        jnp.broadcast_to(jnp.arange(chunk)[:, None], own.shape), col
    ].max(jnp.where(own_del, own, NIL), mode="drop")
    exp_adj = adj[jnp.clip(exp_ids, 0, cap - 1)]  # [chunk, expand_max, R]
    exp_ok = (
        (exp_ids != NIL)[:, :, None]
        & (exp_adj != NIL)
        & ~del_mask[jnp.clip(exp_adj, 0, cap - 1)]
    )
    exp_flat = jnp.where(exp_ok, exp_adj, NIL).reshape(chunk, expand_max * R)

    cand = jnp.concatenate([keep, exp_flat], axis=-1)
    # Drop self references (a deleted node may have pointed back at us)
    cand = jnp.where(cand == sel_safe[:, None], NIL, cand)
    tvec = state.vectors[sel_safe]
    cd = gather_distance(state.vectors, jnp.clip(cand, 0, cap - 1), tvec, config.metric)
    cd = jnp.where(cand != NIL, cd, INF)
    cd, ci = sort_by_distance(cd, cand)
    # Dedup (same candidate can arrive via multiple deleted neighbours)
    from semadb_tpu.ops.topk import dedup_by_id

    cd, ci = dedup_by_id(cd, ci)
    cd, ci = sort_by_distance(cd, ci)
    cd, ci = cd[:, : 2 * R], ci[:, : 2 * R]

    n_cand = jnp.sum(ci != NIL, axis=-1)
    pd = _pairwise_among(state.vectors, ci, config.metric)
    pruned = robust_prune_batch(cd, ci, pd, sel_safe, config)
    appended = ci[:, :R]
    new_rows = jnp.where((n_cand <= R)[:, None], appended, pruned)

    t_idx = jnp.where(sel_valid, sel, cap)
    adjacency = adj.at[t_idx].set(new_rows, mode="drop")
    processed = processed.at[jnp.where(sel_valid, sel, cap)].set(True, mode="drop")
    state = GraphState(vectors=state.vectors, adjacency=adjacency, exists=state.exists)
    remaining = jnp.sum(
        state.exists
        & ~del_mask
        & jnp.any(
            (adjacency != NIL) & del_mask[jnp.clip(adjacency, 0, cap - 1)], axis=-1
        )
        & ~processed
    )
    return state, processed, remaining


@functools.partial(jax.jit, static_argnames=("config",))
def _delete_finalize(state: GraphState, del_mask: jax.Array, config: GraphConfig):
    """Clear deleted rows, then rescue disconnected stragglers by attaching
    them to the start node (vamana.go:205-253 toSave semantics)."""
    cap = state.capacity
    R = config.degree_bound
    exists = state.exists & ~del_mask
    adjacency = jnp.where(del_mask[:, None], NIL, state.adjacency)

    # has_inbound via scatter of all remaining edges
    safe = jnp.where(
        (adjacency != NIL) & exists[:, None], adjacency, cap
    )
    has_inbound = (
        jnp.zeros(cap + 1, bool).at[safe.reshape(-1)].set(True, mode="drop")[:cap]
    )
    ids = jnp.arange(cap, dtype=jnp.int32)
    to_save = exists & ~has_inbound & (ids != START_ID)

    # Append stragglers to the start row (prune only if overflowing; the
    # reference appends unconditionally, but rows are fixed-degree here)
    start_row = adjacency[START_ID]
    n_start = jnp.sum(start_row != NIL)
    save_score = jnp.where(to_save, -ids.astype(jnp.float32), -jnp.inf)
    _, save_ids = jax.lax.top_k(save_score, R)
    save_valid = to_save[save_ids]
    save_ids = jnp.where(save_valid, save_ids.astype(jnp.int32), NIL)
    already = jnp.any(save_ids[:, None] == start_row[None, :], axis=-1)
    save_ids = jnp.where(already, NIL, save_ids)
    pool = jnp.concatenate([start_row, save_ids])  # [2R]
    svec = state.vectors[START_ID][None, :]
    pd_ = gather_distance(
        state.vectors, jnp.clip(pool, 0, cap - 1)[None, :], svec, config.metric
    )[0]
    pd_ = jnp.where(pool != NIL, pd_, INF)
    pd_, pool = sort_by_distance(pd_, pool)
    n_pool = jnp.sum(pool != NIL)
    pruned = robust_prune_batch(
        pd_[None, :],
        pool[None, :],
        _pairwise_among(state.vectors, pool[None, :], config.metric),
        jnp.array([START_ID], jnp.int32),
        config,
    )[0]
    new_start = jnp.where(n_pool <= R, pool[:R], pruned)
    adjacency = adjacency.at[START_ID].set(new_start)
    del n_start
    return GraphState(vectors=state.vectors, adjacency=adjacency, exists=exists)


@functools.partial(jax.jit, static_argnames=("max_sweeps",))
def reachable_mask(state: GraphState, max_sweeps: int = 128) -> jax.Array:
    """BFS reachability from the start node as masked adjacency sweeps."""
    cap = state.capacity

    def cond(carry):
        reach, changed, it = carry
        return jnp.logical_and(changed, it < max_sweeps)

    def body(carry):
        reach, _, it = carry
        edges = jnp.where(
            reach[:, None] & (state.adjacency != NIL), state.adjacency, cap
        )
        new = (
            jnp.zeros(cap + 1, bool).at[edges.reshape(-1)].set(True, mode="drop")[:cap]
        )
        new = new | reach
        return new, jnp.any(new != reach), it + 1

    reach0 = jnp.zeros(cap, bool).at[START_ID].set(True)
    reach, _, _ = jax.lax.while_loop(cond, body, (reach0, jnp.bool_(True), 0))
    return reach


@functools.partial(jax.jit, static_argnames=("config",))
def _attach_representatives(state: GraphState, unreach: jax.Array, config: GraphConfig):
    """Force-attach up to R/2 unreachable nodes (nearest to start), chained:
    rep0 goes into the start row (evicting the farthest incumbent only if
    full) and each further rep is written into the previous rep's last
    adjacency slot. The chain means one rescue pass attaches K components
    while consuming a single start-row slot, so eviction pressure — the
    source of rescue oscillation when more components exist than the start
    row holds — stays at one incumbent per pass."""
    cap = state.capacity
    R = config.degree_bound
    K = max(R // 2, 1)
    svec = state.vectors[START_ID][None, :]
    d_all = gather_distance(
        state.vectors, jnp.arange(cap, dtype=jnp.int32)[None, :], svec, config.metric
    )[0]
    d_all = jnp.where(unreach, d_all, INF)
    rep_d, reps = jax.lax.top_k(-d_all, K)
    rep_ok = jnp.isfinite(-rep_d)
    reps = jnp.where(rep_ok, reps.astype(jnp.int32), NIL)

    # Chain: adjacency[rep_i, R-1] = rep_{i+1} (overwrites rep_i's last
    # out-edge; any node that loses reachability through it is caught by
    # the next rescue pass, bounded by the caller's iteration cap).
    nxt = jnp.concatenate([reps[1:], jnp.array([NIL], jnp.int32)])
    chain_ok = rep_ok & (nxt != NIL)
    rows = jnp.where(chain_ok, reps, cap)  # cap = dropped by scatter
    adjacency = state.adjacency.at[rows, R - 1].set(
        jnp.where(chain_ok, nxt, NIL), mode="drop"
    )

    start_row = adjacency[START_ID]
    sd = gather_distance(
        state.vectors, jnp.clip(start_row, 0, cap - 1)[None, :], svec, config.metric
    )[0]
    sd = jnp.where(start_row != NIL, sd, INF)
    # Pool = forced rep0 + incumbents; rep0 always survives the cut
    pool_i = jnp.concatenate([reps[:1], start_row])
    pool_d = jnp.concatenate([jnp.where(rep_ok[:1], -rep_d[:1], INF), sd])
    prio = jnp.concatenate([jnp.full((1,), -1.0, jnp.float32), jnp.zeros_like(sd)])
    order = jnp.lexsort((pool_d, prio))
    pool_i = jnp.take_along_axis(pool_i, order, axis=-1)
    new_row = pool_i[:R]
    adjacency = adjacency.at[START_ID].set(new_row)
    return GraphState(vectors=state.vectors, adjacency=adjacency, exists=state.exists)


@functools.partial(jax.jit, static_argnames=("config", "chunk", "expand_max"))
def _delete_step(
    state: GraphState,
    del_mask: jax.Array,
    config: GraphConfig,
    chunk: int,
    expand_max: int,
) -> GraphState:
    """Full delete step on device: repair all affected nodes (while_loop
    over fixed-size chunks), clear rows + straggler rescue, then reconnect
    lost components until the whole graph is reachable. One dispatch, no
    host readbacks."""
    cap = state.capacity

    def rep_cond(carry):
        _, _, remaining = carry
        return remaining > 0

    def rep_body(carry):
        st, processed, _ = carry
        st, processed, rem = _delete_repair_chunk(
            st, del_mask, processed, config, chunk, expand_max
        )
        return st, processed, rem

    state, _, _ = jax.lax.while_loop(
        rep_cond, rep_body, (state, jnp.zeros(cap, bool), jnp.int32(1))
    )
    state = _delete_finalize(state, del_mask, config)

    # Component rescue: the reference's toSave only re-attaches nodes with
    # zero inbound edges, so a mass delete can detach whole connected
    # components (acknowledged in prune.go:115-151 comments). We go further:
    # sweep reachability from the start node and force-attach
    # representatives of lost components until everything is reachable.
    ids = jnp.arange(cap, dtype=jnp.int32)

    def unreach_of(st):
        return st.exists & ~reachable_mask(st) & (ids != START_ID)

    # Iteration-bounded (like reachable_mask's max_sweeps): each pass
    # attaches a K-chain of components through one start-row slot, so
    # MAX_RESCUES passes cover MAX_RESCUES*K components; beyond that we
    # stop rather than risk an unbounded device loop (eviction could in
    # principle oscillate) and surface the residue to the caller.
    MAX_RESCUES = 128

    def resc_cond(carry):
        _, unreach, it = carry
        return jnp.any(unreach) & (it < MAX_RESCUES)

    def resc_body(carry):
        st, unreach, it = carry
        st = _attach_representatives(st, unreach, config)
        return st, unreach_of(st), it + 1

    state, unreach, _ = jax.lax.while_loop(
        resc_cond, resc_body, (state, unreach_of(state), jnp.int32(0))
    )
    return state, jnp.sum(unreach)


def delete_batch(
    state: GraphState, del_ids: np.ndarray, config: GraphConfig
) -> GraphState:
    """Delete points and repair the graph."""
    if len(del_ids) == 0:
        return state
    cap = state.capacity
    del_ids = jnp.asarray(del_ids, jnp.int32)
    del_mask = jnp.zeros(cap, bool).at[del_ids].set(True)
    chunk = min(DELETE_CHUNK, cap)
    state, unrescued = _delete_step(state, del_mask, config, chunk, DELETE_EXPAND_MAX)
    # Only sync the residue scalar when someone will see the warning — a
    # host readback drains the device queue.
    import logging as _pylogging

    log = _logger()
    if log._logger.isEnabledFor(_pylogging.WARNING) and int(unrescued) > 0:
        log.warn(
            "delete repair hit the rescue iteration cap; some nodes remain "
            "unreachable until the next write",
            unreachable=int(unrescued),
        )
    return state


@functools.lru_cache(maxsize=1)
def _logger():
    from semadb_tpu.utils.logging import get_logger

    return get_logger("vamana")
