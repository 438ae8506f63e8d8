"""Batched greedy beam search over the device-resident Vamana graph.

The reference's greedySearch (shard/index/vamana/search.go:9-102) walks one
query at a time: a sorted candidate array of ``searchSize`` entries, repeatedly
expanding the closest unvisited entry, adding its neighbours, with a bitset
deduplicating everything ever added (distset.go:120-238). Distances bottom out
in AVX2 assembly one pair at a time.

Here the whole procedure is batched over B queries under one ``lax.while_loop``:

  - the candidate list is a sorted (distance, id, expanded) tile ``[B, L]``
  - each hop expands the best unexpanded candidate of every query at once
  - neighbour gathering is one ``adjacency[cur]`` gather; distances are one
    batched contraction on the device (ops.distance.gather_distance)
  - the list merge is a static-shape sort of ``[B, L+R]`` tiles
  - expanded nodes are appended to a visited ring ``[B, V]`` (the reference's
    visitedSet, used as robust-prune candidates during insertion)

Dedup deviation from the reference: instead of a per-query bitset over all
node ids (memory-prohibitive at B×cap), membership is checked against the
current candidate list plus the visited ring. An un-expanded candidate that
was evicted may therefore be re-admitted later — benign: it competes by
distance exactly as before. Expanded nodes are never re-expanded.

Filtered search follows search.go:27-51 exactly: seed with up to
``searchSize`` filter members, run the normal greedy walk, and admit only
filter members (seeds + expanded) into the result set.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from semadb_tpu.index.vamana.graph import NIL, START_ID, GraphConfig, GraphState
from semadb_tpu.ops.distance import (
    gather_bit_distance,
    gather_distance,
    pairwise_distance,
)
from semadb_tpu.ops.topk import INF, sort_by_distance


def _make_gd(state, queries, config, quant, qcodes, qquery):
    """Distance evaluator over candidate ids: plain f32 gather, packed-bit
    hamming/jaccard (binary quantizer), or ADC table lookup (product
    quantizer). Mirrors vecStore.DistanceFromFloat dispatch
    (vectorstore.go:23-43)."""
    cap = state.capacity
    if quant is None or quant.kind == "plain" or qcodes is None:
        return lambda ids: gather_distance(
            state.vectors, jnp.clip(ids, 0, cap - 1), queries, config.metric
        )
    if quant.kind == "binary":
        return lambda ids: gather_bit_distance(
            qcodes, jnp.clip(ids, 0, cap - 1), qquery, quant.bit_metric
        )
    from semadb_tpu.vectorstore.store import pq_gather_distance

    return lambda ids: pq_gather_distance(
        qcodes, jnp.clip(ids, 0, cap - 1), qquery, quant.num_centroids
    )


class BeamResult(NamedTuple):
    cand_dists: jax.Array  # f32[B, L] sorted candidate list
    cand_ids: jax.Array  # i32[B, L]
    visited_dists: jax.Array  # f32[B, V] expanded nodes (sorted at exit)
    visited_ids: jax.Array  # i32[B, V]
    hops: jax.Array  # i32 scalar — hops taken (diagnostics)


def _merge_sorted(dists, ids, exp, new_d, new_i, L, compact: bool = True):
    """Merge new candidates into the sorted list, dedup, keep best L.

    Duplicate ids carry bit-identical distances (same query, same vector,
    same kernel), so after a stable (distance, id) sort duplicates are
    adjacent with the incumbent list entry first — marking non-first run
    members invalid both dedups and preserves expanded flags.

    ``compact=True`` runs a second sort pushing invalidated slots to the
    tail (exact list semantics, used by the build path whose visited sets
    feed robustPrune). ``compact=False`` leaves the (id=NIL, d=INF) holes
    in place — ordering among live entries is still by distance, selection
    skips holes, and re-encountered duplicates only cost a few wasted list
    slots per hop; ~35% fewer sort passes on the search hot path.
    """
    md = jnp.concatenate([dists, new_d], axis=-1)
    mi = jnp.concatenate([ids, new_i], axis=-1)
    me = jnp.concatenate([exp, jnp.zeros_like(new_i, dtype=bool)], axis=-1)
    # The id tiebreak key is load-bearing for dedup: duplicates of an id
    # carry bit-identical distances, but integer-valued quantized distances
    # (hamming/ADC) tie constantly across DIFFERENT ids — with a
    # distance-only sort duplicates stop landing adjacent, dedup misses,
    # and the beam floods with copies of one near node (recall 0.48→0.16
    # measured). The 2-key sort costs ~2%.
    md, mi, me_i = jax.lax.sort(
        (md, mi, me.astype(jnp.int32)), dimension=-1, num_keys=2, is_stable=True
    )
    dup = jnp.concatenate(
        [jnp.zeros_like(mi[..., :1], dtype=bool), mi[..., 1:] == mi[..., :-1]], axis=-1
    ) & (mi != -1)
    md = jnp.where(dup, INF, md)
    mi = jnp.where(dup, -1, mi)
    me_i = jnp.where(dup, 0, me_i)
    if compact:
        md, mi, me_i = jax.lax.sort(
            (md, mi, me_i), dimension=-1, num_keys=2, is_stable=False
        )
    return md[..., :L], mi[..., :L], me_i[..., :L].astype(bool)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "search_size", "max_hops", "expand_width", "quant",
        "track_visited", "compact_merge",
    ),
)
def beam_search(
    state: GraphState,
    queries: jax.Array,
    config: GraphConfig,
    search_size: int,
    max_hops: int = 0,
    seed_ids: Optional[jax.Array] = None,
    expand_width: int = 8,
    quant=None,
    qcodes: Optional[jax.Array] = None,
    qquery: Optional[jax.Array] = None,
    track_visited: bool = True,
    compact_merge: Optional[bool] = None,
) -> BeamResult:
    """Batched greedy search. ``queries``: f32[B, D] → BeamResult.

    ``compact_merge`` (default: follow ``track_visited``): whether the
    candidate-list merge compacts dedup holes with a second 2-key sort.
    Plain-f32 searches skip it safely (~35% fewer sort passes; f32
    distance ties are rare so holes are few). Quantized searches MUST
    compact: integer-valued distances tie constantly, dedup punches many
    holes per hop, and without compaction the effective beam narrows
    (BQ recall 0.48 → 0.41 measured).

    ``seed_ids``: optional i32[B, S] initial candidates (NIL-padded) used by
    filtered search; the start node is always added as well
    (search.go:53-60).

    ``expand_width`` (W): candidates expanded per hop. The reference expands
    strictly best-first one node at a time (search.go:63-98); expanding the
    W best unexpanded candidates per hop divides the sequential hop count by
    ~W at slightly more total distance work — the standard accelerator ANN
    trade (each hop's gather/contraction is then large enough to fill the
    hardware). W=1 reproduces best-first exactly.
    """
    B = queries.shape[0]
    L = search_size
    R = config.degree_bound
    W = expand_width
    compact = track_visited if compact_merge is None else compact_merge
    # Visited ring: ~2L slots rounded to a multiple of W so block writes
    # never straddle the wrap point (reference visitedSet starts at 2L,
    # distset.go).
    V = ((2 * L + W - 1) // W) * W
    max_hops = max_hops if max_hops > 0 else (3 * L + W - 1) // W
    cap = state.capacity

    gd = _make_gd(state, queries, config, quant, qcodes, qquery)

    # --- initial candidate list: start node (+ optional seeds) ---
    start_d = gd(jnp.full((B, 1), START_ID, jnp.int32))  # [B,1]
    cand_d = jnp.full((B, L), INF, jnp.float32).at[:, 0].set(start_d[:, 0])
    cand_i = jnp.full((B, L), NIL, jnp.int32).at[:, 0].set(START_ID)
    cand_e = jnp.zeros((B, L), dtype=bool)
    if seed_ids is not None:
        sd = gd(seed_ids)
        valid_seed = (seed_ids != NIL) & (seed_ids != START_ID)
        sd = jnp.where(valid_seed, sd, INF)
        si = jnp.where(valid_seed, seed_ids, NIL)
        cand_d, cand_i, cand_e = _merge_sorted(cand_d, cand_i, cand_e, sd, si, L)

    vis_d = jnp.full((B, V), INF, jnp.float32)
    vis_i = jnp.full((B, V), NIL, jnp.int32)

    arangeL = jnp.arange(L, dtype=jnp.int32)

    def not_done(carry):
        cand_d, cand_i, cand_e, vis_d, vis_i, hop = carry
        pending = jnp.any((cand_i != NIL) & ~cand_e & jnp.isfinite(cand_d))
        return jnp.logical_and(hop < max_hops, pending)

    def step(carry):
        cand_d, cand_i, cand_e, vis_d, vis_i, hop = carry
        # W closest unexpanded candidates per query; the list is sorted so
        # these are the first W set bits of the unexpanded mask.
        unexp = (cand_i != NIL) & ~cand_e & jnp.isfinite(cand_d)
        sel_score = jnp.where(unexp, -arangeL, jnp.int32(-(2**30)))
        _, pos = jax.lax.top_k(sel_score, W)  # earliest positions first
        sel_ok = jnp.take_along_axis(unexp, pos, axis=-1)  # [B, W]
        cur = jnp.take_along_axis(cand_i, pos, axis=-1)  # [B, W]
        cur_d = jnp.take_along_axis(cand_d, pos, axis=-1)
        # Mark all selected expanded
        onehot = (arangeL[None, None, :] == pos[:, :, None]) & sel_ok[:, :, None]
        cand_e = cand_e | jnp.any(onehot, axis=1)

        if track_visited:
            # Append W entries to the visited ring (block write, wrap-aligned)
            slot = jnp.mod(hop, V // W) * W
            old_i = jax.lax.dynamic_slice(vis_i, (0, slot), (B, W))
            old_d = jax.lax.dynamic_slice(vis_d, (0, slot), (B, W))
            vis_i = jax.lax.dynamic_update_slice(
                vis_i, jnp.where(sel_ok, cur, old_i), (0, slot)
            )
            vis_d = jax.lax.dynamic_update_slice(
                vis_d, jnp.where(sel_ok, cur_d, old_d), (0, slot)
            )

        # Gather all W*R neighbours and their distances in one shot
        nbr = state.adjacency[jnp.clip(cur, 0, cap - 1)]  # [B, W, R]
        nbr = nbr.reshape(B, W * R)
        nbr_ok = (nbr != NIL) & jnp.repeat(sel_ok, R, axis=-1)
        nbr_safe = jnp.clip(nbr, 0, cap - 1)
        # No exists-mask gather: the graph maintains the invariant that no
        # edge points at a non-existent node (delete repair removes them;
        # tested in test_vamana.test_degree_bound_invariant /
        # test_delete_and_connectivity), so NIL-masking suffices.
        nd = gd(nbr_safe)
        nd = jnp.where(nbr_ok, nd, INF)
        ni = jnp.where(nbr_ok, nbr, NIL)

        # No explicit membership scan needed: duplicates (in-list or among
        # the W rows) are removed by the post-sort adjacent dedup in
        # _merge_sorted, and an evicted candidate can never re-enter because
        # the L-th best distance is monotonically non-increasing.
        cand_d, cand_i, cand_e = _merge_sorted(
            cand_d, cand_i, cand_e, nd, ni, L, compact=compact
        )
        return cand_d, cand_i, cand_e, vis_d, vis_i, hop + 1

    cand_d, cand_i, cand_e, vis_d, vis_i, hops = jax.lax.while_loop(
        not_done, step, (cand_d, cand_i, cand_e, vis_d, vis_i, jnp.int32(0))
    )
    vis_d, vis_i = sort_by_distance(vis_d, vis_i)
    return BeamResult(cand_d, cand_i, vis_d, vis_i, hops)


@functools.partial(
    jax.jit, static_argnames=("config", "search_size", "k", "max_hops", "quant")
)
def search(
    state: GraphState,
    queries: jax.Array,
    config: GraphConfig,
    search_size: int,
    k: int,
    max_hops: int = 0,
    quant=None,
    qcodes: Optional[jax.Array] = None,
    qquery: Optional[jax.Array] = None,
    seed_ids: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Unfiltered top-k search: returns (dists f32[B,k], ids i32[B,k]).

    The start node is excluded from results (vamana.go Search:
    ``elem.Point.Id() == STARTID → continue``); invalid slots carry
    (INF, NIL).
    """
    rerank = quant is not None and quant.kind != "plain" and not quant.user_bit_metric
    res = beam_search(
        state, queries, config, search_size, max_hops, seed_ids=seed_ids,
        expand_width=2, quant=quant, qcodes=qcodes, qquery=qquery,
        track_visited=rerank,  # visited ring widens the rerank pool
    )
    d = res.cand_dists
    i = res.cand_ids
    if rerank:
        # Full-precision rerank: the graph was walked on quantized
        # distances (hamming/ADC — the memory-bandwidth win), but the final
        # top-k ordering uses raw vectors over the candidate list PLUS the
        # visited ring (~3L pool) — one small gather per batch. The
        # reference returns quantized distances directly and eats the
        # recall loss (binary.go/product.go DistanceFromFloat).
        from semadb_tpu.ops.topk import dedup_by_id

        cap = state.capacity
        i = jnp.concatenate([i, res.visited_ids], axis=-1)
        rr = gather_distance(
            state.vectors, jnp.clip(i, 0, cap - 1), queries, config.metric
        )
        d = jnp.where(i != NIL, rr, INF)
        d, i = dedup_by_id(d, i)
    d = jnp.where(i == START_ID, INF, d)
    i = jnp.where(i == START_ID, NIL, i)
    d, i = sort_by_distance(d, i)
    return d[:, :k], i[:, :k]


@functools.partial(
    jax.jit, static_argnames=("config", "search_size", "k", "max_hops", "quant")
)
def search_filtered(
    state: GraphState,
    queries: jax.Array,
    filter_mask: jax.Array,
    config: GraphConfig,
    search_size: int,
    k: int,
    max_hops: int = 0,
    quant=None,
    qcodes: Optional[jax.Array] = None,
    qquery: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Filtered top-k search (search.go:27-51 semantics).

    ``filter_mask``: bool[cap] of admissible node ids. Seeds the walk with
    the first ``search_size`` filter members (ascending id, mirroring the
    roaring iterator order), walks the graph normally, and admits only
    filter members — the seeds plus any expanded node passing the filter —
    into the result set.
    """
    cap = state.capacity
    mask = filter_mask & state.exists
    # First `search_size` member ids in ascending id order
    ids = jnp.arange(cap, dtype=jnp.int32)
    seed_score = jnp.where(mask, -ids, -jnp.inf)
    _, seed_ids = jax.lax.top_k(seed_score, search_size)  # smallest ids first
    seed_ids = jnp.where(
        jnp.take(mask, seed_ids), seed_ids.astype(jnp.int32), NIL
    )
    B = queries.shape[0]
    seeds = jnp.broadcast_to(seed_ids[None, :], (B, search_size))

    res = beam_search(
        state, queries, config, search_size, max_hops, seed_ids=seeds,
        expand_width=2, quant=quant, qcodes=qcodes, qquery=qquery,
        track_visited=True,
    )

    # Result pool: seeds ∪ expanded-nodes-passing-filter
    gd = _make_gd(state, queries, config, quant, qcodes, qquery)
    seed_d = gd(seeds)
    seed_d = jnp.where(seeds != NIL, seed_d, INF)
    vis_ok = (
        (res.visited_ids != NIL)
        & (res.visited_ids != START_ID)
        & jnp.take(mask, jnp.clip(res.visited_ids, 0, cap - 1))
    )
    vd = jnp.where(vis_ok, res.visited_dists, INF)
    vi = jnp.where(vis_ok, res.visited_ids, NIL)
    pool_d = jnp.concatenate([seed_d, vd], axis=-1)
    pool_i = jnp.concatenate([seeds, vi], axis=-1)
    # Dedup (seeds may also appear in visited) then take best k
    from semadb_tpu.ops.topk import dedup_by_id

    pool_d, pool_i = dedup_by_id(pool_d, pool_i)
    if quant is not None and quant.kind != "plain" and not quant.user_bit_metric:
        # Full-precision rerank, same as the unfiltered path: the walk and
        # the filter-pool scoring used quantized distances; final ordering
        # uses raw vectors over the (seed ∪ visited) pool.
        rr = gather_distance(
            state.vectors, jnp.clip(pool_i, 0, cap - 1), queries, config.metric
        )
        pool_d = jnp.where(pool_i != NIL, rr, INF)
    pool_d, pool_i = sort_by_distance(pool_d, pool_i)
    return pool_d[:, :k], pool_i[:, :k]


@functools.partial(jax.jit, static_argnames=("config", "k"))
def exact_search(
    state: GraphState, queries: jax.Array, config: GraphConfig, k: int
) -> tuple[jax.Array, jax.Array]:
    """Brute-force reference search over live nodes (tests / ground truth)."""
    d = pairwise_distance(queries, state.vectors, config.metric)
    live = state.exists & (jnp.arange(state.capacity) != START_ID)
    d = jnp.where(live[None, :], d, INF)
    negv, idx = jax.lax.top_k(-d, k)
    return -negv, idx.astype(jnp.int32)
