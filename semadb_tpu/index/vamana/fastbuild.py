"""Matmul-built Vamana bulk construction: per-cluster exact-kNN candidate pools.

The DiskANN-style two-pass build (insert.go:16-68: greedy-search every
point, robust-prune its visited set) spends essentially all of its time in
the beam searches, because each hop is a random-row gather from device
memory.

This module replaces the searches with dense linear algebra:

  1. k-means the batch into C ≈ N/256 clusters (vectorstore.kmeans
     ``kmeans_fit_large`` — blocked, single dispatch).
  2. Assign every point to its T nearest clusters (``kmeans_assign``).
  3. For each cluster, compute the exact pairwise distance matrix among
     its members — one [m, m] matmul per cluster, batched G clusters at a
     time — and keep each member's K nearest: a high-recall local kNN
     pool from pure matmuls.
  4. Append ``n_rand`` random far candidates per point. The alpha prune
     keeps a far candidate only when no kept edge dominates it, which is
     exactly how the incremental build's long-range edges survive pruning
     — this restores the navigability that a pure kNN graph lacks.
  5. Run the normal two-pass alpha schedule (pass 1 α=1.0, pass 2 at the
     configured α with candidate pool = pool ∪ current row) through
     ``build.insert_batch(pool_d=…, pool_i=…)`` — prune, conflict-free
     backedge scatter and overflow re-prune are shared with the
     incremental path, so every graph invariant (degree bound, no
     self/dangling edges) holds by the same code.
  6. Point the start node at R spread cluster representatives and rescue
     any unreachable stragglers (prune.go:115-151 analog) so BFS
     connectivity from START_ID holds like in the reference.

Reference parity: this replaces vamana.go:190-253's parallel insert
workers for the initial bulk load only; incremental writes keep the
beam-search path (build.py). Quality is validated against the same recall
harness as the two-pass build (semadb_tpu/tools/annbench.py via
BENCH_MODE=plain SEMADB_VAMANA_BUILD=pool).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from semadb_tpu.index.vamana.graph import NIL, START_ID, GraphConfig, GraphState
from semadb_tpu.ops.topk import INF

# Pool-shape knobs (env-tunable for the build lab; defaults were tuned at
# 1M x 128d, ROADMAP D5).
KNN_K = int(os.environ.get("SEMADB_VAMANA_FB_K", 64))  # kNN kept per cluster
ASSIGN_T = int(os.environ.get("SEMADB_VAMANA_FB_T", 2))  # clusters per point
N_RAND = int(os.environ.get("SEMADB_VAMANA_FB_RAND", 16))  # far candidates
MEMBER_TARGET = int(os.environ.get("SEMADB_VAMANA_FB_MEMBERS", 256))
KM_ITERS = int(os.environ.get("SEMADB_VAMANA_FB_KM_ITERS", 8))
# Per-group [G, m, m] distance tensor budget (bytes)
GROUP_BYTES = 1 << 28


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit, static_argnames=("metric", "k", "row_off"), donate_argnums=(0, 1)
)
def _pool_group(
    pool_d: jax.Array,  # f32[N, P] (donated)
    pool_i: jax.Array,  # i32[N, P] (donated) — batch indices, -1 padded
    member: jax.Array,  # i32[G, m] batch indices, -1 padded
    slot: jax.Array,  # i32[G, m] assignment slot (0..T-1)
    vecs: jax.Array,  # f32[N, D] — or [cap, D] graph matrix with row_off
    metric: str,
    k: int,
    row_off: int = 0,
):
    """Exact kNN within each of G clusters; scatter each member's K nearest
    into its pool columns [slot*K, slot*K + K).

    ``row_off``: memory-lean builds gather from the ADOPTED graph matrix
    (batch index b lives at row b+row_off) instead of a second corpus
    copy; pool ids then come out in NODE-id space directly."""
    n = vecs.shape[0]
    G, m = member.shape
    ok = member != NIL
    mv = vecs[jnp.clip(member + row_off, 0, n - 1)]  # [G, m, D]
    cross = jnp.einsum(
        "gmd,gnd->gmn", mv, mv, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    if metric == "euclidean":
        sq = jnp.sum(mv * mv, axis=-1)
        pd = jnp.maximum(sq[:, :, None] - 2.0 * cross + sq[:, None, :], 0.0)
    elif metric == "cosine":
        pd = 1.0 - cross
    else:  # dot
        pd = -cross
    eye = jnp.eye(m, dtype=bool)[None]
    pd = jnp.where(eye | ~ok[:, :, None] | ~ok[:, None, :], INF, pd)
    nd, nj = jax.lax.top_k(-pd, k)  # [G, m, K] nearest member positions
    nd = -nd
    cand = jnp.take_along_axis(
        jnp.broadcast_to(member[:, None, :], (G, m, m)), nj, axis=-1
    )  # [G, m, K] batch indices (+row_off → node ids)
    cand = jnp.where(jnp.isfinite(nd), cand + row_off, NIL)

    rows = jnp.where(ok, member, n).reshape(-1)  # invalid rows → dropped
    cols = (slot.reshape(-1) * k)[:, None] + jnp.arange(k, dtype=jnp.int32)[None, :]
    pool_d = pool_d.at[rows[:, None], cols].set(
        nd.reshape(-1, k).astype(pool_d.dtype), mode="drop"
    )
    pool_i = pool_i.at[rows[:, None], cols].set(cand.reshape(-1, k), mode="drop")
    return pool_d, pool_i


@functools.partial(jax.jit, static_argnames=("metric",), donate_argnums=(0, 1))
def _pool_rand(
    pool_d: jax.Array,  # f32[N, P] (donated)
    pool_i: jax.Array,  # i32[N, P] (donated)
    vecs: jax.Array,  # f32[N, D]
    seed: jax.Array,
    metric: str,
):
    """Fill the last N_RAND pool columns with random far candidates."""
    from semadb_tpu.ops.distance import gather_distance

    n = vecs.shape[0]
    nr = N_RAND
    key = jax.random.PRNGKey(seed)
    rand = jax.random.randint(key, (n, nr), 0, n, dtype=jnp.int32)
    rd = gather_distance(vecs, rand, vecs, metric)  # [N, nr]
    self_hit = rand == jnp.arange(n, dtype=jnp.int32)[:, None]
    rd = jnp.where(self_hit, INF, rd)
    rand = jnp.where(self_hit, NIL, rand)
    P = pool_i.shape[1]
    cols = jnp.arange(P - nr, P)
    pool_d = pool_d.at[:, cols].set(rd.astype(pool_d.dtype))
    pool_i = pool_i.at[:, cols].set(rand)
    return pool_d, pool_i


@functools.partial(
    jax.jit, static_argnames=("metric", "blk", "n", "row_off"),
    donate_argnums=(0, 1),
)
def _pool_rand_blk(
    pool_d, pool_i, vecs, seed, b0, metric, blk: int, n: int, row_off: int
):
    """Blocked variant for the memory-lean build: random-candidate fill
    for batch rows [b0, b0+blk) gathering from the adopted graph matrix
    (one [blk, D] gather per block instead of a corpus-sized transient)."""
    from semadb_tpu.ops.distance import gather_distance

    nr = N_RAND
    key = jax.random.fold_in(jax.random.PRNGKey(seed), b0)
    rand = jax.random.randint(key, (blk, nr), 0, n, dtype=jnp.int32)
    rows_b = b0 + jnp.arange(blk, dtype=jnp.int32)
    valid = rows_b < n
    cap = vecs.shape[0]
    q = vecs[jnp.clip(rows_b + row_off, 0, cap - 1)]  # [blk, D]
    rd = gather_distance(vecs, jnp.clip(rand + row_off, 0, cap - 1), q, metric)
    self_hit = rand == rows_b[:, None]
    rd = jnp.where(self_hit | ~valid[:, None], INF, rd)
    ri = jnp.where(self_hit, NIL, rand + row_off)
    P = pool_i.shape[1]
    target = jnp.where(valid, rows_b, pool_i.shape[0])  # OOB → dropped
    cols = jnp.arange(P - nr, P, dtype=jnp.int32)
    pool_d = pool_d.at[target[:, None], cols[None, :]].set(
        rd.astype(pool_d.dtype), mode="drop"
    )
    pool_i = pool_i.at[target[:, None], cols[None, :]].set(ri, mode="drop")
    return pool_d, pool_i


def build_pools(
    vecs: jax.Array,  # f32[N, D] device-resident batch vectors
    metric: str,
    seed: int = 0,
    n_rows: int = 0,
    row_off: int = 0,
):
    """→ (pool_d f32[N, P], pool_i i32[N, P], cents f32[C, D]|None,
    reps i32[C]|None). Pool entries are BATCH indices (NODE ids when
    ``row_off`` > 0), NIL-padded; ``reps[c]`` is one member batch index
    per cluster (the query-routing representative) or NIL for empty.

    Memory-lean mode (``row_off`` > 0, ``n_rows`` set): ``vecs`` is the
    ADOPTED graph matrix (batch row b at vecs[b+row_off]) — no second
    corpus copy lives in device memory next to the graph arrays at 10M.
    All gathers go through the
    offset; the kmeans assignment runs in bounded blocks.

    P = ASSIGN_T·KNN_K + N_RAND. Runs entirely on device except the member
    grouping (one [N, T] readback + numpy segment packing).
    """
    from semadb_tpu.vectorstore.kmeans import kmeans_assign, kmeans_fit_large

    n = n_rows or vecs.shape[0]
    d = vecs.shape[1]
    T, K = ASSIGN_T, KNN_K
    P = T * K + N_RAND
    # bf16 at-rest pool distances (SEMADB_VAMANA_FB_POOL_BF16=1): the
    # [N, P] distance matrix is the HBM long pole of a 10M pool build
    # (f32 P=144 → 5.8 GB next to vectors + adjacency); distances are
    # rank-only here, and every in-flight merge promotes to f32.
    pdt = (
        jnp.bfloat16
        if os.environ.get("SEMADB_VAMANA_FB_POOL_BF16", "0") == "1"
        else jnp.float32
    )
    pool_d = jnp.full((n, P), INF, pdt)
    pool_i = jnp.full((n, P), NIL, jnp.int32)

    def rand_fill(pool_d, pool_i):
        if row_off == 0 and n == vecs.shape[0]:
            return _pool_rand(
                pool_d, pool_i, vecs, jnp.asarray(seed, jnp.int32), metric
            )
        blk = 1 << 16
        for b0 in range(0, n, blk):
            pool_d, pool_i = _pool_rand_blk(
                pool_d, pool_i, vecs, seed, jnp.asarray(b0, jnp.int32),
                metric, blk, n, row_off,
            )
        return pool_d, pool_i

    if n <= 4 * MEMBER_TARGET:
        # Tiny batch: one cluster holding everything (single [n, n] matmul)
        member = jnp.arange(n, dtype=jnp.int32)[None, :]
        slot = jnp.zeros((1, n), jnp.int32)
        pool_d, pool_i = _pool_group(
            pool_d, pool_i, member, slot, vecs, metric, min(K, n - 1),
            row_off=row_off,
        )
        pool_d, pool_i = rand_fill(pool_d, pool_i)
        return pool_d, pool_i, None, None

    C = max(16, n // MEMBER_TARGET)
    # Fit centroids on a strided subsample: pool quality only needs a
    # reasonable space partition, not converged centroids (the same
    # observation as the PQ codebook subsampling).
    km_cap = int(os.environ.get("SEMADB_VAMANA_FB_KM_SAMPLE", 1 << 18))
    km_cap = max(km_cap, 32 * C)
    stride = max(1, n // km_cap) if n > km_cap else 1
    if stride == 1 and row_off == 0 and n == vecs.shape[0]:
        fit_rows = vecs  # no-slice fast path (a full slice would copy)
    else:
        fit_rows = vecs[row_off : row_off + n : stride]

    def assign(cents_t, t):
        if row_off == 0 and n == vecs.shape[0]:
            return np.asarray(kmeans_assign(vecs, cents_t, t=t))  # [N, t]
        # Bounded-block assignment against the adopted matrix: a whole-
        # corpus slice would be a 5 GB transient at 10M.
        CH = 1 << 20
        cap = vecs.shape[0]
        out = np.empty((n, t), np.int32)
        for lo in range(0, n, CH):
            hi = min(lo + CH, n)
            rows = jnp.clip(
                jnp.arange(lo, lo + CH, dtype=jnp.int32) + row_off, 0, cap - 1
            )
            out[lo:hi] = np.asarray(kmeans_assign(vecs[rows], cents_t, t=t))[
                : hi - lo
            ]
        return out

    # Cross-cluster pool mixing (SEMADB_VAMANA_FB_MIX=m): the last m of
    # the T assignment slots come from an INDEPENDENT k-means partition
    # (decorrelated seed). A true-neighbour pair that straddles a cluster
    # boundary in one partition lands interior to a shared cluster in the
    # other with high probability — targeting the diagnosed fast-build
    # residual (~0.0011 at 1M: candidates the single partition's pools
    # never contain). Matmul mass is unchanged (same n·T member entries);
    # only the subsampled fit + one extra assignment pass are added.
    mix = min(int(os.environ.get("SEMADB_VAMANA_FB_MIX", 0)), T - 1)
    mix = max(mix, 0)
    cents, _ = kmeans_fit_large(fit_rows, C, seed=seed, iters=KM_ITERS)
    asn = assign(cents, T - mix)
    C_total = C
    if mix:
        cents_b, _ = kmeans_fit_large(
            fit_rows, C, seed=seed + 7919, iters=KM_ITERS
        )
        asn = np.concatenate([asn, assign(cents_b, mix) + C], axis=1)
        C_total = 2 * C

    # Host segment packing: entries (cluster, point, slot) grouped by cluster
    flat_c = asn.reshape(-1).astype(np.int64)  # entry order: point-major
    flat_p = np.repeat(np.arange(n, dtype=np.int32), T)
    flat_t = np.tile(np.arange(T, dtype=np.int32), n)
    order = np.argsort(flat_c, kind="stable")
    counts = np.bincount(flat_c, minlength=C_total)
    # Cap members per cluster: heavy-tail clusters lose candidates past the
    # cap (their points keep the other assignment's pool + random edges).
    m_max = _round_up(min(int(counts.max()), 4 * MEMBER_TARGET * T), 128)
    starts = np.zeros(C_total + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(n * T, dtype=np.int64) - starts[flat_c[order]]
    keep = pos < m_max
    member = np.full((C_total, m_max), NIL, np.int32)
    slot = np.zeros((C_total, m_max), np.int32)
    member[flat_c[order][keep], pos[keep]] = flat_p[order][keep]
    slot[flat_c[order][keep], pos[keep]] = flat_t[order][keep]
    # Query-routing representatives: SEMADB_VAMANA_FB_REPS members per
    # cluster (>1 widens each routed cluster's entry WITHOUT widening the
    # cluster top-k — the round-4 route-seed sweep showed more CLUSTERS
    # loses recall past ~8-16, but more entries per good cluster is a
    # different lever). Routing stays on the PRIMARY partition: reps are
    # sliced to its C clusters (the mixed partition only feeds pools).
    n_reps = max(1, int(os.environ.get("SEMADB_VAMANA_FB_REPS", 1)))
    reps = (
        member[:C, 0].copy()
        if n_reps == 1
        else member[:C, : min(n_reps, m_max)].copy()
    )

    # Size-bucketed dispatch: padding every cluster to the HEAVY-TAIL max
    # wastes m_max²/m̄² of the pairwise matmul (16× at 1M with T=3:
    # m̄≈768, m_max=3072). Buckets
    # of power-of-two widths bound the padding waste at 2× for a handful
    # of compile shapes.
    eff = np.minimum(counts, m_max).astype(np.int64)
    widths = []
    w = 256
    while w < m_max:
        widths.append(w)
        w *= 2
    widths.append(m_max)
    lo = 0
    for w in widths:
        sel = np.nonzero((eff > lo) & (eff <= w))[0]
        lo = w
        if len(sel) == 0:
            continue
        mb = member[sel, :w]
        sb = slot[sel, :w]
        G = max(8, min(len(sel), GROUP_BYTES // max(w * w * 4, 1)))
        Cp = _round_up(len(sel), G)
        if Cp != len(sel):
            mb = np.concatenate([mb, np.full((Cp - len(sel), w), NIL, np.int32)])
            sb = np.concatenate([sb, np.zeros((Cp - len(sel), w), np.int32)])
        for g0 in range(0, Cp, G):
            pool_d, pool_i = _pool_group(
                pool_d, pool_i,
                jnp.asarray(mb[g0 : g0 + G]),
                jnp.asarray(sb[g0 : g0 + G]),
                vecs, metric, min(K, w - 1) if w <= K else K,
                row_off=row_off,
            )
    pool_d, pool_i = rand_fill(pool_d, pool_i)
    return pool_d, pool_i, np.asarray(cents), reps


@functools.partial(jax.jit, static_argnames=("keep",), donate_argnums=(0, 1))
def _truncate_pools(pool_d, pool_i, keep: int):
    """Keep each point's ``keep`` nearest kNN-pool candidates plus the
    trailing N_RAND random far columns. Rich pools (T=3/K=96) lift recall
    through WHICH candidates survive, not how many the prune sees — the
    insert passes cost ~linear in pool width, so the width is cut back
    before inserting.
    Duplicate ids across assignment slots carry identical distances and
    collapse in the insert path's merge-dedup."""
    n, P = pool_i.shape
    nr = N_RAND
    kd, kj = jax.lax.top_k(-pool_d[:, : P - nr], keep)
    ki = jnp.take_along_axis(pool_i[:, : P - nr], kj, axis=1)
    return (
        jnp.concatenate([-kd, pool_d[:, P - nr :]], axis=1),
        jnp.concatenate([ki, pool_i[:, P - nr :]], axis=1),
    )


@functools.partial(jax.jit, static_argnames=("metric", "e1", "e2"))
def _expand_pool(
    state: GraphState,
    ids: jax.Array,  # i32[B] chunk node ids
    vecs: jax.Array,  # f32[B, D] chunk vectors
    pool_d: jax.Array,  # f32[B, P]
    pool_i: jax.Array,  # i32[B, P]
    metric: str,
    e1: int = 16,
    e2: int = 16,
):
    """One NN-descent round: merge each node's 2-hop neighbourhood (first
    ``e1`` edges × their first ``e2`` edges, which after pass 1 include
    backedges) into its candidate pool, keep the best P.

    This is what the beam search contributes beyond the cluster pools —
    candidates reached THROUGH the evolving graph — at gather cost of one
    beam hop per chunk instead of a whole walk. Duplicates are removed by
    the (distance, id) 2-key sort + adjacent-dedup (search._merge_sorted:
    duplicate ids carry bit-identical distances)."""
    from semadb_tpu.index.vamana.search import _merge_sorted
    from semadb_tpu.ops.distance import gather_distance

    cap = state.capacity
    B, P = pool_i.shape
    own = state.adjacency[jnp.clip(ids, 0, cap - 1)][:, :e1]  # [B, e1]
    own_ok = own != NIL
    nb2 = state.adjacency[jnp.clip(own, 0, cap - 1)][:, :, :e2]  # [B, e1, e2]
    nb2 = nb2.reshape(B, e1 * e2)
    ok = (nb2 != NIL) & jnp.repeat(own_ok, e2, axis=-1)
    ok &= nb2 != ids[:, None]
    d2 = gather_distance(state.vectors, jnp.clip(nb2, 0, cap - 1), vecs, metric)
    d2 = jnp.where(ok, d2, INF)
    ni = jnp.where(ok, nb2, NIL)
    md, mi, _ = _merge_sorted(
        pool_d, pool_i, jnp.zeros_like(pool_i, dtype=bool), d2, ni, P
    )
    return md, mi


@functools.partial(jax.jit, donate_argnums=(0,))
def _topup_chunk(adjacency, ids, pool_d, pool_i, exists):
    """Backedge top-up: fill a chunk's NIL adjacency slots with their
    nearest not-yet-linked pool candidates. The alpha-detour prune can
    leave rows under-full (candidates dropped without replacements); the
    diagnosed fast-build residual is EDGE quality, so unused row capacity
    is free recall — extra near edges only densify local navigation."""
    rows = adjacency[ids]  # [m, R]
    cand = pool_i  # [m, P] node ids, NIL-padded
    in_row = jnp.any(cand[:, :, None] == rows[:, None, :], axis=2)
    ok = (
        (cand != NIL)
        & (cand != ids[:, None])
        & ~in_row
        & exists[jnp.clip(cand, 0, exists.shape[0] - 1)]
    )
    key = jnp.where(ok, pool_d, INF)
    order = jnp.argsort(key, axis=1)
    sc = jnp.take_along_axis(cand, order, axis=1)
    sk = jnp.take_along_axis(key, order, axis=1)
    sc = jnp.where(jnp.isfinite(sk), sc, NIL)
    # best-effort adjacent dedup (duplicate ids across assignment slots
    # carry identical distances, so they sort adjacent)
    dup = jnp.concatenate(
        [jnp.zeros((sc.shape[0], 1), bool), sc[:, 1:] == sc[:, :-1]], axis=1
    )
    sk = jnp.where(dup, INF, sk)
    order2 = jnp.argsort(sk, axis=1)
    sc = jnp.where(dup, NIL, sc)
    sc = jnp.take_along_axis(sc, order2, axis=1)
    nil_mask = rows == NIL
    nil_rank = jnp.clip(jnp.cumsum(nil_mask, axis=1) - 1, 0, sc.shape[1] - 1)
    fill = jnp.take_along_axis(sc, nil_rank, axis=1)
    new_rows = jnp.where(nil_mask, fill, rows)
    return adjacency.at[ids].set(new_rows)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _adopt_arrays(vectors, exists, ids, vecs):
    return vectors.at[ids].set(vecs), exists.at[ids].set(True)


def _adopt_vectors(
    state: GraphState, ids: jax.Array, vecs: jax.Array
) -> GraphState:
    """Write every batch vector + existence bit up front: pool candidates
    reference vectors across chunks, so the prune's gathers need them all
    resident before the first chunk applies. Donated — the scatter lands
    in the existing (zeros) buffers instead of copying a 5 GB matrix at
    10M."""
    vectors, exists = _adopt_arrays(state.vectors, state.exists, ids, vecs)
    return GraphState(vectors=vectors, adjacency=state.adjacency, exists=exists)


def _connect_start(
    state: GraphState,
    ids: np.ndarray,
    config: GraphConfig,
) -> GraphState:
    """Point START_ID at R evenly-spread batch points (vamana.go:93-120's
    random-unit start vector gains edges organically from backedges during
    the incremental build; the pool build must install them explicitly)."""
    R = config.degree_bound
    sel = ids[np.linspace(0, len(ids) - 1, min(R, len(ids))).astype(int)]
    row = np.full(R, NIL, np.int32)
    row[: len(sel)] = np.unique(sel)[: len(sel)]
    adjacency = state.adjacency.at[START_ID].set(jnp.asarray(row))
    return GraphState(
        vectors=state.vectors, adjacency=adjacency, exists=state.exists
    )


def bulk_build_pools(
    index,  # IndexVamana (fresh: no live user points)
    ids32: np.ndarray,
    vec_np: np.ndarray,
    l2: int,
) -> None:
    """Full fast bulk build on a fresh graph. Mutates ``index.state``."""
    from semadb_tpu.index.vamana.build import _logger, insert_batch

    config: GraphConfig = index.config
    n = len(ids32)
    chunk = int(os.environ.get("SEMADB_VAMANA_FB_CHUNK", 8192))

    # Memory-lean flow for contiguous id ranges (the bulk-load shape):
    # adopt the corpus into the graph matrix FIRST (donated scatter), drop
    # every corpus reference, and build pools gathering from state.vectors
    # with a row offset — no second corpus copy next to pools + graph.
    # At 10M × 128d this is the difference between ~21 GB and ~14 GB peak.
    # Gated on corpus size: lean's offset gathers + blocked kmeans
    # assignment cost real build time, and below the byte threshold the
    # second corpus copy it avoids fits in device memory (a fixed
    # threshold; ROADMAP S4 derives it from the device).
    off = int(ids32[0]) if n else 0
    lean_bytes = int(
        os.environ.get("SEMADB_VAMANA_FB_LEAN_BYTES", 2 << 30)
    )
    lean = bool(
        n
        and n * int(np.shape(vec_np)[1]) * 4 >= lean_bytes
        and np.array_equal(ids32, np.arange(off, off + n, dtype=np.int32))
    )
    with _logger().timed("vamana fastbuild pools", count=n):
        if lean:
            index.state = _adopt_vectors(
                index.state, jnp.asarray(ids32), jnp.asarray(vec_np)
            )
            vec_np = None  # the graph matrix is the corpus now
            pd_b, pi_b, cents, reps = build_pools(
                index.state.vectors, config.metric, n_rows=n, row_off=off
            )
            # lean pools already carry node ids (batch index + off)
        else:
            vecs_dev = jnp.asarray(vec_np)
            index.state = _adopt_vectors(
                index.state, jnp.asarray(ids32), vecs_dev
            )
            pd_b, pi_b, cents, reps = build_pools(vecs_dev, config.metric)
            # Map batch indices → node ids
            ids_dev = jnp.asarray(ids32)
            pi_b = jnp.where(pi_b != NIL, ids_dev[jnp.clip(pi_b, 0, n - 1)], NIL)
        if cents is not None:
            # Query-routed entry: the pool k-means doubles as a coarse
            # quantizer — searches seed at the nearest clusters' members
            # instead of descending from the random start node.
            rep_ids = np.where(reps != NIL, ids32[np.clip(reps, 0, n - 1)], NIL)
            index.set_query_routing(cents, rep_ids.astype(np.int32))
        trunc = int(os.environ.get("SEMADB_VAMANA_FB_TRUNC", 0))
        if trunc and trunc + N_RAND < pd_b.shape[1]:
            pd_b, pi_b = _truncate_pools(pd_b, pi_b, trunc)

    # Number of pass-2 rounds that expand pools through the current graph
    # (0 = one pass-2 round from the raw cluster pools, no expansion;
    # -1 = no pool pass-2 at all — the beam refine below is pass 2).
    n_expand = int(os.environ.get("SEMADB_VAMANA_FB_EXPAND", 1))
    passes = [(1.0, "pass1", False)]
    if n_expand > 0:
        passes += [(config.alpha, f"pass2.{e}", True) for e in range(n_expand)]
    elif n_expand == 0:
        passes += [(config.alpha, "pass2", False)]
    def chunk_vecs(i):
        # lean mode: the corpus lives only in the graph matrix — gather
        # the chunk's rows ([chunk, D], ~4 MB) instead of slicing a freed
        # host array
        if vec_np is not None:
            return vec_np[i : i + chunk]
        return index.state.vectors[jnp.asarray(ids32[i : i + chunk])]

    for alpha, tag, expand in passes:
        with _logger().timed(f"vamana fastbuild {tag}", count=n):
            for i in range(0, n, chunk):
                pd_c = pd_b[i : i + chunk]
                pi_c = pi_b[i : i + chunk]
                cv = chunk_vecs(i)
                if expand:
                    # 2-hop pool expansion against the CURRENT graph (with
                    # pass-1 backedges) — the NN-descent round that stands
                    # in for search-through-the-graph candidates.
                    pd_c, pi_c = _expand_pool(
                        index.state,
                        jnp.asarray(ids32[i : i + chunk]),
                        jnp.asarray(cv),
                        pd_c, pi_c, config.metric,
                    )
                index.state = insert_batch(
                    index.state,
                    ids32[i : i + chunk],
                    cv,
                    config,
                    l2,
                    intra_k=0,
                    keep_current=True,
                    alpha=alpha,
                    pool_d=pd_c,
                    pool_i=pi_c,
                )
    # Backedge top-up (SEMADB_VAMANA_FB_TOPUP=1): fill under-full rows
    # with nearest unused pool candidates — targets the diagnosed
    # edge-quality residual (0.9982 ceiling) at one scatter per chunk.
    if os.environ.get("SEMADB_VAMANA_FB_TOPUP", "0") == "1":
        with _logger().timed("vamana fastbuild topup", count=n):
            for i in range(0, n, chunk):
                index.state = GraphState(
                    vectors=index.state.vectors,
                    adjacency=_topup_chunk(
                        index.state.adjacency,
                        jnp.asarray(ids32[i : i + chunk]),
                        pd_b[i : i + chunk],
                        pi_b[i : i + chunk],
                        index.state.exists,
                    ),
                    exists=index.state.exists,
                )

    index.state = _connect_start(index.state, ids32, config)

    # Optional beam-search polish (IndexVamana.refine: keep_current pass
    # at the configured alpha) — the experiment knob separating pool
    # quality from navigation quality.
    n_refine = int(os.environ.get("SEMADB_VAMANA_FB_REFINE", 0))
    if n_refine:
        refine_l = int(os.environ.get("SEMADB_VAMANA_FB_REFINE_L", 0))
        seed_own = os.environ.get("SEMADB_VAMANA_FB_SEED_OWN", "0") == "1"
        with _logger().timed("vamana fastbuild refine", count=n):
            index.refine(passes=n_refine, search_size=refine_l, seed_own=seed_own)

    # Straggler rescue (prune.go:115-151 analog): attach any node BFS
    # cannot reach from the start to a spread representative set.
    from semadb_tpu.index.vamana.build import _attach_representatives
    from semadb_tpu.index.vamana.build import reachable_mask

    unreach = index.state.exists & ~reachable_mask(index.state)
    if bool(jnp.any(unreach)):  # one scalar readback per build
        index.state = _attach_representatives(index.state, unreach, config)
