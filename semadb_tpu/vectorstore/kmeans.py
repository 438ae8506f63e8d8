"""On-device k-means (Lloyd's) with furthest-point init.

Reference: utils/kmeans.go — kmeans++-style furthest-point initialisation,
Lloyd's iterations with early stop when no label changes, empty clusters
keep their previous centroid, euclidean distance throughout, uint8 labels
(K ≤ 256). The reference runs one goroutine per PQ subvector
(product.go:201-233); here the whole fit is one vmapped device program —
assignment is a blocked [N, K] distance matmul, the update is a
one-hot segment-sum matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from semadb_tpu.utils.logging import get_logger

log = get_logger("kmeans")


@functools.partial(jax.jit, static_argnames=("k",))
def _init_furthest(data: jax.Array, k: int, seed: jax.Array) -> jax.Array:
    """Furthest-point init (kmeans.go:49-85): first centroid random, each
    next is the point furthest from all chosen so far."""
    n = data.shape[0]
    key = jax.random.PRNGKey(seed)
    first = jax.random.randint(key, (), 0, n)
    centroids0 = jnp.zeros((k, data.shape[1]), data.dtype).at[0].set(data[first])
    min_d0 = jnp.full((n,), jnp.inf, jnp.float32).at[first].set(-jnp.inf)

    def body(i, carry):
        centroids, min_d = carry
        last = centroids[i - 1]
        d = jnp.sum((data - last[None, :]) ** 2, axis=-1)
        min_d = jnp.minimum(min_d, d)
        nxt = jnp.argmax(min_d)
        centroids = centroids.at[i].set(data[nxt])
        min_d = min_d.at[nxt].set(-jnp.inf)  # exclude from future picks
        return centroids, min_d

    centroids, _ = jax.lax.fori_loop(1, k, body, (centroids0, min_d0))
    return centroids


@functools.partial(jax.jit, static_argnames=("k", "max_iter"))
def kmeans_fit(
    data: jax.Array, k: int, seed: int | jax.Array = 0, max_iter: int = 100
):
    """Fit k-means on ``data`` f32[N, d] → (centroids f32[k, d], labels u8[N]).

    Early-stops when assignments stabilise (kmeans.go:97-117 changeCount).
    """
    n = data.shape[0]
    sq_data = jnp.sum(data * data, axis=-1, keepdims=True)  # [N,1]
    centroids = _init_furthest(data, k, jnp.asarray(seed, jnp.int32))

    def assign(centroids):
        sq_c = jnp.sum(centroids * centroids, axis=-1)[None, :]
        cross = jax.lax.dot_general(
            data,
            centroids,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        d = sq_data - 2.0 * cross + sq_c  # [N, K]
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    def cond(carry):
        _, _, changed, it = carry
        return jnp.logical_and(changed, it < max_iter)

    def step(carry):
        centroids, labels, _, it = carry
        new_labels = assign(centroids)
        changed = jnp.any(new_labels != labels)
        onehot = jax.nn.one_hot(new_labels, k, dtype=jnp.float32)  # [N, K]
        sums = jax.lax.dot_general(
            onehot,
            data,
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # [K, d]
        counts = jnp.sum(onehot, axis=0)  # [K]
        new_centroids = jnp.where(
            (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None], centroids
        )
        return new_centroids, new_labels, changed, it + 1

    labels0 = jnp.full((n,), -1, jnp.int32)
    centroids, labels, _, _ = jax.lax.while_loop(
        cond, step, (centroids, labels0, jnp.bool_(True), jnp.int32(0))
    )
    return centroids, labels.astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("k", "max_iter"))
def kmeans_fit_subvectors(
    data: jax.Array, k: int, seed: int | jax.Array = 0, max_iter: int = 100
):
    """Per-subvector fit for PQ: data f32[M, N, dsub] →
    (centroids f32[M, k, dsub], labels u8[M, N]).

    Vmapped when the combined [M, N, K] distance tensor is small; serial
    (``lax.map``) past 256 MB — the vmapped tensor is 98 GB at
    1M x 96 subvectors x 256 centroids."""
    m = data.shape[0]
    seeds = jnp.arange(m, dtype=jnp.int32) + jnp.asarray(seed, jnp.int32)
    if m * data.shape[1] * k > 2**26:
        return jax.lax.map(
            lambda ds_: kmeans_fit(ds_[0], k, ds_[1], max_iter), (data, seeds)
        )
    return jax.vmap(lambda d, s: kmeans_fit(d, k, s, max_iter))(data, seeds)


@functools.partial(jax.jit, static_argnames=("t",))
def kmeans_assign(data: jax.Array, cents: jax.Array, t: int = 1, row_ids=None):
    """Top-t nearest centroids per row → i32[N, t] (ascending distance).

    Row-blocked like :func:`kmeans_fit_large` so the [NB, K] distance
    matrix stays bounded. With ``row_ids``, `data` is the full backing
    matrix and rows are gathered PER BLOCK — the full [N, D] gather copy
    would double peak HBM (6.2 GB extra at 1M x 1536d). Used for
    SOAR-style multi-cluster assignment (index/ivf.py assignCopies)."""
    n = row_ids.shape[0] if row_ids is not None else data.shape[0]
    k = cents.shape[0]
    sq_c = jnp.sum(cents * cents, axis=-1)[None, :]

    def blk_top(blk):
        sq_b = jnp.sum(blk * blk, axis=-1, keepdims=True)
        dist = sq_b - 2.0 * (blk @ cents.T) + sq_c
        _, idx = jax.lax.top_k(-dist, t)
        return idx.astype(jnp.int32)

    if row_ids is None and n * k <= 2**26:
        return blk_top(data)
    nb = max(2**26 // k, 512)
    nblk = -(-n // nb)
    npad = nblk * nb
    if row_ids is not None:
        rpad = row_ids if npad == n else jnp.pad(row_ids, (0, npad - n))
        _, out = jax.lax.scan(
            lambda _, r: (None, blk_top(data[r])), None, rpad.reshape(nblk, nb)
        )
    else:
        dpad = data if npad == n else jnp.pad(data, ((0, npad - n), (0, 0)))
        _, out = jax.lax.scan(
            lambda _, b: (None, blk_top(b)), None,
            dpad.reshape(nblk, nb, data.shape[1]),
        )
    return out.reshape(npad, t)[:n]


@functools.partial(jax.jit, static_argnames=("k", "iters", "block_rows"))
def kmeans_fit_large(
    data: jax.Array,
    k: int,
    seed: int | jax.Array = 0,
    iters: int = 15,
    block_rows: int = 0,
    row_ids=None,
):
    """Large-K k-means for IVF coarse quantization → (centroids f32[k, d],
    labels i32[N]).

    Differs from :func:`kmeans_fit` where that one mirrors the reference's
    PQ fit (utils/kmeans.go, K ≤ 256, uint8 labels): sampled init instead
    of the sequential furthest-point loop (k iterations of which are too
    slow at k ≈ thousands), segment-sum centroid update instead of a
    one-hot matmul (the [N, K] one-hot would materialise gigabytes), and a
    fixed iteration count under ``lax.scan`` so the whole fit is a single
    dispatch.

    The assignment is blocked over rows so the [NB, K] distance matrix
    stays ≤ 512 MB: at 1M x 32768 clusters an unblocked matrix would be
    137 GB — far past HBM — and XLA will not tile a single matmul across
    memory on its own.

    With ``row_ids``, `data` is the full backing matrix and fit rows are
    gathered per block inside the scan — materialising the [N, D] gather
    up front would double peak HBM (6.2 GB extra at 1M x 1536d).
    """
    if row_ids is not None:
        return _kmeans_fit_gather(data, row_ids, k, seed, iters, block_rows)
    n, d = data.shape
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.int32))
    idx = jax.random.choice(key, n, (k,), replace=False)
    cents = data[idx]

    def assign_block(c, blk, sq_blk):
        sq_c = jnp.sum(c * c, axis=-1)[None, :]
        return jnp.argmin(sq_blk - 2.0 * (blk @ c.T) + sq_c, axis=-1)

    if not block_rows and n * k <= 2**28:  # dist matrix ≤ 1 GB: one block
        sq_data = jnp.sum(data * data, axis=-1, keepdims=True)
        ones = jnp.ones((n,), jnp.float32)

        def step(c, _):
            lab = assign_block(c, data, sq_data)
            sums = jax.ops.segment_sum(data, lab, num_segments=k)
            cnt = jax.ops.segment_sum(ones, lab, num_segments=k)
            c = jnp.where(
                (cnt > 0)[:, None], sums / jnp.maximum(cnt, 1.0)[:, None], c
            )
            return c, None

        cents, _ = jax.lax.scan(step, cents, None, length=iters)
        return cents, assign_block(cents, data, sq_data).astype(jnp.int32)

    nb = block_rows or max(2**27 // k, 512)  # rows per block (powers of two)
    nblk = -(-n // nb)
    npad = nblk * nb
    dpad = data if npad == n else jnp.pad(data, ((0, npad - n), (0, 0)))
    blocks = dpad.reshape(nblk, nb, d)
    # Padded rows carry weight 0 so they never pull a centroid.
    w = (jnp.arange(npad) < n).astype(jnp.float32).reshape(nblk, nb)
    sq_blocks = jnp.sum(blocks * blocks, axis=-1, keepdims=True)

    def step(c, _):
        def scan_blk(carry, xw):
            sums, cnt = carry
            blk, sq_blk, wf = xw
            lab = assign_block(c, blk, sq_blk)
            sums = sums + jax.ops.segment_sum(
                blk * wf[:, None], lab, num_segments=k
            )
            cnt = cnt + jax.ops.segment_sum(wf, lab, num_segments=k)
            return (sums, cnt), None

        (sums, cnt), _ = jax.lax.scan(
            scan_blk,
            (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
            (blocks, sq_blocks, w),
        )
        c = jnp.where((cnt > 0)[:, None], sums / jnp.maximum(cnt, 1.0)[:, None], c)
        return c, None

    cents, _ = jax.lax.scan(step, cents, None, length=iters)

    def lab_blk(_, xw):
        blk, sq_blk = xw
        return None, assign_block(cents, blk, sq_blk)

    _, labs = jax.lax.scan(lab_blk, None, (blocks, sq_blocks))
    return cents, labs.reshape(npad)[:n].astype(jnp.int32)


def _kmeans_fit_gather(data, row_ids, k, seed, iters, block_rows):
    """kmeans_fit_large over rows gathered per block from the full
    matrix `data` (see the row_ids doc above). Always blocked."""
    n = row_ids.shape[0]
    d = data.shape[1]
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.int32))
    idx = jax.random.choice(key, n, (k,), replace=False)
    cents = data[row_ids[idx]]

    def assign_block(c, blk, sq_blk):
        sq_c = jnp.sum(c * c, axis=-1)[None, :]
        return jnp.argmin(sq_blk - 2.0 * (blk @ c.T) + sq_c, axis=-1)

    nb = block_rows or max(2**27 // k, 512)
    nblk = -(-n // nb)
    npad = nblk * nb
    rpad = row_ids if npad == n else jnp.pad(row_ids, (0, npad - n))
    rblocks = rpad.reshape(nblk, nb)
    w = (jnp.arange(npad) < n).astype(jnp.float32).reshape(nblk, nb)

    def step(c, _):
        def scan_blk(carry, xw):
            sums, cnt = carry
            rblk, wf = xw
            blk = data[rblk]
            sq_blk = jnp.sum(blk * blk, axis=-1, keepdims=True)
            lab = assign_block(c, blk, sq_blk)
            sums = sums + jax.ops.segment_sum(
                blk * wf[:, None], lab, num_segments=k
            )
            cnt = cnt + jax.ops.segment_sum(wf, lab, num_segments=k)
            return (sums, cnt), None

        (sums, cnt), _ = jax.lax.scan(
            scan_blk,
            (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
            (rblocks, w),
        )
        c = jnp.where((cnt > 0)[:, None], sums / jnp.maximum(cnt, 1.0)[:, None], c)
        return c, None

    cents, _ = jax.lax.scan(step, cents, None, length=iters)

    def lab_blk(_, rblk):
        blk = data[rblk]
        sq_blk = jnp.sum(blk * blk, axis=-1, keepdims=True)
        return None, assign_block(cents, blk, sq_blk)

    _, labs = jax.lax.scan(lab_blk, None, rblocks)
    return cents, labs.reshape(npad)[:n].astype(jnp.int32)


# ---------------------------------------------------------------------------
# Two-level (hierarchical) coarse quantization — cluster counts past the
# flat fit's practical ceiling (~65536, where the flat fit's [N, K]
# assignment blocks stop fitting).
# Fit `supers` super-centroids, then `k/supers` children per super on its
# own members. Scoring stays DENSE throughout: members are grouped by super
# on host and each group is a plain [m, kc] matmul — per-row gathers of
# child blocks lose to dense matmuls (the same reasoning that shaped the
# slab layout). The returned centroid array is FLAT: children of super s occupy
# rows [s*kc, (s+1)*kc), so the whole query/insert path downstream is
# unchanged except for chunked probe selection.
# ---------------------------------------------------------------------------


def _group_rows(labels: "np.ndarray", n_groups: int, maxm: int):
    """Host-side grouping: row positions per label, padded/subsampled to
    ``maxm`` columns. Returns (rows i32[G, maxm], w f32[G, maxm],
    cnt i32[G]). Groups larger than maxm are strided-subsampled; empty
    groups point at row 0 with weight 0."""
    import numpy as np

    order = np.argsort(labels, kind="stable")
    ls = labels[order]
    starts = np.searchsorted(ls, np.arange(n_groups))
    ends = np.searchsorted(ls, np.arange(n_groups) + 1)
    cnt = (ends - starts).astype(np.int32)
    rows = np.zeros((n_groups, maxm), np.int32)
    w = np.zeros((n_groups, maxm), np.float32)
    if cnt.max(initial=0) <= maxm:
        # Fast path (no subsampling): one vectorized scatter by
        # within-group rank — the per-group Python loop costs seconds per
        # call at 10M rows on a 1-vCPU host.
        rank = np.arange(len(ls), dtype=np.int64) - starts[ls]
        rows[ls, rank] = order
        w[ls, rank] = 1.0
        return rows, w, cnt
    for g in range(n_groups):
        mem = order[starts[g] : ends[g]]
        m = len(mem)
        if m == 0:
            continue
        if m > maxm:
            mem = mem[np.linspace(0, m - 1, maxm).astype(np.int64)]
            m = maxm
        rows[g, :m] = mem
        w[g, :m] = 1.0
    return rows, w, cnt


@functools.partial(jax.jit, static_argnames=("kc", "iters"))
def _kmeans_grouped(
    data: jax.Array,      # f32[cap, D] full backing matrix
    rows: jax.Array,      # i32[G, maxm] member row ids (padded)
    w: jax.Array,         # f32[G, maxm] member weights (0 = padding)
    cnt: jax.Array,       # i32[G]
    kc: int,
    iters: int,
):
    """Weighted Lloyd's vmapped over member groups → cents f32[G, kc, D].
    Init is a stride over each group's true members (deterministic);
    empty clusters keep their previous centroid."""
    G, maxm = rows.shape
    mem = data[rows]  # [G, maxm, D]

    # Strided init within the live member range
    pick = (
        jnp.arange(kc)[None, :] * jnp.maximum(cnt, 1)[:, None] // kc
    ).astype(jnp.int32)  # [G, kc]
    cents = jnp.take_along_axis(mem, pick[:, :, None], axis=1)  # [G, kc, D]

    sq_m = jnp.sum(mem * mem, axis=-1)  # [G, maxm]

    def step(c, _):
        sq_c = jnp.sum(c * c, axis=-1)  # [G, kc]
        cross = jnp.einsum(
            "gmd,gkd->gmk", mem, c, preferred_element_type=jnp.float32
        )
        lab = jnp.argmin(
            sq_m[:, :, None] - 2.0 * cross + sq_c[:, None, :], axis=-1
        )  # [G, maxm]
        sums = jax.vmap(
            lambda r, l, wf: jax.ops.segment_sum(r * wf[:, None], l, num_segments=kc)
        )(mem, lab, w)
        cnts = jax.vmap(
            lambda l, wf: jax.ops.segment_sum(wf, l, num_segments=kc)
        )(lab, w)
        c = jnp.where(
            (cnts > 0)[:, :, None], sums / jnp.maximum(cnts, 1.0)[:, :, None], c
        )
        return c, None

    cents, _ = jax.lax.scan(step, cents, None, length=iters)
    return cents


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=("t",))
def _merge_top(cand_d, cand_i, d_col, i_col, t: int):
    """Keep the best ``t`` of the running candidates ∪ one new column."""
    dd = jnp.concatenate([cand_d, d_col], axis=1)
    ii = jnp.concatenate([cand_i, i_col], axis=1)
    nv, oi = jax.lax.top_k(-dd, t)
    return -nv, jnp.take_along_axis(ii, oi, axis=1)


@functools.partial(
    jax.jit, static_argnames=("n_groups", "maxm", "gchunk", "t_in")
)
def _assign_col(
    data: jax.Array,   # f32[cap, D]
    lab: jax.Array,    # i32[n] — this column's super per row
    child: jax.Array,  # f32[n_groups, kc, D]
    rid,               # i32[n] row ids into `data`, or None (position == id)
    n_groups: int,
    maxm: int,
    gchunk: int,
    t_in: int,
):
    """Top-``t_in`` children within each row's ``lab`` super → (dists
    f32[n, t_in], flat cluster ids i32[n, t_in]). One dispatch per column.

    Scatter-free by design: XLA scatter cost can scale with the
    DESTINATION table, not the update count (64 scatters into a [10M, 4]
    table per column would make the two-level assignment slower than a
    host path). Instead:
    sort rows by super, score the grouped [G, maxm] layout under one
    `lax.scan`, then GATHER each row's result back through its
    (super, within-super-rank) coordinate — rank comes from the inverse
    permutation, itself just a second argsort (~0.3 s at 10M). Group
    padding slots are never read back, so no liveness masking is needed.
    """
    n = lab.shape[0]
    kc = child.shape[1]
    order = jnp.argsort(lab, stable=True).astype(jnp.int32)
    ls = lab[order]
    starts = jnp.searchsorted(ls, jnp.arange(n_groups, dtype=ls.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[ls].astype(jnp.int32)
    # rows[g, m] = position (into n) of group g's m-th member; padding
    # slots keep 0 — they cost wasted compute, never wrong results.
    rows = jnp.zeros((n_groups, maxm), jnp.int32)
    rows = rows.at[ls, rank].set(order, mode="drop")

    nchunk = n_groups // gchunk
    rows_c = rows.reshape(nchunk, gchunk, maxm)
    child_c = child.reshape(nchunk, gchunk, kc, child.shape[-1])

    def body(_, xs):
        rows_b, child_b = xs
        r = rows_b if rid is None else rid[rows_b]
        mem = data[r]  # [gchunk, maxm, D]
        sq_c = jnp.sum(child_b * child_b, axis=-1)
        cross = jnp.einsum(
            "gmd,gkd->gmk", mem, child_b, preferred_element_type=jnp.float32
        )
        dd = (
            jnp.sum(mem * mem, axis=-1)[:, :, None]
            - 2.0 * cross
            + sq_c[:, None, :]
        )
        nv, idx = jax.lax.top_k(-dd, t_in)
        return None, (-nv, idx.astype(jnp.int32))

    _, (dd_g, ci_g) = jax.lax.scan(body, None, (rows_c, child_c))
    dd_g = dd_g.reshape(n_groups, maxm, t_in)
    ci_g = ci_g.reshape(n_groups, maxm, t_in)

    # Inverse permutation → each row's rank within its own group.
    perm_inv = jnp.argsort(order, stable=True).astype(jnp.int32)
    m = perm_inv - starts[lab].astype(jnp.int32)
    d_col = dd_g[lab, m]                          # [n, t_in]
    i_col = lab[:, None] * kc + ci_g[lab, m]      # flat cluster ids
    return d_col, i_col.astype(jnp.int32)


def kmeans_fit_two_level(
    data: jax.Array,
    k: int,
    seed: int = 0,
    iters: int = 15,
    row_ids=None,
    supers: int = 512,
    fit_maxm: int = 32768,
    refine_iters: int = 2,
    final_n_sup: int = 8,
):
    """Hierarchical fit → (centroids f32[k, d] FLAT, labels i32[N],
    sup_cents f32[supers, d]).

    ``k`` must be a multiple of ``supers``. ``labels`` are flat cluster
    ids (super*kc + child).

    The pure own-super hierarchy mis-places boundary points: measured at
    64k×64d / C=1024, 12% of own-super labels are NOT the point's globally
    nearest centroid (flat fit: 0%) and quantization error is 40% higher —
    which cost the 10M IVF row 0.16 recall (0.956 → 0.796, round-3
    regression). Two corrections close most of that gap at
    O(N·(supers + n_sup·kc)) cost, far below the O(N·k) flat assignment
    that crashes the worker past ~65536 clusters:

    - ``refine_iters`` global Lloyd rounds: reassign every point over the
      children of its 4 nearest supers, then scatter-mean-update all
      children (measured qerr 29.4 → 26.4 vs flat 20.8).
    - final labels from the ``final_n_sup`` nearest supers (rank-0
      agreement with the global argmin 0.878 → 0.99; within-top-8 → 1.0).
    """
    import numpy as np

    assert k % supers == 0, (k, supers)
    kc = k // supers
    n = row_ids.shape[0] if row_ids is not None else data.shape[0]
    d = data.shape[1]

    # 1. super fit on a ≤2^18-row subsample (supers ≤ 512: tiny problem)
    with log.timed("2lv super fit", n=n, supers=supers):
        stride = max(n // 2**18, 1)
        if row_ids is not None:
            sub_ids = row_ids[::stride]
            sup_cents, _ = kmeans_fit_large(
                data, supers, seed, iters, row_ids=sub_ids
            )
        else:
            sub = data[::stride]
            sup_cents, _ = kmeans_fit_large(sub, supers, seed, iters)

    # 2. assign every row to its nearest super (blocked dense matmul)
    with log.timed("2lv super assign"):
        lab_sup = np.asarray(
            kmeans_assign(data, sup_cents, 1, row_ids=row_ids)
        )[:, 0]

    # 3. children per super, grouped weighted Lloyd in G-chunks sized so
    #    the larger of the [G, maxm, D] member gather and the
    #    [G, maxm, kc] distance/cross tensors stays ~256 MB
    with log.timed("2lv child fit", kc=kc):
        gchunk = max(2**26 // max(fit_maxm * max(d, kc), 1), 1)
        rows_np, w_np, cnt_np = _group_rows(lab_sup, supers, fit_maxm)
        if row_ids is not None:
            rid = np.asarray(row_ids)
            rows_np = rid[rows_np]
        child_parts = []
        for g0 in range(0, supers, gchunk):
            child_parts.append(
                _kmeans_grouped(
                    data,
                    jnp.asarray(rows_np[g0 : g0 + gchunk]),
                    jnp.asarray(w_np[g0 : g0 + gchunk]),
                    jnp.asarray(cnt_np[g0 : g0 + gchunk]),
                    kc,
                    iters,
                )
            )
        child = jnp.concatenate(child_parts, axis=0)  # [supers, kc, D]
        child_flat = child.reshape(k, d)

    # 4. global refinement: reassign over the 4 nearest supers' children,
    #    scatter-mean-update all children (blocked: the segment-sum walks
    #    the backing matrix 2^20 rows at a time, no [N, D] copy)
    for it in range(refine_iters):
        with log.timed("2lv refine iter", i=it):
            # Labels stay on device end to end (an [n] readback + per-block
            # re-upload costs 80 MB of host↔device traffic at 10M rows).
            lab_r = kmeans_assign_two_level(
                data, sup_cents, child_flat, 1, row_ids=row_ids, n_sup=4
            )[:, 0]
            ssum = jnp.zeros((k, d), jnp.float32)
            cnt = jnp.zeros((k,), jnp.float32)
            BLK = 1 << 20
            for i in range(0, n, BLK):
                lab_b = lab_r[i : i + BLK]
                rows_b = (
                    data[row_ids[i : i + BLK]] if row_ids is not None
                    else data[i : i + BLK]
                )
                ssum = ssum.at[lab_b].add(rows_b.astype(jnp.float32))
                cnt = cnt.at[lab_b].add(1.0)
            child_flat = jnp.where(
                (cnt > 0)[:, None],
                ssum / jnp.maximum(cnt, 1.0)[:, None],
                child_flat,
            )

    # 5. final flat labels over the final_n_sup nearest supers
    with log.timed("2lv final labels", n_sup=final_n_sup):
        labels = np.asarray(
            kmeans_assign_two_level(
                data, sup_cents, child_flat, 1, row_ids=row_ids,
                n_sup=final_n_sup,
            )
        )[:, 0]
    return child_flat, jnp.asarray(labels.astype(np.int32)), sup_cents


def kmeans_assign_two_level(
    data: jax.Array,
    sup_cents: jax.Array,   # f32[Cs, D]
    child_flat: jax.Array,  # f32[Cs*kc, D]
    t: int,
    row_ids=None,
    n_sup: int = 2,
):
    """Top-t flat cluster ids per row, considering the children of each
    row's ``n_sup`` nearest supers (grouped dense scoring per super) —
    the two-level replacement for :func:`kmeans_assign` at cluster counts
    where the flat [N, C] scoring no longer fits. Returns i32[N, t]."""
    import numpy as np

    n = row_ids.shape[0] if row_ids is not None else data.shape[0]
    Cs = sup_cents.shape[0]
    d = data.shape[1]
    kc = child_flat.shape[0] // Cs
    child = child_flat.reshape(Cs, kc, d)
    t_in = min(t, kc)
    n_sup = min(n_sup, Cs)

    with log.timed("2lv assign sup_t", n=n, n_sup=n_sup):
        # sup_t stays ON DEVICE: the [n, n_sup] readback is 160 MB at 10M
        # rows, and the groupings below only
        # need per-column bincount maxima (one tiny readback).
        sup_t = kmeans_assign(data, sup_cents, n_sup, row_ids=row_ids)
        if n <= 2048:
            # Small (incremental-write) batches: use the worst case —
            # every row in one super — instead of reading the bincount
            # back. The padded [G, maxm] work is cheap at this n, and
            # skipping the readback keeps the whole write txn a pure
            # async dispatch chain (the readback drains the device queue).
            maxms = np.full(n_sup, n, np.int32)
        else:
            maxms = np.asarray(
                jnp.max(
                    jax.vmap(
                        lambda c: jnp.zeros(Cs, jnp.int32).at[c].add(1)
                    )(sup_t.T),
                    axis=1,
                )
            )

    # Merge columns INCREMENTALLY (donated running buffers): collecting
    # all n_sup [n, t_in] column results before one final top-k holds
    # n_sup·t_in·8 bytes/row — 5 GB at 10M×(4 cols × t=8), next to the
    # resident vector matrix.
    cand_d = cand_i = None
    for col in range(n_sup):
        # Round maxm up to a power of two: every distinct [G, maxm]
        # shape recompiles the column kernel, and max-bincount varies
        # run to run.
        maxm = max(1 << (int(maxms[col]) - 1).bit_length(), 512)
        gchunk = max(2**26 // max(maxm * max(d, kc), 1), 1)
        gchunk = min(1 << (gchunk.bit_length() - 1), Cs)  # pow2, divides Cs
        with log.timed("2lv assign col", col=col, maxm=maxm):
            d_col, i_col = _assign_col(
                data, sup_t[:, col], child, row_ids, Cs, maxm, gchunk, t_in
            )
            if cand_d is None:
                cand_d, cand_i = d_col, i_col
            else:
                cand_d, cand_i = _merge_top(
                    cand_d, cand_i, d_col, i_col,
                    min(t, cand_d.shape[1] + t_in),
                )
    if cand_d.shape[1] > t:
        with log.timed("2lv assign final top"):
            _, oi = jax.lax.top_k(-cand_d, t)
            return jnp.take_along_axis(cand_i, oi, axis=1)
    return cand_i
