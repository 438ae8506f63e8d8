"""IVF (inverted-file / clustered) vector index — the accelerator-native engine.

No reference counterpart: SemaDB ships flat + Vamana only. This index
exists because an accelerator prefers dense contraction over pointer
chasing: a graph walk gathers scattered 512-byte rows, while IVF reads
whole cluster *slabs* — contiguous [S, tdim] blocks — and spends the rest
on dense matrix products.

Layout (traversal state is separate from the exact-rerank state):
  - ``vectors f32[cap, D]``   — per-node full-precision rows, the source
    of truth for CRUD/refits and the exact rerank
  - ``centroids f32[C, D]``   — k-means coarse quantizer
    (vectorstore.kmeans.kmeans_fit_large, row-blocked assignment)
  - ``slabs [C, S, tdim]``    — cluster members, zero-padded to S slots;
    f32 or bf16 (auto past SLAB_BF16_BYTES), stored PROJECTED to the
    corpus' top-``PROJ_DIM`` principal subspace when D > PROJ_DIM (ADC
    table lookups are random-access-bound)
  - ``slab_sq f32[C, S]``     — per-slot norms (computed from f32 rows)
  - ``slab_ids i32[C, S]``    — node id per slot (-1 = empty)
  - overflow pool + ids       — points whose home AND relocation clusters
    were all full, plus not-yet-clustered inserts; scanned densely (and
    chunked past OVF_CHUNK_BYTES) so correctness never depends on the
    clustering being fresh. Spill RELOCATION (next-nearest cluster with
    room, up to RELOC_T candidates) keeps this pool near-empty — it is a
    dense every-query matmul.

Placement: each point lands in its nearest cluster with room; with
``assignCopies`` > 1, SOAR-style secondary copies go to the next-nearest
clusters best-effort (boundary points are the dominant probe-miss mode;
copies=2 lifted 1M recall 0.982 -> 1.000). The query pool dedups copies.

Query = one [B, C] centroid matmul in traversal space -> top-p probe ids
(approx_max_k past APPROX_PROBE_MIN_C clusters) -> probe-chunked slab
gather + matmul scoring -> overflow scan -> coarse pool -> EXACT f32
rerank from ``vectors`` -> top-k. Coarse scoring runs at the default
matmul precision (TF32 on an H100); the rerank restores exact ordering.

With a product quantizer at D <= PROJ_DIM (IVF-PQ; reference quantizer:
product.go:136-305), slabs hold u8 PQ codes and scoring is ADC table
lookups followed by the same exact rerank. Above PROJ_DIM the projected
path replaces ADC regardless of quantizer config.

Writes: ``insert_update_delete`` and ``insert_bulk`` share the
vectorised greedy placement (``_place_fitted``: one multi-cluster
assignment, per-column capacity packing, one device scatter per array);
bulk loads adopt whole arrays — device-resident corpora never
round-trip through the host — with an optionally deferred first refit.
The index refits (k-means + repack, gather-built slabs, all device-side
except one [N] label readback) when the live count doubles or the
overflow pool outgrows its share. Deletes blank every copy's slot in
place.

Scale: cluster counts past TWO_LEVEL_MIN_C use a two-level coarse
quantizer — ~512 supers fit first, then k/supers children per super
with grouped dense scoring (vectorstore.kmeans.kmeans_fit_two_level).
The centroid array stays FLAT (children of super s contiguous), so only
probe selection changes: the [B, C] matrix chunks over C with a
per-chunk approx top-p carry.
"""

from __future__ import annotations

import functools
import threading
from typing import Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from semadb_tpu.models import constants as C
from semadb_tpu.models.schema import VectorIVFParams
from semadb_tpu.ops.distance import pairwise_distance
from semadb_tpu.utils.grow import next_capacity
from semadb_tpu.utils.logging import get_logger
from semadb_tpu.vectorstore.kmeans import kmeans_fit_large

log = get_logger("ivf")

import os  # noqa: E402  (env-tunable engine knobs below)

NIL = -1
# Slab slots per cluster: ~2.5x the target mean cluster size, so only the
# size distribution's tail (measured ~4% of points at C = N/24) spills to
# the overflow pool.
TARGET_CLUSTER_SIZE = 24
DEFAULT_SLAB = 64
MIN_FIT = 512
KMEANS_ITERS = 15
# Coarse-pool depth feeding the exact f32 rerank. The coarse scores run at
# the default matmul precision: on tight-margin data the true neighbour can
# fall below a shallow pool even when its cluster WAS probed.
RERANK_POOL = int(os.environ.get("SEMADB_IVF_RERANK", 64))
# ADC ordering is coarser than f32 scoring, so IVF-PQ reranks a deeper
# pool; the extra [B, pool, D] f32 gather is small next to the slab scan.
RERANK_POOL_PQ = 256
# High-dim traversal: past this width, slabs/centroids are stored in an
# r-dim random-orthonormal projection and scored by matmul; the exact
# f32 rerank restores full-precision ordering. ADC scoring (u8 codes +
# per-query table lookups) is gather-bound — 1.2e9 table lookups per
# 4096-query batch at 1M x 1536d. ADC remains the scoring path only when
# D ≤ PROJ_DIM (where the lookup count is small).
PROJ_DIM = int(os.environ.get("SEMADB_IVF_PROJ_DIM", 128))
# Traversal slabs switch to bf16 past this many f32 bytes (norms stay f32
# and the rerank is exact f32, so only the coarse cross term carries
# rounding). Force with =0. A fixed bound; ROADMAP S4 derives the memory
# budgets from the device.
SLAB_BF16_BYTES = int(os.environ.get("SEMADB_IVF_SLAB_BF16_BYTES", 2**32))
# approx_max_k for probe selection (exact top_k over [B, C] dominates at
# C >= 2^17); recall effect is a few borderline probes swapped
APPROX_PROBE_MIN_C = int(os.environ.get("SEMADB_IVF_APPROX_PROBE_MIN_C", 2**17))
# Full [B, O] overflow distance matrix cap before the scan chunks it
OVF_CHUNK_BYTES = 2**26
# Full [B, C] probe-selection matrix cap before chunking over C (needed
# at two-level cluster counts: [4096, 262144] would be 4.3 GB)
PROBE_CHUNK_BYTES = int(os.environ.get("SEMADB_IVF_PROBE_CHUNK_BYTES", 2**30))
PROBE_CHUNK_C = int(os.environ.get("SEMADB_IVF_PROBE_CHUNK_C", 16384))
# Cluster counts past this use the two-level (hierarchical) coarse
# quantizer: the flat kmeans fit's [N, C] assignment blocks grow past
# ~65536 clusters, and two-level fit/assign keeps all
# scoring dense per super. Flat centroid layout is preserved (children of
# super s at rows [s*kc, (s+1)*kc)) so the query path is unchanged apart
# from chunked probe selection.
TWO_LEVEL_MIN_C = int(os.environ.get("SEMADB_IVF_TWO_LEVEL_MIN_C", 65537))
TWO_LEVEL_SUPERS = int(os.environ.get("SEMADB_IVF_TWO_LEVEL_SUPERS", 512))
# Largest filter-member count served by the EXACT member-gather scan
# (recall 1.0 by construction); larger filters fall back to widened
# probing. The chunked scan is one dense [B, chunk] matmul per 64k-row
# block (probing pays a strided slab gather per probe chunk; the member
# scan gathers each block once). Cost is linear in members, so the cap is
# an absolute count.
FILTER_EXACT_CAP = int(os.environ.get("SEMADB_IVF_FILTER_EXACT_CAP", 262144))
# Probe multiplier for filters past the exact cap (the mask discards
# ~(1-sel) of scanned candidates, so the effective pool shrinks by the
# selectivity; widen to compensate). 4 trades recall for QPS; raise
# toward 1/sel for recall-first serving.
FILTER_WIDEN = int(os.environ.get("SEMADB_IVF_FILTER_WIDEN", 4))


@functools.partial(jax.jit, donate_argnums=(0,))
def _set_rows(dst, rows, vals):
    """``dst.at[rows].set(vals)`` with the DESTINATION donated: XLA
    aliases the output onto the input buffer, so updating the 5.4 GB
    ``vectors`` matrix (or the multi-GB slab tables) costs one in-place
    scatter instead of a full second copy — the eager ``.at`` op doubled
    peak HBM and OOMed 10M write txns at slab depth 192."""
    return dst.at[rows].set(vals)


@functools.partial(jax.jit, donate_argnums=(0,))
def _set_cells(dst, cs, ss, vals):
    """Donated 2-D coordinate scatter (see :func:`_set_rows`)."""
    return dst.at[cs, ss].set(vals)


def _member_scan_chunked_host(vectors, members, q, k, metric, chunk_cap):
    """Host wrapper for the chunked exact member scan: pads the member
    list to (pow2 chunk count) × chunk_cap so recompiles stay bounded,
    then runs one jitted ``lax.scan`` dispatch."""
    nc = -(-len(members) // chunk_cap)
    ncp = 1
    while ncp < nc:
        ncp *= 2
    P = ncp * chunk_cap
    padded = np.full(P, members[0], np.int32)
    padded[: len(members)] = members
    valid = np.zeros(P, bool)
    valid[: len(members)] = True
    return _member_scan_chunked(
        vectors,
        jnp.asarray(padded.reshape(ncp, chunk_cap)),
        jnp.asarray(valid.reshape(ncp, chunk_cap)),
        q, k, metric,
    )


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _member_scan_chunked(vectors, ids_c, valid_c, q, k, metric):
    """Exact top-k over member rows scanned in [nc, CB] chunks: gather a
    chunk's rows, score by matmul, merge its top-k into the running
    [B, k] pool. Exact because the global top-k is a fixed point of the
    per-chunk merge (invalid slots score +inf and are masked to NIL)."""
    B = q.shape[0]
    init = (
        jnp.full((B, k), jnp.inf, jnp.float32),
        jnp.full((B, k), NIL, jnp.int32),
    )

    def step(carry, inp):
        ids, vd = inp  # [CB], bool[CB]
        mv = jnp.take(vectors, ids, axis=0)  # [CB, D]
        d = pairwise_distance(q, mv, metric)  # [B, CB]
        d = jnp.where(vd[None, :], d, jnp.inf)
        kk = min(k, ids.shape[0])
        nv, pos = jax.lax.top_k(-d, kk)
        cd, ci = carry
        alld = jnp.concatenate([cd, -nv], axis=1)
        alli = jnp.concatenate([ci, jnp.take(ids, pos)], axis=1)
        nv2, p2 = jax.lax.top_k(-alld, k)
        return (-nv2, jnp.take_along_axis(alli, p2, axis=1)), None

    (out_d, out_i), _ = jax.lax.scan(step, init, (ids_c, valid_c))
    out_i = jnp.where(jnp.isfinite(out_d), out_i, NIL)
    return out_d, out_i


@jax.jit
def _gather_project(vectors, rows, proj):
    """``vectors[rows] @ proj`` with the gather blocked per 64k rows —
    the full-D gather would transiently materialise 12+ GB for 2M rows
    at 1536d."""
    m = rows.shape[0]
    nb = 65536
    if m <= nb:
        return vectors[rows] @ proj
    nblk = -(-m // nb)
    mpad = nblk * nb
    rpad = rows if mpad == m else jnp.pad(rows, (0, mpad - m))
    _, out = jax.lax.scan(
        lambda _, r: (None, vectors[r] @ proj), None, rpad.reshape(nblk, nb)
    )
    return out.reshape(mpad, -1)[:m]


@functools.partial(jax.jit, static_argnames=("out_dtype", "want_sq"))
def _slabs_from_ids(vectors, sid, proj, out_dtype=jnp.float32, want_sq=True):
    """Build [Cn, S, tdim] slabs (+ f32 |x|^2 per slot) by GATHERING rows
    for the id layout ``sid`` (NIL slots -> zero rows). A zeros+scatter
    construction holds zeros + result + the gathered rows simultaneously
    (~24 GB at 10M x 128d); the gather form peaks at vectors + output.
    Blocked over cluster rows so each step's full-D gather stays ~128 MB.
    ``out_dtype=bfloat16`` halves the resident slab bytes (norms are
    computed from the f32 rows before the cast, so only the cross term
    carries bf16 rounding — absorbed by the exact rerank)."""
    Cn, S = sid.shape
    cap, D = vectors.shape
    cb = max(2**25 // max(S * D * 4, 1), 8)
    # Prefer a power-of-two block that DIVIDES Cn: when cpad != Cn the
    # [:Cn] slice of the scan-stacked output materialises a second full
    # slab copy (6.4 GB at 10M/C=131072/S=192) next to the stacked
    # original.
    cb_pow2 = 1 << (cb.bit_length() - 1)
    if Cn % cb_pow2 == 0:
        cb = cb_pow2
    nblk = -(-Cn // cb)
    cpad = nblk * cb
    spad = sid if cpad == Cn else jnp.pad(sid, ((0, cpad - Cn), (0, 0)), constant_values=NIL)

    def blk(_, sb):  # sb: [cb, S]
        rows = vectors[jnp.clip(sb, 0, cap - 1)]
        if proj is not None:
            rows = jnp.einsum("csd,dr->csr", rows, proj)
        rows = jnp.where((sb != NIL)[..., None], rows, 0.0)
        sq = (
            jnp.sum(rows * rows, axis=-1)
            if want_sq
            else jnp.zeros(rows.shape[:-1], jnp.float32)
        )
        return None, (rows.astype(out_dtype), sq)

    _, (out, sqs) = jax.lax.scan(blk, None, spad.reshape(nblk, cb, S))
    return out.reshape(cpad, S, -1)[:Cn], sqs.reshape(cpad, S)[:Cn]


def _pack_greedy(rows, col_clusters, fill, S, Cn):
    """Greedy capacity-bounded packing of `rows` into `col_clusters`
    (per-row target cluster): returns (placed rows, clusters, slots,
    updated fill, leftover positions into `rows`). Vectorised: rank
    within each target cluster via stable sort + searchsorted."""
    order2 = np.argsort(col_clusters, kind="stable")
    c2s = col_clusters[order2]
    starts2 = np.searchsorted(c2s, np.arange(Cn))
    rank2 = np.arange(len(rows)) - starts2[c2s]
    slot2 = fill[c2s] + rank2
    ok = slot2 < S
    fill = fill + np.minimum(
        np.bincount(col_clusters, minlength=Cn), np.maximum(S - fill, 0)
    ).astype(np.int32)
    return rows[order2[ok]], c2s[ok], slot2[ok], fill, order2[~ok]


def _pad_dup(a: np.ndarray, lo: int = 64) -> np.ndarray:
    """Pad a host array to the next power-of-two length (min ``lo``) by
    repeating its LAST element.

    Shape bucketing for the incremental write path: every device op in a
    write txn (scatter sizes = however many points packed into slabs vs
    overflow that txn) otherwise compiles fresh XLA per distinct length —
    about 25 compiles per 1k-point txn at steady state, so write latency
    would be compile latency. Repeating the last element is idempotent for
    every use here: duplicate scatter indices write the same value, and
    duplicate assignment rows just re-score the same point."""
    n = len(a)
    m = lo
    while m < n:
        m *= 2
    if m == n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], m - n, axis=0)], axis=0)


def _auto_slab(copies: int, n: int, Cn: int, tdim: int, current: int) -> int:
    """Slab depth for a refit: grow past the configured default when SOAR
    copies would otherwise saturate the slot budget.

    At 10M × 128d / C=131072 / copies=2, the default S=128 offers 16.8M
    slots for 20M placements — a third of the copies get dropped and
    primaries relocate far from home, capping recall ~0.96 at p=24. Sizing
    S to copies·n/Cn with 25% heavy-tail headroom (rounded up to 64, the
    gather-friendly granule) keeps both placements resident. Bounded by a
    7 GiB bf16 slab budget (vectors f32 + slabs + 1 GB query transient
    must co-reside; a fixed figure that ROADMAP S4 derives from the device);
    never shrinks below the configured value."""
    if n <= 0:
        return current
    need = int(np.ceil(copies * n / Cn * 1.25 / 64.0)) * 64
    budget = int(os.environ.get("SEMADB_IVF_SLAB_BYTES", 7 * 2**30))
    cap = max((budget // (Cn * tdim * 2)) // 64 * 64, 64)
    return max(current, min(need, cap))


def _npow2(x: int, lo: int, hi: int) -> int:
    """Nearest power of two in [lo, hi] (geometric rounding): the cluster
    count drives the [B, C] probe-selection top_k, whose cost doubles per
    step, so round down unless x is past the geometric midpoint."""
    p = lo
    while p * 1.414 < x and p < hi:
        p *= 2
    return p


def _select_probes(qp, centroids, cent_sq, p: int) -> jax.Array:
    """Top-p probe cluster ids per query: one dense [B, C] matmul. Past
    PROBE_CHUNK_BYTES the matrix is chunked over C with a per-chunk approx
    top-p carry (the full [4096, 262144] matrix at two-level cluster
    counts would be 4.3 GB) — dense chunked matmuls, never per-query
    centroid gathers. Traced inline by the query kernels.
    """
    B = qp.shape[0]
    Cn_ = centroids.shape[0]
    if B * Cn_ * 4 > PROBE_CHUNK_BYTES:
        cb_ = min(PROBE_CHUNK_C, Cn_)
        cpad = -(-Cn_ // cb_) * cb_
        cents_p = (
            centroids if cpad == Cn_
            else jnp.pad(centroids, ((0, cpad - Cn_), (0, 0)))
        )
        # Padding rows carry a huge norm term so they are never probed
        # (works for all metrics — dot/cosine pass cent_sq = 0).
        csq_p = jnp.pad(
            cent_sq, (0, cpad - Cn_), constant_values=np.float32(1e30)
        ) if cpad != Cn_ else cent_sq

        def probe_chunk(off, x):
            c_blk, csq_blk = x
            dd = csq_blk[None, :] - 2.0 * (qp @ c_blk.T)
            nv_, pos_ = jax.lax.approx_max_k(-dd, min(p, cb_))
            return off + cb_, (-nv_, pos_.astype(jnp.int32) + off)

        nchunk_c = cpad // cb_
        _, (pd_c, pi_c) = jax.lax.scan(
            probe_chunk, jnp.int32(0),
            (
                cents_p.reshape(nchunk_c, cb_, -1),
                csq_p.reshape(nchunk_c, cb_),
            ),
        )
        pdist = jnp.moveaxis(pd_c, 0, 1).reshape(B, -1)
        pids = jnp.moveaxis(pi_c, 0, 1).reshape(B, -1)
        _, sel = jax.lax.top_k(-pdist, min(p, pdist.shape[1]))
        probe = jnp.take_along_axis(pids, sel, axis=-1)
        return jnp.clip(probe, 0, Cn_ - 1)
    cd = cent_sq[None, :] - 2.0 * (qp @ centroids.T)
    if Cn_ >= APPROX_PROBE_MIN_C:
        _, probe = jax.lax.approx_max_k(-cd, p)  # [B, p]
        return probe.astype(jnp.int32)
    _, probe = jax.lax.top_k(-cd, p)  # [B, p]
    return probe


@functools.partial(jax.jit, static_argnames=("p", "k", "pchunk", "metric", "dedup"))
def _ivf_query(
    centroids: jax.Array,   # f32[C, D]
    cent_sq: jax.Array,     # f32[C]
    slabs: jax.Array,       # f32[C, S, D]
    slab_sq: jax.Array,     # f32[C, S]
    slab_ids: jax.Array,    # i32[C, S]
    ovf_vecs: jax.Array,    # f32[O, D]
    ovf_sq: jax.Array,      # f32[O]
    ovf_ids: jax.Array,     # i32[O]
    queries: jax.Array,     # f32[B, D]
    vectors: jax.Array,     # f32[cap, D] per-node rerank vectors
    filter_mask: Optional[jax.Array],  # bool[cap] | None
    proj: Optional[jax.Array],  # f32[D, r] traversal projection | None
    p: int,
    k: int,
    pchunk: int = 4,
    metric: str = C.DISTANCE_EUCLIDEAN,
    dedup: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (dists f32[B,k], node ids i32[B,k]); empty slots (inf, -1).

    Distances are metric-consistent with the flat/vamana engines
    (squared euclidean / negated dot / 1-cosine), exact f32 after rerank.

    With ``proj``, centroids/slabs/overflow are stored in the projected
    r-space and the coarse scoring runs there (PROJ_DIM rationale above);
    the final rerank always uses the full-precision `vectors`/`queries`.
    """
    B = queries.shape[0]
    S = slabs.shape[1]
    cap = vectors.shape[0]
    qp = queries if proj is None else (queries @ proj)

    # 1. probe selection (shared helper; chunked over C past
    # PROBE_CHUNK_BYTES of [B, C])
    probe = _select_probes(qp, centroids, cent_sq, p)

    # 2. probe-chunked slab scoring (full [B,p,S,D] would be gigabytes)
    def score_chunk(_, pr):  # pr: [B, pchunk]
        cand_v = slabs[pr]  # [B, pchunk, S, r]
        cross = jnp.einsum(
            "bpsd,bd->bps", cand_v, qp, preferred_element_type=jnp.float32
        )
        cid = slab_ids[pr]
        dd = jnp.where(cid != NIL, slab_sq[pr] - 2.0 * cross, jnp.inf)
        return None, (dd, cid)

    nchunk = p // pchunk
    prs = probe[:, : nchunk * pchunk].reshape(B, nchunk, pchunk).transpose(1, 0, 2)
    _, (dists_c, ids_c) = jax.lax.scan(score_chunk, None, prs)
    dist = dists_c.transpose(1, 0, 2, 3).reshape(B, nchunk * pchunk * S)
    ids = ids_c.transpose(1, 0, 2, 3).reshape(B, nchunk * pchunk * S)

    # 3. overflow scan (dense matmul — exact regardless of clustering age).
    # Past ~64 MB of [B, O] the full distance matrix cannot materialise
    # (a pathological 2.9M-row pool at B=4096 would be 48 GB): chunk the
    # pool and carry only each chunk's top slice into the candidate set.
    O = ovf_vecs.shape[0]
    if B * O * 4 > OVF_CHUNK_BYTES:
        ob = 65536
        opad = -(-O // ob) * ob
        ov = ovf_vecs if opad == O else jnp.pad(ovf_vecs, ((0, opad - O), (0, 0)))
        osq = ovf_sq if opad == O else jnp.pad(ovf_sq, (0, opad - O))
        oid = (
            ovf_ids if opad == O
            else jnp.pad(ovf_ids, (0, opad - O), constant_values=NIL)
        )
        # Per-chunk carry must never be shallower than the final rerank
        # pool `rr` (below, incl. the 2*k floor) — a shallower slice
        # could truncate true neighbours living in a huge pool before
        # the exact rerank ever sees them.
        keep = min(
            max(RERANK_POOL_PQ if proj is not None else RERANK_POOL, 2 * k),
            ob,
        )

        def ovf_chunk(_, x):
            v, sq_, i_ = x
            dd = sq_[None, :] - 2.0 * (qp @ v.T)
            dd = jnp.where(i_[None, :] != NIL, dd, jnp.inf)
            # approx: 3x cheaper than exact top_k per chunk; the pool's
            # exact rerank absorbs a few swapped borderline entries
            nv_, pos_ = jax.lax.approx_max_k(-dd, keep)
            return None, (-nv_, i_[pos_.astype(jnp.int32)])

        _, (od_c, oi_c) = jax.lax.scan(
            ovf_chunk, None,
            (
                ov.reshape(-1, ob, ov.shape[1]),
                osq.reshape(-1, ob),
                oid.reshape(-1, ob),
            ),
        )
        od = jnp.moveaxis(od_c, 0, 1).reshape(B, -1)
        oi = jnp.moveaxis(oi_c, 0, 1).reshape(B, -1)
        dist = jnp.concatenate([dist, od], axis=-1)
        ids = jnp.concatenate([ids, oi], axis=-1)
    else:
        od = ovf_sq[None, :] - 2.0 * (qp @ ovf_vecs.T)
        od = jnp.where(ovf_ids[None, :] != NIL, od, jnp.inf)
        dist = jnp.concatenate([dist, od], axis=-1)
        ids = jnp.concatenate(
            [ids, jnp.broadcast_to(ovf_ids[None, :], od.shape)], axis=-1
        )

    if filter_mask is not None:
        ok = jnp.take(filter_mask, jnp.clip(ids, 0, cap - 1)) & (ids != NIL)
        dist = jnp.where(ok, dist, jnp.inf)
        ids = jnp.where(ok, ids, NIL)

    # 4. coarse pool under fast scores, then exact f32 rerank in the
    # engine-wide metric (squared euclidean / -dot / 1-cosine). |q|^2 is
    # omitted in the coarse scores (constant per query, rank-invariant).
    # Projected coarse scores carry JL distortion, so the pool must be
    # deeper for the exact rerank to recover (0.92 → 1.00 recall measured
    # at pool 64 → 256 on 256d data projected to 128).
    rr = max(RERANK_POOL_PQ if proj is not None else RERANK_POOL, 2 * k)
    nv, pos = jax.lax.top_k(-dist, rr)
    pool = jnp.take_along_axis(ids, pos, axis=-1)  # [B, rr]
    if dedup:
        # assignCopies > 1 stores a point in several slabs; keep one copy
        from semadb_tpu.ops.topk import dedup_by_id

        dpool, pool = dedup_by_id(-nv, pool)
        nv = -dpool

    def _exact(pc):  # pc: [B, chunk] → f32[B, chunk]
        pv = vectors[jnp.clip(pc, 0, cap - 1)]
        if metric == C.DISTANCE_EUCLIDEAN:
            return jnp.sum((pv - queries[:, None, :]) ** 2, axis=-1)
        cross = jnp.einsum(
            "brd,bd->br", pv, queries,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross

    D_full = queries.shape[1]
    RCH = 64
    if B * rr * D_full > 2**27 and rr % RCH == 0:
        # Chunk the rerank gather ([B, rr, D] is 6.4 GB at 1M x 1536d)
        pools = pool.reshape(B, rr // RCH, RCH).transpose(1, 0, 2)
        _, rds = jax.lax.scan(lambda _, pc: (None, _exact(pc)), None, pools)
        rd = rds.transpose(1, 0, 2).reshape(B, rr)
    else:
        rd = _exact(pool)
    rd = jnp.where((pool != NIL) & jnp.isfinite(-nv), rd, jnp.inf)
    nv2, pos2 = jax.lax.top_k(-rd, k)
    out_i = jnp.take_along_axis(pool, pos2, axis=-1)
    out_d = -nv2
    return jnp.where(jnp.isfinite(out_d), out_d, jnp.inf), jnp.where(
        jnp.isfinite(out_d), out_i, NIL
    )


@functools.partial(jax.jit, static_argnames=("p", "k", "pchunk", "kq", "metric", "dedup"))
def _ivf_query_pq(
    centroids: jax.Array,   # f32[C, D]
    cent_sq: jax.Array,     # f32[C]
    slab_codes: jax.Array,  # u8[C, S, M]
    slab_ids: jax.Array,    # i32[C, S]
    ovf_codes: jax.Array,   # u8[O, M]
    ovf_ids: jax.Array,     # i32[O]
    table: jax.Array,       # f32[B, M, K] ADC tables for this query batch
    queries: jax.Array,     # f32[B, D]
    vectors: jax.Array,     # f32[cap, D] per-node rerank vectors
    filter_mask: Optional[jax.Array],  # bool[cap] | None
    p: int,
    k: int,
    pchunk: int,
    kq: int,                # PQ centroids per subquantizer (K)
    metric: str,
    dedup: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """IVF-PQ query: probe by centroid matmul, score probed slabs + overflow
    by ADC lookup (product.go:269-276 accumulate, vectorised as a flat
    take_along_axis over [B, M*K]), exact f32 rerank on the pool."""
    B = queries.shape[0]
    S = slab_codes.shape[1]
    M = slab_codes.shape[2]
    cap = vectors.shape[0]
    flat_table = table.reshape(B, M * kq)
    m_off = jnp.arange(M, dtype=jnp.int32) * kq  # [M]

    # 1. probe selection (shared helper, chunked at large C)
    probe = _select_probes(queries, centroids, cent_sq, p)

    # 2. probe-chunked ADC slab scoring
    def score_chunk(_, pr):  # pr: [B, pchunk]
        cand = slab_codes[pr].astype(jnp.int32)  # [B, pc, S, M]
        idx = (cand + m_off[None, None, None, :]).reshape(B, -1)
        vals = jnp.take_along_axis(flat_table, idx, axis=1)
        dd = jnp.sum(vals.reshape(B, pr.shape[1], S, M), axis=-1)
        cid = slab_ids[pr]
        dd = jnp.where(cid != NIL, dd, jnp.inf)
        return None, (dd, cid)

    nchunk = p // pchunk
    prs = probe[:, : nchunk * pchunk].reshape(B, nchunk, pchunk).transpose(1, 0, 2)
    _, (dists_c, ids_c) = jax.lax.scan(score_chunk, None, prs)
    dist = dists_c.transpose(1, 0, 2, 3).reshape(B, nchunk * pchunk * S)
    ids = ids_c.transpose(1, 0, 2, 3).reshape(B, nchunk * pchunk * S)

    # 3. overflow ADC scan
    o_idx = (ovf_codes.astype(jnp.int32) + m_off[None, :]).reshape(-1)  # [O*M]
    o_vals = flat_table[:, o_idx].reshape(B, ovf_codes.shape[0], M)
    od = jnp.sum(o_vals, axis=-1)
    od = jnp.where(ovf_ids[None, :] != NIL, od, jnp.inf)
    dist = jnp.concatenate([dist, od], axis=-1)
    ids = jnp.concatenate(
        [ids, jnp.broadcast_to(ovf_ids[None, :], od.shape)], axis=-1
    )

    if filter_mask is not None:
        ok = jnp.take(filter_mask, jnp.clip(ids, 0, cap - 1)) & (ids != NIL)
        dist = jnp.where(ok, dist, jnp.inf)
        ids = jnp.where(ok, ids, NIL)

    # 4. ADC pool -> exact f32 rerank (the reference's PQ search has no
    # rerank — this engine's recall edge at the same code size)
    rr = max(RERANK_POOL_PQ, 2 * k)
    nv, pos = jax.lax.top_k(-dist, rr)
    pool = jnp.take_along_axis(ids, pos, axis=-1)  # [B, rr]
    if dedup:
        from semadb_tpu.ops.topk import dedup_by_id

        dpool, pool = dedup_by_id(-nv, pool)
        nv = -dpool

    def _exact(pc):  # pc: [B, chunk] → f32[B, chunk]
        pv = vectors[jnp.clip(pc, 0, cap - 1)]
        if metric == C.DISTANCE_EUCLIDEAN:
            return jnp.sum((pv - queries[:, None, :]) ** 2, axis=-1)
        cross = jnp.einsum(
            "brd,bd->br", pv, queries,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross

    D = queries.shape[1]
    RCH = 64
    if B * rr * D > 2**27 and rr % RCH == 0:
        # Chunk the rerank gather: [B, rr, D] unchunked is 6.4 GB at the
        # 1M x 1536d config.
        pools = pool.reshape(B, rr // RCH, RCH).transpose(1, 0, 2)
        _, rds = jax.lax.scan(lambda _, pc: (None, _exact(pc)), None, pools)
        rd = rds.transpose(1, 0, 2).reshape(B, rr)
    else:
        rd = _exact(pool)
    rd = jnp.where((pool != NIL) & jnp.isfinite(-nv), rd, jnp.inf)
    nv2, pos2 = jax.lax.top_k(-rd, k)
    out_i = jnp.take_along_axis(pool, pos2, axis=-1)
    out_d = -nv2
    return jnp.where(jnp.isfinite(out_d), out_d, jnp.inf), jnp.where(
        jnp.isfinite(out_d), out_i, NIL
    )


class IndexIVF:
    """Stateful host handle on a device-resident IVF index.

    Same surface as IndexVamana/IndexFlat: ``insert_update_delete`` over
    (id, vector|None) changes, ``search_batch``/``search_batch_async``
    with optional filter mask, array persistence.

    Only euclidean/dot/cosine metrics (the matmul contraction path); the
    schema validator rejects the rest.
    """

    def __init__(self, params: VectorIVFParams):
        self.params = params
        self.metric = params.distance_metric
        D = params.vector_size
        # Slab capacity scales with assignCopies: at copies=2 the same
        # slot pool must hold ~2x placements, and squeezing them into 64
        # slots displaces dense-region points from their home cluster
        # (recall 0.982 vs 1.000 measured at 1M; larger contiguous slabs
        # also gather faster).
        self.slab = params.slab_size or DEFAULT_SLAB * max(1, params.assign_copies)
        # High-dim traversal projection (PROJ_DIM rationale above): a
        # fixed random-orthonormal [D, r] map; slabs/overflow/centroids
        # used for SCORING are stored projected, the `vectors` rerank
        # matrix stays full precision. Deterministic seed so every
        # process derives the same map (persistence stores it anyway).
        pdim = params.proj_dim or PROJ_DIM
        if D > pdim:
            prng = np.random.default_rng(0xC0FFEE)
            qmat, _ = np.linalg.qr(
                prng.standard_normal((D, pdim)).astype(np.float64)
            )
            self._proj = jnp.asarray(qmat.astype(np.float32))  # [D, r]
            self.tdim = pdim
        else:
            self._proj = None
            self.tdim = D
        # Pre-fit state: everything lives in the overflow pool
        self.centroids = jnp.zeros((1, D), jnp.float32)
        self.slabs = jnp.zeros((1, self.slab, self.tdim), jnp.float32)
        self.slab_sq = jnp.zeros((1, self.slab), jnp.float32)
        self.slab_ids = jnp.full((1, self.slab), NIL, jnp.int32)
        self._fill = np.zeros(1, np.int32)
        self.ovf_vecs = jnp.zeros((8, self.tdim), jnp.float32)
        self.ovf_ids = jnp.full((8,), NIL, jnp.int32)
        self._ovf_free: list[int] = list(range(8))
        # Host mirror so CRUD never reads back from device; all vector data
        # stays on device (the ``vectors`` matrix is the source of truth)
        self._loc: dict[int, tuple] = {}  # node id -> ("s", c, slot) | ("o", j)
        self._loc2: dict[int, list] = {}  # node id -> [(c, slot), ...] copies
        self._n_at_fit = 0
        self._sq_cache: dict[str, jax.Array] = {}
        # Guards the donated-scatter read→donate→rebind windows against
        # concurrent search DISPATCH: donation invalidates the old buffer
        # object, so a search thread that grabbed the array ref but hasn't
        # dispatched yet would Execute() on a deleted buffer. Searches
        # hold this only while dispatching (device execution overlaps);
        # writers hold it per donated statement.
        self._donate_lock = threading.RLock()
        # Serialises engine-level WRITERS against each other (the shard
        # layer's store txns usually do this, but the engine contract is
        # safe standalone): _fill/_loc read-modify-write and the greedy
        # slab packing are not atomic across two concurrent writers.
        # Searches never take this lock — read overlap is unaffected.
        self._write_lock = threading.RLock()
        # Dirty-row tracking for incremental snapshots (shard/snapshot.py):
        # every write path below marks the rows it scatters; refits and
        # resizes mark whole arrays. Fresh index = everything dirty.
        from semadb_tpu.utils.dirty import DirtyTracker

        self.dirty = DirtyTracker()
        # Grow-ahead bookkeeping (_maybe_grow_ahead)
        self._grow_thread = None
        self._max_seen = 0
        # Per-node rerank matrix grows like the other engines' capacity
        # (or starts pre-grown under SEMADB_PREGROW_ROWS — no growth
        # event, and so no re-pad/recompile, ever lands in a write txn)
        from semadb_tpu.utils.grow import initial_capacity

        self.capacity = initial_capacity(D * 4, 128)
        self.vectors = jnp.zeros((self.capacity, D), jnp.float32)
        # IVF-PQ: codebook fits once at the quantizer trigger; when active,
        # slabs/overflow hold u8 codes and scoring is ADC + f32 rerank.
        self.pq_config = None
        self.pq_codebook = None  # f32[M, K, D/M]
        # Two-level coarse quantizer: super centroids (traversal space)
        # when the cluster count exceeds TWO_LEVEL_MIN_C, else None
        self._sup_cents = None
        self.slab_codes = jnp.zeros((1, self.slab, 1), jnp.uint8)
        self.ovf_codes = jnp.zeros((8, 1), jnp.uint8)
        q = params.quantizer
        # ADC scoring only below PROJ_DIM: above it, per-query table
        # lookups are gather-bound, so high-dim configs use the traversal
        # projection regardless of the quantizer setting.
        if q is not None and q.type == C.QUANTIZER_PRODUCT and D <= PROJ_DIM:
            from semadb_tpu.vectorstore.store import QuantConfig

            self.pq_config = QuantConfig.from_params(q, D, self.metric)

    @property
    def pq_active(self) -> bool:
        return self.pq_codebook is not None

    def capture_stack_view(self):
        """Consistent snapshot of the arrays the mesh fan-out stacks
        (parallel/fanout.stack_ivf_states), taken under ``_write_lock`` so
        a concurrent write can't interleave between attribute reads and
        hand the stacker a torn view (e.g. new slab_ids with old slabs).
        Device arrays are immutable buffers — capturing the references is
        enough; only the capture itself must be atomic vs writers."""
        import types

        with self._write_lock:
            p0 = self._num_probes(0)
            return types.SimpleNamespace(
                params=self.params,
                metric=self.metric,
                pq_active=self.pq_active,
                pq_codebook=self.pq_codebook,
                slab_codes=self.slab_codes,
                ovf_codes=self.ovf_codes,
                centroids=self.centroids,
                slabs=self.slabs,
                slab_sq=self.slab_sq,
                slab_ids=self.slab_ids,
                ovf_vecs=self.ovf_vecs,
                ovf_ids=self.ovf_ids,
                vectors=self.vectors,
                _proj=self._proj,
                _sq=self._sq,  # reads only self.metric (immutable)
                # default probe count frozen at capture time (the live
                # method reads centroid count, which a refit can change)
                _num_probes=lambda requested=0: requested or p0,
            )

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _prep(v: np.ndarray) -> np.ndarray:
        return np.asarray(v, np.float32)

    def _sq(self, arr: jax.Array, axis=-1) -> jax.Array:
        """Stored-side norm term: squared-euclidean keeps |x|^2; dot and
        cosine drop it so the score reduces to -2*(q . x), which orders
        exactly like the engine-wide negated-dot / 1-cosine distances."""
        if self.metric == C.DISTANCE_EUCLIDEAN:
            return jnp.sum(arr * arr, axis=axis)
        return jnp.zeros(arr.shape[:-1], jnp.float32)

    def _ensure_capacity(self, max_id: int) -> None:
        self._max_seen = max(getattr(self, "_max_seen", 0), max_id)
        if max_id < self.capacity:
            return
        new_cap = next_capacity(
            self.capacity, max_id, self.params.vector_size * 4
        )
        self.vectors = jnp.pad(self.vectors, ((0, new_cap - self.capacity), (0, 0)))
        self.capacity = new_cap
        self.dirty.all("vectors")  # shape change: full rewrite of the array

    # -- grow-ahead: keep bucket crossings out of user write txns ------------
    def _maybe_grow_ahead(self) -> None:
        """Spawn one daemon grower when occupancy passes the threshold.

        A growth event inside a write txn costs re-pad + new-shape kernel
        compiles — bbolt never charges a user txn O(state)
        (diskstore/diskstore.go:45-95), so neither should we. The grower
        (a) AOT-warms the persistent compile cache for the next bucket's
        write-scatter shapes WITHOUT any lock, then (b) pads under the
        write lock — a dispatch-only operation once the cache is warm."""
        from semadb_tpu.utils.grow import GROW_AHEAD_FRAC, PREGROW_ROWS

        if GROW_AHEAD_FRAC <= 0 or self._grow_thread is not None:
            return
        # A pre-grown deployment sized its capacity deliberately — filling
        # it is the EXPECTED state, not a growth signal. Padding to the
        # next ×4 bucket in the background here allocates 8 GB mid-refit
        # at 10M; synchronous growth remains the
        # fallback if writes genuinely overrun the pregrow size.
        if PREGROW_ROWS > 0:
            return
        if getattr(self, "_max_seen", 0) < GROW_AHEAD_FRAC * self.capacity:
            return
        t = threading.Thread(target=self._grow_ahead, daemon=True)
        self._grow_thread = t
        t.start()

    def _grow_ahead(self) -> None:
        try:
            target = next_capacity(
                self.capacity, self.capacity, self.params.vector_size * 4
            )
            self.warm_capacity_shapes(target)
            with self._write_lock:
                if self.capacity < target:
                    with self._donate_lock:
                        self.vectors = jnp.pad(
                            self.vectors, ((0, target - self.capacity), (0, 0))
                        )
                    self.capacity = target
                    self.dirty.all("vectors")
        except Exception as e:  # pragma: no cover - never break the write path
            log.warn("grow-ahead failed; synchronous growth will cover", error=str(e))
        finally:
            self._grow_thread = None

    def warm_capacity_shapes(self, capacity: int = 0, buckets=(64, 1024)) -> None:
        """Populate the persistent XLA compile cache for the write-path
        scatter kernels at ``capacity`` (default: current) without
        touching live arrays or taking any lock: AOT lower+compile on
        ShapeDtypeStructs. The later real dispatch re-lowers and hits the
        cache, so a cold first-write / post-growth txn pays ~100 ms of
        tracing instead of the full XLA compile."""
        cap = capacity or self.capacity
        D = self.params.vector_size
        dst = jax.ShapeDtypeStruct((cap, D), jnp.float32)
        for b in buckets:
            rows = jax.ShapeDtypeStruct((b,), jnp.int32)
            vals = jax.ShapeDtypeStruct((b, D), jnp.float32)
            _set_rows.lower(dst, rows, vals).compile()

    def __len__(self) -> int:
        return len(self._loc)

    def _ovf_slots(self, n: int) -> list[int]:
        """Reserve n overflow slots, growing (doubling) the pool at most
        once per call — one scatter per write batch, never per point."""
        while len(self._ovf_free) < n:
            old = self.ovf_ids.shape[0]
            grow = max(old, n)
            if self.pq_active:
                self.ovf_codes = jnp.pad(self.ovf_codes, ((0, grow), (0, 0)))
            else:
                self.ovf_vecs = jnp.pad(self.ovf_vecs, ((0, grow), (0, 0)))
            self.ovf_ids = jnp.pad(self.ovf_ids, (0, grow), constant_values=NIL)
            self._ovf_free.extend(range(old, old + grow))
            self.dirty.all("ovf_vecs")
            self.dirty.all("ovf_ids")
            self.dirty.all("ovf_codes")
        return [self._ovf_free.pop() for _ in range(n)]

    def _assign_top(self, cents, t, row_ids=None, rows=None):
        """Top-t nearest clusters as flat ids: grouped two-level scoring
        when a super layer exists (cluster counts past the flat ceiling),
        blocked flat scoring otherwise. ``rows`` = explicit data matrix;
        ``row_ids`` = gather rows from ``self.vectors`` per block."""
        from semadb_tpu.vectorstore.kmeans import (
            kmeans_assign,
            kmeans_assign_two_level,
        )

        if self._sup_cents is not None and cents.shape[0] >= TWO_LEVEL_MIN_C:
            # n_sup=4: with the default 2, 6.5% of assignments miss the
            # globally nearest cluster (measured 64k×64d/C=1024) — SOAR
            # copies and spill relocation then land in the wrong
            # neighbourhood. 4 supers brings rank-0 agreement to 0.974
            # at ~2× the (cheap) grouped-scoring cost.
            if rows is not None:
                return np.asarray(
                    kmeans_assign_two_level(
                        rows, self._sup_cents, cents, t, n_sup=4
                    )
                )
            return np.asarray(
                kmeans_assign_two_level(
                    self.vectors, self._sup_cents, cents, t,
                    row_ids=row_ids, n_sup=4,
                )
            )
        if rows is not None:
            return np.asarray(kmeans_assign(rows, cents, t))
        return np.asarray(kmeans_assign(self.vectors, cents, t, row_ids=row_ids))

    def _should_refit(self) -> bool:
        n = len(self._loc)
        if n < MIN_FIT:
            return False
        if self._n_at_fit == 0:
            return True
        # Occupied overflow slots = pool size − free list, O(1). (A scan
        # of _loc here cost O(n) Python per WRITE TXN at 1M+ points.)
        n_ovf = self.ovf_ids.shape[0] - len(self._ovf_free)
        return n >= 2 * self._n_at_fit or n_ovf > max(64, n // 4)

    def _refit(self) -> None:
        """Full k-means + repack. Vector data never leaves the device: the
        corpus is gathered from the ``vectors`` matrix, k-means labels are
        the only readback ([N] int32), and slabs/codes are built by device
        scatters with host-computed (cluster, rank) coordinates."""
        # The refit rebuilds centroids/slabs/overflow wholesale (and may
        # resize them): every array is dirty for the next snapshot.
        self.dirty.everything()
        ids = np.fromiter(self._loc.keys(), np.int32, len(self._loc))
        n = len(ids)
        D = self.params.vector_size
        # Auto cap 131072, not the schema's 262144 maximum: slab slots
        # scale with C (C × S × tdim), and at 10M × 128d the 262144
        # geometry's bf16 slabs alone are 8.6 GB and resident state would
        # reach ~14.4 GB (a fixed cap; ROADMAP S4 derives it from the device).
        # 131072 (mean cluster ~76 at 10M) halves that; an explicit
        # numClusters override can still ask for more.
        Cn = self.params.num_clusters or _npow2(
            max(n // TARGET_CLUSTER_SIZE, 1), 16, 131072
        )
        # Slab depth may grow with the corpus (see _auto_slab); the refit
        # rebuilds every slab-shaped array, so this is the one safe point
        # to change it. Explicit slabSize in the schema stays fixed.
        if not self.params.slab_size:
            self.slab = _auto_slab(
                min(self.params.assign_copies, Cn), n, Cn, self.tdim, self.slab
            )
        S = self.slab
        # Pad the fit input by tiling real point IDS (duplicates only nudge
        # centroid means): every distinct shape would otherwise recompile
        # the kmeans kernel, and an incremental write workload refits at
        # ever-growing counts. Padding the id list (not the gathered data)
        # avoids a second [n_pad, D] device copy — 6.7 GB at 1M x 1536d.
        if n < 2**17:
            n_pad = MIN_FIT
            while n_pad < n:
                n_pad *= 2
        else:
            # Large corpora: multiple-of-4096 (the blocked kmeans row block)
            # instead of the next power of two — recompiles are rare at
            # this scale (doubling refit schedule) and pow2 padding would
            # waste up to 2x fit compute.
            n_pad = -(-n // 4096) * 4096
        # A user numClusters override can exceed the (padded) fit row
        # count on the first small fit — kmeans' replace=False centroid
        # seeding needs Cn ≤ rows. Clamp like the auto path; later,
        # larger refits restore the requested count.
        Cn = min(Cn, n_pad)
        pad_ids = ids if n_pad == n else ids[np.arange(n_pad) % n]
        pad_ids_dev = jnp.asarray(pad_ids)
        # Past ~256 MB the [n_pad, D] gather copy meaningfully raises peak
        # device memory (vectors 6.4 GB + copy 6.2 GB + kmeans temporaries
        # at 1M x 1536d): gather rows per block inside the blocked kernels
        # instead.
        big = n_pad * D * 4 >= 2**28
        two_level = Cn >= TWO_LEVEL_MIN_C
        self._sup_cents = None
        with log.timed("refit kmeans", n=n, clusters=Cn, slab=S,
                       two_level=two_level):
            if two_level:
                from semadb_tpu.vectorstore.kmeans import kmeans_fit_two_level

                fit_data = None if big else self.vectors[pad_ids_dev]
                cents, lab, self._sup_cents = kmeans_fit_two_level(
                    self.vectors if big else fit_data, Cn, iters=KMEANS_ITERS,
                    row_ids=pad_ids_dev if big else None,
                    supers=min(TWO_LEVEL_SUPERS, Cn),
                )
            elif big:
                fit_data = None
                cents, lab = kmeans_fit_large(
                    self.vectors, Cn, iters=KMEANS_ITERS, row_ids=pad_ids_dev
                )
            else:
                fit_data = self.vectors[pad_ids_dev]  # device gather
                cents, lab = kmeans_fit_large(fit_data, Cn, iters=KMEANS_ITERS)
            lab = np.asarray(lab)[:n]
        log.hbm("hbm after kmeans fit")
        # All row selections below (sel/spill) index < n, so the padded
        # matrix can be used directly — slicing [:n] would cost another
        # [n, D] device copy at peak memory time.
        data = fit_data

        if self._proj is not None:
            # Refit the traversal basis as the corpus' top-r PRINCIPAL
            # subspace: a random-orthonormal projection keeps only ~r/D of
            # every distance's energy (recall 0.81 at 1M x 1536d measured),
            # while embedding corpora are effectively low-rank — the top-r
            # eigenvectors carry nearly all neighbourhood structure. The
            # second-moment matrix is accumulated on device from a ≤64k-row
            # sample; the [D, D] eigendecomposition runs on host.
            with log.timed("refit pca basis"):
                stride_p = max(n_pad // 2**16, 1)
                sample_rows = (
                    self.vectors[jnp.asarray(pad_ids[::stride_p])]
                    if big
                    else (fit_data[::stride_p] if stride_p > 1 else fit_data)
                )
                cov = jax.lax.dot_general(
                    sample_rows, sample_rows,
                    dimension_numbers=(((0,), (0,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32,
                )
                _, evecs = np.linalg.eigh(np.asarray(cov).astype(np.float64))
                self._proj = jnp.asarray(
                    np.ascontiguousarray(
                        evecs[:, -self.tdim:][:, ::-1]
                    ).astype(np.float32)
                )
                del sample_rows

        order = np.argsort(lab, kind="stable")
        lab_sorted = lab[order]
        # rank of each point within its cluster
        starts = np.searchsorted(lab_sorted, np.arange(Cn))
        rank = np.arange(n) - starts[lab_sorted]
        in_slab = rank < S
        sel = order[in_slab]  # row positions into `data`
        spill = order[~in_slab]
        cs, ss = lab[sel], rank[in_slab]

        copies = min(self.params.assign_copies, Cn)
        fill = np.minimum(np.bincount(lab, minlength=Cn), S).astype(np.int32)

        def _pack(rows, col_clusters, fill):
            return _pack_greedy(rows, col_clusters, fill, S, Cn)

        # Spill relocation (any assignCopies): a primary that misses its
        # full home cluster moves to the next-nearest cluster with a free
        # slot instead of the overflow pool. kmeans cluster sizes are
        # heavy-tailed, so the tail past S slots is percent-scale at 1M —
        # and the overflow pool is a DENSE every-query matmul: 65k spilled
        # rows cost more per query than the whole probed slab scan.
        # After relocation only points whose top-4
        # clusters are all full remain in overflow.
        # 8 relocation candidates: at saturated geometries (10M x 128d,
        # mean cluster 153 vs slab 256) the top-4 neighbours are often all
        # full — 4.7% of the corpus spilled to overflow, and the chunked
        # overflow scan's per-chunk top_k then dominates a query batch.
        RELOC_T = 8
        t_all = max(copies, RELOC_T)
        topt = None
        pc = np.full(n, -1, np.int64)  # placed (primary) cluster per row
        pc[sel] = lab[sel]
        pri_rows, pri_cs, pri_ss = sel, cs.astype(np.int64), ss.astype(np.int64)
        log.hbm("hbm before assign_top")
        with log.timed("refit assign_top", spill=len(spill)):
            if len(spill) and copies > 1:
                topt = (
                    self._assign_top(cents, t_all, row_ids=pad_ids_dev)
                    if big else self._assign_top(cents, t_all, rows=fit_data)
                )[:n]
                topt_sp = topt[spill]
            elif len(spill):
                topt_sp = self._assign_top(
                    cents, RELOC_T, rows=self.vectors[jnp.asarray(ids[spill])]
                )
            else:
                topt_sp = np.empty((0, t_all), np.int64)
        with log.timed("refit relocation pack"):
            still = spill  # rows still unplaced; still_topt stays row-aligned
            still_topt = topt_sp
            for col in range(1, t_all):
                if not len(still):
                    break
                placed, pcl, psl, fill, left_pos = _pack(
                    still, still_topt[:, col], fill
                )
                pri_rows = np.concatenate([pri_rows, placed])
                pri_cs = np.concatenate([pri_cs, pcl])
                pri_ss = np.concatenate([pri_ss, psl])
                pc[placed] = pcl
                still = still[left_pos]
                still_topt = still_topt[left_pos]
            spill = still

        # SOAR-style secondary copies (assignCopies > 1): each point also
        # lands in its 2nd..t-th nearest cluster, best-effort into the
        # slots primaries left free. Boundary points — the dominant
        # probe-miss mode (recall vs probes saturates ~0.99 at 1M with
        # single assignment) — become reachable from both sides. Copies
        # never displace primaries; a full cluster just drops them.
        sec_rows = np.empty(0, np.int64)
        sec_cs = np.empty(0, np.int64)
        sec_ss = np.empty(0, np.int64)
        if copies > 1:
            with log.timed("refit copies pack"):
                if topt is None:
                    topt = (
                        self._assign_top(cents, t_all, row_ids=pad_ids_dev)
                        if big
                        else self._assign_top(cents, t_all, rows=fit_data)
                    )[:n]
                for col in range(1, copies):
                    cand = np.nonzero((pc >= 0) & (topt[:, col] != pc))[0]
                    placed, pcl, psl, fill, _ = _pack(
                        cand, topt[cand, col], fill
                    )
                    sec_rows = np.concatenate([sec_rows, placed])
                    sec_cs = np.concatenate([sec_cs, pcl])
                    sec_ss = np.concatenate([sec_ss, psl])
        all_rows = np.concatenate([pri_rows, sec_rows]).astype(np.int64)
        all_cs = np.concatenate([pri_cs, sec_cs])
        all_ss = np.concatenate([pri_ss, sec_ss])

        # Floor the pool at 4096 once the corpus is large: the pool size
        # is an operand shape of the query kernel, so a write workload
        # regrowing a post-refit pool from 8 slots recompiles the search
        # ~9 times. 4096 overflow rows cost one tiny
        # chunk in the dense overflow scan.
        o_min = 4096 if n >= 2**17 else 8
        O = max(int(2 ** np.ceil(np.log2(max(len(spill) * 2, 8)))), o_min)
        ovf_ids = np.full((O,), NIL, np.int32)
        ovf_ids[: len(spill)] = ids[spill]
        slab_ids = np.full((Cn, S), NIL, np.int32)
        slab_ids[all_cs, all_ss] = ids[all_rows]

        # Fit the PQ codebook once, at the quantizer's trigger threshold
        # (product.go:175-183 fit-once semantics).
        if (
            self.pq_config is not None
            and self.pq_codebook is None
            and n >= max(self.pq_config.trigger, MIN_FIT)
        ):
            from semadb_tpu.vectorstore.store import pq_fit

            # Codebooks need ~256 samples per centroid, not the whole
            # corpus: subsample by stride to ≤ 64k rows (the reference
            # fits on the full set, product.go:175-183, but tops out at
            # trigger-threshold sizes; FAISS guidance is the same).
            stride = max(n_pad // 2**16, 1)
            if big:
                sample = self.vectors[jnp.asarray(pad_ids[::stride])]
            else:
                sample = fit_data[::stride] if stride > 1 else fit_data
            self.pq_codebook = pq_fit(
                sample, jnp.ones((sample.shape[0],), bool),
                self.pq_config.num_subvectors, self.pq_config.num_centroids,
            )

        if self.pq_active:
            from semadb_tpu.vectorstore.store import pq_encode

            M = self.pq_config.num_subvectors
            if big:
                codes = pq_encode(
                    self.vectors, self.pq_codebook, M,
                    self.pq_config.num_centroids, self.metric,
                    row_ids=pad_ids_dev,
                )
            else:
                codes = pq_encode(
                    data, self.pq_codebook, M,
                    self.pq_config.num_centroids, self.metric,
                )  # u8[n_pad, M]
            # Gather-based build (see _slabs_from_ids): map slab ids to
            # fit rows via a host inverse, then one [Cn, S, M] u8 gather.
            inv = np.zeros(self.capacity, np.int32)
            inv[ids] = np.arange(n, dtype=np.int32)
            code_rows = jnp.asarray(inv[np.clip(slab_ids, 0, self.capacity - 1)])
            self.slab_codes = jnp.where(
                (jnp.asarray(slab_ids) != NIL)[..., None], codes[code_rows], 0
            ).astype(jnp.uint8)
            ovf_codes = jnp.zeros((O, M), jnp.uint8)
            if len(spill):
                ovf_codes = ovf_codes.at[: len(spill)].set(codes[spill])
            self.ovf_codes = ovf_codes
            # f32 slabs/overflow are dead weight in PQ mode: shrink them
            self.slabs = jnp.zeros((1, S, self.tdim), jnp.float32)
            self.ovf_vecs = jnp.zeros((1, self.tdim), jnp.float32)
        else:
            log.hbm("hbm before slab build")
            with log.timed("refit slab build"):
                bf16 = Cn * S * self.tdim * 4 > SLAB_BF16_BYTES
                self.slabs, self.slab_sq = _slabs_from_ids(
                    self.vectors, jnp.asarray(slab_ids), self._proj,
                    out_dtype=jnp.bfloat16 if bf16 else jnp.float32,
                    want_sq=self.metric == C.DISTANCE_EUCLIDEAN,
                )
                ovf_vecs = jnp.zeros((O, self.tdim), jnp.float32)
                if len(spill):
                    sp_v = (
                        self.vectors[jnp.asarray(ids[spill])]
                        if big else data[spill]
                    )
                    if self._proj is not None:
                        sp_v = sp_v @ self._proj
                    ovf_vecs = ovf_vecs.at[: len(spill)].set(sp_v)
                self.ovf_vecs = ovf_vecs
                # Wait for the device work so the timer reflects it.
                jax.block_until_ready(self.slabs)

        self.centroids = cents
        self.slab_ids = jnp.asarray(slab_ids)
        self._fill = fill  # HWM incl. secondary copies
        self.ovf_ids = jnp.asarray(ovf_ids)
        self._ovf_free = list(range(len(spill), O))
        # .tolist() upfront: per-element int() over numpy scalars costs
        # 3-6x more than one C-loop conversion (10M-iteration build on a
        # 1-vCPU host).
        with log.timed("refit loc maps"):
            self._loc = dict(
                zip(
                    ids[pri_rows].tolist(),
                    zip(
                        ("s",) * len(pri_rows), pri_cs.tolist(),
                        pri_ss.tolist(),
                    ),
                )
            )
            for j, i in enumerate(ids[spill].tolist()):
                self._loc[i] = ("o", j)
            self._loc2 = {}
            for i, c, s in zip(
                ids[sec_rows].tolist(), sec_cs.tolist(), sec_ss.tolist()
            ):
                self._loc2.setdefault(i, []).append((c, s))
        self._n_at_fit = n
        self._sq_cache = {}

    # -- writes --------------------------------------------------------------
    def insert_update_delete(
        self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]
    ) -> None:
        """Apply (id, vector|None) changes. Vectors should be HOST arrays:
        each one is converted individually, so handing this path rows of a
        device-resident matrix costs one device→host readback per point.
        For device-resident batches use :meth:`insert_bulk`."""
        with self._write_lock:
            out = self._insert_update_delete_locked(changes)
        self._maybe_grow_ahead()
        return out

    def _insert_update_delete_locked(
        self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]
    ) -> None:
        ups: list[tuple[int, np.ndarray]] = []
        removals: list = []  # loc tuples to blank
        max_id = 0
        for node_id, vec in changes:
            if node_id in (0, 1):
                raise ValueError(f"cannot modify point with reserved id: {node_id}")
            max_id = max(max_id, node_id)
            if vec is None:
                loc = self._loc.pop(node_id, None)
                if loc is not None:
                    removals.append(loc)
                for c2, s2 in self._loc2.pop(node_id, ()):
                    removals.append(("s", c2, s2))
            else:
                ups.append((node_id, self._prep(vec)))
        self._ensure_capacity(max_id)
        if ups:
            up_ids = np.array([u[0] for u in ups], np.int32)
            up_vecs = np.stack([u[1] for u in ups])
            # Chunk the upload+scatter for huge batches: one 6 GB transfer
            # (1M x 1536d bulk load) doubles peak device memory next to
            # the grown `vectors` matrix.
            CH = 131072
            if len(ups) > CH:
                up_dev = None
                for off in range(0, len(ups), CH):
                    blk = jnp.asarray(_pad_dup(up_vecs[off : off + CH]))
                    with self._donate_lock:
                        self.vectors = _set_rows(
                            self.vectors,
                            jnp.asarray(_pad_dup(up_ids[off : off + CH])),
                            blk,
                        )
            else:
                up_dev = jnp.asarray(_pad_dup(up_vecs))
                with self._donate_lock:
                    self.vectors = _set_rows(
                        self.vectors, jnp.asarray(_pad_dup(up_ids)), up_dev
                    )
            self.dirty.rows("vectors", up_ids)

            # update = replace: pop every old location before placement
            for node_id, _ in ups:
                old = self._loc.pop(node_id, None)
                if old is not None:
                    removals.append(old)
                for c2, s2 in self._loc2.pop(node_id, ()):
                    removals.append(("s", c2, s2))
            if removals:
                self._apply_removals(removals)
                removals = []
            if self._n_at_fit > 0:
                # Vectorised device placement (same greedy column packing
                # as insert_bulk/_refit — no per-point Python)
                self._place_fitted(up_ids.astype(np.int64))
            elif len(self._loc) + len(ups) >= MIN_FIT:
                # Bulk-load fast path: this batch triggers the FIRST fit
                # at the end of this call (the refit predicate is exactly
                # this condition), which rebuilds slabs and overflow from
                # `vectors` — materialising a full-size overflow pool
                # first is pure waste (12.9 GB of transient HBM at 1M x
                # 1536d). Locations are placeholders the refit replaces.
                self._loc.update((int(i), ("o", -1)) for i in up_ids)
            else:
                # tiny pre-fit corpus: real overflow entries so searches
                # before the first fit still see the points
                slots = np.array(self._ovf_slots(len(ups)), np.int32)
                rows_dev = (
                    up_dev  # already padded to the same bucket as slots
                    if up_dev is not None
                    else self.vectors[jnp.asarray(_pad_dup(up_ids))]
                )
                if self._proj is not None:
                    rows_dev = rows_dev @ self._proj
                self.ovf_vecs = self.ovf_vecs.at[_pad_dup(slots)].set(rows_dev)
                self.ovf_ids = self.ovf_ids.at[_pad_dup(slots)].set(
                    _pad_dup(up_ids)
                )
                self.dirty.rows("ovf_vecs", slots)
                self.dirty.rows("ovf_ids", slots)
                for nid, j in zip(up_ids, slots):
                    self._loc[int(nid)] = ("o", int(j))
        if removals:
            self._apply_removals(removals)
        if self._should_refit():
            self._refit()
        self._sq_cache = {}

    def _apply_removals(self, removals: list) -> None:
        """Blank removed locations on device. Deferred-fit placeholders
        ``("o", -1)`` have no device state — dropping them here is the
        whole removal (a -1 would otherwise blank the LAST real overflow
        slot via negative indexing and poison ``_ovf_free`` with -1)."""
        s_cs = np.array([l[1] for l in removals if l[0] == "s"], np.int32)
        s_ss = np.array([l[2] for l in removals if l[0] == "s"], np.int32)
        o_js = np.array(
            [l[1] for l in removals if l[0] == "o" and l[1] >= 0], np.int32
        )
        if len(s_cs):
            cs_d = jnp.asarray(_pad_dup(s_cs))
            with self._donate_lock:
                self.slab_ids = _set_cells(
                    self.slab_ids, cs_d, jnp.asarray(_pad_dup(s_ss)),
                    jnp.full(cs_d.shape, NIL, jnp.int32),
                )
            self.dirty.rows("slab_ids", s_cs)
        if len(o_js):
            js_d = jnp.asarray(_pad_dup(o_js))
            with self._donate_lock:
                self.ovf_ids = _set_rows(
                    self.ovf_ids, js_d, jnp.full(js_d.shape, NIL, jnp.int32)
                )
            self._ovf_free.extend(int(j) for j in o_js)
            self.dirty.rows("ovf_ids", o_js)

    def _has_placeholders(self) -> bool:
        """True while any deferred-fit ``("o", -1)`` location exists (a
        bulk insert with ``defer_fit`` whose refit hasn't run yet)."""
        return any(
            l[0] == "o" and l[1] < 0 for l in self._loc.values()
        )


    def insert_bulk(self, ids, vecs, defer_fit: bool = False) -> None:
        """Array bulk insert — no per-point Python, no host round-trip.

        ``ids``: int array [n] of NEW node ids; ``vecs``: f32 [n, D]
        (numpy or device-resident). Semantics match
        :meth:`insert_update_delete` over fresh ids; batches containing
        existing ids fall back to the generic path. The bulk-load flow
        (empty index -> one big batch) goes: chunked scatter into
        ``vectors`` -> placeholder locations -> one refit; a fitted index
        takes the vectorised greedy packing used by refits.

        ``defer_fit=True`` skips the trailing refit so the caller can
        first release its own reference to ``vecs`` (Python keeps the
        6 GB corpus alive through the whole call chain otherwise, next to
        the index being refit at 1M x 1536d); call :meth:`flush_pending`
        afterwards.
        """
        with self._write_lock:
            out = self._insert_bulk_locked(ids, vecs, defer_fit)
        self._maybe_grow_ahead()
        return out

    def _insert_bulk_locked(self, ids, vecs, defer_fit: bool) -> None:
        ids_np = np.asarray(ids, np.int64)
        n = len(ids_np)
        if n == 0:
            return
        if (ids_np <= 1).any():
            raise ValueError("cannot modify point with reserved id")
        if len(np.unique(ids_np)) != n or any(
            int(i) in self._loc for i in ids_np
        ):
            self.insert_update_delete(zip(ids_np.tolist(), np.asarray(vecs)))
            return
        contiguous = bool(
            np.array_equal(ids_np, np.arange(ids_np[0], ids_np[0] + n))
        )
        if (
            isinstance(vecs, jnp.ndarray)
            and not self._loc
            and contiguous
            and len(self.vectors) == self.capacity
        ):
            # Adopt a device-resident corpus by padding rows into id
            # positions: an eager scatter would hold old vectors + new
            # vectors + the corpus simultaneously (19 GB at 1M x 1536d).
            # Capacity pads to a 2^20 multiple, not the next power of two
            # — pow2 doubling wastes 40% of HBM at 10M points (16.7M x
            # 128d = 8.6 GB vs 5.8 GB); bulk loads are the one shape
            # class where recompiles-per-capacity don't compound.
            new_cap = self.capacity
            while new_cap <= int(ids_np[-1]):
                new_cap *= 2
            if new_cap >= 2**21:
                new_cap = (int(ids_np[-1]) // 2**20 + 1) * 2**20
            lead = int(ids_np[0])
            self.vectors = jnp.pad(
                vecs.astype(jnp.float32), ((lead, new_cap - n - lead), (0, 0))
            )
            self.capacity = new_cap
            # This branch bypasses _ensure_capacity, which normally tracks
            # the snapshot row bound — without this line a device-corpus
            # bulk load persisted a 1-row vectors array (reopen parity
            # 0.053 at 10M, caught by the shardwrite crash leg).
            self._max_seen = max(self._max_seen, int(ids_np[-1]))
            self.dirty.all("vectors")
        else:
            self._ensure_capacity(int(ids_np.max()))
            CH = 131072
            for off in range(0, n, CH):
                blk = vecs[off : off + CH]
                if not isinstance(blk, jnp.ndarray):
                    blk = jnp.asarray(np.asarray(blk, np.float32))
                with self._donate_lock:
                    self.vectors = _set_rows(
                        self.vectors, jnp.asarray(ids_np[off : off + CH]), blk
                    )
            self.dirty.rows("vectors", ids_np)
        fitted = self._n_at_fit > 0
        if not fitted:
            self._loc.update((int(i), ("o", -1)) for i in ids_np)
            if len(self._loc) >= MIN_FIT:
                if not defer_fit:
                    self._refit()
            else:
                # tiny pre-fit corpus: materialise real overflow entries so
                # searches before the first fit still see the points
                for i in ids_np:
                    self._loc.pop(int(i))
                self.insert_update_delete(
                    zip(ids_np.tolist(), np.asarray(jax.device_get(vecs)))
                )
            self._sq_cache = {}
            return

        self._place_fitted(ids_np)
        if self._should_refit() and not defer_fit:
            self._refit()
        self._sq_cache = {}

    def _place_fitted(self, ids_np: np.ndarray) -> None:
        """Vectorised placement of already-scattered ``vectors`` rows into
        slabs/overflow: per-column greedy capacity packing (primaries with
        spill relocation, then SOAR copies), one device scatter per array.
        Shared by :meth:`insert_bulk` and the incremental write path — the
        old per-point Python pack capped sustained-write throughput.
        """
        n = len(ids_np)
        # Shape-bucketed assignment (see _pad_dup): duplicate rows just
        # re-score the same point; slice back to the true count.
        ids_dev = jnp.asarray(_pad_dup(ids_np.astype(np.int32)))
        Cn = self.centroids.shape[0]
        S = self.slab
        copies = min(self.params.assign_copies, Cn)
        t_ins = min(max(copies, 2), Cn)
        topt = self._assign_top(self.centroids, t_ins, row_ids=ids_dev)[:n]
        fill = self._fill
        placed_cols = []  # (rows(pos into ids_np), clusters, slots, is_primary)
        pc = np.full(n, -1, np.int64)
        still = np.arange(n)
        for col in range(t_ins):
            if not len(still):
                break
            placed, pcl, psl, fill, left = _pack_greedy(
                still, topt[still, col], fill, S, Cn
            )
            placed_cols.append((placed, pcl, psl, True))
            pc[placed] = pcl
            still = still[left]
        ovf_rows = still
        if copies > 1:
            for col in range(1, copies):
                cand = np.nonzero((pc >= 0) & (topt[:, col] != pc))[0]
                placed, pcl, psl, fill, _ = _pack_greedy(
                    cand, topt[cand, col], fill, S, Cn
                )
                placed_cols.append((placed, pcl, psl, False))
        self._fill = fill

        all_rows = np.concatenate([p[0] for p in placed_cols])
        all_cs = np.concatenate([p[1] for p in placed_cols])
        all_ss = np.concatenate([p[2] for p in placed_cols])
        if len(all_rows):
            # Joint duplicate-pad keeps (row, cluster, slot) aligned: the
            # padded tail rewrites the last slot with its own value.
            all_rows = _pad_dup(all_rows)
            all_cs = _pad_dup(all_cs)
            all_ss = _pad_dup(all_ss)
            rows_dev = jnp.asarray(ids_np[all_rows].astype(np.int32))
            if self.pq_active:
                from semadb_tpu.vectorstore.store import pq_encode

                codes = pq_encode(
                    self.vectors, self.pq_codebook,
                    self.pq_config.num_subvectors,
                    self.pq_config.num_centroids, self.metric,
                    row_ids=rows_dev,
                )
                with self._donate_lock:
                    self.slab_codes = _set_cells(
                        self.slab_codes, jnp.asarray(all_cs),
                        jnp.asarray(all_ss), codes,
                    )
            else:
                rows_f = (
                    _gather_project(self.vectors, rows_dev, self._proj)
                    if self._proj is not None
                    else self.vectors[rows_dev]
                )
                cs_d = jnp.asarray(all_cs)
                ss_d = jnp.asarray(all_ss)
                with self._donate_lock:
                    self.slabs = _set_cells(
                        self.slabs, cs_d, ss_d, rows_f.astype(self.slabs.dtype)
                    )
                    self.slab_sq = _set_cells(
                        self.slab_sq, cs_d, ss_d, self._sq(rows_f)
                    )
            # slab_ids LAST: the id write is what makes a slot visible to
            # concurrent searches — writing it before the slab vectors
            # exposes zero-filled rows that score spuriously close
            # (search-while-insert regression, caught by
            # test_ivf_search_while_insert).
            with self._donate_lock:
                self.slab_ids = _set_cells(
                    self.slab_ids,
                    jnp.asarray(all_cs),
                    jnp.asarray(all_ss),
                    jnp.asarray(ids_np[all_rows].astype(np.int32)),
                )
            self.dirty.rows("slab_ids", all_cs)
            if self.pq_active:
                self.dirty.rows("slab_codes", all_cs)
            else:
                self.dirty.rows("slabs", all_cs)
                self.dirty.rows("slab_sq", all_cs)
        if len(ovf_rows):
            slots = np.array(self._ovf_slots(len(ovf_rows)), np.int32)
            slots_d = _pad_dup(slots)
            o_dev = jnp.asarray(_pad_dup(ids_np[ovf_rows].astype(np.int32)))
            if self.pq_active:
                from semadb_tpu.vectorstore.store import pq_encode

                self.ovf_codes = self.ovf_codes.at[slots_d].set(
                    pq_encode(
                        self.vectors, self.pq_codebook,
                        self.pq_config.num_subvectors,
                        self.pq_config.num_centroids, self.metric,
                        row_ids=o_dev,
                    )
                )
            else:
                ov = (
                    _gather_project(self.vectors, o_dev, self._proj)
                    if self._proj is not None
                    else self.vectors[o_dev]
                )
                with self._donate_lock:
                    self.ovf_vecs = _set_rows(
                        self.ovf_vecs, jnp.asarray(slots_d), ov
                    )
            with self._donate_lock:
                self.ovf_ids = _set_rows(
                    self.ovf_ids, jnp.asarray(slots_d), o_dev
                )
            self.dirty.rows("ovf_ids", slots)
            self.dirty.rows("ovf_codes" if self.pq_active else "ovf_vecs", slots)
            for r, j in zip(ovf_rows, slots):
                self._loc[int(ids_np[r])] = ("o", int(j))
        for placed, pcl, psl, primary in placed_cols:
            if primary:
                for r, c, sl in zip(placed, pcl, psl):
                    self._loc[int(ids_np[r])] = ("s", int(c), int(sl))
            else:
                for r, c, sl in zip(placed, pcl, psl):
                    self._loc2.setdefault(int(ids_np[r]), []).append(
                        (int(c), int(sl))
                    )

    def flush_pending(self) -> None:
        """Run the refit a ``defer_fit`` bulk insert postponed.

        Also forces a refit when placeholder ``("o", -1)`` locations
        exist even if the doubling predicate doesn't fire (deletes can
        shrink the live count below MIN_FIT while placeholders linger —
        they carry no device state, so a search would miss them)."""
        with self._write_lock:
            if self._should_refit() or self._has_placeholders():
                self._refit()
                self._sq_cache = {}

    def sync(self) -> None:
        """Block until every queued device mutation of the index state
        has executed (build timing)."""
        jax.block_until_ready(
            [v for v in vars(self).values() if isinstance(v, jax.Array)]
        )

    # -- reads ---------------------------------------------------------------
    def _num_probes(self, requested: int = 0) -> int:
        Cn = self.centroids.shape[0]
        if requested or self.params.num_probes:
            p = requested or self.params.num_probes
        elif self.params.assign_copies > 1:
            # With copies + spill relocation the required probe count is
            # ~scale-free: 16-24 probes reach recall 1.0 at both 100k
            # (C=4096) and 1M (C=32768) on SIFT-margin data — probing is
            # about local neighbourhood coverage, not corpus fraction.
            p = 24
        else:
            p = max(8, Cn // 170)
        return max(1, min(max(4, p), Cn))

    def search_batch_async(
        self, queries, k: int, num_probes: int = 0, filter_mask=None
    ):
        """Dispatch without synchronising → (dists, ids) device arrays."""
        if isinstance(queries, jnp.ndarray) and queries.ndim == 2:
            q = queries
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
        # Snapshot the cache DICT once: writers invalidate by rebinding
        # self._sq_cache = {}, so reading through self between the check
        # and the use races (KeyError under concurrent writes). A stale
        # local dict only means stale-but-valid arrays — same semantics
        # as the tolerant search-while-write reads of the slab arrays.
        cache = self._sq_cache
        if "cent" not in cache:
            cent_p = (
                self.centroids @ self._proj
                if self._proj is not None
                else self.centroids
            )
            cache["cent_p"] = cent_p
            cache["cent"] = self._sq(cent_p)
        # The overflow pool GROWS between writes: pair the pool array and
        # its norms as one capture, recomputing when the cached sq was
        # built for a different pool shape (a mismatched pair would fail
        # shape checking inside the query program).
        ov = self.ovf_vecs
        ov_ids = self.ovf_ids
        if ov_ids.shape[0] != ov.shape[0]:  # pool grew mid-capture
            ov, ov_ids = self.ovf_vecs, self.ovf_ids
        if not self.pq_active:
            ovf_sq = cache.get("ovf")
            if ovf_sq is None or ovf_sq.shape[0] != ov.shape[0]:
                ovf_sq = self._sq(ov)
                cache["ovf"] = ovf_sq
        p = self._num_probes(num_probes)
        if filter_mask is not None:
            fm_np = np.asarray(filter_mask, bool)
            # Selective filters: an exact member-gather scan over the
            # per-node vectors is one dense matmul (the [B, P] distance
            # matrix caps the budget: ≤ 1 GB at B=4096 / P=65536) and
            # EXACT — probing misses members whose clusters aren't
            # selected (measured: sel=0.005 at 1M recalled only 0.52 via
            # 4x-widened probes vs 1.0 exact; vamana solves the same
            # problem by seeding with filter members, search.go:27-51).
            exact_cap = max(p * self.slab, FILTER_EXACT_CAP)
            if int(fm_np.sum()) <= exact_cap:
                with self._donate_lock:
                    return self._member_exact(q, k, fm_np)
            # Broad filter: probe wider instead.
            p = min(FILTER_WIDEN * p, self.centroids.shape[0])
            fm = jnp.asarray(fm_np)
            if fm.shape[0] < self.capacity:
                fm = jnp.pad(fm, (0, self.capacity - fm.shape[0]))
        else:
            fm = None
        # Larger probe chunks amortise scan-step overhead; keep the
        # gathered [B, pc, S, tdim] chunk ≤ ~1 GB (ROADMAP S5 re-tunes
        # these sizes on the GPU).
        B_pad = q.shape[0]
        for pchunk in (8, 4, 2, 1):
            if p % pchunk == 0 and B_pad * pchunk * self.slab * self.tdim * 4 <= 2**30:
                break
        # Dispatch under the donate lock: grabbing array refs and calling
        # Execute() must not interleave with a writer's donated scatter
        # (which invalidates the old buffer objects). Device EXECUTION
        # still overlaps — the lock covers dispatch only.
        if self.pq_active:
            from semadb_tpu.vectorstore.store import pq_query_table

            table = pq_query_table(
                q, self.pq_codebook,
                self.pq_config.num_subvectors, self.pq_config.num_centroids,
                self.metric,
            )
            with self._donate_lock:
                return _ivf_query_pq(
                    self.centroids, cache["cent"],
                    self.slab_codes, self.slab_ids,
                    self.ovf_codes, self.ovf_ids,
                    table, q, self.vectors, fm,
                    p, k, pchunk, self.pq_config.num_centroids, self.metric,
                    dedup=self.params.assign_copies > 1,
                )
        with self._donate_lock:
            return _ivf_query(
                cache["cent_p"], cache["cent"],
                self.slabs, self.slab_sq, self.slab_ids,
                ov, ovf_sq, ov_ids,
                q, self.vectors, fm, self._proj, p, k, pchunk, self.metric,
                dedup=self.params.assign_copies > 1,
            )

    def _member_exact(self, q: jax.Array, k: int, fm_np: np.ndarray):
        """Exact top-k over filter members only, by gathering member rows
        (O(members), not O(capacity) — the member-gather scan). Live
        membership is intersected host-side via ``_loc``; member count is
        padded to a power of two to bound recompiles. Past one matmul's
        memory budget the scan chunks over member blocks under a single
        ``lax.scan`` dispatch (same pattern as the overflow scan), merging
        per-chunk top-k into a running pool — still exact."""
        live = self._sq_cache.get("live")
        if live is None or live.shape[0] != self.capacity:
            live = np.zeros(self.capacity, bool)
            ids = np.fromiter(self._loc.keys(), np.int64, len(self._loc))
            if len(ids):
                live[ids[ids < self.capacity]] = True
            self._sq_cache["live"] = live
        fm = np.zeros(self.capacity, bool)
        n = min(len(fm_np), self.capacity)
        fm[:n] = fm_np[:n]
        fm &= live
        members = np.nonzero(fm)[0].astype(np.int32)
        B = q.shape[0]
        if len(members) == 0:
            return (jnp.full((B, k), jnp.inf), jnp.full((B, k), NIL, jnp.int32))
        # Keep the [B, chunk] distance matrix ≤ ~1 GB f32.
        chunk_cap = max(1024, min(65536, 2**28 // max(B, 1)))
        if len(members) > chunk_cap:
            return _member_scan_chunked_host(
                self.vectors, members, q, k, self.metric, chunk_cap
            )
        P = 8
        while P < len(members):
            P *= 2
        padded = np.full(P, members[0], np.int32)
        padded[: len(members)] = members
        valid = np.zeros(P, bool)
        valid[: len(members)] = True
        mv = self.vectors[jnp.asarray(padded)]  # [P, D] device gather
        d = pairwise_distance(q, mv, self.metric)
        d = jnp.where(jnp.asarray(valid)[None, :], d, jnp.inf)
        kk = min(k, P)
        nv, pos = jax.lax.top_k(-d, kk)
        out_d = -nv
        out_i = jnp.asarray(padded)[pos]
        out_d = jnp.where(jnp.isfinite(out_d), out_d, jnp.inf)
        out_i = jnp.where(jnp.isfinite(out_d), out_i, NIL)
        if kk < k:
            out_d = jnp.pad(out_d, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
            out_i = jnp.pad(out_i, ((0, 0), (0, k - kk)), constant_values=NIL)
        return out_d, out_i

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        num_probes: int = 0,
        filter_mask: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        q_np = np.atleast_2d(np.asarray(queries, np.float32))
        B = q_np.shape[0]
        d, i = self.search_batch_async(q_np, k, num_probes, filter_mask)
        return np.asarray(d)[:B], np.asarray(i)[:B]

    # -- persistence ----------------------------------------------------------
    def to_arrays(self) -> dict:
        # Exclude writers for the whole snapshot: a donated scatter would
        # invalidate an array object between our ref-grab and readback,
        # and a half-applied txn would snapshot torn state.
        with self._write_lock:
            return self._to_arrays_locked()

    def _to_arrays_locked(self) -> dict:
        return {k: np.asarray(v) for k, v in self._device_arrays_locked().items()}

    def device_arrays(self) -> dict:
        """Device-resident snapshot view (no readback): the incremental
        snapshot writer (shard/snapshot.py) slices only dirty chunks out
        of these. Caller must hold ``_write_lock``."""
        return self._device_arrays_locked()

    def _device_arrays_locked(self) -> dict:
        if self._has_placeholders():
            # Deferred-fit placeholders have no device state — a snapshot
            # taken now would silently drop those points. Materialise them.
            self.flush_pending()
        out = {
            "centroids": self.centroids,
            "slab_ids": self.slab_ids,
            "ovf_ids": self.ovf_ids,
            "vectors": self.vectors,
            "n_at_fit": np.asarray([self._n_at_fit], np.int64),
        }
        if self.pq_active:
            # PQ mode: codes are the mass (slabs/ovf_vecs are shrunk to
            # dummies by _refit) — persist them; codes are not cheaply
            # derivable from f32 vectors at load.
            out["slabs"] = self.slabs
            out["slab_sq"] = self.slab_sq
            out["ovf_vecs"] = self.ovf_vecs
            out["pq_codebook"] = self.pq_codebook
            out["slab_codes"] = self.slab_codes
            out["ovf_codes"] = self.ovf_codes
        # else: slabs / slab_sq / ovf_vecs are DERIVED state —
        # slabs[c,s] == cast(proj(vectors[slab_ids[c,s]])) (zero at NIL),
        # exactly what _refit builds (_slabs_from_ids). from_arrays
        # reconstructs them with one device gather at load, so the
        # snapshot never pays their readback (at 10M the slab grid alone
        # is ~3-5 GB that scatter-heavy writes re-dirty within a few
        # txns) and reopen never pays their upload.
        if self._proj is not None:
            out["proj"] = self._proj
        if self._sup_cents is not None:
            out["sup_cents"] = self._sup_cents
        return out

    def snapshot_row_bounds(self) -> dict:
        """Used-row bounds for the incremental snapshot writer: the
        rerank matrix is capacity-padded (16M rows for a 10M corpus) —
        rows past the highest id ever written are zeros that never need
        to leave the device. from_arrays re-pads to the policy bucket."""
        return {"vectors": min(self.capacity, int(self._max_seen) + 1)}

    @classmethod
    def from_arrays(cls, params: VectorIVFParams, arrays: dict) -> "IndexIVF":
        from semadb_tpu.utils.grow import next_capacity

        idx = cls(params)
        D = params.vector_size
        idx.centroids = jnp.asarray(arrays["centroids"])
        idx.slab_ids = jnp.asarray(arrays["slab_ids"])
        idx.ovf_ids = jnp.asarray(arrays["ovf_ids"])
        # Row-bounded snapshots persist only the used rows of the rerank
        # matrix; re-pad to the growth-policy bucket ON DEVICE (the
        # padded tail never leaves the device), so post-reopen write
        # shapes match the pre-crash process and hit the compile cache.
        vec = jnp.asarray(arrays["vectors"])
        rows = int(vec.shape[0])
        # Re-pad from the PREGROW-AWARE base (idx.capacity =
        # initial_capacity), exactly the chain the pre-crash process
        # grew along. max(bucket-from-128, pregrow) here lets pregrow
        # 10.07M rows (5.16 GB vectors) lose the max() to the 16.7M
        # growth bucket (8.6 GB) — 3.4 GB the live process never held,
        # spent next to the 6.4 GB slab rebuild.
        cap = max(
            next_capacity(idx.capacity, rows - 1, D * 4)
            if rows
            else idx.capacity,
            rows,
        )
        if cap > rows:
            vec = jnp.pad(vec, ((0, cap - rows), (0, 0)))
        idx.vectors = vec
        idx.capacity = cap
        idx._max_seen = max(rows - 1, 0)
        idx._n_at_fit = int(arrays["n_at_fit"][0])
        idx.slab = idx.slab_ids.shape[1]
        if "proj" in arrays:
            idx._proj = jnp.asarray(arrays["proj"])
            idx.tdim = idx._proj.shape[1]
        else:
            # Pre-projection snapshot (or D ≤ PROJ_DIM): the stored
            # slabs/centroids are in the snapshot's own traversal space —
            # score there, never with this process' fresh random basis
            # (a mismatched basis mis-scores every slab row).
            idx._proj = None
            idx.tdim = (
                int(arrays["slabs"].shape[-1]) if "slabs" in arrays else D
            )
        if "slabs" in arrays:
            idx.slabs = jnp.asarray(arrays["slabs"])
            if "slab_sq" in arrays:
                idx.slab_sq = jnp.asarray(arrays["slab_sq"])
            else:  # pre-round-2 snapshots: recompute
                idx.slab_sq = jnp.sum(
                    jnp.square(idx.slabs.astype(jnp.float32)), axis=-1
                )
            idx.ovf_vecs = jnp.asarray(arrays["ovf_vecs"])
        else:
            # Derived-state snapshot: rebuild slabs/overflow from the
            # rerank matrix with one device gather — the same
            # construction _refit uses, so search behaviour is identical
            # (NIL slots are zeroed here where a live engine may hold
            # stale rows; both are masked out of scoring).
            Cn = int(idx.slab_ids.shape[0])
            bf16 = Cn * idx.slab * idx.tdim * 4 > SLAB_BF16_BYTES
            idx.slabs, idx.slab_sq = _slabs_from_ids(
                idx.vectors, idx.slab_ids, idx._proj,
                out_dtype=jnp.bfloat16 if bf16 else jnp.float32,
                want_sq=idx.metric == C.DISTANCE_EUCLIDEAN,
            )
            ovf_rows = idx.vectors[jnp.clip(idx.ovf_ids, 0, cap - 1)]
            if idx._proj is not None:
                ovf_rows = ovf_rows @ idx._proj
            idx.ovf_vecs = jnp.where(
                (idx.ovf_ids != NIL)[:, None], ovf_rows, 0.0
            )
        if "sup_cents" in arrays:
            idx._sup_cents = jnp.asarray(arrays["sup_cents"])
        if "pq_codebook" in arrays:
            if idx.pq_config is None:
                # Old snapshots encoded PQ above PROJ_DIM (where ADC is
                # now disabled at construction): rebuild the config from
                # the quantizer params so the codes stay readable.
                from semadb_tpu.vectorstore.store import QuantConfig

                q = params.quantizer
                if q is None or q.type != C.QUANTIZER_PRODUCT:
                    raise ValueError(
                        "snapshot holds PQ codes but params carry no "
                        "product quantizer config"
                    )
                idx.pq_config = QuantConfig.from_params(
                    q, params.vector_size, idx.metric
                )
            idx.pq_codebook = jnp.asarray(arrays["pq_codebook"])
            idx.slab_codes = jnp.asarray(arrays["slab_codes"])
            idx.ovf_codes = jnp.asarray(arrays["ovf_codes"])
        # Rebuild host mirrors
        slab_ids = np.asarray(arrays["slab_ids"])
        # _fill is a never-decremented high-water mark (deletes blank slots
        # in place), so it must be rebuilt as last-occupied-slot + 1 — a
        # plain count of live slots would under-shoot past holes and the
        # next insert would clobber a live point's slab row.
        S = slab_ids.shape[1]
        has = slab_ids != NIL
        idx._fill = np.where(
            has.any(axis=1), S - np.argmax(has[:, ::-1], axis=1), 0
        ).astype(np.int32)
        # Overflow first: with assignCopies > 1 an id can sit in overflow
        # (primary spill) AND in slabs (secondary copies) — the slab pass
        # below must file those slab slots under _loc2, not _loc.
        ovf_ids = np.asarray(arrays["ovf_ids"])
        idx._ovf_free = [int(j) for j in np.nonzero(ovf_ids == NIL)[0]]
        for j in np.nonzero(ovf_ids != NIL)[0]:
            idx._loc[int(ovf_ids[j])] = ("o", int(j))
        for c, s in zip(*np.nonzero(has)):
            i = int(slab_ids[c, s])
            if i in idx._loc:
                # duplicate occurrence = SOAR secondary copy (which copy
                # counts as "primary" is arbitrary; deletes blank all)
                idx._loc2.setdefault(i, []).append((int(c), int(s)))
            else:
                idx._loc[i] = ("s", int(c), int(s))
        # Loaded state matches the snapshot it came from: nothing dirty.
        idx.dirty.clear()
        return idx
