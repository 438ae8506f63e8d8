"""Vamana index tests.

Mirrors shard/index/vamana/vamana_test.go: insert/search/recall, the BFS
connectivity invariant (every live node reachable from the start node),
delete repair, update-reinsert, filtered search, persistence round-trip.
"""

import numpy as np
import pytest

from semadb_tpu.index.vamana import (
    NIL,
    START_ID,
    IndexVamana,
)
from semadb_tpu.models.schema import VectorVamanaParams

RNG = np.random.default_rng(7)


def make_index(dim=2, metric="euclidean", **kw) -> IndexVamana:
    params = VectorVamanaParams(
        vector_size=dim,
        distance_metric=metric,
        search_size=kw.pop("search_size", 36),
        degree_bound=kw.pop("degree_bound", 32),
        alpha=1.2,
    )
    return IndexVamana(params, **kw)


def rand_points(n, dim=2):
    """2-D random vectors like vamana_test.go randPoints (ids start at 2)."""
    ids = np.arange(2, n + 2, dtype=np.int32)
    vecs = RNG.random((n, dim)).astype(np.float32)
    return ids, vecs


def check_connectivity(idx: IndexVamana):
    """BFS from start node must reach every live node (vamana_test.go:29-46)."""
    adj = np.asarray(idx.state.adjacency)
    exists = np.asarray(idx.state.exists)
    visited = set()
    frontier = [START_ID]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v != NIL and v not in visited:
                    visited.add(int(v))
                    nxt.append(int(v))
        frontier = nxt
    live = {int(i) for i in np.nonzero(exists)[0] if i != START_ID}
    missing = live - visited
    assert not missing, f"disconnected nodes: {sorted(missing)[:10]} (of {len(missing)})"


def test_insert_and_search():
    idx = make_index()
    ids, vecs = rand_points(200)
    idx.insert_update_delete(zip(ids, vecs))
    assert len(idx) == 200
    check_connectivity(idx)
    # Query near known points: nearest must be the point itself
    d, i = idx.search_batch(vecs[:10], k=5)
    assert i.shape == (10, 5)
    assert list(i[:, 0]) == list(ids[:10])
    assert np.all(d[:, 0] < 1e-5)


def test_degree_bound_invariant():
    idx = make_index()
    ids, vecs = rand_points(300)
    idx.insert_update_delete(zip(ids, vecs))
    adj = np.asarray(idx.state.adjacency)
    counts = np.sum(adj != NIL, axis=1)
    assert counts.max() <= idx.config.degree_bound
    # no self-loops, no dangling edges to nonexistent nodes
    exists = np.asarray(idx.state.exists)
    for u in np.nonzero(exists)[0]:
        row = adj[u]
        row = row[row != NIL]
        assert u not in row, f"self-loop at {u}"
        assert all(exists[v] for v in row), f"dangling edge from {u}"
        assert len(set(row.tolist())) == len(row), f"duplicate edges at {u}"


def test_recall_small():
    dim = 16
    n = 1000
    idx = make_index(dim=dim, search_size=75, degree_bound=32)
    ids = np.arange(2, n + 2, dtype=np.int32)
    vecs = RNG.standard_normal((n, dim)).astype(np.float32)
    idx.insert_update_delete(zip(ids, vecs))
    check_connectivity(idx)

    queries = RNG.standard_normal((32, dim)).astype(np.float32)
    d, i = idx.search_batch(queries, k=10)
    # Exact ground truth
    full = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    gt = ids[np.argsort(full, axis=1)[:, :10]]
    recall = np.mean([len(set(i[b]) & set(gt[b])) / 10 for b in range(32)])
    assert recall >= 0.95, f"recall@10 too low: {recall}"


def test_delete_and_connectivity():
    idx = make_index()
    ids, vecs = rand_points(150)
    idx.insert_update_delete(zip(ids, vecs))
    # Delete a third
    dele = ids[::3]
    idx.insert_update_delete((int(i), None) for i in dele)
    assert len(idx) == 150 - len(dele)
    check_connectivity(idx)
    # Deleted ids are gone from results
    d, i = idx.search_batch(vecs[::3][:5], k=10)
    assert not (set(i.flatten().tolist()) & set(int(x) for x in dele))
    # And not present in any edge list
    adj = np.asarray(idx.state.adjacency)
    assert not (set(adj.flatten().tolist()) & set(int(x) for x in dele))


def test_update_moves_point():
    idx = make_index()
    ids, vecs = rand_points(100)
    idx.insert_update_delete(zip(ids, vecs))
    # Move point 2 to a far corner
    target = np.array([100.0, 100.0], dtype=np.float32)
    idx.insert_update_delete([(2, target)])
    assert len(idx) == 100
    check_connectivity(idx)
    d, i = idx.search_batch(target[None, :], k=1)
    assert i[0, 0] == 2
    assert d[0, 0] < 1e-5


def test_delete_then_reinsert():
    idx = make_index()
    ids, vecs = rand_points(100)
    idx.insert_update_delete(zip(ids, vecs))
    idx.insert_update_delete([(int(i), None) for i in ids[:50]])
    idx.insert_update_delete(zip(ids[:50], vecs[:50]))
    assert len(idx) == 100
    check_connectivity(idx)
    d, i = idx.search_batch(vecs[:5], k=1)
    assert list(i[:, 0]) == list(ids[:5])


def test_skip_nonexistent_delete():
    idx = make_index()
    idx.insert_update_delete([(42, None)])  # unknown id + None → skip
    assert len(idx) == 0


def test_reserved_ids_rejected():
    idx = make_index()
    with pytest.raises(ValueError):
        idx.insert_update_delete([(0, np.zeros(2, np.float32))])
    with pytest.raises(ValueError):
        idx.insert_update_delete([(START_ID, np.zeros(2, np.float32))])


def test_filtered_search():
    idx = make_index()
    ids, vecs = rand_points(200)
    idx.insert_update_delete(zip(ids, vecs))
    # Filter to even ids only
    fmask = np.zeros(idx.state.capacity, dtype=bool)
    even = ids[ids % 2 == 0]
    fmask[even] = True
    d, i = idx.search_batch(vecs[:8], k=10, filter_mask=fmask)
    found = i[i != NIL]
    assert len(found) > 0
    assert np.all(found % 2 == 0)
    # A point in the filter searching for itself should find itself
    q_id = int(even[0])
    qv = vecs[q_id - 2][None, :]
    d, i = idx.search_batch(qv, k=1, filter_mask=fmask)
    assert i[0, 0] == q_id


def test_filter_smaller_than_search_size():
    """Extreme selectivity: |filter| < searchSize returns exactly the
    filtered points ordered by distance (search.go:36-40)."""
    idx = make_index()
    ids, vecs = rand_points(100)
    idx.insert_update_delete(zip(ids, vecs))
    fmask = np.zeros(idx.state.capacity, dtype=bool)
    chosen = [2, 30, 77]
    fmask[chosen] = True
    q = vecs[77 - 2][None, :]
    d, i = idx.search_batch(q, k=3, filter_mask=fmask)
    assert set(i[0].tolist()) == set(chosen)
    assert i[0, 0] == 77


def test_persistence_roundtrip():
    idx = make_index()
    ids, vecs = rand_points(50)
    idx.insert_update_delete(zip(ids, vecs))
    arrays = idx.to_arrays()
    idx2 = IndexVamana.from_arrays(idx.params, arrays)
    assert len(idx2) == 50
    d1, i1 = idx.search_batch(vecs[:5], k=3)
    d2, i2 = idx2.search_batch(vecs[:5], k=3)
    assert np.array_equal(i1, i2)


def test_capacity_growth():
    idx = make_index()
    cap0 = idx.state.capacity
    ids = np.arange(2, 400, dtype=np.int32)
    vecs = RNG.random((len(ids), 2)).astype(np.float32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx.state.capacity > cap0
    assert len(idx) == len(ids)
    check_connectivity(idx)


def test_mass_delete_many_components_terminates():
    """A mass delete can fragment the survivors into more mutually-
    unreachable components than the start row holds. The rescue loop must
    terminate (it is iteration-capped and chains representatives) and the
    survivors must stay reachable (no oscillating evictions)."""
    dim = 4
    # Tight, well-separated micro-clusters: survivors of different clusters
    # have essentially no edges between them after the mass delete.
    n_clusters = 80  # > degree_bound (32): more components than start row slots
    per = 6
    cents = RNG.standard_normal((n_clusters, dim)).astype(np.float32) * 100
    vecs = np.repeat(cents, per, axis=0) + 0.01 * RNG.standard_normal(
        (n_clusters * per, dim)
    ).astype(np.float32)
    ids = np.arange(2, len(vecs) + 2, dtype=np.int32)
    idx = make_index(dim=dim, degree_bound=32, search_size=40)
    idx.insert_update_delete(zip(ids, vecs))
    # Keep exactly one point per cluster -> up to 80 singleton components
    keep = ids[::per]
    dele = sorted(set(ids.tolist()) - set(keep.tolist()))
    idx.insert_update_delete((int(i), None) for i in dele)
    assert len(idx) == len(keep)
    check_connectivity(idx)
    # Every survivor is findable by exact-match search
    d, i = idx.search_batch(vecs[::per], k=1, search_size=64)
    assert list(i[:, 0]) == list(keep)


def test_refine_keeps_invariants_and_recall():
    """refine() re-links every node against the current graph: recall must
    hold (within noise) and edges must stay valid/degree-bounded. (At 1M
    scale a naive refine measurably hurts a fresh build's recall — but it
    must remain safe to run.)"""
    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    ds = embedding_like(8000, 32, 64, latent=16, seed=6, spread=0.5)
    ids = np.arange(2, 8002, dtype=np.int32)
    p = VectorVamanaParams(
        vector_size=32, distance_metric="euclidean",
        search_size=75, degree_bound=32, alpha=1.2,
    )
    idx = IndexVamana(p)
    idx.insert_update_delete(zip(ids, ds.train))
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2

    def rec():
        _, i_ = idx.search_batch(ds.test, 10, search_size=75)
        return np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])

    r0 = rec()
    idx.refine()
    r1 = rec()
    assert r1 >= r0 - 0.01, (r0, r1)
    adj = np.asarray(idx.state.adjacency)
    ex = np.asarray(idx.state.exists)
    live_edges = adj[ids]
    ok = (live_edges == -1) | ex[np.clip(live_edges, 0, len(ex) - 1)]
    assert ok.all(), "edge to non-existent node after refine"


def test_insert_bulk_two_pass_invariants_and_recall():
    """insert_bulk runs the two-pass alpha schedule (pass 1 at alpha=1.0,
    pass 2 keep_current re-insertion): the result must beat-or-match the
    single-pass incremental build's recall and hold every graph
    invariant (recall at 1M rose 0.9960 -> 1.0000 at L=75)."""
    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    n = 6000
    ds = embedding_like(n, 32, 64, latent=16, seed=9, spread=0.5)
    ids = np.arange(2, n + 2, dtype=np.int32)
    p = VectorVamanaParams(
        vector_size=32, distance_metric="euclidean",
        search_size=75, degree_bound=32, alpha=1.2,
    )
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2

    def rec(ix):
        _, i_ = ix.search_batch(ds.test, 10, search_size=75)
        return np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])

    import semadb_tpu.index.vamana as V

    assert V.TWO_PASS and n >= V.TWO_PASS_MIN  # two-pass engaged

    idx1 = IndexVamana(p)
    idx1.insert_update_delete(zip(ids, ds.train))  # single-pass incremental
    idx2 = IndexVamana(p)
    idx2.insert_bulk(ids, ds.train)  # two-pass
    r1, r2 = rec(idx1), rec(idx2)
    assert r2 >= r1 - 0.005, f"two-pass regressed recall: {r1} -> {r2}"

    check_connectivity(idx2)
    adj = np.asarray(idx2.state.adjacency)
    ex = np.asarray(idx2.state.exists)
    counts = (adj[ids] != NIL).sum(-1)
    assert counts.max() <= idx2.config.degree_bound
    live_edges = adj[ids]
    ok = (live_edges == NIL) | ex[np.clip(live_edges, 0, len(ex) - 1)]
    assert ok.all(), "edge to non-existent node after two-pass build"
    # no self edges, no duplicate edges within a row
    for r, nid in zip(live_edges[:200], ids[:200]):
        e = r[r != NIL]
        assert nid not in e
        assert len(set(e.tolist())) == len(e)
    # CRUD still works on the bulk-built graph
    idx2.insert_update_delete([(int(ids[0]), None)])
    _, i_ = idx2.search_batch(ds.train[:1], 1, search_size=36)
    assert i_[0][0] != ids[0]


def test_insert_bulk_pool_build_invariants_and_recall():
    """The matmul-built pool build (fastbuild.py: per-cluster exact-kNN
    candidate pools + random long-range candidates, no beam searches)
    must hold every graph invariant and land within noise of the
    search-based two-pass build's recall (20k CPU A/B measured 0.9990
    vs 0.9996)."""
    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    n = 6000
    ds = embedding_like(n, 32, 64, latent=16, seed=9, spread=0.5)
    ids = np.arange(2, n + 2, dtype=np.int32)
    p = VectorVamanaParams(
        vector_size=32, distance_metric="euclidean",
        search_size=75, degree_bound=32, alpha=1.2,
    )
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2

    idx = IndexVamana(p)
    idx.insert_bulk(ids, ds.train, build_mode="pool")
    _, i_ = idx.search_batch(ds.test, 10, search_size=75)
    r = np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])
    assert r >= 0.98, f"pool build recall too low: {r}"

    check_connectivity(idx)
    adj = np.asarray(idx.state.adjacency)
    ex = np.asarray(idx.state.exists)
    counts = (adj[ids] != NIL).sum(-1)
    assert counts.max() <= idx.config.degree_bound
    live_edges = adj[ids]
    ok = (live_edges == NIL) | ex[np.clip(live_edges, 0, len(ex) - 1)]
    assert ok.all(), "edge to non-existent node after pool build"
    for row, nid in zip(live_edges[:200], ids[:200]):
        e = row[row != NIL]
        assert nid not in e
        assert len(set(e.tolist())) == len(e)
    # Incremental CRUD still works on the pool-built graph (delete + search)
    idx.insert_update_delete([(int(ids[0]), None)])
    _, i_ = idx.search_batch(ds.train[:1], 1, search_size=36)
    assert i_[0][0] != ids[0]
    # Fresh inserts go through the beam path and stay findable
    nv = ds.train[:1] + 0.01
    idx.insert_update_delete([(n + 10, nv[0])])
    _, i_ = idx.search_batch(nv, 1, search_size=36)
    assert i_[0][0] == n + 10


def test_pool_build_seeded_refine_schedule(monkeypatch):
    """The recommended fast-build schedule (pool pass 1 → beam refine with
    own-edge seeding, no pool pass 2) holds invariants and recall."""
    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    monkeypatch.setenv("SEMADB_VAMANA_FB_EXPAND", "-1")
    monkeypatch.setenv("SEMADB_VAMANA_FB_REFINE", "1")
    monkeypatch.setenv("SEMADB_VAMANA_FB_SEED_OWN", "1")

    n = 6000
    ds = embedding_like(n, 32, 64, latent=16, seed=11, spread=0.5)
    ids = np.arange(2, n + 2, dtype=np.int32)
    p = VectorVamanaParams(
        vector_size=32, distance_metric="euclidean",
        search_size=75, degree_bound=32, alpha=1.2,
    )
    idx = IndexVamana(p)
    idx.insert_bulk(ids, ds.train, build_mode="pool")

    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2
    _, i_ = idx.search_batch(ds.test, 10, search_size=75)
    r = np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])
    assert r >= 0.98, f"seeded-refine pool build recall too low: {r}"
    check_connectivity(idx)
    adj = np.asarray(idx.state.adjacency)
    assert (adj[ids] != NIL).sum(-1).max() <= idx.config.degree_bound


def test_pool_build_mixed_partition_schedule(monkeypatch):
    """Cross-cluster pool mixing (SEMADB_VAMANA_FB_MIX): the last mix
    assignment slots come from an independent k-means partition so
    true-neighbour pairs straddling a cluster boundary in one partition
    share a cluster in the other. Composed with the backedge top-up and
    multi-rep routing knobs — the full round-5 lever stack must hold
    every graph invariant and stay within noise of the plain pool
    build's recall."""
    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    monkeypatch.setenv("SEMADB_VAMANA_FB_T", "3")
    monkeypatch.setenv("SEMADB_VAMANA_FB_MIX", "1")
    monkeypatch.setenv("SEMADB_VAMANA_FB_TOPUP", "1")
    monkeypatch.setenv("SEMADB_VAMANA_FB_REPS", "2")

    n = 6000
    ds = embedding_like(n, 32, 64, latent=16, seed=13, spread=0.5)
    ids = np.arange(2, n + 2, dtype=np.int32)
    p = VectorVamanaParams(
        vector_size=32, distance_metric="euclidean",
        search_size=75, degree_bound=32, alpha=1.2,
    )
    idx = IndexVamana(p)
    idx.insert_bulk(ids, ds.train, build_mode="pool")

    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2
    _, i_ = idx.search_batch(ds.test, 10, search_size=75)
    r = np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])
    assert r >= 0.98, f"mixed-partition pool build recall too low: {r}"
    check_connectivity(idx)
    adj = np.asarray(idx.state.adjacency)
    ex = np.asarray(idx.state.exists)
    counts = (adj[ids] != NIL).sum(-1)
    assert counts.max() <= idx.config.degree_bound
    live_edges = adj[ids]
    ok = (live_edges == NIL) | ex[np.clip(live_edges, 0, len(ex) - 1)]
    assert ok.all(), "edge to non-existent node after mixed pool build"
    for row, nid in zip(live_edges[:200], ids[:200]):
        e = row[row != NIL]
        assert nid not in e
        assert len(set(e.tolist())) == len(e)


def test_vamana_grow_ahead_warm():
    """ROADMAP round-5 gap #4: the graph engine gets the grow-ahead
    treatment IVF has — occupancy past SEMADB_GROW_AHEAD_FRAC spawns a
    background warmer that AOT-compiles the NEXT bucket's insert kernel,
    so the synchronous bucket crossing pays a pad + cache hit instead of
    a full XLA compile. (The pad itself stays synchronous: graph writes
    are Shard-serialized, there is no engine lock to pad under.)"""
    import time

    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana, required_capacity
    from semadb_tpu.models.schema import VectorVamanaParams

    p = VectorVamanaParams(
        vector_size=8, distance_metric="euclidean",
        search_size=20, degree_bound=8, alpha=1.2,
    )
    rng = np.random.default_rng(0)
    idx = IndexVamana(p)
    cap0 = idx.state.capacity
    assert cap0 == 128
    # 110/128 > 0.8 -> warmer fires after the txn returns
    idx.insert_update_delete(
        [(i + 2, rng.standard_normal(8).astype(np.float32)) for i in range(110)]
    )
    for _ in range(200):
        if idx._grow_thread is None and idx._warm_target:
            break
        time.sleep(0.05)
    assert idx._warm_target == required_capacity(cap0, idx.config), (
        "grow-ahead warm did not run for the next bucket"
    )
    # Capacity itself is unchanged (warm-only) until a write crosses it...
    assert idx.state.capacity == cap0
    big_id = cap0 + 5
    v = rng.standard_normal(8).astype(np.float32)
    idx.insert_update_delete([(big_id, v)])
    assert idx.state.capacity > cap0
    d, i = idx.search_batch(v[None, :], 1)
    assert int(np.asarray(i)[0, 0]) == big_id
    # Direct AOT warm never touches live arrays
    idx.warm_capacity_shapes(idx.state.capacity * 4, buckets=(64,))


def test_pool_build_lean_mode_parity(monkeypatch):
    """The memory-lean pool flow (adopt-first + offset gathers, the
    10M-scale shape) is size-gated (SEMADB_VAMANA_FB_LEAN_BYTES: its
    blocked assignment costs ~2.5x build time at 1M where the second
    corpus copy it avoids is affordable) — force it on and check it
    builds the same-quality graph as the direct path."""
    import numpy as np

    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    monkeypatch.setenv("SEMADB_VAMANA_FB_LEAN_BYTES", "1")
    n = 6000
    ds = embedding_like(n, 32, 64, latent=16, seed=9, spread=0.5)
    ids = np.arange(2, n + 2, dtype=np.int32)
    p = VectorVamanaParams(
        vector_size=32, distance_metric="euclidean",
        search_size=75, degree_bound=32, alpha=1.2,
    )
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2
    idx = IndexVamana(p)
    idx.insert_bulk(ids, ds.train, build_mode="pool")
    _, i_ = idx.search_batch(ds.test, 10, search_size=75)
    r = np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])
    assert r >= 0.98, f"lean pool build recall too low: {r}"
    check_connectivity(idx)
    # Non-contiguous ids can never take the lean flow (offset gathers
    # assume batch row b lives at vecs[b + off]) — still builds fine.
    idx2 = IndexVamana(p)
    ids_gap = np.concatenate([ids[: n // 2], ids[n // 2 :] + 7]).astype(np.int32)
    idx2.insert_bulk(ids_gap, ds.train, build_mode="pool")
    _, i2 = idx2.search_batch(ds.test[:8], 10, search_size=75)
    assert np.asarray(i2).shape == (8, 10)
