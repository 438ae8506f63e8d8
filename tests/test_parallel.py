"""Sharded fan-out search/insert tests on the 8-device virtual CPU mesh.

Mirrors the reference's scatter-gather cluster search semantics
(cluster/actions.go:267-378) on a jax.sharding.Mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from semadb_tpu.index.vamana import IndexVamana, init_graph
from semadb_tpu.index.vamana.graph import GraphConfig
from semadb_tpu.models.schema import VectorVamanaParams
from semadb_tpu.parallel import (
    shard_mesh,
    sharded_insert_step,
    sharded_search,
    stack_states,
)
from semadb_tpu.parallel.fanout import poisson_shard_limit

RNG = np.random.default_rng(3)


def test_poisson_shard_limit():
    # actions.go: targetLimit = limit/numShards*1.42 + 10
    assert poisson_shard_limit(100, 1) == 100
    assert poisson_shard_limit(100, 4) == min(100, int(100 / 4 * 1.42) + 10)


def test_sharded_search_matches_union():
    n_shards = 4
    dim = 8
    per_shard = 100
    mesh = shard_mesh(n_shards)
    params = VectorVamanaParams(
        vector_size=dim, distance_metric="euclidean", search_size=40, degree_bound=32
    )
    states = []
    all_vecs = []
    for s in range(n_shards):
        idx = IndexVamana(params, capacity=256)
        ids = np.arange(2, per_shard + 2, dtype=np.int32)
        vecs = RNG.standard_normal((per_shard, dim)).astype(np.float32)
        idx.insert_update_delete(zip(ids, vecs))
        states.append(idx.state)
        all_vecs.append(vecs)
    stacked = stack_states(states, mesh)

    q = RNG.standard_normal((4, dim)).astype(np.float32)
    k = 10
    d, i, sh = sharded_search(
        stacked,
        jnp.asarray(q),
        GraphConfig(dim=dim, metric="euclidean", degree_bound=32, search_size=40),
        40,
        k,
        mesh,
    )
    d, i, sh = np.asarray(d), np.asarray(i), np.asarray(sh)
    assert d.shape == (4, k)
    # Ground truth over the union of shards
    union = np.concatenate(all_vecs)  # [S*per_shard, dim]
    shard_of = np.repeat(np.arange(n_shards), per_shard)
    local_id = np.tile(np.arange(2, per_shard + 2), n_shards)
    full = ((q[:, None, :] - union[None, :, :]) ** 2).sum(-1)
    order = np.argsort(full, axis=1)[:, :k]
    for b in range(4):
        got = set(zip(sh[b].tolist(), i[b].tolist()))
        want = set(zip(shard_of[order[b]].tolist(), local_id[order[b]].tolist()))
        overlap = len(got & want) / k
        assert overlap >= 0.9, f"query {b}: fan-out overlap {overlap}"
    # distances ascending
    assert np.all(np.diff(d, axis=1) >= 0)


def test_sharded_insert_step():
    n_shards = 8
    dim = 8
    mesh = shard_mesh(n_shards)
    config = GraphConfig(dim=dim, metric="euclidean", degree_bound=32, search_size=32)
    base = init_graph(config, capacity=128)
    states = [base] * n_shards
    stacked = stack_states(states, mesh)

    B = 16
    ids = np.tile(np.arange(2, B + 2, dtype=np.int32)[None, :], (n_shards, 1))
    vecs = RNG.standard_normal((n_shards, B, dim)).astype(np.float32)
    valid = np.ones((n_shards, B), bool)
    out = sharded_insert_step(
        stacked,
        jnp.asarray(ids),
        jnp.asarray(vecs),
        jnp.asarray(valid),
        config,
        32,
        mesh,
    )
    exists = np.asarray(out.exists)
    assert exists.shape == (n_shards, 128)
    assert exists[:, 2 : B + 2].all()
    # search the freshly inserted points
    q = vecs[0, :4]
    d, i, sh = sharded_search(out, jnp.asarray(q), config, 32, 3, mesh)
    i, sh = np.asarray(i), np.asarray(sh)
    for b in range(4):
        assert i[b, 0] == b + 2  # nearest = the point itself (in some shard)


def test_sharded_ivf_search_matches_union():
    """IVF fan-out over the virtual mesh returns the union's exact top-k."""
    import numpy as np

    from semadb_tpu.index.ivf import IndexIVF
    from semadb_tpu.models.schema import VectorIVFParams
    from semadb_tpu.parallel import shard_mesh, sharded_ivf_search, stack_ivf_states

    mesh = shard_mesh(4)
    rng = np.random.default_rng(5)
    params = VectorIVFParams(vector_size=8, distance_metric="euclidean")
    indices, all_vecs = [], []
    for s in range(4):
        idx = IndexIVF(params)
        vecs = rng.standard_normal((600, 8)).astype(np.float32)
        ids = np.arange(2, 602, dtype=np.int32)
        idx.insert_update_delete(zip(ids, vecs))
        assert idx._n_at_fit > 0
        indices.append(idx)
        all_vecs.append(vecs)
    # pad to common shapes (cluster counts match here: same N per shard)
    stacked = stack_ivf_states(indices, mesh)
    q = all_vecs[2][:5]
    d, i, sh = sharded_ivf_search(stacked, jnp.asarray(q), 16, 5, mesh)
    d, i, sh = np.asarray(d), np.asarray(i), np.asarray(sh)
    # global exact top-1 must be the planted self point on shard 2
    assert list(sh[:, 0]) == [2] * 5
    assert list(i[:, 0]) == [2, 3, 4, 5, 6]
    assert np.allclose(d[:, 0], 0, atol=1e-4)
    # distances ascending and consistent with exact union scan for top-3
    union = np.concatenate(all_vecs)
    for b in range(5):
        exact = np.sort(np.sum((union - q[b]) ** 2, -1))[:3]
        np.testing.assert_allclose(d[b, :3], exact, rtol=1e-3, atol=1e-3)


def test_sharded_ivf_equals_local_union_at_scale():
    """The mesh fan-out (shard_map + all-gather merge) must return
    EXACTLY the merge of each shard's local search — the collective path
    adds no loss (actions.go:352-378 merge semantics) — at shapes large
    enough to exercise real slab/probe geometry (8 x 8192 x 64d)."""
    from semadb_tpu.index.ivf import IndexIVF
    from semadb_tpu.models.schema import VectorIVFParams
    from semadb_tpu.parallel import shard_mesh, sharded_ivf_search, stack_ivf_states

    n_shards, per, dim, k, B = 8, 8192, 64, 10, 16
    mesh = shard_mesh(n_shards)
    rng = np.random.default_rng(9)
    params = VectorIVFParams(vector_size=dim, distance_metric="euclidean")
    cents = rng.standard_normal((64, dim)).astype(np.float32) * 5
    indices = []
    for s in range(n_shards):
        lab = rng.integers(0, 64, per)
        vecs = (cents[lab] + rng.standard_normal((per, dim))).astype(np.float32)
        idx = IndexIVF(params)
        idx.insert_update_delete(zip(np.arange(2, per + 2, dtype=np.int32), vecs))
        assert idx._n_at_fit > 0
        indices.append(idx)
    stacked = stack_ivf_states(indices, mesh)
    q = (cents[rng.integers(0, 64, B)] + rng.standard_normal((B, dim))).astype(
        np.float32
    )
    p = 8
    d, i, sh = sharded_ivf_search(stacked, jnp.asarray(q), p, k, mesh)
    d, i, sh = np.asarray(d), np.asarray(i), np.asarray(sh)

    # Local per-shard searches with the same probe count, merged on host
    merged = []
    for s, idx in enumerate(indices):
        ld, li = idx.search_batch(q, k=k, num_probes=p)
        merged.append((ld, li, np.full_like(li, s)))
    md = np.concatenate([m[0] for m in merged], axis=1)
    mi = np.concatenate([m[1] for m in merged], axis=1)
    msh = np.concatenate([m[2] for m in merged], axis=1)
    for b in range(B):
        order = np.argsort(md[b], kind="stable")[:k]
        want = list(zip(md[b][order].tolist(), msh[b][order].tolist(), mi[b][order].tolist()))
        got = list(zip(d[b].tolist(), sh[b].tolist(), i[b].tolist()))
        # distances must match exactly; (shard, id) sets must match
        np.testing.assert_allclose(
            [w[0] for w in want], [g[0] for g in got], rtol=1e-6, atol=1e-5
        )
        assert {(w[1], w[2]) for w in want} == {(g[1], g[2]) for g in got}, b


def _pq_params():
    from semadb_tpu.models.quantizer import ProductQuantizerParams, Quantizer
    from semadb_tpu.models.schema import VectorIVFParams

    return VectorIVFParams(
        vector_size=16, distance_metric="euclidean",
        quantizer=Quantizer(
            type="product",
            product=ProductQuantizerParams(
                num_centroids=16, num_subvectors=4, trigger_threshold=64
            ),
        ),
    )


def _pq_shards(rng, n_shards=2, n=1024):
    from semadb_tpu.index.ivf import IndexIVF

    params = _pq_params()
    indices, corpora = [], []
    for _ in range(n_shards):
        idx = IndexIVF(params)
        vecs = rng.standard_normal((n, 16)).astype(np.float32)
        idx.insert_bulk(np.arange(2, n + 2, dtype=np.int32), vecs)
        indices.append(idx)
        corpora.append(vecs)
    assert all(i.pq_active for i in indices), "PQ never activated: bad fixture"
    return indices, corpora


def test_sharded_ivf_pq_matches_local_union():
    """VERDICT r4 #7: PQ-mode shards ride the mesh fan-out — codes +
    per-shard codebooks are stacked, ADC tables are built per
    (query, shard) inside the shard_map body, and the merged result
    equals the union of each shard's own local PQ search."""
    import numpy as np

    from semadb_tpu.parallel import shard_mesh, stack_ivf_states
    from semadb_tpu.parallel.fanout import sharded_ivf_pq_search

    mesh = shard_mesh(2)
    rng = np.random.default_rng(9)
    indices, _ = _pq_shards(rng)
    stacked = stack_ivf_states(indices, mesh)
    k, p = 8, 12
    q = rng.standard_normal((8, 16)).astype(np.float32)
    import jax.numpy as jnp

    d, i, s = sharded_ivf_pq_search(
        stacked, jnp.asarray(q), p, k, 16, mesh, metric="euclidean"
    )
    d, i, s = np.asarray(d), np.asarray(i), np.asarray(s)
    # local union reference
    for b in range(len(q)):
        cand = []
        for si, idx in enumerate(indices):
            dd, ii = idx.search_batch(q[b : b + 1], k, num_probes=p)
            for dv, iv in zip(np.asarray(dd)[0], np.asarray(ii)[0]):
                if iv >= 0 and np.isfinite(dv):
                    cand.append((float(dv), si, int(iv)))
        cand.sort()
        want = cand[:k]
        got = [
            (float(d[b, j]), int(s[b, j]), int(i[b, j]))
            for j in range(k)
            if i[b, j] >= 0 and np.isfinite(d[b, j])
        ]
        np.testing.assert_allclose(
            [w[0] for w in want], [g[0] for g in got], rtol=1e-5, atol=1e-5
        )
        assert {(w[1], w[2]) for w in want} == {(g[1], g[2]) for g in got}, b


def test_stack_ivf_states_rejects_mixed_pq_fleet():
    """The genuinely un-stackable config: shards in MIXED PQ /
    full-precision modes share no scoring space and must be rejected
    loudly, never silently mis-scored."""
    import numpy as np

    from semadb_tpu.index.ivf import IndexIVF
    from semadb_tpu.models.schema import VectorIVFParams
    from semadb_tpu.parallel import shard_mesh, stack_ivf_states

    mesh = shard_mesh(2)
    rng = np.random.default_rng(9)
    indices, _ = _pq_shards(rng, n_shards=1)
    plain = IndexIVF(
        VectorIVFParams(vector_size=16, distance_metric="euclidean")
    )
    plain.insert_bulk(
        np.arange(2, 514, dtype=np.int32),
        rng.standard_normal((512, 16)).astype(np.float32),
    )
    with pytest.raises(NotImplementedError):
        stack_ivf_states([indices[0], plain], mesh)


def test_sharded_delete_step_repairs_all_shards():
    """Per-shard delete + repair under shard_map: deleted ids vanish from
    results, remaining points stay findable (prune.go:88-154 analog)."""
    import numpy as np

    from semadb_tpu.parallel import (
        shard_mesh,
        sharded_delete_step,
        sharded_insert_step,
        sharded_search,
        stack_states,
    )
    from semadb_tpu.index.vamana import init_graph
    from semadb_tpu.index.vamana.graph import GraphConfig

    S = 4
    config = GraphConfig(dim=8, metric="euclidean", degree_bound=16, search_size=25)
    mesh = shard_mesh(S)
    base = init_graph(config, capacity=64)
    cap = base.capacity  # init_graph rounds up to its minimum capacity
    stacked = stack_states([base] * S, mesh)
    rng = np.random.default_rng(2)
    B = 16
    ids = np.tile(np.arange(2, B + 2, dtype=np.int32)[None], (S, 1))
    vecs = rng.standard_normal((S, B, 8)).astype(np.float32)
    stacked = sharded_insert_step(
        stacked, jnp.asarray(ids), jnp.asarray(vecs),
        jnp.asarray(np.ones((S, B), bool)), config, 25, mesh,
    )
    masks = np.zeros((S, cap), bool)
    masks[:, 2:5] = True
    stacked = sharded_delete_step(stacked, jnp.asarray(masks), config, mesh)
    q = jnp.asarray(vecs[0, 6:10])  # surviving points of shard 0
    d, i, sh = sharded_search(stacked, q, config, 25, 4, mesh)
    i = np.asarray(i)
    assert not np.isin(i, [2, 3, 4]).any(), "deleted ids resurfaced"
    # each query's own point is its top hit, found on shard 0
    assert list(np.asarray(sh)[:, 0]) == [0] * 4
    assert list(i[:, 0]) == [8, 9, 10, 11]
