"""IVF index tests: recall vs exact scan, CRUD, refit, filters,
persistence round-trip, shard + HTTP integration.

The IVF engine has no reference counterpart (SemaDB ships flat + vamana);
these tests hold it to the same contracts as the other vector indices.
"""

import uuid

import numpy as np
import pytest

from semadb_tpu.index.ivf import IndexIVF
from semadb_tpu.models.quantizer import ProductQuantizerParams, Quantizer
from semadb_tpu.models.schema import IndexSchema, VectorIVFParams

RNG = np.random.default_rng(11)


def make_index(dim=16, metric="euclidean", **kw) -> IndexIVF:
    return IndexIVF(VectorIVFParams(vector_size=dim, distance_metric=metric, **kw))


def clustered(n, dim=16, k=20):
    cents = RNG.standard_normal((k, dim)).astype(np.float32) * 5
    lab = RNG.integers(0, k, n)
    return (cents[lab] + RNG.standard_normal((n, dim)).astype(np.float32)).astype(
        np.float32
    )


def exact_top(vecs, ids, q, k):
    d = np.sum((vecs - q[None, :]) ** 2, axis=-1)
    order = np.argsort(d)[:k]
    return ids[order]


def test_prefit_exact():
    """Below the fit threshold everything lives in the overflow pool and
    search is an exact scan."""
    idx = make_index()
    vecs = clustered(100)
    ids = np.arange(2, 102, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert len(idx) == 100
    d, i = idx.search_batch(vecs[:5], k=3)
    assert list(i[:, 0]) == list(ids[:5])
    assert d[0, 0] == pytest.approx(0.0, abs=1e-4)


def test_fit_and_recall():
    idx = make_index()
    vecs = clustered(3000)
    ids = np.arange(2, 3002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx._n_at_fit > 0, "refit should have triggered"
    queries = vecs[:32]
    d, i = idx.search_batch(queries, k=10)
    hits = 0
    for b in range(32):
        gt = set(exact_top(vecs, ids, queries[b], 10))
        hits += len(gt & set(i[b])) / 10
    assert hits / 32 >= 0.95, f"recall too low: {hits/32}"
    # distances are exact f32 squared euclidean
    self_pos = np.where(i[0] == ids[0])[0]
    assert len(self_pos) and d[0, self_pos[0]] == pytest.approx(0.0, abs=1e-4)


def test_crud_delete_update():
    idx = make_index()
    vecs = clustered(1000)
    ids = np.arange(2, 1002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    # delete the nearest neighbour of query 0 — it must vanish from results
    q = vecs[0]
    idx.insert_update_delete([(2, None)])
    assert len(idx) == 999
    d, i = idx.search_batch(q[None, :], k=5)
    assert 2 not in i[0]
    # update: move point 3 on top of the query
    idx.insert_update_delete([(3, q)])
    d, i = idx.search_batch(q[None, :], k=1)
    assert i[0, 0] == 3 and d[0, 0] == pytest.approx(0.0, abs=1e-4)
    # reinsert 2 far away
    idx.insert_update_delete([(2, np.full(16, 99.0, np.float32))])
    assert len(idx) == 1000


def test_filtered_search():
    idx = make_index()
    vecs = clustered(2000)
    ids = np.arange(2, 2002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    fmask = np.zeros(4096, bool)
    fmask[ids[ids % 2 == 0]] = True
    q = vecs[ids % 2 == 0][:8]
    d, i = idx.search_batch(q, k=5, filter_mask=fmask)
    assert np.all((i == -1) | (i % 2 == 0))
    qids = ids[ids % 2 == 0][:8]
    self_hits = sum(qids[b] in i[b] for b in range(8))
    assert self_hits >= 7


def test_dot_and_cosine_metrics():
    for metric in ("dot", "cosine"):
        idx = make_index(metric=metric)
        vecs = clustered(800)
        if metric == "cosine":
            vecs = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        ids = np.arange(2, 802, dtype=np.int32)
        idx.insert_update_delete(zip(ids, vecs))
        d, i = idx.search_batch(vecs[:4], k=3)
        if metric == "cosine":
            assert np.all(i[:, 0] == ids[:4])
            assert d[0, 0] == pytest.approx(0.0, abs=1e-3)  # 1 - dot(self)
        else:
            # -dot ordering: self need not be top-1, but distances = -dot
            ref = -np.sum(vecs[int(i[0, 0]) - 2] * vecs[0])
            assert d[0, 0] == pytest.approx(ref, rel=1e-3, abs=1e-3)


def test_persistence_roundtrip():
    idx = make_index()
    vecs = clustered(1500)
    ids = np.arange(2, 1502, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    arrays = idx.to_arrays()
    idx2 = IndexIVF.from_arrays(idx.params, arrays)
    assert len(idx2) == len(idx)
    q = vecs[:4]
    d1, i1 = idx.search_batch(q, k=5)
    d2, i2 = idx2.search_batch(q, k=5)
    np.testing.assert_array_equal(i1, i2)
    # and the restored index still accepts writes
    idx2.insert_update_delete([(5000, vecs[0])])
    d, i = idx2.search_batch(vecs[0][None, :], k=2)
    assert 5000 in i[0]


def test_persistence_roundtrip_after_delete_keeps_live_points():
    """_fill must be restored as a high-water mark, not a live-slot count:
    deletes blank slab slots in place, so a count would under-shoot past
    holes and the next insert would overwrite a live point's slab row."""
    idx = make_index()
    vecs = clustered(1500)
    ids = np.arange(2, 1502, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx._n_at_fit > 0
    # Delete points that sit in slab slots *below* their cluster's HWM
    slab_ids = np.asarray(idx.slab_ids)
    victims = []
    for c in range(slab_ids.shape[0]):
        live = np.nonzero(slab_ids[c] != -1)[0]
        if len(live) >= 2:
            victims.append(int(slab_ids[c, live[0]]))  # lowest slot, hole below HWM
        if len(victims) >= 8:
            break
    assert victims, "test setup: need clusters with >=2 slab members"
    idx.insert_update_delete([(v, None) for v in victims])

    idx2 = IndexIVF.from_arrays(idx.params, idx.to_arrays())
    np.testing.assert_array_equal(idx2._fill, idx._fill)

    # Insert new points into the reloaded index: no live point may vanish
    new_ids = np.arange(5000, 5064, dtype=np.int32)
    new_vecs = clustered(64)
    idx2.insert_update_delete(zip(new_ids, new_vecs))
    survivors = [int(i) for i in ids if int(i) not in victims]
    assert len(idx2) == len(survivors) + len(new_ids)
    # Every survivor must still be findable by exact-match search
    surv_set = set(survivors)
    sample = survivors[:: max(1, len(survivors) // 50)]
    svecs = np.stack([vecs[s - 2] for s in sample])
    d, i = idx2.search_batch(svecs, k=1)
    for row, nid in zip(i, sample):
        assert row[0] == nid, f"live point {nid} vanished after reload+insert"
    # And the slab ids referenced by _loc must agree with the device arrays
    slab_ids2 = np.asarray(idx2.slab_ids)
    for nid, loc in idx2._loc.items():
        if loc[0] == "s":
            assert slab_ids2[loc[1], loc[2]] == nid
    assert surv_set <= set(idx2._loc.keys())


def test_schema_validation():
    schema = IndexSchema.from_dict(
        {
            "emb": {
                "type": "vectorIVF",
                "vectorIVF": {"vectorSize": 16, "distanceMetric": "euclidean"},
            }
        }
    )
    schema.validate()
    with pytest.raises(Exception):
        IndexSchema.from_dict(
            {
                "emb": {
                    "type": "vectorIVF",
                    "vectorIVF": {"vectorSize": 2, "distanceMetric": "haversine"},
                }
            }
        ).validate()
    pm = {"emb": [0.0] * 16}
    schema.check_compatible_map(pm)
    with pytest.raises(Exception):
        schema.check_compatible_map({"emb": [0.0] * 3})


def test_shard_and_http_integration(tmp_path):
    """vectorIVF through the full stack: shard CRUD + HTTP v2 search."""
    import requests

    from semadb_tpu.cluster.node import ClusterNode, ClusterNodeConfig
    from semadb_tpu.httpapi.server import HttpApiConfig, HttpServer
    from semadb_tpu.models.collection import UserPlan

    node = ClusterNode(
        ClusterNodeConfig(root_dir=str(tmp_path), rpc_host="127.0.0.1", rpc_port=0)
    )
    node.serve()
    cfg = HttpApiConfig(
        http_host="127.0.0.1",
        http_port=0,
        user_plans={"BASIC": UserPlan(name="BASIC", max_collections=2)},
    )
    srv = HttpServer(node, cfg)
    srv.serve_background()
    base = f"http://127.0.0.1:{srv.port}"
    H = {"X-User-Id": "ivfu", "X-Plan-Id": "BASIC"}
    try:
        r = requests.post(
            f"{base}/v2/collections",
            json={
                "id": "ivfcol",
                "indexSchema": {
                    "emb": {
                        "type": "vectorIVF",
                        "vectorIVF": {"vectorSize": 8, "distanceMetric": "euclidean"},
                    },
                    "tag": {"type": "string", "string": {"caseSensitive": False}},
                },
            },
            headers=H,
        )
        assert r.status_code == 200, r.text
        vecs = clustered(300, dim=8)
        pts = [
            {"emb": vecs[j].tolist(), "tag": "even" if j % 2 == 0 else "odd"}
            for j in range(300)
        ]
        pts[7]["_id"] = str(uuid.UUID(int=7))
        r = requests.post(
            f"{base}/v2/collections/ivfcol/points", json={"points": pts}, headers=H
        )
        assert r.status_code == 200, r.text
        r = requests.post(
            f"{base}/v2/collections/ivfcol/points/search",
            json={
                "query": {
                    "property": "emb",
                    "vectorIVF": {
                        "vector": vecs[7].tolist(),
                        "operator": "near",
                        "limit": 3,
                    },
                },
                "limit": 3,
            },
            headers=H,
        )
        assert r.status_code == 200, r.text
        got = r.json()["points"]
        assert got[0]["_id"] == str(uuid.UUID(int=7))
        assert got[0]["_distance"] == pytest.approx(0.0, abs=1e-4)
        # filtered
        r = requests.post(
            f"{base}/v2/collections/ivfcol/points/search",
            json={
                "query": {
                    "property": "emb",
                    "vectorIVF": {
                        "vector": vecs[8].tolist(),
                        "operator": "near",
                        "limit": 3,
                        "filter": {
                            "property": "tag",
                            "string": {"value": "odd", "operator": "equals"},
                        },
                    },
                },
                "limit": 3,
                "select": ["*"],
            },
            headers=H,
        )
        assert r.status_code == 200, r.text
        assert all(p["tag"] == "odd" for p in r.json()["points"])
    finally:
        srv.shutdown()
        node.close()


def test_highly_selective_filter_exact():
    """A filter much smaller than the probe budget must return ALL its
    nearest members even when their clusters would never be probed
    (routed to the exact masked scan)."""
    idx = make_index()
    vecs = clustered(3000)
    ids = np.arange(2, 3002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx._n_at_fit > 0
    # 12 members scattered across the id space
    members = ids[::250]
    fmask = np.zeros(4096, bool)
    fmask[members] = True
    q = RNG.standard_normal((4, 16)).astype(np.float32)
    d, i = idx.search_batch(q, k=5, filter_mask=fmask)
    member_set = set(int(m) for m in members)
    for b in range(4):
        got = [x for x in i[b] if x != -1]
        assert set(got) <= member_set
        # must equal the exact top-5 among members
        mv = vecs[members - 2]
        exact = members[np.argsort(np.sum((mv - q[b]) ** 2, -1))[:5]]
        assert got == [int(x) for x in exact]
    # deleted members never resurface through the masked scan
    idx.insert_update_delete([(int(members[0]), None)])
    d, i = idx.search_batch(q, k=5, filter_mask=fmask)
    assert int(members[0]) not in set(i.flatten().tolist())


def make_pq_index(dim=32, metric="euclidean", m=8, trigger=512, **kw) -> IndexIVF:
    return IndexIVF(
        VectorIVFParams(
            vector_size=dim,
            distance_metric=metric,
            quantizer=Quantizer(
                type="product",
                product=ProductQuantizerParams(
                    num_centroids=64, num_subvectors=m, trigger_threshold=trigger
                ),
            ),
            **kw,
        )
    )


def test_ivfpq_fit_recall_and_memory():
    """IVF-PQ: codes replace f32 slabs after the codebook fits; ADC + f32
    rerank keeps recall@10 high; the f32 slab arrays shrink to placeholders
    (the memory point of PQ, product.go:136-169)."""
    dim = 32
    idx = make_pq_index(dim=dim)
    vecs = clustered(4000, dim=dim)
    ids = np.arange(2, 4002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx.pq_active, "codebook should have fitted at the trigger"
    assert idx.slab_codes.shape[-1] == 8  # M subvector codes
    assert idx.slabs.shape[0] == 1, "f32 slabs must shrink in PQ mode"
    assert idx.ovf_vecs.shape[0] == 1
    queries = vecs[:32]
    d, i = idx.search_batch(queries, k=10)
    hits = 0
    for b in range(32):
        gt = set(exact_top(vecs, ids, queries[b], 10))
        hits += len(gt & set(int(x) for x in i[b]))
    recall = hits / 320
    assert recall >= 0.9, f"IVF-PQ recall@10 too low: {recall}"


def test_ivfpq_crud_after_fit():
    idx = make_pq_index()
    vecs = clustered(2000, dim=32)
    ids = np.arange(2, 2002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx.pq_active
    # post-fit inserts are PQ-encoded into slabs/overflow
    new = clustered(50, dim=32)
    new_ids = np.arange(9000, 9050, dtype=np.int32)
    idx.insert_update_delete(zip(new_ids, new))
    d, i = idx.search_batch(new[:5], k=1)
    assert list(i[:, 0]) == list(new_ids[:5])
    # deletes remove from results
    idx.insert_update_delete([(9000, None)])
    d, i = idx.search_batch(new[:1], k=3)
    assert 9000 not in i[0]
    # updates move the point
    idx.insert_update_delete([(9001, vecs[0] + 100.0)])
    d, i = idx.search_batch((vecs[0] + 100.0)[None, :], k=1)
    assert i[0, 0] == 9001


def test_ivfpq_persistence_roundtrip():
    idx = make_pq_index()
    vecs = clustered(1500, dim=32)
    ids = np.arange(2, 1502, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx.pq_active
    idx2 = IndexIVF.from_arrays(idx.params, idx.to_arrays())
    assert idx2.pq_active
    d1, i1 = idx.search_batch(vecs[:4], k=5)
    d2, i2 = idx2.search_batch(vecs[:4], k=5)
    np.testing.assert_array_equal(i1, i2)
    idx2.insert_update_delete([(5000, vecs[0])])
    d, i = idx2.search_batch(vecs[0][None, :], k=2)
    assert 5000 in i[0]


def test_ivf_filtered_member_gather():
    """Selective filters use the member-gather scan (O(members)): results
    must contain only live filter members, exactly ranked."""
    idx = make_index()
    vecs = clustered(2000)
    ids = np.arange(2, 2002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    members = ids[::37]
    fm = np.zeros(int(ids.max()) + 1, bool)
    fm[members] = True
    # also include a deleted id in the filter: must not be returned
    idx.insert_update_delete([(int(members[1]), None)])
    d, i = idx.search_batch(vecs[:8], k=5, filter_mask=fm)
    live_members = set(int(x) for x in members) - {int(members[1])}
    for b in range(8):
        got = [int(x) for x in i[b] if x != -1]
        assert set(got) <= live_members
        gt = exact_top(
            np.stack([vecs[m - 2] for m in sorted(live_members)]),
            np.array(sorted(live_members), np.int32),
            vecs[b], 5,
        )
        assert got == list(gt)


def test_ivf_member_scan_chunked_matches_flat():
    """The chunked member scan (members past one matmul's budget) must
    return bit-identical results to the single-matmul exact path."""
    import jax.numpy as jnp

    from semadb_tpu.index.ivf import _member_scan_chunked_host

    idx = make_index()
    vecs = clustered(2000)
    ids = np.arange(2, 2002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    members = ids[::3]
    fm = np.zeros(int(ids.max()) + 1, bool)
    fm[members] = True
    q = vecs[:8]
    # reference: the (tested-exact) single-path member scan
    d_ref, i_ref = idx._member_exact(jnp.asarray(q), 5, fm)
    # force chunking with a tiny chunk_cap that doesn't divide the count
    live = np.array(sorted(set(int(x) for x in members)), np.int32)
    d_ch, i_ch = _member_scan_chunked_host(
        idx.vectors, live, jnp.asarray(q), 5, idx.metric, chunk_cap=96
    )
    assert np.array_equal(np.asarray(i_ref), np.asarray(i_ch))
    # distances agree to f32 matmul-split tolerance (chunked reductions
    # round differently from the single big matmul)
    np.testing.assert_allclose(
        np.asarray(d_ref), np.asarray(d_ch), rtol=2e-3, atol=2e-3
    )


def test_ivf_broad_filter_routes_exact(monkeypatch):
    """With FILTER_EXACT_CAP covering a broad (50%) filter, search_batch
    routes through the exact member scan and returns the exact filtered
    top-k (chunked-scan numerics are covered by the test above)."""
    from semadb_tpu.index import ivf as ivf_mod

    idx = make_index()
    vecs = clustered(3000)
    ids = np.arange(2, 3002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    members = ids[ids % 2 == 0]  # 50% selectivity — a broad filter
    fm = np.zeros(4096, bool)
    fm[members] = True
    monkeypatch.setattr(ivf_mod, "FILTER_EXACT_CAP", 2048)
    q = vecs[:8]
    d, i = idx.search_batch(q, k=5, filter_mask=fm)
    member_set = set(int(m) for m in members)
    for b in range(8):
        got = [int(x) for x in i[b] if x != -1]
        assert set(got) <= member_set
        gt = exact_top(vecs[members - 2], members.astype(np.int32), q[b], 5)
        assert got == list(gt)


def test_ivfpq_schema_rejects_binary():
    import pytest as _pytest

    from semadb_tpu.models.errors import ValidationError
    from semadb_tpu.models.quantizer import BinaryQuantizerParams

    p = VectorIVFParams(
        vector_size=32,
        distance_metric="euclidean",
        quantizer=Quantizer(type="binary", binary=BinaryQuantizerParams()),
    )
    with _pytest.raises(ValidationError):
        p.validate()


def test_soar_copies_improve_recall_and_dedup():
    """assignCopies=2 (SOAR-style spilled assignment) must strictly help
    recall at equal probe count, return no duplicate ids, and survive
    delete/update/persistence with all copies accounted for."""
    from semadb_tpu.tools.datasets import embedding_like

    N, D = 3000, 32
    ds = embedding_like(N, D, 32, latent=16, seed=5)
    ids = np.arange(2, N + 2, dtype=np.int32)
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2

    recs = {}
    for copies in (1, 2):
        idx = make_index(dim=D, assign_copies=copies)
        idx.insert_update_delete(zip(ids, ds.train))
        d_, i_ = idx.search_batch(ds.test, 10, num_probes=8)
        recs[copies] = np.mean(
            [len(set(i_[b]) & set(gt[b])) / 10 for b in range(len(ds.test))]
        )
        for b in range(len(ds.test)):
            live = i_[b][i_[b] >= 0]
            assert len(set(live.tolist())) == len(live), "duplicate id in results"
    assert recs[2] > recs[1] + 0.01, recs
    assert len(idx._loc2) > 0  # secondaries actually placed

    # deletes remove every copy
    victims = ids[:150]
    idx.insert_update_delete((int(v), None) for v in victims)
    assert not any(int(v) in idx._loc2 for v in victims)
    _, i2 = idx.search_batch(ds.train[:16], 5, num_probes=16)
    assert not set(victims.tolist()) & {int(x) for x in i2.flatten()}

    # persistence: reload gives identical results; inserts after reload
    # never clobber live slots (secondary copies counted in the fill HWM)
    idx2 = IndexIVF.from_arrays(idx.params, idx.to_arrays())
    _, a = idx.search_batch(ds.test, 10, num_probes=16)
    _, b = idx2.search_batch(ds.test, 10, num_probes=16)
    assert np.array_equal(a, b)
    before = idx2.search_batch(ds.train[200:264], 1)[1][:, 0]
    idx2.insert_update_delete(
        (90001 + t, RNG.standard_normal(D).astype(np.float32)) for t in range(50)
    )
    after = idx2.search_batch(ds.train[200:264], 1)[1][:, 0]
    assert np.array_equal(before, after)


def test_spill_relocation_keeps_overflow_empty():
    """Primary spill relocates to the next-nearest cluster with room
    instead of the overflow pool: overflow is a DENSE every-query matmul,
    and heavy-tailed kmeans cluster sizes would put percent-scale point
    counts there. After a refit only points
    whose top-4 clusters are all full may remain — none, at sane fills."""
    from semadb_tpu.tools.datasets import embedding_like

    ds = embedding_like(20000, 32, 8, latent=16, seed=7)
    ids = np.arange(2, 20002, dtype=np.int32)
    for copies in (1, 2):
        idx = make_index(dim=32, assign_copies=copies)
        idx.insert_update_delete(zip(ids, ds.train))
        n_ovf = sum(1 for l in idx._loc.values() if l[0] == "o")
        assert n_ovf <= len(ids) // 1000, (copies, n_ovf)
        # every id is still findable (self-query hits itself)
        _, i_ = idx.search_batch(ds.train[:32], 1, num_probes=8)
        assert (i_[:, 0] == ids[:32]).mean() > 0.9


def test_highdim_projected_traversal():
    """Above PROJ_DIM the engine scores slabs in a random-orthonormal
    projection (ADC table lookups are gather-bound) while the rerank stays
    exact f32. Recall, persistence, and CRUD must hold; a product
    quantizer config must route to the projected path too."""
    from semadb_tpu.tools.datasets import embedding_like

    N, D = 4000, 256
    ds = embedding_like(N, D, 64, latent=32, seed=13, spread=0.5)
    ids = np.arange(2, N + 2, dtype=np.int32)
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2

    quant = Quantizer(
        type="product",
        product=ProductQuantizerParams(
            num_centroids=256, num_subvectors=16, trigger_threshold=1000
        ),
    )
    for q in (None, quant):
        idx = make_index(dim=D, assign_copies=2, quantizer=q)
        idx.insert_update_delete(zip(ids, ds.train))
        assert idx._proj is not None and idx.slabs.shape[-1] == 128
        assert not idx.pq_active  # ADC disabled above PROJ_DIM
        d_, i_ = idx.search_batch(ds.test, 10, num_probes=16)
        rec = np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])
        assert rec >= 0.95, rec

    # roundtrip preserves the projection and results exactly
    idx2 = IndexIVF.from_arrays(idx.params, idx.to_arrays())
    _, a = idx.search_batch(ds.test, 10, num_probes=16)
    _, b = idx2.search_batch(ds.test, 10, num_probes=16)
    assert np.array_equal(a, b)

    # CRUD through the projected path
    idx.insert_update_delete([(2, None)])
    _, i3 = idx.search_batch(ds.train[:4], 3, num_probes=16)
    assert 2 not in set(i3.flatten().tolist())
    nv = RNG.standard_normal(D).astype(np.float32)
    idx.insert_update_delete([(70001, nv)])
    _, i4 = idx.search_batch(nv, 1, num_probes=16)
    assert i4[0][0] == 70001


def test_shard_ivf_assign_copies_e2e(tmp_path):
    """assignCopies flows schema -> shard dispatch -> device index ->
    persistence: search returns the exact point before and after a shard
    reload, and the reloaded engine still carries secondary copies."""
    import uuid as _uuid

    from semadb_tpu.models import Collection, Point, UserPlan
    from semadb_tpu.models.query import SearchRequest
    from semadb_tpu.shard import Shard
    from semadb_tpu.store import open_store

    s = IndexSchema.from_dict({"v": {"type": "vectorIVF", "vectorIVF": {
        "vectorSize": 24, "distanceMetric": "euclidean", "assignCopies": 2}}})
    s.validate()
    col = Collection(user_id="u1", id="c1", index_schema=s, user_plan=UserPlan())
    path = str(tmp_path / "s1")
    sh = Shard(open_store(path), col)
    vecs = RNG.standard_normal((800, 24)).astype(np.float32)
    pts = [
        Point.from_map({"v": vecs[i].tolist()}, _uuid.UUID(int=i + 1))
        for i in range(800)
    ]
    sh.insert_points(pts)
    req = SearchRequest.from_dict({"query": {"property": "v", "vectorIVF": {
        "vector": vecs[5].tolist(), "limit": 3}}, "limit": 3})
    res = sh.search_points(req)
    assert res[0].point.id == _uuid.UUID(int=6)
    sh.flush()
    sh.close()
    sh2 = Shard(open_store(path), col)
    res2 = sh2.search_points(req)
    assert res2[0].point.id == _uuid.UUID(int=6)
    sh2.close()


def test_bf16_slab_traversal(monkeypatch):
    """Past SLAB_BF16_BYTES the traversal slabs store bf16 (norms stay
    f32, rerank exact f32): recall must hold, incremental inserts must
    keep slab_sq consistent, and persistence must round-trip the dtype."""
    import jax.numpy as jnp

    import semadb_tpu.index.ivf as ivfmod
    from semadb_tpu.tools.datasets import embedding_like

    monkeypatch.setattr(ivfmod, "SLAB_BF16_BYTES", 1)
    ds = embedding_like(6000, 32, 64, latent=16, seed=8, spread=0.5)
    ids = np.arange(2, 6002, dtype=np.int32)
    idx = ivfmod.IndexIVF(
        VectorIVFParams(vector_size=32, distance_metric="euclidean", assign_copies=2)
    )
    idx.insert_update_delete(zip(ids, ds.train))
    assert idx.slabs.dtype == jnp.bfloat16
    dd = (
        (ds.test[:, None, :].astype(np.float64) - ds.train[None].astype(np.float64))
        ** 2
    ).sum(-1)
    gt = np.argsort(dd, 1)[:, :10] + 2
    _, i_ = idx.search_batch(ds.test, 10, num_probes=16)
    rec = np.mean([len(set(i_[b]) & set(gt[b])) / 10 for b in range(64)])
    assert rec >= 0.98, rec
    # post-fit inserts land in bf16 slabs with a consistent norm cache
    nv = RNG.standard_normal(32).astype(np.float32)
    idx.insert_update_delete([(90001, nv)])
    _, hit = idx.search_batch(nv, 1, num_probes=24)
    assert hit[0][0] == 90001
    idx2 = ivfmod.IndexIVF.from_arrays(idx.params, idx.to_arrays())
    assert idx2.slabs.dtype == jnp.bfloat16
    _, a = idx.search_batch(ds.test, 10, num_probes=16)
    _, b = idx2.search_batch(ds.test, 10, num_probes=16)
    assert np.array_equal(a, b)


def test_chunked_overflow_scan(monkeypatch):
    """Past OVF_CHUNK_BYTES the overflow scan blocks the [B, O] distance
    matrix and carries per-chunk top slices — results must stay exact for
    self-queries (a pathological pool at 10M scale would otherwise need a
    48 GB buffer and fail to compile)."""
    import semadb_tpu.index.ivf as ivfmod

    monkeypatch.setattr(ivfmod, "OVF_CHUNK_BYTES", 1)
    vecs = RNG.standard_normal((300, 32)).astype(np.float32)
    ids = np.arange(2, 302, dtype=np.int32)
    idx = ivfmod.IndexIVF(
        VectorIVFParams(vector_size=32, distance_metric="euclidean")
    )
    idx.insert_update_delete(zip(ids, vecs))  # below MIN_FIT: all overflow
    d, i = idx.search_batch(vecs[:8], 5)
    assert (i[:, 0] == ids[:8]).all()
    exact = exact_top(vecs, ids, vecs[3], 5)
    assert [int(x) for x in i[3]] == list(exact)


def test_deferred_fit_placeholder_delete_then_flush():
    """Regression (advisor r2): a delete arriving between a defer_fit bulk
    insert and flush_pending must not blank real overflow slots via the
    ("o", -1) placeholder, and flush_pending must materialise the rest."""
    idx = make_index(dim=8)
    n = 600  # past MIN_FIT so bulk insert defers a real fit
    vecs = clustered(n, dim=8)
    ids = np.arange(2, 2 + n, dtype=np.int32)
    idx.insert_bulk(ids, vecs, defer_fit=True)
    assert idx._has_placeholders()
    # Delete a handful of placeholder points before the deferred fit runs
    idx.insert_update_delete([(int(i), None) for i in ids[:5]])
    assert -1 not in idx._ovf_free, "placeholder leaked into the free list"
    idx.flush_pending()
    assert not idx._has_placeholders()
    assert len(idx) == n - 5
    # Remaining points are searchable; deleted ones are gone
    d, i = idx.search_batch(vecs[5:10], k=1)
    assert list(i[:, 0]) == list(ids[5:10])
    d, i = idx.search_batch(vecs[:5], k=3)
    assert not (set(ids[:5].tolist()) & set(i.ravel().tolist()))


def test_deferred_fit_to_arrays_materialises():
    """to_arrays during the placeholder window must not silently drop
    points from the snapshot (advisor r2)."""
    idx = make_index(dim=8)
    n = 600
    vecs = clustered(n, dim=8)
    ids = np.arange(2, 2 + n, dtype=np.int32)
    idx.insert_bulk(ids, vecs, defer_fit=True)
    assert idx._has_placeholders()
    snap = idx.to_arrays()
    idx2 = IndexIVF.from_arrays(idx.params, snap)
    assert len(idx2) == n
    _, i = idx2.search_batch(vecs[:5], k=1)
    assert list(i[:, 0]) == list(ids[:5])


def test_from_arrays_highdim_snapshot_without_proj():
    """Pre-round-2 snapshot compatibility (advisor r2): a snapshot with
    full-D slabs and no stored projection must be scored full-D, not with
    this process' fresh random basis."""
    import jax.numpy as jnp

    D = 160  # > PROJ_DIM(128): constructor would normally build a proj
    idx = make_index(dim=D)
    n = 700
    vecs = clustered(n, dim=D)
    ids = np.arange(2, 2 + n, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    snap = idx.to_arrays()
    # Simulate an old snapshot: full-D traversal arrays, no "proj" key
    assert "proj" in snap
    del snap["proj"]
    # Rebuild true full-D traversal state from the vectors matrix
    vec_np = snap["vectors"]
    slab_ids = snap["slab_ids"]
    full = vec_np[np.clip(slab_ids, 0, vec_np.shape[0] - 1)]
    full[slab_ids == -1] = 0.0
    snap["slabs"] = full.astype(np.float32)
    snap["slab_sq"] = np.sum(full.astype(np.float32) ** 2, axis=-1)
    ovf_ids = snap["ovf_ids"]
    ovf_full = vec_np[np.clip(ovf_ids, 0, vec_np.shape[0] - 1)].astype(np.float32)
    ovf_full[ovf_ids == -1] = 0.0
    snap["ovf_vecs"] = ovf_full
    # centroids: recompute per-cluster means in full-D space
    C_n = slab_ids.shape[0]
    sums = np.zeros((C_n, D), np.float32)
    cnt = np.zeros(C_n, np.float32)
    for c in range(C_n):
        live = slab_ids[c] != -1
        cnt[c] = max(live.sum(), 1)
        sums[c] = full[c][live].sum(axis=0)
    snap["centroids"] = (sums / cnt[:, None]).astype(np.float32)
    idx2 = IndexIVF.from_arrays(idx.params, snap)
    assert idx2._proj is None and idx2.tdim == D
    _, i = idx2.search_batch(vecs[:8], k=1)
    assert list(i[:, 0]) == list(ids[:8])


def test_two_level_coarse_quantizer(monkeypatch):
    """Cluster counts past the flat-fit ceiling use the hierarchical
    (super -> children) fit + grouped assignment; the flat centroid
    layout keeps the query path identical, probe selection chunks over
    C, and recall must hold up vs the exact scan."""
    import semadb_tpu.index.ivf as ivfmod

    monkeypatch.setattr(ivfmod, "TWO_LEVEL_MIN_C", 64)
    monkeypatch.setattr(ivfmod, "TWO_LEVEL_SUPERS", 8)
    monkeypatch.setattr(ivfmod, "PROBE_CHUNK_BYTES", 1)
    monkeypatch.setattr(ivfmod, "PROBE_CHUNK_C", 32)
    idx = ivfmod.IndexIVF(
        VectorIVFParams(
            vector_size=16, distance_metric="euclidean",
            num_clusters=128, assign_copies=2,
        )
    )
    vecs = clustered(4000, dim=16, k=30)
    ids = np.arange(2, 4002, dtype=np.int32)
    idx.insert_update_delete(zip(ids, vecs))
    assert idx._sup_cents is not None, "two-level path not taken"
    assert idx.centroids.shape[0] == 128
    queries = vecs[:32]
    d, i = idx.search_batch(queries, k=10, num_probes=24)
    hits = sum(
        len(set(exact_top(vecs, ids, queries[b], 10)) & set(i[b])) / 10
        for b in range(32)
    )
    assert hits / 32 >= 0.95, f"two-level recall too low: {hits/32}"
    # incremental insert via the two-level assign path
    nv = RNG.standard_normal(16).astype(np.float32)
    idx.insert_update_delete([(9000, nv)])
    _, hit = idx.search_batch(nv, 1, num_probes=24)
    assert hit[0][0] == 9000
    # persistence carries the super layer
    idx2 = ivfmod.IndexIVF.from_arrays(idx.params, idx.to_arrays())
    assert idx2._sup_cents is not None
    _, a = idx.search_batch(queries, 10, num_probes=16)
    _, b = idx2.search_batch(queries, 10, num_probes=16)
    assert np.array_equal(a, b)


def test_auto_slab_growth():
    """Refit grows the slab depth when SOAR copies would saturate the slot
    pool (the 10M recall fix), bounded by the HBM slab budget; explicit
    slabSize stays fixed."""
    from semadb_tpu.index.ivf import _auto_slab

    # 10M x 128d / C=131072 / copies=2: need = ceil(2*10e6/131072*1.25/64)*64
    # = 256, capped by the 7 GiB bf16 budget at 192.
    assert _auto_slab(2, 10_000_000, 131072, 128, 128) == 192
    # Small corpora never shrink below the configured depth.
    assert _auto_slab(2, 1000, 128, 16, 128) == 128
    # Plenty of budget at small C: need wins.
    assert _auto_slab(2, 1_000_000, 4096, 128, 64) == 640
    # n=0 (pre-fit refit) leaves the depth untouched.
    assert _auto_slab(2, 0, 128, 16, 128) == 128

    # Integration: auto-slab index (no explicit slabSize) grows on refit
    # when copies*n/C overflows the default depth.
    idx = IndexIVF(
        VectorIVFParams(
            vector_size=16, distance_metric="euclidean",
            num_clusters=16, assign_copies=2,
        )
    )
    assert idx.slab == 128  # DEFAULT_SLAB * copies
    vecs = clustered(4096, dim=16, k=16)
    idx.insert_update_delete(zip(np.arange(2, 4098, dtype=np.int32), vecs))
    # 2 * 4096 / 16 * 1.25 = 640 placements/cluster -> slab grew
    assert idx.slab >= 640
    assert idx.slabs.shape[1] == idx.slab
    _, i = idx.search_batch(vecs[:8], k=1, num_probes=8)
    assert np.array_equal(i[:, 0], np.arange(2, 10))

    # Explicit slabSize is never auto-grown.
    idx2 = IndexIVF(
        VectorIVFParams(
            vector_size=16, distance_metric="euclidean",
            num_clusters=16, assign_copies=2, slab_size=512,
        )
    )
    idx2.insert_update_delete(zip(np.arange(2, 4098, dtype=np.int32), vecs))
    assert idx2.slab == 512


def test_grow_ahead_and_pregrow():
    """VERDICT r4 #3: capacity growth must not land inside a user write
    txn. (a) occupancy past SEMADB_GROW_AHEAD_FRAC spawns a background
    grower that pre-pads to the next bucket; (b) SEMADB_PREGROW_ROWS
    starts the engine at final capacity so growth never happens."""
    import time

    import semadb_tpu.utils.grow as grow
    from semadb_tpu.models.schema import VectorIVFParams

    p = VectorIVFParams(vector_size=8, distance_metric="euclidean")
    rng = np.random.default_rng(0)
    idx = IndexIVF(p)
    assert idx.capacity == 128
    # 110/128 > 0.8 -> grower fires after the txn returns
    idx.insert_update_delete(
        [(i + 2, rng.standard_normal(8).astype(np.float32)) for i in range(110)]
    )
    for _ in range(100):
        if idx._grow_thread is None and idx.capacity > 128:
            break
        time.sleep(0.05)
    assert idx.capacity > 128, "grow-ahead did not grow"
    # the grown index still serves and accepts writes
    v = rng.standard_normal(8).astype(np.float32)
    idx.insert_update_delete([(500, v)])
    d, i = idx.search_batch(v[None, :], 1)
    assert int(np.asarray(i)[0, 0]) == 500

    # pregrow: engine starts at (rounded) requested capacity
    old = grow.PREGROW_ROWS
    try:
        grow.PREGROW_ROWS = 50_000
        idx2 = IndexIVF(p)
        assert idx2.capacity >= 50_000 and idx2.capacity % 4096 == 0
    finally:
        grow.PREGROW_ROWS = old

    # AOT warm compiles without touching live arrays
    idx.warm_capacity_shapes(idx.capacity * 4, buckets=(64,))


def test_sync_blocks_on_whole_index_state(monkeypatch):
    """sync() hands every device array of the index to block_until_ready."""
    import jax

    idx = IndexIVF(VectorIVFParams(vector_size=8, distance_metric="euclidean"))
    vecs = np.random.default_rng(2).standard_normal((600, 8)).astype(np.float32)
    idx.insert_bulk(np.arange(2, 602), vecs)
    seen = []
    real = jax.block_until_ready
    monkeypatch.setattr(jax, "block_until_ready", lambda x: seen.append(x) or real(x))
    idx.sync()
    arrays = seen[0]
    assert any(a is idx.vectors for a in arrays)
    assert any(a is idx.slabs for a in arrays)
    assert any(a is idx.slab_ids for a in arrays)


def test_grow_ahead_failure_is_logged_not_raised(monkeypatch):
    """A failing background grower logs a warning and leaves capacity as is."""
    import semadb_tpu.index.ivf as ivf_mod

    idx = IndexIVF(VectorIVFParams(vector_size=8, distance_metric="euclidean"))
    cap = idx.capacity

    def broken(*a, **k):
        raise RuntimeError("warm failed")

    warnings = []
    monkeypatch.setattr(idx, "warm_capacity_shapes", broken)
    monkeypatch.setattr(ivf_mod.log, "warn", lambda msg, **f: warnings.append((msg, f)))
    idx._grow_ahead()
    assert idx.capacity == cap
    assert warnings and warnings[0][1]["error"] == "warm failed"
    assert idx._grow_thread is None
