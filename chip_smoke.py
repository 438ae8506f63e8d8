"""Smoke test of the serving path on one NVIDIA GPU.

    python chip_smoke.py          # one GPU: device, engine, serve, bq
    python chip_smoke.py --four   # four GPUs: the device-mesh placement only

Phases, each printed with its seconds and each result line naming the card:

- device: refuses to run unless JAX's first device is a GPU; prints the
  card's name and power limit from ``nvidia-smi`` and the compile cache.
- engine: a 1,000,000 x 128d euclidean IVF index (the default ``vectorIVF``
  schema) built through ``IndexIVF.insert_bulk`` on SIFT-like synthetic data
  (``tools.datasets.embedding_like``, spread 0.5: the shape of
  ann-benchmarks sift-128-euclidean), searched with 8,192 held-out queries
  in 4,096-query batches; then a 100,000 x 128d Vamana index built through
  ``insert_update_delete`` and searched at L=75. Recall@10 is checked
  against an exact float64 numpy scan on the host.
- serve: ``ClusterNode`` + HTTP server in this process on 127.0.0.1, a v2
  ``vectorIVF`` collection filled with 100,000 points in 10k msgpack
  batches, 100 single searches for stored vectors (each must find itself
  at distance 0) and one 1,024-query batch search (recall@10).
- bq: the flat index's binary-quantized scan at 1M x 128d (4 words) and
  100k x 1536d (48 words): whatever ``vectorstore.store.bit_scan`` runs
  here against ``ops.distance.pairwise_bit_distance``; hamming must be
  equal, jaccard within 1e-6.

Precision: IVF coarse scoring runs at JAX's default matmul precision
(TF32 on this card); the exact rerank is elementwise float32 for
euclidean. Bounds: IVF and served recall@10 >= 0.99, Vamana >= 0.95,
reranked distances within 1e-4 relative of the float64 host values.

Any failed check raises; the last line is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid

import msgpack
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from semadb_tpu.utils import compilecache, compilemeter  # noqa: E402

CARD = "card unknown"
K = 10


def log(msg: str) -> None:
    print(f"{msg} [{CARD}]", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def exact_topk(train: np.ndarray, test: np.ndarray, k: int = K):
    """Exact squared-euclidean top-k on the host in float64:
    (ids i64[Q, k], dists f64[Q, k])."""
    tr = np.asarray(train, np.float64)
    tr_sq = (tr * tr).sum(-1)
    ids = np.empty((len(test), k), np.int64)
    for i in range(0, len(test), 256):
        q = np.asarray(test[i : i + 256], np.float64)
        d = (q * q).sum(-1)[:, None] - 2.0 * (q @ tr.T) + tr_sq[None, :]
        part = np.argpartition(d, k, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(d, part, 1), axis=1)
        ids[i : i + 256] = np.take_along_axis(part, order, 1)
    return ids, sq_dist(train, test, ids)


def sq_dist(train: np.ndarray, test: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """float64 squared euclidean distance of each query to its ``ids``."""
    diff = np.asarray(train, np.float64)[ids] - np.asarray(test, np.float64)[:, None, :]
    return (diff * diff).sum(-1)


def recall(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.mean([
        len(set(g.tolist()) & set(w.tolist())) / want.shape[1]
        for g, w in zip(got, want)
    ]))


def min_seconds(fn, reps: int = 5) -> float:
    """Best of ``reps`` timed calls after one warm-up; ``fn`` must block."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def device_phase(count: int = 1) -> dict:
    """Refuse anything but ``count`` GPUs; name the cards and the cache."""
    global CARD
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPU(s), JAX found "
            f"{len(devs)} {devs[0].platform} device(s)"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)
    CARD = smi[0].strip()
    cache = compilecache.configure()
    log(f"device: {len(devs)} x {devs[0].device_kind}, compile cache {cache}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def engine_phase(
    n: int = 1_000_000, n_queries: int = 8192, n_check: int = 1000,
    batch: int = 4096, vamana_n: int = 100_000, vamana_queries: int = 1000,
    dim: int = 128,
) -> dict:
    from semadb_tpu.index.ivf import IndexIVF
    from semadb_tpu.index.vamana import IndexVamana
    from semadb_tpu.models.schema import VectorIVFParams, VectorVamanaParams
    from semadb_tpu.tools.datasets import embedding_like

    compilemeter.install()
    out = {}
    ds = embedding_like(n, dim, n_queries, spread=0.5)
    gt, _ = exact_topk(ds.train, ds.test[:n_check])
    idx = IndexIVF(VectorIVFParams.from_dict(
        {"vectorSize": dim, "distanceMetric": "euclidean"}
    ))
    c0, t0 = compilemeter.seconds(), time.perf_counter()
    idx.insert_bulk(np.arange(2, n + 2, dtype=np.int32), ds.train)
    idx.sync()
    build_s = time.perf_counter() - t0
    compile_s = compilemeter.seconds() - c0
    log(f"engine ivf {n}x{dim}: build {build_s:.2f}s "
        f"(compile {compile_s:.2f}s, execution {build_s - compile_s:.2f}s)")

    def search_all():
        parts = [idx.search_batch(ds.test[i : i + batch], K)
                 for i in range(0, n_queries, batch)]
        return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])

    t0 = time.perf_counter()
    search_all()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, ids = search_all()
    query_s = time.perf_counter() - t0
    ids = ids[:n_check].astype(np.int64) - 2
    out["ivf_recall"] = recall(ids, gt)
    host_d = sq_dist(ds.train, ds.test[:n_check], np.clip(ids, 0, n - 1))
    rel = np.abs(d[:n_check] - host_d) / np.maximum(host_d, 1e-6)
    out["ivf_rerank_rel_err"] = float(rel[ids >= 0].max())
    log(f"engine ivf: {n_queries} queries in {query_s:.3f}s warm "
        f"({cold_s:.2f}s cold), recall@10 {out['ivf_recall']:.4f}, "
        f"rerank max rel err {out['ivf_rerank_rel_err']:.2e}")
    check(out["ivf_recall"] >= 0.99, f"IVF recall@10 {out['ivf_recall']} < 0.99")
    check((ids >= 0).all(), "IVF returned empty slots")
    check(out["ivf_rerank_rel_err"] <= 1e-4, "IVF rerank distances off by >1e-4")
    del idx, ds

    vs = embedding_like(vamana_n, dim, vamana_queries, spread=0.5, seed=7)
    vgt, _ = exact_topk(vs.train, vs.test)
    vidx = IndexVamana(VectorVamanaParams.from_dict(
        {"vectorSize": dim, "distanceMetric": "euclidean"}
    ))
    c0, t0 = compilemeter.seconds(), time.perf_counter()
    vidx.insert_update_delete(zip(range(2, vamana_n + 2), vs.train))
    vidx.sync()
    build_s = time.perf_counter() - t0
    compile_s = compilemeter.seconds() - c0
    vidx.search_batch(vs.test, K, 75)
    t0 = time.perf_counter()
    _, vids = vidx.search_batch(vs.test, K, 75)
    query_s = time.perf_counter() - t0
    out["vamana_recall"] = recall(vids.astype(np.int64) - 2, vgt)
    log(f"engine vamana {vamana_n}x{dim}: build {build_s:.2f}s (compile "
        f"{compile_s:.2f}s, execution {build_s - compile_s:.2f}s); "
        f"{vamana_queries} queries at L=75 in {query_s:.3f}s, "
        f"recall@10 {out['vamana_recall']:.4f}")
    check(out["vamana_recall"] >= 0.95, f"Vamana recall@10 {out['vamana_recall']} < 0.95")
    return out


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


class Client:
    """msgpack-over-HTTP client on one keep-alive connection."""

    HEADERS = {
        "X-User-Id": "smoke", "X-Plan-Id": "BASIC",
        "Content-Type": "application/msgpack", "Accept": "application/msgpack",
    }

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def post(self, path: str, body: dict) -> dict:
        self.conn.request("POST", path, msgpack.packb(body, use_bin_type=True), self.HEADERS)
        resp = self.conn.getresponse()
        data = resp.read()
        out = msgpack.unpackb(data, raw=False) if data else {}
        check(resp.status == 200, f"POST {path} -> {resp.status} {out}")
        return out

    def close(self) -> None:
        self.conn.close()


def _start_server(root: str, **node_cfg):
    from semadb_tpu.cluster.node import ClusterNode, ClusterNodeConfig
    from semadb_tpu.httpapi.server import HttpApiConfig, run_http_server
    from semadb_tpu.models.collection import UserPlan

    node = ClusterNode(ClusterNodeConfig(
        root_dir=root, rpc_host="127.0.0.1", rpc_port=0, **node_cfg
    ))
    node.serve()
    server = run_http_server(node, HttpApiConfig(
        http_host="127.0.0.1", http_port=0,
        user_plans={"BASIC": UserPlan(name="BASIC")},
    ))
    return node, server


def serve_phase(
    n: int = 100_000, insert_batch: int = 10_000, n_single: int = 100,
    n_batch: int = 1024, dim: int = 128,
) -> dict:
    from semadb_tpu.tools.datasets import embedding_like

    out = {}
    ds = embedding_like(n, dim, n_batch, spread=0.5, seed=11)
    gt, _ = exact_topk(ds.train, ds.test)
    uids = [str(uuid.UUID(int=i + 1)) for i in range(n)]
    index_of = {u: i for i, u in enumerate(uids)}
    col = "/v2/collections/smoke"
    with tempfile.TemporaryDirectory(prefix="chip_smoke") as root:
        node, server = _start_server(root)
        client = Client(server.port)
        try:
            client.post("/v2/collections", {"id": "smoke", "indexSchema": {"emb": {
                "type": "vectorIVF",
                "vectorIVF": {"vectorSize": dim, "distanceMetric": "euclidean"},
            }}})
            t0 = time.perf_counter()
            for lo in range(0, n, insert_batch):
                hi = min(lo + insert_batch, n)
                client.post(f"{col}/points", {"points": [
                    {"_id": uids[i], "emb": ds.train[i].tolist()} for i in range(lo, hi)
                ]})
            ingest_s = time.perf_counter() - t0
            out["ingest_pts_per_s"] = n / ingest_s
            log(f"serve: ingested {n} points in {ingest_s:.2f}s "
                f"({out['ingest_pts_per_s']:.1f} points/s)")

            def search(i: int) -> list:
                return client.post(f"{col}/points/search", {
                    "query": {"property": "emb", "vectorIVF": {
                        "vector": ds.train[i].tolist(), "limit": K}},
                    "limit": K,
                })["points"]

            t0 = time.perf_counter()
            search(0)
            warm_s = time.perf_counter() - t0
            probes = np.random.default_rng(5).choice(n, n_single, replace=False)
            lat = []
            for i in probes:
                t0 = time.perf_counter()
                top = search(int(i))
                lat.append(time.perf_counter() - t0)
                check(top and top[0]["_id"] == uids[i] and top[0]["_distance"] == 0.0,
                      f"stored vector {i} is not its own top-1 at distance 0: {top[:1]}")
            out["single_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["single_p99_ms"] = float(np.percentile(lat, 99) * 1e3)
            log(f"serve: {n_single} single searches, every stored vector its own "
                f"top-1 at distance 0; p50 {out['single_p50_ms']:.2f} ms, "
                f"p99 {out['single_p99_ms']:.2f} ms (first search {warm_s:.2f}s)")

            t0 = time.perf_counter()
            res = client.post(f"{col}/points/search/batch", {"queries": [
                {"query": {"property": "emb", "vectorIVF": {
                    "vector": ds.test[i].tolist(), "limit": K}}, "limit": K}
                for i in range(n_batch)
            ]})["results"]
            batch_s = time.perf_counter() - t0
            got = np.array([[index_of[p["_id"]] for p in r["points"]] for r in res])
            out["served_recall"] = recall(got, gt)
            log(f"serve: {n_batch}-query batch search in {batch_s:.3f}s, "
                f"recall@10 {out['served_recall']:.4f}")
            check(out["served_recall"] >= 0.99, f"served recall@10 {out['served_recall']} < 0.99")
        finally:
            client.close()
            server.shutdown()
            node.close()
    return out


# ---------------------------------------------------------------------------
# bq
# ---------------------------------------------------------------------------


def bq_phase(shapes=((1_000_000, 128), (100_000, 1536)), n_queries: int = 1024) -> dict:
    import jax

    from semadb_tpu.index.flat import IndexFlat
    from semadb_tpu.models.quantizer import BinaryQuantizerParams, Quantizer
    from semadb_tpu.models.schema import VectorFlatParams
    from semadb_tpu.ops.distance import pairwise_bit_distance
    from semadb_tpu.vectorstore.store import bit_scan, bq_encode

    out = {}
    rng = np.random.default_rng(3)
    for n, dim in shapes:
        x = rng.standard_normal((n, dim), dtype=np.float32)
        q = rng.standard_normal((n_queries, dim), dtype=np.float32)
        idx = IndexFlat(VectorFlatParams(
            vector_size=dim, distance_metric="euclidean",
            quantizer=Quantizer(type="binary", binary=BinaryQuantizerParams(
                distance_metric="hamming", trigger_threshold=min(10_000, n))),
        ))
        idx.insert_update_delete(zip(range(2, n + 2), x))
        check(idx.store.fitted, "binary quantizer did not fit")
        codes = idx.store.state.codes
        qc = bq_encode(jax.numpy.asarray(q), idx.store.state.aux, dim)
        words = codes.shape[1]
        for metric in ("hamming", "jaccard"):
            got = np.asarray(bit_scan(qc, codes, metric))
            want = np.asarray(pairwise_bit_distance(qc, codes, metric))
            err = float(np.abs(got - want).max())
            check(err == 0.0 if metric == "hamming" else err <= 1e-6,
                  f"bq {metric} W={words}: max |dispatched - plain| = {err}")
            t_disp = min_seconds(lambda: jax.block_until_ready(bit_scan(qc, codes, metric)))
            t_plain = min_seconds(
                lambda: jax.block_until_ready(pairwise_bit_distance(qc, codes, metric)))
            out[f"{metric}_w{words}"] = {"err": err, "dispatched_s": t_disp, "plain_s": t_plain}
            log(f"bq {metric} {n}x{dim} (W={words}), {n_queries} queries: max err {err}; "
                f"dispatched scan {t_disp * 1e3:.3f} ms, plain scan {t_plain * 1e3:.3f} ms")
        t_search = min_seconds(lambda: idx.search_batch(q, K))
        out[f"search_w{words}_s"] = t_search
        log(f"bq flat search {n}x{dim} hamming, {n_queries} queries: {t_search * 1e3:.3f} ms")
        del idx, codes
    return out


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def four_phase(per_device: int = 100_000, n_queries: int = 1024, dim: int = 128,
               probes: int = 256) -> dict:
    """The same points in a ``shardPlacement: "device"`` collection (one
    shard per device, searched through the mesh) and a host-placed one;
    both answered for the same queries and checked against the exact scan."""
    import jax

    from semadb_tpu.models import Collection, IndexSchema, Point, UserPlan
    from semadb_tpu.models.query import SearchRequest
    from semadb_tpu.tools.datasets import embedding_like

    n_dev = len(jax.devices())
    n = per_device * n_dev
    ds = embedding_like(n, dim, n_queries, spread=0.5, seed=13)
    gt, _ = exact_topk(ds.train, ds.test)
    schema = {"emb": {"type": "vectorIVF",
                      "vectorIVF": {"vectorSize": dim, "distanceMetric": "euclidean"}}}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke") as root:
        node, server = _start_server(root, max_shard_point_count=per_device)
        try:
            cols = {}
            for placement in ("device", "host"):
                col = Collection(user_id="smoke", id=placement,
                                 index_schema=IndexSchema.from_dict(schema),
                                 user_plan=UserPlan(), shard_placement=placement)
                node.create_collection(col)
                t0 = time.perf_counter()
                # One call: each shard takes its points in one transaction
                # (one bulk fit instead of incremental ones).
                pts = [Point.from_map({"emb": ds.train[i].tolist()}, uuid.UUID(int=i + 1))
                       for i in range(n)]
                check(not node.insert_points(col, pts), f"{placement} insert failed")
                log(f"four: {placement} collection, {n} points in "
                    f"{len(col.shard_ids)} shards, {time.perf_counter() - t0:.2f}s")
                cols[placement] = col

            check(len(cols["device"].shard_ids) == n_dev,
                  f"device placement made {len(cols['device'].shard_ids)} shards")
            ms = node._mesh()
            check(ms is not None, "no device mesh")
            log(f"four: mesh devices {list(ms.mesh.devices.flat)}")
            for placement, col in cols.items():
                for sid in col.shard_ids:
                    def where(s):
                        eng = next(iter(s.device_indices.values()))
                        return {k: sorted(str(d) for d in v.devices())
                                for k, v in vars(eng).items() if isinstance(v, jax.Array)}
                    log(f"four: {placement} shard {sid}: "
                        f"{node.shard_manager.do_with_shard(col, sid, where)}")

            reqs = [SearchRequest.from_dict({"query": {"property": "emb", "vectorIVF": {
                "vector": ds.test[i].tolist(), "limit": K, "numProbes": probes}},
                "limit": K}) for i in range(n_queries)]
            found = {}
            for placement, col in cols.items():
                node.search_points_batch(col, reqs[:8])
                t0 = time.perf_counter()
                res = node.search_points_batch(col, reqs)
                dt = time.perf_counter() - t0
                found[placement] = np.array(
                    [[r.point.id.int - 1 for r in row] for row in res])
                out[f"{placement}_recall"] = recall(found[placement], gt)
                log(f"four: {placement} collection, {n_queries} queries in {dt:.3f}s, "
                    f"recall@10 {out[f'{placement}_recall']:.4f}")
                check(out[f"{placement}_recall"] >= 0.99,
                      f"{placement} recall@10 {out[f'{placement}_recall']} < 0.99")
            # Ties aside: the two answers agree when their float64 distance
            # lists agree, whichever of two equidistant points each returned.
            dd = sq_dist(ds.train, ds.test, found["device"])
            dh = sq_dist(ds.train, ds.test, found["host"])
            same = np.isclose(np.sort(dd, 1), np.sort(dh, 1), rtol=1e-6, atol=0).all(1)
            out["agree"] = float(same.mean())
            log(f"four: device and host collections agree on {int(same.sum())} of "
                f"{n_queries} top-10 lists")
            check(same.all(), "device and host collections disagree")
        finally:
            server.shutdown()
            node.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU device-placement phase")
    args = ap.parse_args(argv)
    phases = [("four", four_phase)] if args.four else [
        ("engine", engine_phase), ("serve", serve_phase), ("bq", bq_phase)]
    t0 = time.perf_counter()
    device = device_phase(4 if args.four else 1)
    log(f"phase device: {time.perf_counter() - t0:.2f}s")
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"phase {name}: {time.perf_counter() - t0:.2f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
