"""Tests for internal tools: migrate, jsonschema, dumpgraph, pipeline,
structured logging, datasets."""

import json
import logging
import uuid

import numpy as np
import pytest

from semadb_tpu.store.diskstore import DiskStore, open_store
from semadb_tpu.tools.datasets import compute_ground_truth, synthetic_clustered
from semadb_tpu.tools.jsonschema import ALL
from semadb_tpu.tools.migrate import migrate_store, migrate_v1_collection
from semadb_tpu.utils import pipeline
from semadb_tpu.utils.logging import FieldLogger, get_logger, setup_logging


def test_migrate_store_roundtrip(tmp_path):
    pytest.importorskip("semadb_tpu.store.native")
    from semadb_tpu.store.native import load_library

    if load_library() is None:
        pytest.skip("native engine not built")
    src = DiskStore(str(tmp_path / "src"))
    src.write(lambda bm: [bm.get("b").put(f"k{i}".encode(), b"v" * i) for i in range(10)])
    src.close()
    n = migrate_store(str(tmp_path / "src"), str(tmp_path / "dst"))
    assert n == 10
    dst = open_store(str(tmp_path / "dst"))
    out = []
    dst.read(lambda bm: out.append(bm.get("b").get(b"k5")))
    assert out[0] == b"v" * 5
    dst.close()


def test_migrate_v1_collection():
    v1 = {"userId": "u", "id": "c", "vectorSize": 128, "distanceMetric": "cosine"}
    v2 = migrate_v1_collection(v1)
    assert v2["indexSchema"]["vector"]["vectorVamana"]["vectorSize"] == 128
    assert "vectorSize" not in v2
    # idempotent on v2 records
    assert migrate_v1_collection(v2) == v2


def test_jsonschema_valid_json():
    blob = json.dumps(ALL)
    parsed = json.loads(blob)
    assert "searchRequest" in parsed and "query" in parsed
    assert parsed["query"]["properties"]["_and"]["items"] == {"$ref": "#"}


def test_dumpgraph(tmp_path, capsys):
    from semadb_tpu.models import Collection, IndexSchema, Point, UserPlan
    from semadb_tpu.shard import Shard
    from semadb_tpu.tools.dumpgraph import dump_graph

    schema = IndexSchema.from_dict(
        {
            "v": {
                "type": "vectorVamana",
                "vectorVamana": {
                    "vectorSize": 2,
                    "distanceMetric": "euclidean",
                    "searchSize": 36,
                    "degreeBound": 32,
                },
            }
        }
    )
    path = str(tmp_path / "s.sdb")
    shard = Shard(
        open_store(path, backend="python"),
        Collection(user_id="u", id="c", index_schema=schema, user_plan=UserPlan()),
    )
    pts = [
        Point.from_map({"v": [float(i), float(i)]}, uuid.UUID(int=i + 1))
        for i in range(10)
    ]
    shard.insert_points(pts)
    shard.close()
    out_csv = str(tmp_path / "g.csv")
    n = dump_graph(path, "v", out_csv)
    assert n == 11  # 10 points + start node
    lines = open(out_csv).read().strip().split("\n")
    assert len(lines) == 11
    assert all("," in l for l in lines)


def test_pipeline_combinators():
    src = pipeline.produce(range(10))
    evens = pipeline.transform(src, lambda x: (x * 2, x % 2 == 1))
    assert pipeline.collect(evens) == [0, 4, 8, 12, 16]
    multi = pipeline.transform_multiple(range(3), lambda x: [x] * x)
    assert pipeline.collect(multi) == [1, 2, 2]
    merged = pipeline.collect(pipeline.merge([1, 2], [3]))
    assert merged == [1, 2, 3]
    err = pipeline.sink(range(3), lambda x: (_ for _ in ()).throw(ValueError("boom")))
    assert isinstance(err, ValueError)
    assert pipeline.sink(range(3), lambda x: None) is None


def test_structured_logger(caplog):
    log = get_logger("testcomp").with_fields(shard="s1")
    with caplog.at_level(logging.DEBUG):
        log.info("hello", n=42)
        with log.timed("stage done"):
            pass
    assert any("hello" in r.message for r in caplog.records)
    rec = [r for r in caplog.records if r.message == "hello"][0]
    assert rec.fields == {"shard": "s1", "n": 42}
    timed = [r for r in caplog.records if r.message == "stage done"][0]
    assert "duration_ms" in timed.fields


def test_synthetic_dataset_gt():
    ds = synthetic_clustered(500, 8, 16, n_clusters=16, seed=1)
    gt = compute_ground_truth(ds, k=5)
    assert gt.shape == (16, 5)
    # GT really is the nearest: check one query by hand
    d = ((ds.test[0][None, :] - ds.train) ** 2).sum(-1)
    assert gt[0, 0] == int(np.argmin(d))


def test_async_dispatcher_order_and_backpressure():
    """AsyncDispatcher returns results in submission order and never holds
    more than `depth` un-materialised handles (HBM backpressure)."""
    import jax.numpy as jnp

    from semadb_tpu.utils.pipeline import AsyncDispatcher

    pipe = AsyncDispatcher(depth=2)
    for i in range(7):
        pipe.submit(lambda x: jnp.asarray(x) * 2, np.full((4,), i, np.float32))
        assert len(pipe._pending) <= 2
    got = pipe.results()
    assert len(got) == 7
    for i, arr in enumerate(got):
        assert isinstance(arr, np.ndarray)
        assert (arr == 2 * i).all()
    # dispatcher is reusable after drain
    pipe.submit(lambda: jnp.ones((2,)))
    (one,) = pipe.results()
    assert (one == 1).all()


def test_load_hdf5_annbenchmarks_format(tmp_path):
    """End-to-end ann-benchmarks HDF5 ingestion (loadhdf5.go:30-71 parity):
    write a file in the exact ann-benchmarks layout (train/test/neighbors
    datasets + a `distance` attr), load it, and run the benchmark harness
    against the file's own ground-truth neighbors."""
    h5py = pytest.importorskip("h5py")
    from semadb_tpu.tools.annbench import run
    from semadb_tpu.tools.datasets import load_hdf5

    rng = np.random.default_rng(3)
    n, d, q = 512, 16, 32
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    train = (centers[rng.integers(0, 8, n)]
             + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    test = (train[rng.integers(0, n, q)]
            + 0.05 * rng.standard_normal((q, d))).astype(np.float32)
    # angular GT on the normalised vectors, like ann-benchmarks computes it
    tn = train / np.linalg.norm(train, axis=1, keepdims=True)
    qn = test / np.linalg.norm(test, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ tn.T), axis=1)[:, :10].astype(np.int32)

    path = tmp_path / "toy-16-angular.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("test", data=test)
        f.create_dataset("neighbors", data=gt)
        f.create_dataset("distances", data=np.zeros((q, 10), np.float32))
        f.attrs["distance"] = "angular"

    ds = load_hdf5(str(path))
    assert ds.metric == "cosine"
    # loader normalises angular corpora (loadhdf5.go normalisation)
    np.testing.assert_allclose(
        np.linalg.norm(ds.train, axis=1), np.ones(n), rtol=1e-5)
    assert ds.neighbors is not None and ds.neighbors.shape == (q, 10)

    out = run(ds, k=10, batch=32, engine="ivf")
    assert out["recall@10"] > 0.9, out


def test_ann_benchmarks_adapter():
    """BaseANN-protocol adapter: fit / set_query_arguments / query /
    batch_query return train indices with self-hit at rank 0, for both
    engines and both ann-benchmarks metric names."""
    import numpy as np

    from semadb_tpu.tools.ann_benchmarks_adapter import SemaDBTPU

    rng = np.random.default_rng(5)
    X = rng.standard_normal((800, 16)).astype(np.float32)
    for metric, engine, op in (("euclidean", "ivf", 8), ("angular", "vamana", 36)):
        a = SemaDBTPU(metric, {"engine": engine, "searchSize": 36})
        a.fit(X)
        a.set_query_arguments(op)
        got = a.query(X[7], 5)
        assert got[0] == 7, (metric, engine, got)
        a.batch_query(X[:16], 5)
        res = a.get_batch_results()
        assert res.shape == (16, 5)
        assert list(res[:, 0][:4]) == [0, 1, 2, 3]
        a.done()


def test_bench_result_lines_name_the_device():
    import os
    import sys

    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    fields = bench._device_fields(jax)
    assert fields == {
        "platform": "cpu",
        "device_kind": jax.devices()[0].device_kind,
        "device_count": 8,
    }
