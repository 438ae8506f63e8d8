"""Drop-in ann-benchmarks algorithm adapter.

Parity reference: internal/shardpy/shardpy.go + the reference's
ann-benchmarks fork wiring (README.md:184-200) — the reference exposes
initShard/fit/query over a cgo bridge so ann-benchmarks can score it.
This module provides the same integration as a duck-typed
``ann_benchmarks.algorithms.base.BaseANN`` subclass (no import of
ann-benchmarks required here, so the zero-egress environment can test
it): drop this repo on PYTHONPATH and register

    "semadb_tpu":
      constructor: SemaDBTPU
      module: semadb_tpu.tools.ann_benchmarks_adapter

in an ann-benchmarks config with ``args: [{engine: ivf}]`` etc.

Protocol (ann_benchmarks/algorithms/base.py):
  fit(X) -> build the index from a float32 [N, D] matrix
  set_query_arguments(op) -> search-time operating point on the pareto
    (IVF: num_probes; vamana: search list L)
  query(v, n) -> top-n train indices for one vector
  batch_query(X, n) + get_batch_results() -> batched path (the accelerator-shaped
    one; enable with --batch in ann-benchmarks)
"""

from __future__ import annotations

import numpy as np


class SemaDBTPU:
    def __init__(self, metric: str, params: dict | None = None):
        params = params or {}
        # ann-benchmarks names: "angular" | "euclidean" (| "hamming"...)
        self._metric = {"angular": "cosine"}.get(metric, metric)
        self._normalize = metric == "angular"
        self._engine = params.get("engine", "ivf")
        self._build_kw = {
            "search_size": int(params.get("searchSize", 75)),
            "degree_bound": int(params.get("degreeBound", 64)),
            "alpha": float(params.get("alpha", 1.2)),
            "assign_copies": int(params.get("assignCopies", 2)),
        }
        self._op = 0  # operating point (probes / L), set_query_arguments
        self._bench = None
        self._batch_res = None

    def __str__(self) -> str:  # shown in ann-benchmarks result names
        return f"SemaDBTPU({self._engine}, op={self._op})"

    def _prep(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if self._normalize:
            X = X / np.maximum(np.linalg.norm(X, axis=-1, keepdims=True), 1e-12)
        return X

    def fit(self, X) -> None:
        from semadb_tpu.tools.annbench import VamanaBench

        X = self._prep(X)
        self._bench = VamanaBench(
            dim=X.shape[1], metric=self._metric, engine=self._engine,
            **self._build_kw,
        )
        self._bench.fit(X)

    def set_query_arguments(self, op) -> None:
        self._op = int(op)

    def query(self, v, n: int):
        q = self._prep(np.atleast_2d(v))
        idx = self._bench.index
        if self._engine == "ivf":
            _, ids = idx.search_batch(q, k=n, num_probes=self._op)
        else:
            _, ids = idx.search_batch(q, k=n, search_size=self._op)
        return [int(i) - 2 for i in ids[0] if i >= 2]

    def batch_query(self, X, n: int) -> None:
        q = self._prep(X)
        idx = self._bench.index
        if self._engine == "ivf":
            _, ids = idx.search_batch(q, k=n, num_probes=self._op)
        else:
            _, ids = idx.search_batch(q, k=n, search_size=self._op)
        ids = np.asarray(ids, np.int64) - 2
        ids[ids < 0] = -1
        self._batch_res = ids

    def get_batch_results(self):
        return self._batch_res

    def done(self) -> None:  # BaseANN cleanup hook
        self._bench = None
