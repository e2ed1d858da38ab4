"""Drop-in ann-benchmarks algorithm adapter.

Port of ``semadb_tpu/tools/ann_benchmarks_adapter.py`` (reference:
internal/shardpy/shardpy.go and the reference's ann-benchmarks wiring,
README.md:184-200): a duck-typed ``ann_benchmarks.algorithms.base.BaseANN``
(ann-benchmarks itself is not imported). Register

    "semadb_tpu_torch":
      constructor: SemaDBTPU
      module: semadb_tpu_torch.tools.ann_benchmarks_adapter

in an ann-benchmarks config with ``args: [{engine: ivf}]`` etc. The index is
built by :class:`~semadb_tpu_torch.tools.annbench.AnnBench` over ``IndexIVF``
or ``IndexVamana``, on ``params["device"]`` (``cuda`` unless told).

Protocol (ann_benchmarks/algorithms/base.py):
  fit(X) -> build the index from a float32 [N, D] matrix
  set_query_arguments(op) -> search-time operating point on the pareto
    (IVF: num_probes; vamana: search list L)
  query(v, n) -> top-n train indices for one vector
  batch_query(X, n) + get_batch_results() -> the batched path
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
        self._device = params.get("device", "cuda")
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
        from semadb_tpu_torch.tools.annbench import AnnBench

        X = self._prep(X)
        self._bench = AnnBench(
            dim=X.shape[1], device=self._device, metric=self._metric, engine=self._engine, **self._build_kw,
        )
        idx = self._bench.index
        idx.insert_bulk(np.arange(2, len(X) + 2, dtype=np.int32), X)
        idx.flush_pending()
        idx.sync()

    def set_query_arguments(self, op) -> None:
        self._op = int(op)

    def _search(self, q: np.ndarray, n: int) -> np.ndarray:
        idx = self._bench.index
        if self._engine == "ivf":
            _, ids = idx.search_batch(q, k=n, num_probes=self._op)
        else:
            _, ids = idx.search_batch(q, k=n, search_size=self._op)
        return np.asarray(ids, np.int64)

    def query(self, v, n: int):
        ids = self._search(self._prep(np.atleast_2d(v)), n)
        return [int(i) - 2 for i in ids[0] if i >= 2]

    def batch_query(self, X, n: int) -> None:
        ids = self._search(self._prep(X), n) - 2
        ids[ids < 0] = -1
        self._batch_res = ids

    def get_batch_results(self):
        return self._batch_res

    def done(self) -> None:  # BaseANN cleanup hook
        self._bench = None
