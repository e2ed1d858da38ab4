"""The stages of one search request, by the names of its device events.

Copied from ``semadb_tpu_torch/tools/annbench.py`` (``STAGES``,
``stage_of``): an event belongs to the first stage whose patterns its name
holds. K3's memset zeroes its work area. The probe scores' -2x and + |c|^2
passes are elementwise kernels; a chunked probe selection concatenates the
chunks' top-p and gathers the winners.
"""

from __future__ import annotations

STAGES = (
    ("k10_beam_search", ("vamana_beam_search_kernel",)),
    ("k9_adc_scan", ("pq_probe_scan_kernel", "pq_scan_dense_kernel")),
    ("k3_probed_slab_scan", ("ivf_scan_", "Memset")),
    ("k4_dedup_rerank", ("rerank_kernel",)),
    ("probe_gemm", ("gemm",)),
    ("probe_topk", ("topk", "Sort")),
    ("probe_scale_shift", ("MulFunctor", "CUDAFunctor_add", "CUDAFunctorOnSelf_add", "CUDAFunctorOnOther_add")),
    ("probe_chunk_merge", ("CatArrayBatchedCopy", "scatter_gather", "copy_kernel")),
    ("upload", ("Memcpy HtoD",)),
)
PROBE_SELECTION = ("probe_gemm", "probe_topk", "probe_scale_shift", "probe_chunk_merge")


def stage_of(name: str) -> str:
    return next((stage for stage, pats in STAGES if any(p in name for p in pats)), "other")


def seconds_by_stage(trace) -> dict:
    out: dict = {}
    for name, a, b in zip(trace.dev_names, trace.dev_start, trace.dev_end):
        s = stage_of(name)
        out[s] = out.get(s, 0.0) + (b - a)
    return out


def count(trace, stage: str) -> int:
    return sum(1 for name in trace.dev_names if stage_of(name) == stage)
