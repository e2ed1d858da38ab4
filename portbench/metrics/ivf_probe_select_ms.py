"""IVF probe selection (K5: the GEMM, the scale and shift passes, top-p and
the chunk merge): its device time per request in the traced window, the
requests counted by K4's launches (one a request)."""

from portbench import stages


def read(run):
    if run.trace is None:
        return None
    n = stages.count(run.trace, "k4_dedup_rerank")
    by = stages.seconds_by_stage(run.trace)
    s = sum(by.get(k, 0.0) for k in stages.PROBE_SELECTION)
    return s / n * 1e3 if n and s > 0 else None
