"""K4's share of its memory roofline: the least time for the bytes of a
request's rerank (``k4bytes.k4_bytes`` on the operands of two of the
window's requests, run again after it) over K4's device time per request in
the traced window."""

import numpy as np

from portbench import bytecount, k4bytes, stages

SAMPLES = 2


def read(run):
    if run.trace is None or not hasattr(run.engine, "refit_seconds"):
        return None
    n = stages.count(run.trace, "k4_dedup_rerank")
    s = stages.seconds_by_stage(run.trace).get("k4_dedup_rerank", 0.0)
    if not n or s <= 0:
        return None
    B, k = run.traffic["batch"], run.traffic["k"]
    nbytes = []
    for j in range(SAMPLES):
        off = (j * B) % run.n_queries
        keep = {}
        run.engine.search_batch_async(run.qtile[off : off + B], k, keep=keep)
        nbytes.append(k4bytes.k4_bytes(*keep["k4"]))
    return 100.0 * bytecount.bound_s(float(np.mean(nbytes))) * n / s
