"""The query projection of IVF above PROJ_DIM (``queries @ proj``, one
cuBLAS product a search, which may launch more than one kernel: on the H100
the 4,096 x 1,536 x 128 product runs as a split-K GEMM and its reduction):
its device time per projection in the traced window, the ``probe_gemm``-stage
events' seconds over the projections the engine counted in the window
(``run.spans["projections"]``, recorded by the angular driver). None where the
program keeps no such count, or where some GEMM kernel's events do not number
one a projection (another product ran in the window)."""

import collections

from portbench import stages


def read(run):
    counted = run.spans.get("projections")
    if run.trace is None or not counted or not counted["calls"]:
        return None
    kernels = collections.Counter(n for n in run.trace.dev_names if stages.stage_of(n) == "probe_gemm")
    if not kernels or any(c != counted["calls"] for c in kernels.values()):
        return None
    s = stages.seconds_by_stage(run.trace).get("probe_gemm", 0.0)
    return s / counted["calls"] * 1e3 if s > 0 else None
