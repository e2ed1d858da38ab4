"""K10's share of its memory roofline: the least time for the bytes of a
request's walk (``bytecount.k10_bytes`` on the first request's queries, the
graph and the engine's entry seeds after the window) over K10's device time
per request in the traced window."""

import torch

from portbench import bytecount, stages


def read(run):
    if run.trace is None or not hasattr(run.engine, "state"):
        return None
    n = stages.count(run.trace, "k10_beam_search")
    s = stages.seconds_by_stage(run.trace).get("k10_beam_search", 0.0)
    if not n or s <= 0:
        return None
    eng = run.engine
    q = torch.from_numpy(run.qtile[: run.traffic["batch"]]).to(eng.device)
    with torch.no_grad():
        got = bytecount.k10_bytes(eng.state.vectors, eng.state.adjacency, q, eng.params.search_size, 2,
                                  eng._seeds_for(q))
    return 100.0 * bytecount.bound_s(got["bytes"]) * n / s
