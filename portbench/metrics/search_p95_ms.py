"""The closed-loop client: the 95th percentile (nearest rank) of every
request's time in the window, from its submission to its results on the
host. With a fixed number of requests in flight the loop runs at the
engine's capacity, so a request's time is mostly the wait behind those sent
before it: the tail moves with the rate, and is read here, not held to a
bound."""

from portbench import stats


def read(run):
    lat = run.spans.get("latency")
    return stats.p95(lat) * 1e3 if lat else None
