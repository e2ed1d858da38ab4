"""Engine host dispatch: the median host time of one ``search_batch_async``
call in the window (the benchmark's span around each submission)."""

from portbench import stats


def read(run):
    spans = run.spans.get("enqueue")
    return stats.median(spans) * 1e3 if spans else None
