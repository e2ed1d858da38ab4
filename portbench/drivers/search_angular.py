"""Batched searches in a closed loop, judged under the angular metric.

The loop is ``drivers/search.py``'s (``prepare`` and its ``window``); the
answers are judged against ``reference/exact_angular.py``, exact search by
1 - q·x in float64. The window also records, under ``run.spans
["projections"]``, how many searches projected their queries onto the
engine's traversal basis in it and how many query rows they projected (the
delta of ``semadb_tpu_torch.index.ivf.PROJECTIONS``); where the program
keeps no such count, nothing is recorded.
"""

from __future__ import annotations

import sys

import numpy as np

from portbench import datagen
from portbench.drivers import search
from portbench.reference import exact_angular
from portbench.reference.exact_knn import Store

prepare = search.prepare


def _projections():
    ivf = sys.modules.get("semadb_tpu_torch.index.ivf")
    return getattr(ivf, "PROJECTIONS", None)


def window(run, seconds: float) -> dict:
    counter = _projections()
    before = dict(counter) if counter is not None else None
    w = search.window(run, seconds)
    if before is not None:
        run.spans["projections"] = {name: counter[name] - before[name] for name in before}
    return w


def judge(run) -> dict:
    """The window's answers against exact angular search over the corpus."""
    B, Q = run.traffic["batch"], run.n_queries
    store = Store(run.mix, run.config["n_points"], run.first_id)
    queries = run.mix.rows(datagen.QUERIES, 0, Q)
    answers = [(run.perm[(off + np.arange(B)) % Q], i, d) for off, i, d in run.answers]
    run.answers = None
    return exact_angular.judge_answers(store, queries, answers, run.traffic["k"])
