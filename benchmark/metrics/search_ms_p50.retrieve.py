"""Median time of ``BruteForceKnn.search`` (scores, top-k, the fetch)
over the queries sent in the window, by the benchmark's own host clock."""

import numpy as np

from benchmark.harness.stats import in_window


def read(run):
    v = [q.done - q.embedded for q in run.result["requests"]
         if q.error is None and in_window(run, q.sent)]
    return float(np.median(v)) * 1e3 if v else None
