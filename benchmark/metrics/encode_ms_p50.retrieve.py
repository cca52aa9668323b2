"""Median time of ``embed_scheduled`` (the scheduler's queue and the
graph replay) over the queries sent in the window, by the benchmark's own
host clock."""

import numpy as np

from benchmark.harness.stats import in_window


def read(run):
    v = [q.embedded - q.sent for q in run.result["requests"]
         if q.error is None and in_window(run, q.sent)]
    return float(np.median(v)) * 1e3 if v else None
