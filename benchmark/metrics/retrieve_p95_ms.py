"""95th percentile, over every query due in the window, of the time its
top-k came back from ``search`` less the time it was due; a failed query
counts as infinite."""

import math

from benchmark.harness.stats import due_in_window, percentile


def read(run):
    due = due_in_window(run)
    if not due:
        return None
    lat = [(q.done - q.due) if q.error is None else math.inf for q in due]
    return percentile(lat, 95) * 1e3
