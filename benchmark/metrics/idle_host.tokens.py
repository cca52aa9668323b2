"""100 x the window's device idle time, outside any issue span, inside an
``engine.host_gap`` (a sync's return to the next dispatch) or inside a
round's dispatch->sync window after its issue ended
(``harness/spans.idle_split``)."""

from benchmark.harness import spans


def read(run):
    split = spans.idle_split(run)
    if split is None:
        return None
    return 100.0 * split["host"] / split["window"]
