"""100 x the window's device idle time during which an ``engine.issue.*``
span is open: the host still enqueuing a round's kernels while the card
waits for them (``harness/spans.idle_split``)."""

from benchmark.harness import spans


def read(run):
    split = spans.idle_split(run)
    if split is None:
        return None
    return 100.0 * split["issue"] / split["window"]
