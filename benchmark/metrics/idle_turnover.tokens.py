"""100 x the rest of the window's device idle time, outside the engine's
rounds and host gaps: batch formation, admission before a run's first
dispatch, a run's end, between serve batches
(``harness/spans.idle_split``).  With ``idle_issue.tokens`` and
``idle_host.tokens`` it adds up to ``device_idle.tokens``."""

from benchmark.harness import spans


def read(run):
    split = spans.idle_split(run)
    if split is None:
        return None
    return 100.0 * split["turnover"] / split["window"]
