"""Every token delivered by ``on_token`` inside the window, over the
window's length."""

from benchmark.harness.stats import in_window


def read(run):
    n = sum(1 for r in run.result["requests"] for t in r.stamps
            if in_window(run, t))
    return n / run.seconds if n else None
