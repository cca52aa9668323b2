"""95th percentile, over every request due in the window, of its first
token's arrival at ``on_token`` less the time it was due; a request that
failed or never produced a token counts as infinite."""

import math

from benchmark.harness.stats import due_in_window, percentile


def read(run):
    due = due_in_window(run)
    if not due:
        return None
    ttft = [(r.stamps[0] - r.due) if (r.stamps and r.error is None)
            else math.inf for r in due]
    return percentile(ttft, 95) * 1e3
