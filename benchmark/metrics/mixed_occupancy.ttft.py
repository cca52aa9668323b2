"""Live rows (decode and prompt chunks) per mixed dispatch of the paged
engine, from its ``KVCacheStats`` counters differenced over the window."""


def read(run):
    c0, c1 = run.result["counters"]
    steps = c1["mixed_steps"] - c0["mixed_steps"]
    if steps <= 0:
        return None
    return (c1["mixed_step_rows"] - c0["mixed_step_rows"]) / steps
