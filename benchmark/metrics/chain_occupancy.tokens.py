"""Emitted tokens per dispatched decode slot (rows x steps) of the paged
engine, from its ``KVCacheStats`` counters differenced over the window."""


def read(run):
    c0, c1 = run.result["counters"]
    slots = c1["chain_slots"] - c0["chain_slots"]
    if slots <= 0:
        return None
    return 100.0 * (c1["chain_emitted"] - c0["chain_emitted"]) / slots
