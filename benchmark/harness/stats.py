"""What the metric readers share: the run they read, percentiles, and the
model work of a generation window counted from its requests."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import arith


@dataclasses.dataclass
class Run:
    """One run as the readers see it: the configuration and mix, the
    window's result, the device trace (``--trace 1`` only), the window's
    length and the set-up time."""
    config: dict
    mix: dict
    result: dict
    trace: object | None
    seconds: float
    setup_s: float


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (numpy's linear rule); a missing value
    (a failed request) counts as infinite."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return math.inf
    if np.isinf(v).any():
        v = np.sort(v)
        pos = (v.size - 1) * q / 100.0
        lo = int(math.floor(pos))
        hi = min(lo + 1, v.size - 1)
        if math.isinf(v[hi]):
            return math.inf
        return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))
    return float(np.percentile(v, q))


def due_in_window(run: Run) -> list:
    r = run.result
    return [q for q in r["requests"] if r["t_open"] <= q.due < r["t_close"]]


def in_window(run: Run, t: float) -> bool:
    return run.result["t_open"] <= t < run.result["t_close"]


def generation_work(run: Run):
    """(model FLOPs, attention FLOPs, attention bytes) of the window's
    tokens: a prompt counts when its first token arrives in the window
    (the positions past the mix's shared prefix, which the prefix cache
    holds), each later token when it arrives in the window."""
    c = run.config
    D, L = c["n_embd"], c["n_layer"]
    F, V = c["n_inner"] or 4 * D, c["vocab_size"]
    elt = arith.DTYPE_BYTES[c["torch_dtype"]]
    shared = int(run.mix["shared_prefix_tokens"])
    model = attn_f = attn_b = 0
    for r in run.result["requests"]:
        P = len(r.prompt)
        for j, t in enumerate(r.stamps):
            if not in_window(run, t):
                continue
            if j == 0:
                model += arith.prompt_flops(shared, P, D, F, L, V)
                f, b = arith.prefill_attention_work(shared, P, D, L, elt)
            else:
                model += arith.decode_flops(P + j, D, F, L, V)
                f, b = arith.decode_attention_work(P + j, D, L, elt)
            attn_f += f
            attn_b += b
    return model, attn_f, attn_b
