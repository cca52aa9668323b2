"""100 x the live rows of the rounds dispatched in the window over their
capacity (the engine's ``max_batch_size``), each round weighted by its
dispatch->sync time: from the ``rows`` and ``capacity`` of each
``engine.issue.*`` span and its ``engine.device.*`` window."""

from benchmark.harness import spans


def read(run):
    rounds = spans.rounds(run)
    if not rounds:
        return None
    cap = sum(c * w for _k, _r, c, w in rounds)
    if cap <= 0:
        return None
    return 100.0 * sum(r * w for _k, r, _c, w in rounds) / cap
