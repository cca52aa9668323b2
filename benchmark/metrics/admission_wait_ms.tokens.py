"""The mean wait, in ms, of the requests whose admission ended in the
window, from the start of their ``serve.queue`` span (submit) to the end
of their ``engine.pending`` span (the engine admits them), joined by
trace id."""

from benchmark.harness import spans


def read(run):
    waits = spans.admission_waits(run)
    if not waits:
        return None
    return 1e3 * sum(t for t, _q, _p in waits) / len(waits)
