"""Model FLOPs of the window's tokens (the benchmark's count from the
configuration: every prompt past the shared prefix, every generated
token, one head row each) over the window times the bf16 dense peak."""

from benchmark.harness import arith
from benchmark.harness.stats import generation_work


def read(run):
    model, _f, _b = generation_work(run)
    if not model:
        return None
    peak = arith.PEAK_FLOPS[run.config["torch_dtype"]]
    return 100.0 * model / (run.seconds * peak)
