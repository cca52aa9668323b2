"""The least time of the window's attention work (a prompt's causal
attention with its K/V read once; a decode token's whole context read once
and its own K/V written once) over the device time of the paged attention
kernels in the trace."""

from benchmark.harness import arith
from benchmark.harness.stats import generation_work

KERNELS = ("paged_tc_kernel", "append_kernel")


def read(run):
    if run.trace is None:
        return None
    kernel_s, _n = run.trace.kernel_time(KERNELS)
    _m, flops, nbytes = generation_work(run)
    if kernel_s <= 0 or not flops:
        return None
    return arith.least_time_s(flops, nbytes,
                              run.config["torch_dtype"]) / kernel_s * 100.0
