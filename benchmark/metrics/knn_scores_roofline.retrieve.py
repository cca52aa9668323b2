"""The least time of the KNN score launches in the trace (each scores at
least one query against the index's valid float32 rows, read once) over
their device time."""

from benchmark.harness import arith

KERNELS = ("knn_gemv_kernel", "knn_gemm_kernel")


def read(run):
    if run.trace is None:
        return None
    kernel_s, launches = run.trace.kernel_time(KERNELS)
    if kernel_s <= 0:
        return None
    c = run.config
    flops, nbytes = arith.knn_scores_work(1, c["index_rows"],
                                          c["hidden_size"])
    return launches * arith.least_time_s(flops, nbytes,
                                         c["index_dtype"]) / kernel_s * 100.0
