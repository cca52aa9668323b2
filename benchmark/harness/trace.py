"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

Only device activity is recorded (no host operator records), so a long
window stays cheap to trace and to read.  The reading gives each kernel's
interval; from them the busy time (the union of intervals), the idle
share, the time by kernel name, the longest idle gaps, and the intervals
that a per-layer metric's reader sums for the kernels it names.
"""

from __future__ import annotations

import collections
import sys
import time

import torch


class DeviceTrace:
    """Records the device's kernels from :meth:`start` to :meth:`finish`;
    the window is the perf_counter span from :meth:`open` to
    :meth:`close`.  Starting the profiler can take seconds on a process
    that holds CUDA graphs, so it starts before the load does, and the
    window is cut out of the trace afterwards."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        # (name, start, end) in perf_counter seconds, of the kernels that
        # overlap the window: whole, and cut to the window
        self.kernels: list[tuple[str, float, float]] = []
        self.cut: list[tuple[str, float, float]] = []
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        # a marker kernel on a stream of its own starts a few microseconds
        # after the host issues it: it ties the trace's clock to
        # perf_counter, so the window can be cut out of the trace and idle
        # gaps named by host spans
        side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side):
            self._t_mark = time.perf_counter()
            torch.cuda._sleep(1)
        torch.cuda.synchronize(self.device)

    def open(self) -> None:
        self._t_open = time.perf_counter()

    def close(self) -> None:
        self._t_close = time.perf_counter()
        self.window_s = self._t_close - self._t_open

    def finish(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        raw = _device_intervals(self.prof)
        marks = [a for n, a, _b in raw if "spin_kernel" in n]
        offset = (marks[0] - self._t_mark) if marks else 0.0
        t0, t1 = self._t_open, self._t_close
        for n, a, b in raw:
            a, b = a - offset, b - offset
            if b > t0 and a < t1 and "spin_kernel" not in n:
                self.kernels.append((n, a, b))
                self.cut.append((n, max(a, t0), min(b, t1)))
        print(f"[trace] {len(raw)} device records, {len(self.kernels)} in "
              f"the window, read in {time.perf_counter() - t_read:.3f} s; "
              f"clock marker {'found' if marks else 'MISSING'}",
              file=sys.stderr)
        self.prof = None

    # -- readings -------------------------------------------------------------
    def busy_s(self) -> float:
        return union_length([(a, b) for _n, a, b in self.cut])

    def time_by_name(self, top: int = 10) -> list[list]:
        by = collections.Counter()
        for n, a, b in self.cut:
            by[n] += b - a
        return [[n, s] for n, s in by.most_common(top)]

    def kernel_time(self, patterns) -> tuple[float, int]:
        """(seconds, launches) of the kernels that start in the window and
        whose name holds one of ``patterns``, each timed whole."""
        s, k = 0.0, 0
        for n, a, b in self.kernels:
            if a >= self._t_open and any(p in n for p in patterns):
                s += b - a
                k += 1
        return s, k

    def idle_gaps(self, spans, top: int = 10) -> list[list]:
        """The ``top`` longest gaps between device intervals, each named by
        the benchmark's host span that covers most of it (``spans``: a list
        of (name, t0, t1) in the trace's clock), or ``host`` when none."""
        iv = sorted((a, b) for _n, a, b in self.cut)
        gaps = []
        end = None
        for a, b in iv:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            best, cover = "host", 0.0
            for name, s0, s1 in spans:
                c = min(g1, s1) - max(g0, s0)
                if c > cover:
                    best, cover = name, c
            out.append([best, g1 - g0])
        return out


def union_length(intervals) -> float:
    total = 0.0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        elif b > end:
            end = b
    if end is not None:
        total += end - start
    return total


def _device_intervals(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device-side record of the trace
    (kernels, copies and fills), in the profiler's clock."""
    out = []
    events = prof.profiler.kineto_results.events()
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        t0 = e.start_ns() / 1e9
        out.append((e.name(), t0, t0 + e.duration_ns() / 1e9))
    return out
